"""Seeded smooth textures, rounded to 8 bits as a decoder delivers frames.

A numpy copy of ``smooth_texture`` in ``flowonthego_tpu_torch/utils/
synth.py`` at commit 5c83323: standard normals on a coarse grid, two
[1, 2, 1]/4 passes per axis, bilinear upsampling by ``factor``, then
``128 + 200 * texture``; here clipped to [0, 255] and rounded to uint8.
Every step is float64 arithmetic in a fixed order, so a seed gives the
same bytes on any machine.
"""

from __future__ import annotations

import numpy as np


def _smooth(g: np.ndarray, axis: int) -> np.ndarray:
    n = g.shape[axis]
    pad = [(0, 0)] * g.ndim
    pad[axis] = (1, 1)
    p = np.pad(g, pad, mode="edge")
    return (np.take(p, np.arange(0, n), axis=axis)
            + 2.0 * np.take(p, np.arange(1, n + 1), axis=axis)
            + np.take(p, np.arange(2, n + 2), axis=axis)) * 0.25


def _upsample(g: np.ndarray, n_out: int, factor: int, axis: int) -> np.ndarray:
    src = (np.arange(n_out, dtype=np.float64) + 0.5) / factor + 1.0
    i0 = np.floor(src).astype(np.int64)
    shape = [1] * g.ndim
    shape[axis] = n_out
    frac = (src - i0).reshape(shape)
    return (np.take(g, i0, axis=axis) * (1.0 - frac)
            + np.take(g, i0 + 1, axis=axis) * frac)


def texture(seed: int, height: int, width: int, channels: int = 3,
            factor: int = 16) -> np.ndarray:
    """[height, width, channels] uint8 texture around 128."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((height // factor + 4, width // factor + 4,
                             channels))
    for _ in range(2):
        g = _smooth(_smooth(g, 0), 1)
    tex = _upsample(_upsample(g, height, factor, 0), width, factor, 1)
    return np.clip(np.rint(128.0 + 200.0 * tex), 0, 255).astype(np.uint8)
