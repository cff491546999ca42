"""Seeded synthetic scenes with a known integer motion (numpy only).

A smooth random texture is built at a coarse grid (standard normals from
``np.random.default_rng(seed)``), smoothed by two [1, 2, 1]/4 passes per
axis and bilinearly upsampled by ``factor``.  Every step is elementwise
float64 arithmetic in a fixed order, so the same seed gives the same
frames on any machine; a golden flow computed on one machine therefore
holds on another.  Frames are crops of that texture moved by a whole
number of pixels, so the true flow is known everywhere but at the border.
:func:`synthetic_split_pair` moves the two halves of a frame by different
amounts, so the true flow is known per pixel and is not uniform.
"""

from __future__ import annotations

import numpy as np


def _smooth(g: np.ndarray, axis: int) -> np.ndarray:
    n = g.shape[axis]
    pad = [(0, 0)] * g.ndim
    pad[axis] = (1, 1)
    p = np.pad(g, pad, mode="edge")
    take = lambda lo: np.take(p, np.arange(lo, lo + n), axis=axis)  # noqa: E731
    return (take(0) + 2.0 * take(1) + take(2)) * 0.25


def _upsample(g: np.ndarray, n_out: int, factor: int, axis: int) -> np.ndarray:
    # output sample j sits at grid coordinate (j + 0.5) / factor + 1
    src = (np.arange(n_out, dtype=np.float64) + 0.5) / factor + 1.0
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    shape = [1] * g.ndim
    shape[axis] = n_out
    frac = frac.reshape(shape)
    return (np.take(g, i0, axis=axis) * (1.0 - frac)
            + np.take(g, i0 + 1, axis=axis) * frac)


def smooth_texture(seed: int, height: int, width: int, channels: int = 3,
                   factor: int = 16) -> np.ndarray:
    """[height, width, channels] float32 texture around 128 (std ~50)."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((height // factor + 4, width // factor + 4,
                             channels))
    for _ in range(2):
        g = _smooth(_smooth(g, 0), 1)
    tex = _upsample(_upsample(g, height, factor, 0), width, factor, 1)
    return (128.0 + 200.0 * tex).astype(np.float32)


def plant_stripes(frames: np.ndarray, size: int = 20) -> np.ndarray:
    """Overwrite the bottom-right block of each frame [..., h, w, C] (in
    place; ``size`` x ``size``, at most half of each side) with vertical
    stripes: constant along y, varying along x.  Inside it gy is exactly 0
    and gx is not, so a patch whose window lies there has H01 == H11 == 0
    < H00, and det == 0 (the Hessian's bump) at a patch that is not flat.
    Returns ``frames``."""
    h, w = frames.shape[-3], frames.shape[-2]
    hs, ws = min(size, h // 2), min(size, w // 2)
    x = np.arange(w - ws, w, dtype=np.float64)
    stripes = (128.0 + 60.0 * np.sin(0.9 * x)).astype(np.float32)
    frames[..., h - hs:, w - ws:, :] = stripes[:, None]
    return frames


def synthetic_frames(seed: int, n_frames: int, height: int, width: int,
                     shift: tuple[int, int], channels: int = 3,
                     factor: int = 16) -> list[np.ndarray]:
    """``n_frames`` crops of one texture; frame k+1 is frame k moved by
    ``shift = (sx, sy)`` whole pixels, so the flow from each frame to the
    next is ``(sx, sy)`` everywhere the content stays in view."""
    sx, sy = int(shift[0]), int(shift[1])
    m = (n_frames - 1) * max(abs(sx), abs(sy)) + 8
    base = smooth_texture(seed, height + 2 * m, width + 2 * m, channels,
                          factor)
    return [base[m - k * sy:m - k * sy + height, m - k * sx:m - k * sx + width]
            for k in range(n_frames)]


def synthetic_pair(seed: int, height: int, width: int,
                   shift: tuple[int, int], channels: int = 3,
                   factor: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """(I0, I1) with flow ``shift = (sx, sy)`` from I0 to I1."""
    i0, i1 = synthetic_frames(seed, 2, height, width, shift, channels, factor)
    return i0, i1


def synthetic_split_pair(seed: int, height: int, width: int,
                         shift_left: tuple[int, int] = (2, 2),
                         shift_right: tuple[int, int] = (16, 8),
                         channels: int = 3, factor: int = 16):
    """A pair whose left half moves by ``shift_left`` and whose right half
    by ``shift_right`` (whole pixels, (sx, sy)) -> (I0, I1, flow, known).

    I0 is a crop of the texture; I1 is that texture warped by the exact
    field: a pixel of I1 left of the seam ``width // 2`` shows the texture
    moved by ``shift_left``, one at or right of it the texture moved by
    ``shift_right``.  ``flow`` [H, W, 2] float32 is the motion of every I0
    pixel and ``known`` [H, W] bool marks the pixels where it is the true
    flow: those whose target ``x + flow`` lies in I1 on their own side of
    the seam.  Between the two (a band as wide as the difference of the
    horizontal motions) content is hidden or uncovered and no flow is
    true."""
    shifts = np.asarray([shift_left, shift_right], dtype=np.int64)
    m = int(np.abs(shifts).max()) + 8
    base = smooth_texture(seed, height + 2 * m, width + 2 * m, channels,
                          factor)
    seam = width // 2
    i0 = base[m:m + height, m:m + width]
    moved = [base[m - sy:m - sy + height, m - sx:m - sx + width]
             for sx, sy in shifts]
    i1 = np.concatenate([moved[0][:, :seam], moved[1][:, seam:]], axis=1)
    jj, ii = np.mgrid[0:height, 0:width]
    right = ii + shifts[1, 0] >= seam          # lands right of the seam
    left = ii + shifts[0, 0] < seam
    flow = np.where(right[..., None], shifts[1], shifts[0]).astype(np.float32)
    tx, ty = ii + flow[..., 0], jj + flow[..., 1]
    known = ((left ^ right) & (tx >= 0) & (tx < width) & (ty >= 0)
             & (ty < height))
    return i0, np.ascontiguousarray(i1), flow, known
