"""Flow-field colorization (Middlebury color wheel), numpy only.

Hue encodes flow direction via a 55-entry color wheel, saturation the
magnitude normalized by the max motion.  A copy of
``flowonthego_tpu/io/color.py`` (importing that package would import JAX).
"""

from __future__ import annotations

import numpy as np

from .flo import UNKNOWN_FLOW_THRESH


def make_color_wheel() -> np.ndarray:
    """The 55-color Middlebury wheel: RY=15, YG=6, GC=4, CB=11, BM=13, MR=6."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3), dtype=np.float64)
    col = 0
    # RY
    wheel[col:col + RY, 0] = 255
    wheel[col:col + RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    # YG
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    # GC
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    # CB
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    # BM
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    # MR
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


_WHEEL = make_color_wheel()


def compute_color(fx: np.ndarray, fy: np.ndarray) -> np.ndarray:
    """Map normalized flow (|f| <= 1 in the saturated range) to RGB uint8.

    Angle -> wheel index; radius <= 1 scales toward white, radius > 1
    darkens by 0.75.
    """
    ncols = _WHEEL.shape[0]
    rad = np.sqrt(fx * fx + fy * fy)
    a = np.arctan2(-fy, -fx) / np.pi
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int64)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    col = (1.0 - f) * _WHEEL[k0] / 255.0 + f * _WHEEL[k1] / 255.0
    inside = (rad <= 1.0)[..., None]
    col = np.where(inside, 1.0 - rad[..., None] * (1.0 - col), col * 0.75)
    return np.floor(255.0 * col).astype(np.uint8)


def flow_to_color(flow: np.ndarray, max_motion: float | None = None) -> np.ndarray:
    """Colorize a [H, W, 2] flow field -> RGB uint8 [H, W, 3].

    Unknown flow is painted black; the field is normalized by
    ``max_motion`` (or the observed max radius).
    """
    flow = np.asarray(flow, dtype=np.float64)
    fx, fy = flow[..., 0].copy(), flow[..., 1].copy()
    unknown = (np.abs(fx) > UNKNOWN_FLOW_THRESH) | (
        np.abs(fy) > UNKNOWN_FLOW_THRESH) | np.isnan(fx) | np.isnan(fy)
    fx[unknown] = 0.0
    fy[unknown] = 0.0

    rad = np.sqrt(fx * fx + fy * fy)
    maxrad = float(max_motion) if max_motion else max(float(rad.max()), 1e-9)
    rgb = compute_color(fx / maxrad, fy / maxrad)
    rgb[unknown] = 0
    return rgb
