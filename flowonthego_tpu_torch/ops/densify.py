"""Patch-to-dense flow aggregation (port of
``flowonthego_tpu/ops/densify.py``, without the forward-backward merge).

Patch origins are static integer grid midpoints, so with the periodic
split py = m*steps + pr an in-patch row lands on output row
(j+m)*steps + pr: the scatter is r = ceil(ps/steps) shifted adds per axis
of pure reshapes — no scatter, no atomics, deterministic.

Per-pixel weight absw = 1 / sum_c max(min_errval, cost_px[c]),
accumulating (absw, absw*u, absw*v), then normalize where the weight is
positive.  Contributions outside the image are dropped (2-D clipping).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import DISConfig
from .dis import PatchState
from .patches import PatchGrid


def _pixel_weights(state: PatchState, cfg: DISConfig) -> torch.Tensor:
    """absw = 1 / sum_c max(min_errval, e_c); e_c is the squared residual,
    or its square root under ``densify_weight="abs"``."""
    err = state.cost_px
    if cfg.densify_weight == "abs" and cfg.cost_fn == "l2":
        err = torch.sqrt(err)
    clamped = torch.clamp(err, min=cfg.min_errval)
    return 1.0 / clamped.sum(dim=-1)


def overlap_add_canvas(contrib: torch.Tensor, ps: int, st: int) -> torch.Tensor:
    """Overlap-add the [n_h, n_w, ps, ps, F] contribution grid into a
    canvas [(n_h+r-1)*st, (n_w+r-1)*st, F] whose (0, 0) sits at image
    position (first patch midpoint - ps/2) on each axis."""
    n_h, n_w = contrib.shape[:2]
    Fd = contrib.shape[-1]
    r = -(-ps // st)
    R = r * st
    c = F.pad(contrib, (0, 0, 0, R - ps, 0, R - ps))
    c = c.reshape(n_h, n_w, r, st, r, st, Fd)     # py=(m,pr), px=(q,qc)
    Yp = (n_h + r - 1) * st
    rows = None
    for m in range(r):
        part = c[:, :, m].permute(0, 2, 1, 3, 4, 5).reshape(
            n_h * st, n_w, r, st, Fd)
        sh = F.pad(part, (0, 0, 0, 0, 0, 0, 0, 0,
                          m * st, Yp - m * st - n_h * st))
        rows = sh if rows is None else rows + sh
    Xp = (n_w + r - 1) * st
    cols = None
    for q in range(r):
        part = rows[:, :, q].reshape(Yp, n_w * st, Fd)
        sh = F.pad(part, (0, 0, q * st, Xp - q * st - n_w * st))
        cols = sh if cols is None else cols + sh
    return cols


def densify(state: PatchState, grid: PatchGrid, cfg: DISConfig) -> torch.Tensor:
    """Aggregate per-patch flow into a dense [H, W, 2] field."""
    if cfg.use_fb_consistency:
        raise NotImplementedError("the forward-backward merge is not ported")
    ps, st = grid.patch_size, grid.steps
    h, w = grid.height, grid.width
    r = -(-ps // st)
    R = r * st
    margin = ps + 2 * R       # generous static margin, cropped at the end

    absw = _pixel_weights(state, cfg)                     # [n_h, n_w, ps, ps]
    u = state.p_cur[..., 0][..., None, None]
    v = state.p_cur[..., 1][..., None, None]
    contrib = torch.stack([absw, absw * u, absw * v], dim=-1)

    canvas = overlap_add_canvas(contrib, ps, st)
    Yp, Xp = canvas.shape[0], canvas.shape[1]
    top = margin + grid.offset_h - ps // 2
    left = margin + grid.offset_w - ps // 2
    acc = F.pad(canvas, (0, 0, left, w + 2 * margin - left - Xp,
                         top, h + 2 * margin - top - Yp))
    acc = acc[margin:margin + h, margin:margin + w, :]
    weight = acc[..., 0:1]
    return torch.where(weight > 0, acc[..., 1:3] / weight, 0.0)
