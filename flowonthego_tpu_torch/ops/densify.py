"""Patch-to-dense flow aggregation (port of
``flowonthego_tpu/ops/densify.py``).

Patch origins are static integer grid midpoints, so with the periodic
split py = m*steps + pr an in-patch row lands on output row
(j+m)*steps + pr: the scatter is r = ceil(ps/steps) shifted adds per axis
of pure reshapes — no scatter, no atomics, deterministic.

Per-pixel weight absw = 1 / sum_c max(min_errval, cost_px[c]),
accumulating (absw, absw*u, absw*v), then normalize where the weight is
positive.  Contributions outside the image are dropped (2-D clipping).

The forward-backward merge (:func:`fb_merge_plain`) lands patches at
optimized, data-dependent positions, so it is a real scatter-add; it
accumulates in a fixed order (see there).

On the card the weights, the overlap-add, the clip and the normalisation
are one launch of the G3 kernel (:mod:`.cuda.densify`), a gather in the
canvas's order of adds; the merge is the G5 kernel
(:mod:`.cuda.fb_merge`), which keeps the merge's order of adds.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..config import DISConfig, use_kernel
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


def _fb_merge_scatter(state: PatchState, grid: PatchGrid, cfg: DISConfig,
                      out_h: int, out_w: int) -> torch.Tensor:
    """Complementary-grid merge: scatter the *reversed* backward flow into
    a [B, out_h, out_w, 3] (weight, w*u, w*v) accumulator
    (:func:`fb_merge_plain` says how).  The G5 kernel
    (:mod:`.cuda.fb_merge`) where ``cfg.gn_backend`` selects the kernels
    for the state, :func:`fb_merge_plain` otherwise."""
    if use_kernel(cfg.gn_backend, state.p_cur):
        from .cuda.fb_merge import fb_merge
        return fb_merge(state._replace(p_cur=state.p_cur.contiguous(),
                                       cost_px=state.cost_px.contiguous()),
                        grid, cfg, out_h, out_w)
    return fb_merge_plain(state, grid, cfg, out_h, out_w)


def fb_merge_contributions(state: PatchState, grid: PatchGrid,
                           cfg: DISConfig, out_h: int, out_w: int):
    """The merge's contributions: (idx [B*4*ps*ps*n], vals [.., 3]) in the
    order of :func:`fb_merge_plain`'s fold; a dropped one has index
    ``B * out_h * out_w`` (one row past the frames) and zero values."""
    ps = grid.patch_size
    B = state.p_cur.shape[0]
    pos = state.mid_org + state.p_cur                 # [B, n_h, n_w, 2]
    px = pos[..., 0]
    py = pos[..., 1]
    cx = torch.ceil(px + 1e-5).to(torch.int64)
    cy = torch.ceil(py + 1e-5).to(torch.int64)
    fx = torch.floor(px)
    fy = torch.floor(py)
    rx = (px - fx)[..., None, None]
    ry = (py - fy)[..., None, None]
    wbil = [rx * ry, (1 - rx) * ry, rx * (1 - ry), (1 - rx) * (1 - ry)]
    corner_off = [(0, 0), (1, 0), (0, 1), (1, 1)]      # (dx, dy) subtracted

    absw = _pixel_weights(state, cfg)             # [B, n_h, n_w, ps, ps]
    u = state.p_cur[..., 0][..., None, None]
    v = state.p_cur[..., 1][..., None, None]

    lb = -ps // 2
    ar = torch.arange(lb, lb + ps, device=pos.device)
    xt = cx[..., None, None] + ar[None, :]        # [B, n_h, n_w, ps, ps]
    yt = cy[..., None, None] + ar[:, None]
    valid = (xt >= 1) & (yt >= 1) & (xt < out_w - 1) & (yt < out_h - 1)

    n = out_h * out_w
    frame = (torch.arange(B, device=pos.device) * n).reshape(B, 1, 1, 1, 1)
    base = torch.stack([absw, -u * absw, -v * absw], dim=-1)
    # [B, 4 corners, patch values]: frame-major, then JAX's order
    idx = torch.stack([(frame + (yt - oy) * out_w + (xt - ox)).reshape(B, -1)
                       for ox, oy in corner_off], dim=1)
    valid4 = valid.reshape(B, 1, -1).expand(B, 4, -1)
    idx = torch.where(valid4, idx, B * n).reshape(-1)   # row B*n: dropped
    vals = torch.stack([torch.where(valid[..., None], wb[..., None] * base,
                                    0.0).reshape(B, -1, 3) for wb in wbil],
                       dim=1).reshape(-1, 3)
    return idx, vals


def fb_merge_plain(state: PatchState, grid: PatchGrid, cfg: DISConfig,
                   out_h: int, out_w: int) -> torch.Tensor:
    """The merge in plain PyTorch (the JAX package's ``_fb_merge_scatter``).

    Each complementary patch lands at its optimized position ``mid_org +
    p_cur`` (coordinates of the other frame); its per-pixel weights are
    spread bilinearly over the 4 neighbour cells and its NEGATED flow is
    accumulated.  A pixel counts only where all 4 cells lie inside
    [1, w-1) x [1, h-1).  Returns a [B, out_h, out_w, 3] (weight, u, v)
    accumulator.

    Deterministic: one scatter-add for the whole batch takes each frame's
    contributions in the JAX package's order (corners outer, patches in
    grid order within a corner), frame after frame, each frame's cells
    offset by b * out_h * out_w.  Frames never share a cell, so every cell
    sees the contributions a single-pair merge gives it, in the same
    order, and for a fixed corner and patch at most one pixel lands on a
    cell: each cell's sum is the left fold from +0.0 of its contributions
    in that order.  On the CPU ``index_add_`` adds serially in that order,
    as JAX does.  On the card ``index_put_(accumulate=True)`` sorts the
    flat indices stably and folds each cell's run in sorted order, without
    atomics, which is the same fold.
    """
    idx, vals = fb_merge_contributions(state, grid, cfg, out_h, out_w)
    B, n = state.p_cur.shape[0], out_h * out_w
    acc = torch.zeros((B * n + 1, 3), dtype=vals.dtype, device=vals.device)
    return scatter_add(acc, idx, vals)[:B * n].reshape(B, out_h, out_w, 3)


def scatter_add(acc: torch.Tensor, idx: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """``acc[idx[k]] += vals[k]`` in place, deterministically (see
    :func:`fb_merge_plain`): a sorted ``index_put_(accumulate=True)``
    on the card, ``index_add_`` (serial, in index order) on the CPU."""
    if acc.is_cuda:
        acc.index_put_((idx,), vals, accumulate=True)
    else:
        # index_put_ adds in parallel on the CPU when torch has several
        # threads; index_add_ adds serially, in index order
        acc.index_add_(0, idx, vals)
    return acc


def overlap_add_canvas(contrib: torch.Tensor, ps: int, st: int) -> torch.Tensor:
    """Overlap-add the [B, n_h, n_w, ps, ps, F] contribution grid into
    per-frame canvases [B, (n_h+r-1)*st, (n_w+r-1)*st, F] whose (0, 0) sits
    at image position (first patch midpoint - ps/2) on each axis."""
    B, n_h, n_w = contrib.shape[:3]
    Fd = contrib.shape[-1]
    r = -(-ps // st)
    R = r * st
    c = F.pad(contrib, (0, 0, 0, R - ps, 0, R - ps))
    c = c.reshape(B, n_h, n_w, r, st, r, st, Fd)  # py=(m,pr), px=(q,qc)
    Yp = (n_h + r - 1) * st
    rows = None
    for m in range(r):
        part = c[:, :, :, m].permute(0, 1, 3, 2, 4, 5, 6).reshape(
            B, n_h * st, n_w, r, st, Fd)
        sh = F.pad(part, (0, 0, 0, 0, 0, 0, 0, 0,
                          m * st, Yp - m * st - n_h * st))
        rows = sh if rows is None else rows + sh
    Xp = (n_w + r - 1) * st
    cols = None
    for q in range(r):
        part = rows[:, :, :, q].reshape(B, Yp, n_w * st, Fd)
        sh = F.pad(part, (0, 0, q * st, Xp - q * st - n_w * st))
        cols = sh if cols is None else cols + sh
    return cols


def fb_merge(compl_state: PatchState, grid: PatchGrid,
             cfg: DISConfig) -> torch.Tensor:
    """The [B, H, W, 3] merge of a complementary (opposite-direction)
    grid's reversed flow into this grid's frame, for :func:`densify`'s
    ``merge``: the G5 kernel or :func:`fb_merge_plain`
    (:func:`_fb_merge_scatter`)."""
    return _fb_merge_scatter(compl_state, grid, cfg, grid.height,
                             grid.width)


def densify(state: PatchState, grid: PatchGrid, cfg: DISConfig,
            compl_state: Optional[PatchState] = None,
            merge: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Aggregate each frame's per-patch flow into a dense [B, H, W, 2]
    field; contributions outside a frame are dropped (2-D clipping per
    frame), so none reaches the next frame.

    ``compl_state`` optionally merges a complementary (opposite-direction)
    grid's reversed flow: forward-backward consistency (the JAX package's
    argument); ``merge`` is that merge computed already (:func:`fb_merge`).
    The merge is the G5 kernel and the canvas and the normalisation the
    G3 kernel (:mod:`.cuda.fb_merge`, :mod:`.cuda.densify`) where
    ``cfg.gn_backend`` selects the kernels for the state, and
    :func:`fb_merge_plain` and :func:`densify_plain` otherwise."""
    if compl_state is not None:
        merge = fb_merge(compl_state, grid, cfg)
    if use_kernel(cfg.gn_backend, state.p_cur):
        from .cuda.densify import densify as kernel
        return kernel(state._replace(p_cur=state.p_cur.contiguous(),
                                     cost_px=state.cost_px.contiguous()),
                      grid, cfg, None if merge is None else merge.contiguous())
    return densify_plain(state, grid, cfg, merge)


def densify_plain(state: PatchState, grid: PatchGrid, cfg: DISConfig,
                  merge: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`densify` in plain PyTorch; ``merge``: the fb merge's
    [B, H, W, 3] (weight, w*u, w*v) accumulator, added to the canvas
    before the normalisation."""
    ps, st = grid.patch_size, grid.steps
    h, w = grid.height, grid.width
    r = -(-ps // st)
    R = r * st
    margin = ps + 2 * R       # generous static margin, cropped at the end

    absw = _pixel_weights(state, cfg)                # [B, n_h, n_w, ps, ps]
    u = state.p_cur[..., 0][..., None, None]
    v = state.p_cur[..., 1][..., None, None]
    contrib = torch.stack([absw, absw * u, absw * v], dim=-1)

    canvas = overlap_add_canvas(contrib, ps, st)
    Yp, Xp = canvas.shape[1], canvas.shape[2]
    top, left = grid.window_origin(margin)
    acc = F.pad(canvas, (0, 0, left, w + 2 * margin - left - Xp,
                         top, h + 2 * margin - top - Yp))
    acc = acc[:, margin:margin + h, margin:margin + w, :]
    if merge is not None:
        acc = acc + merge
    weight = acc[..., 0:1]
    return torch.where(weight > 0, acc[..., 1:3] / weight, 0.0)
