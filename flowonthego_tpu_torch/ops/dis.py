"""Dense Inverse Search patch optimizer (port of
``flowonthego_tpu/ops/dis.py``: state, warm start, the L2 fixed-trip
solve and the reference-form solve).

Every tensor carries a leading batch axis: B frames' patch grids step
together (a single pair is B = 1).  The whole patch grid steps in
lockstep: ``grad_descent_iter``
projection+resample trips with a per-patch active mask.  A patch whose
step leaves the outlier radius or the midpoint box resets to ``p_org``
(the coarser-scale init) and freezes.  The fixed-trip L2 solve is
:func:`.cuda.dis_gn.gn_scale_loop`: the K2 kernel on the card, the JAX
package's reduction form in plain PyTorch otherwise.  The robust costs,
the ``min_iter`` early exits and ``res_thresh > 0`` take
:func:`optimize_reference`, as in the JAX package: the G6 kernel on the
card (:mod:`.cuda.dis_ref`), :func:`optimize_reference_plain` otherwise.

``cfg.dtype="bfloat16"`` is the Pallas kernel's operand mode: the level
image, the templates and their gradients are rounded to bf16 once per
scale; the blend, the reductions and the carries stay float32, and the
per-patch sums of the gradients and of gradient x template come from
the float32 state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DISConfig, use_kernel
from ..utils.device import device_constant
from .cuda import dis_gn
from .interp import sample_patches_bilinear
from .patches import PatchGrid


class PatchState(NamedTuple):
    """Struct-of-arrays patch state of B frames, shaped [B, n_h, n_w] (+
    trailing dims)."""
    p_cur: torch.Tensor       # [B, n_h, n_w, 2] current flow (u, v)
    p_org: torch.Tensor       # [B, n_h, n_w, 2] init flow (outlier reset target)
    mid_org: torch.Tensor     # [B, n_h, n_w, 2] grid midpoint (x, y)
    H: torch.Tensor           # [B, n_h, n_w, 3] Hessian (H00, H01, H11)
    templates: torch.Tensor   # [B, n_h, n_w, ps, ps, C] mean-normalized template
    tgrad_x: torch.Tensor     # [B, n_h, n_w, ps, ps, C] template d/dx
    tgrad_y: torch.Tensor     # [B, n_h, n_w, ps, ps, C] template d/dy
    converged: torch.Tensor   # [B, n_h, n_w] bool
    cost_px: torch.Tensor     # [B, n_h, n_w, ps, ps, C] final per-pixel sq. residual
    diff: torch.Tensor        # [B, n_h, n_w, ps, ps, C] residual (zeros after K2)


_PATCH = (-3, -2, -1)         # the ps, ps, C dims of a per-pixel patch tensor


def init_state(templates, tgrad_x, tgrad_y, H, grid: PatchGrid) -> PatchState:
    """Fresh per-scale state of templates [B, n_h, n_w, ps, ps, C]: zero
    flow, nothing converged."""
    dev, dt = templates.device, templates.dtype
    B = templates.shape[0]
    # the grid's midpoints, built on the host once per (grid, device) and
    # shared by the B frames
    mid_org = device_constant(
        ("mid_org", grid, dt), dev,
        lambda: torch.as_tensor(
            np.stack(grid.midpoints(), axis=-1)[None]).to(dt)
    ).expand(B, grid.n_h, grid.n_w, 2)
    zeros2 = torch.zeros((B, grid.n_h, grid.n_w, 2), dtype=dt, device=dev)
    return PatchState(
        p_cur=zeros2,
        p_org=zeros2,
        mid_org=mid_org,
        H=H,
        templates=templates,
        tgrad_x=tgrad_x,
        tgrad_y=tgrad_y,
        converged=torch.zeros((B, grid.n_h, grid.n_w), dtype=torch.bool,
                              device=dev),
        cost_px=torch.zeros_like(templates),
        diff=torch.zeros_like(templates),
    )


def coarse_lookup(grid: PatchGrid, ch: int, cw: int, device):
    """(ix, iy) [n_h, n_w] int64 on ``device``: where each patch of
    ``grid`` reads a coarser field of ch x cw, floor(midpoint / 2) clamped
    to the field; built on the host once per (grid, field, device)."""
    def build(axis, n):
        return lambda: np.minimum(grid.midpoints()[axis].astype(int) // 2,
                                  n - 1)
    return (device_constant(("coarse_ix", grid, cw), device, build(0, cw)),
            device_constant(("coarse_iy", grid, ch), device, build(1, ch)))


def init_from_coarser(state: PatchState, coarse_flow: torch.Tensor,
                      grid: PatchGrid) -> PatchState:
    """Warm start from the coarser scale's dense flow [B, ch, cw, 2]:
    nearest lookup at floor(midpoint / 2), flow x2 (deliberately not
    bilinear), each frame from its own field.  Patches whose warm-started
    midpoint leaves the valid box are frozen at once (converged, cost 0).

    The lookup clamps to the coarse field, as JAX's gather does: a warm
    start at 1/2^(cs+1) of a height like 2176 (8 rows, from 8.5) is one
    row short of floor(midpoint / 2) for the last grid row.  The clamp
    is per frame: the index never leaves frame b's field.
    """
    dev = coarse_flow.device
    ch, cw = coarse_flow.shape[1], coarse_flow.shape[2]
    ix, iy = coarse_lookup(grid, ch, cw, dev)
    p = coarse_flow[:, iy, ix, :] * 2.0        # [B, n_h, n_w, 2]

    mid = state.mid_org + p
    oob = ((mid[..., 0] < grid.l_bound) | (mid[..., 1] < grid.l_bound)
           | (mid[..., 0] > grid.u_bound_w) | (mid[..., 1] > grid.u_bound_h))
    return state._replace(p_cur=p, p_org=p, converged=oob)


def _sample_residual(state: PatchState, I1_pad: torch.Tensor,
                     grid: PatchGrid, cfg: DISConfig, sample_offset=None):
    """Resample the target patch at ``mid_org + p_cur``, mean-normalize,
    subtract the template and apply the cost's residual transform.

    ``sample_offset`` (off_x, off_y), Python floats: the midpoints are
    global and ``I1_pad`` is a shard's strip or tile; samples are read at
    ``(mid_org + p_cur) + sample_offset``.

    Returns (diff, cost_px, cost): the transformed residual and its
    per-pixel cost, each like ``templates``, and the per-patch sum."""
    mid = state.mid_org + state.p_cur
    mx, my = mid[..., 0], mid[..., 1]
    if sample_offset is not None:
        mx, my = mx + sample_offset[0], my + sample_offset[1]
    raw = sample_patches_bilinear(I1_pad, mx, my, grid.patch_size,
                                  grid.padding)
    if cfg.use_mean_normalization:
        raw = raw - raw.mean(dim=_PATCH, keepdim=True)
    diff = raw - state.templates
    if cfg.cost_fn == "l1":
        # sign(d) * sqrt(|d|)
        diff = torch.sign(diff) * torch.sqrt(torch.abs(diff))
        cost_px = torch.abs(diff)
    elif cfg.cost_fn == "huber":
        # pseudo-Huber: sign(d) * sqrt(2 b^2 (sqrt(1 + d^2/b^2) - 1))
        b2 = cfg.norm_outlier * cfg.norm_outlier
        diff = torch.sign(diff) * torch.sqrt(
            2.0 * b2 * (torch.sqrt(1.0 + diff * diff / b2) - 1.0))
        cost_px = torch.abs(diff)
    else:
        cost_px = diff * diff
    return diff, cost_px, cost_px.sum(dim=_PATCH)


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """Broadcast a [B, n_h, n_w] mask over the trailing dims of a and b."""
    extra = a.dim() - mask.dim()
    return torch.where(mask.reshape(mask.shape + (1,) * extra), a, b)


def contiguous_state(state: PatchState) -> PatchState:
    """``state`` in the kernels' layout: every per-patch field contiguous
    (``mid_org`` may stay the grid's expanded constant)."""
    return state._replace(**{
        k: getattr(state, k).contiguous()
        for k in PatchState._fields if k != "mid_org"})


def optimize_reference(state: PatchState, I1_pad: torch.Tensor,
                       grid: PatchGrid, cfg: DISConfig,
                       sample_offset=None) -> PatchState:
    """The reference-form solve (:func:`optimize_reference_plain`): the
    G6 kernel (:mod:`.cuda.dis_ref`) where ``cfg.gn_backend`` selects the
    kernels for ``I1_pad``, the plain version otherwise."""
    if use_kernel(cfg.gn_backend, I1_pad):
        from .cuda import dis_ref
        return dis_ref.optimize_reference(contiguous_state(state),
                                          I1_pad.contiguous(), grid, cfg,
                                          sample_offset)
    return optimize_reference_plain(state, I1_pad, grid, cfg, sample_offset)


def optimize_reference_plain(state: PatchState, I1_pad: torch.Tensor,
                             grid: PatchGrid, cfg: DISConfig,
                             sample_offset=None, count_iters: bool = False):
    """The reference-form solve in plain PyTorch: the residual tensor is
    materialized every iteration, so any cost transform and the 4-clause
    convergence test apply.  The JAX package runs this form in XLA for
    l1/huber costs, ``min_iter`` early exits and ``res_thresh > 0``.

    Order as the JAX loop: sample at the warm start first, then
    ``grad_descent_iter`` trips of project -> outlier reset -> resample ->
    convergence test, every patch masked once converged.  Below
    ``min_iter`` (None: ``grad_descent_iter``) the dp/dr clauses cannot
    stop a patch.  Every patch ends converged.  ``sample_offset``: see
    :func:`_sample_residual` (the tests stay global).  With
    ``count_iters`` it returns (state, trips [B, n_h, n_w]): the trips
    each patch ran, the work a bound on these inputs counts.
    """
    # values per patch, channel-generic (gray/gradmag inputs have C = 1)
    n_vals = float(np.prod(state.templates.shape[-3:]))
    max_iter = cfg.grad_descent_iter
    min_iter = max_iter if cfg.min_iter is None else cfg.min_iter

    active0 = ~state.converged
    diff, cost_px, cost = _sample_residual(state, I1_pad, grid, cfg,
                                           sample_offset)
    mares = cost / n_vals
    state = state._replace(
        diff=_where(active0, diff, state.diff),
        cost_px=_where(active0, cost_px, state.cost_px),
        converged=state.converged | (active0 & (mares <= cfg.res_thresh)))
    # the previous trip's mares and the first trip's |delta_p|^2
    mares_prev = mares
    dp_init = torch.full_like(mares, 1e-10)
    trips = (torch.zeros(mares.shape, dtype=torch.int64, device=mares.device)
             if count_iters else None)

    for cnt in range(1, max_iter + 1):
        st = state
        active = ~st.converged
        if count_iters:
            trips += active
        # projection: delta_p = H^-1 J^T diff
        dpx = (st.tgrad_x * st.diff).sum(dim=_PATCH)
        dpy = (st.tgrad_y * st.diff).sum(dim=_PATCH)
        h00, h01, h11 = st.H[..., 0], st.H[..., 1], st.H[..., 2]
        det = h00 * h11 - h01 * h01
        delta_px = (h11 * dpx - h01 * dpy) / det
        delta_py = (h00 * dpy - h01 * dpx) / det
        p_new = st.p_cur - torch.stack([delta_px, delta_py], dim=-1)
        mid_new = st.mid_org + p_new

        # beyond the outlier radius or out of the midpoint box: reset to
        # p_org and stop
        disp = mid_new - st.mid_org
        norm = torch.sqrt(disp[..., 0] ** 2 + disp[..., 1] ** 2)
        outlier = ((norm > cfg.outlier_thresh)
                   | (mid_new[..., 0] < grid.l_bound)
                   | (mid_new[..., 1] < grid.l_bound)
                   | (mid_new[..., 0] > grid.u_bound_w)
                   | (mid_new[..., 1] > grid.u_bound_h))
        p_new = _where(outlier, st.p_org, p_new)
        st = st._replace(p_cur=_where(active, p_new, st.p_cur))

        diff, cost_px, cost = _sample_residual(st, I1_pad, grid, cfg,
                                               sample_offset)
        mares = cost / n_vals

        # |delta_p|^2 of the solved step, before the reset; the first
        # trip's is the dp-ratio's denominator
        dp_sq = delta_px * delta_px + delta_py * delta_py
        if cnt == 1:
            dp_init = torch.where(active, dp_sq, dp_init)

        # go on while under max_iter and above res_thresh and, from
        # min_iter on, while the step and the residual still shrink
        keep_going = mares > cfg.res_thresh
        if cnt >= max_iter:
            keep_going = torch.zeros_like(keep_going)
        if cnt >= min_iter:
            keep_going = (keep_going & (dp_sq / dp_init >= cfg.dp_thresh)
                          & (mares / mares_prev <= cfg.dr_thresh))
        done_now = active & (outlier | ~keep_going)
        mares_prev = torch.where(active, mares, mares_prev)
        state = st._replace(diff=_where(active, diff, st.diff),
                            cost_px=_where(active, cost_px, st.cost_px),
                            converged=st.converged | done_now)
    state = state._replace(converged=torch.ones_like(state.converged))
    return (state, trips) if count_iters else state


def optimize(state: PatchState, I1_pad: torch.Tensor, grid: PatchGrid,
             cfg: DISConfig, sample_offset=None) -> PatchState:
    """Inverse search on one scale.

    As in the JAX package, ``res_thresh > 0``, a cost other than l2 and
    ``min_iter < grad_descent_iter`` take :func:`optimize_reference`.  The
    fixed-trip L2 solve takes K2 or its plain version by
    ``cfg.gn_backend`` (see :func:`..config.use_kernel`), in float32 or,
    with ``cfg.dtype="bfloat16"``, in the Pallas kernel's bf16 operand
    mode (module docstring).  ``state`` holds B frames and ``I1_pad`` is
    [B, Hp, Wp, C]: one solve for the whole batch.

    ``sample_offset`` (off_x, off_y), Python floats: ``I1_pad`` is a
    shard's strip or tile of the level and the samples are read at
    ``(mid_org + p) + sample_offset``, the tests stay global (the spatial
    forms, ``parallel/spatial_fine.py``); K2 takes it in its strip entry.
    """
    if (cfg.res_thresh > 0.0 or cfg.cost_fn != "l2"
            or (cfg.min_iter is not None
                and cfg.min_iter < cfg.grad_descent_iter)):
        return optimize_reference(state, I1_pad, grid, cfg, sample_offset)
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown dtype {cfg.dtype!r} "
                         "(expected 'float32' or 'bfloat16')")
    started = ~state.converged
    kw = dict(n_iters=cfg.grad_descent_iter, padding=grid.padding,
              thresh=cfg.outlier_thresh, l_bound=grid.l_bound,
              ub_w=grid.u_bound_w, ub_h=grid.u_bound_h,
              mean_on=1.0 if cfg.use_mean_normalization else 0.0,
              bf16=cfg.dtype == "bfloat16", offset=sample_offset)
    args = (I1_pad, state.templates, state.tgrad_x, state.tgrad_y, state.H,
            state.mid_org, state.p_cur, state.p_org, started)
    if use_kernel(cfg.gn_backend, I1_pad):
        p_cur, cost_px = dis_gn.gn_scale_loop(*args, **kw)
    else:
        p_cur, cost_px = dis_gn.gn_scale_loop_plain(*args, **kw)
    return state._replace(p_cur=p_cur, cost_px=cost_px,
                          diff=torch.zeros_like(state.diff),
                          converged=torch.ones_like(state.converged))
