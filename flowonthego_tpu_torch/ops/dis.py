"""Dense Inverse Search patch optimizer (port of
``flowonthego_tpu/ops/dis.py``: state, warm start and the L2 fixed-trip
solve).

The whole patch grid steps in lockstep: ``grad_descent_iter``
projection+resample trips with a per-patch active mask.  A patch whose
step leaves the outlier radius or the midpoint box resets to ``p_org``
(the coarser-scale init) and freezes.  The solve itself is
:func:`.cuda.dis_gn.gn_scale_loop`: the K2 kernel on the card, the JAX
package's reduction form in plain PyTorch otherwise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DISConfig, use_kernel
from .cuda import dis_gn
from .patches import PatchGrid


class PatchState(NamedTuple):
    """Struct-of-arrays patch state, shaped [n_h, n_w] (+ trailing dims)."""
    p_cur: torch.Tensor       # [n_h, n_w, 2] current flow (u, v)
    p_org: torch.Tensor       # [n_h, n_w, 2] init flow (outlier reset target)
    mid_org: torch.Tensor     # [n_h, n_w, 2] grid midpoint (x, y)
    H: torch.Tensor           # [n_h, n_w, 3] Hessian (H00, H01, H11)
    templates: torch.Tensor   # [n_h, n_w, ps, ps, C] mean-normalized template
    tgrad_x: torch.Tensor     # [n_h, n_w, ps, ps, C] template d/dx
    tgrad_y: torch.Tensor     # [n_h, n_w, ps, ps, C] template d/dy
    converged: torch.Tensor   # [n_h, n_w] bool
    cost_px: torch.Tensor     # [n_h, n_w, ps, ps, C] final per-pixel sq. residual
    diff: torch.Tensor        # [n_h, n_w, ps, ps, C] residual (not kept: zeros)


def init_state(templates, tgrad_x, tgrad_y, H, grid: PatchGrid) -> PatchState:
    """Fresh per-scale state: zero flow, nothing converged."""
    mx, my = grid.midpoints()
    dev, dt = templates.device, templates.dtype
    mid_org = torch.stack([torch.as_tensor(mx, device=dev),
                           torch.as_tensor(my, device=dev)], dim=-1).to(dt)
    zeros2 = torch.zeros((grid.n_h, grid.n_w, 2), dtype=dt, device=dev)
    return PatchState(
        p_cur=zeros2,
        p_org=zeros2,
        mid_org=mid_org,
        H=H,
        templates=templates,
        tgrad_x=tgrad_x,
        tgrad_y=tgrad_y,
        converged=torch.zeros((grid.n_h, grid.n_w), dtype=torch.bool,
                              device=dev),
        cost_px=torch.zeros_like(templates),
        diff=torch.zeros_like(templates),
    )


def init_from_coarser(state: PatchState, coarse_flow: torch.Tensor,
                      grid: PatchGrid) -> PatchState:
    """Warm start from the coarser scale's dense flow: nearest lookup at
    floor(midpoint / 2), flow x2 (deliberately not bilinear).  Patches
    whose warm-started midpoint leaves the valid box are frozen at once
    (converged, cost 0).

    The lookup clamps to the coarse field, as JAX's gather does: a warm
    start at 1/2^(cs+1) of a height like 2176 (8 rows, from 8.5) is one
    row short of floor(midpoint / 2) for the last grid row.
    """
    mx, my = grid.midpoints()
    dev = coarse_flow.device
    ch, cw = coarse_flow.shape[0], coarse_flow.shape[1]
    ix = torch.as_tensor(np.minimum(mx.astype(int) // 2, cw - 1), device=dev)
    iy = torch.as_tensor(np.minimum(my.astype(int) // 2, ch - 1), device=dev)
    p = coarse_flow[iy, ix, :] * 2.0           # [n_h, n_w, 2]

    mid = state.mid_org + p
    oob = ((mid[..., 0] < grid.l_bound) | (mid[..., 1] < grid.l_bound)
           | (mid[..., 0] > grid.u_bound_w) | (mid[..., 1] > grid.u_bound_h))
    return state._replace(p_cur=p, p_org=p, converged=oob)


def optimize(state: PatchState, I1_pad: torch.Tensor, grid: PatchGrid,
             cfg: DISConfig) -> PatchState:
    """Fixed-trip L2 inverse search on one scale.

    ``cfg.gn_backend`` picks the K2 kernel or the plain version (see
    :func:`..config.use_kernel`).  Only the fixed-trip L2 form is ported:
    l1/huber costs, ``min_iter`` early exits and ``res_thresh > 0`` need
    the JAX package's ``optimize_reference``, which is not ported yet.
    """
    if (cfg.res_thresh > 0.0 or cfg.cost_fn != "l2"
            or (cfg.min_iter is not None
                and cfg.min_iter < cfg.grad_descent_iter)):
        raise NotImplementedError(
            "only the fixed-trip L2 solve is ported (cost_fn='l2', "
            "res_thresh=0, min_iter unset)")
    if cfg.dtype != "float32":
        raise NotImplementedError("only dtype='float32' is ported")
    started = ~state.converged
    kw = dict(n_iters=cfg.grad_descent_iter, padding=grid.padding,
              thresh=cfg.outlier_thresh, l_bound=grid.l_bound,
              ub_w=grid.u_bound_w, ub_h=grid.u_bound_h,
              mean_on=1.0 if cfg.use_mean_normalization else 0.0)
    args = (I1_pad, state.templates, state.tgrad_x, state.tgrad_y, state.H,
            state.mid_org, state.p_cur, state.p_org, started)
    if use_kernel(cfg.gn_backend, I1_pad):
        p_cur, cost_px = dis_gn.gn_scale_loop(*args, **kw)
    else:
        p_cur, cost_px = dis_gn.gn_scale_loop_plain(*args, **kw)
    return state._replace(p_cur=p_cur, cost_px=cost_px,
                          diff=torch.zeros_like(state.diff),
                          converged=torch.ones_like(state.converged))
