"""Depth from stereo by 1-D Dense Inverse Search (port of
``flowonthego_tpu/models/stereo.py``).

The patch parameter is one horizontal disparity, the Gauss-Newton system
is scalar (H = sum gx^2), and after every update the disparity is
sign-clamped: <= 0 when matching into the right image (``cam_lr == 0``),
>= 0 into the left.  The output is a dense [H, W] disparity map.

The pyramids go through K1; the 1-D solve is the JAX package's XLA loop
(no Pallas kernel), here the G6 kernel's 1-D form on the card
(:mod:`..ops.cuda.dis_ref`) and plain PyTorch on the CPU.  On the
card ``compute_disparity`` runs the padding, ``stereo_disparity_padded``,
the upsample and the crop as one CUDA graph per (shape, ``cfg``,
``cam_lr``, device) (``utils/graphs.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import (DISConfig, operating_point, pad_to_divisible,
                      pool_backend, use_kernel)
from ..ops import dis as dis_mod
from ..ops.densify import densify
from ..ops.patches import PatchGrid, extract_templates_and_hessians
from ..ops.pyramid import build_pyramid, pad_replicate
from ..utils import graphs
from ..utils.device import resolve_device
from .dis_flow import as_image, pin_fp32, upsample_flow_to_full, \
    validate_image_pair


def _optimize_1d(state: dis_mod.PatchState, I1_pad: torch.Tensor,
                 grid: PatchGrid, cfg: DISConfig,
                 cam_lr: int) -> dis_mod.PatchState:
    """Fixed-trip 1-D inverse search with the disparity sign clamp
    (:func:`optimize_1d_plain`): the G6 kernel's 1-D form
    (:mod:`..ops.cuda.dis_ref`) where ``cfg.gn_backend`` selects the
    kernels for ``I1_pad``, the plain version otherwise."""
    if use_kernel(cfg.gn_backend, I1_pad):
        from ..ops.cuda import dis_ref
        return dis_ref.optimize_1d(dis_mod.contiguous_state(state),
                                   I1_pad.contiguous(), grid, cfg, cam_lr)
    return optimize_1d_plain(state, I1_pad, grid, cfg, cam_lr)


def optimize_1d_plain(state: dis_mod.PatchState, I1_pad: torch.Tensor,
                      grid: PatchGrid, cfg: DISConfig, cam_lr: int,
                      count_iters: bool = False):
    """Fixed-trip 1-D inverse search with the disparity sign clamp, in
    plain PyTorch: sample at the warm start, then ``grad_descent_iter``
    trips of a scalar step dpx / H00, the sign clamp, an outlier and box
    test on x (beyond it: back to ``p_org``, stop), a resample, and a stop
    where the mean residual is at most ``res_thresh``; v is 0 from the
    first trip on.  With ``count_iters`` it returns (state, trips [B, n_h,
    n_w]): the trips each patch ran."""
    # values per patch, channel-generic (gray/gradmag inputs have C = 1)
    n_vals = float(np.prod(state.templates.shape[-3:]))

    active0 = ~state.converged
    diff, cost_px, cost = dis_mod._sample_residual(state, I1_pad, grid, cfg)
    state = state._replace(
        diff=dis_mod._where(active0, diff, state.diff),
        cost_px=dis_mod._where(active0, cost_px, state.cost_px),
        converged=state.converged
        | (active0 & (cost / n_vals <= cfg.res_thresh)))
    trips = (torch.zeros(cost.shape, dtype=torch.int64, device=cost.device)
             if count_iters else None)

    for _ in range(cfg.grad_descent_iter):
        st = state
        active = ~st.converged
        if count_iters:
            trips += active
        dpx = (st.tgrad_x * st.diff).sum(dim=(-3, -2, -1))
        delta = dpx / st.H[..., 0]          # scalar Gauss-Newton step
        d_new = st.p_cur[..., 0] - delta
        d_new = (torch.clamp(d_new, max=0.0) if cam_lr == 0
                 else torch.clamp(d_new, min=0.0))
        mid_new_x = st.mid_org[..., 0] + d_new

        disp = torch.abs(mid_new_x - st.mid_org[..., 0])
        outlier = ((disp > cfg.outlier_thresh)
                   | (mid_new_x < grid.l_bound)
                   | (mid_new_x > grid.u_bound_w))
        d_new = torch.where(outlier, st.p_org[..., 0], d_new)

        p_cur = torch.stack([torch.where(active, d_new, st.p_cur[..., 0]),
                             torch.zeros_like(d_new)], dim=-1)
        st = st._replace(p_cur=p_cur)

        diff, cost_px, cost = dis_mod._sample_residual(st, I1_pad, grid, cfg)
        done = active & (outlier | (cost / n_vals <= cfg.res_thresh))
        state = st._replace(diff=dis_mod._where(active, diff, st.diff),
                            cost_px=dis_mod._where(active, cost_px,
                                                   st.cost_px),
                            converged=st.converged | done)
    state = state._replace(converged=torch.ones_like(state.converged))
    return (state, trips) if count_iters else state


def stereo_disparity_padded(I_left: torch.Tensor, I_right: torch.Tensor,
                            cfg: DISConfig, cam_lr: int = 0) -> torch.Tensor:
    """Dense disparity [H/2^fs, W/2^fs] at the finest processed scale of
    divisibility-padded images [H, W, C] (run as a batch of one).
    ``cam_lr`` 0: the reference is the left image and disparity <= 0; 1:
    mirrored."""
    pin_fp32()
    H, W = I_left.shape[0], I_left.shape[1]
    kw = dict(start_level=cfg.finest_scale, backend=pool_backend(cfg))
    pyr0 = build_pyramid(I_left[None], cfg.coarsest_scale + 1, cfg.padding,
                         **kw)
    pyr1 = build_pyramid(I_right[None], cfg.coarsest_scale + 1, cfg.padding,
                         **kw)

    flow = None
    for sl in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        grid = PatchGrid.create(cfg, W >> sl, H >> sl)
        lvl0, lvl1 = pyr0[sl], pyr1[sl]
        templates, gx, gy, Hs = extract_templates_and_hessians(
            lvl0.image, lvl0.grad_x, lvl0.grad_y, grid, cfg)
        state = dis_mod.init_state(templates, gx, gy, Hs, grid)
        if flow is not None:
            state = dis_mod.init_from_coarser(state, flow, grid)
        state = _optimize_1d(state, lvl1.image, grid, cfg, cam_lr)
        flow = densify(state, grid, cfg)
        # keep the vertical channel exactly zero between scales
        flow = torch.stack([flow[..., 0], torch.zeros_like(flow[..., 1])],
                           dim=-1)
    return flow[0, ..., 0]


def compute_disparity(I_left, I_right, cfg: Optional[DISConfig] = None,
                      op_point: int = 2, cam_lr: int = 0,
                      device=None) -> torch.Tensor:
    """End-to-end dense disparity [H, W] at input resolution, on
    ``device`` (``None``: where tensor inputs lie, the GPU for numpy
    inputs; without a GPU that raises, so pass ``device="cpu"``).
    Without a ``cfg``, operating point ``op_point`` without variational
    refinement."""
    validate_image_pair(I_left, I_right, what="stereo image")
    device = resolve_device(device, I_left, I_right)
    I_left = as_image(I_left, device)
    I_right = as_image(I_right, device)
    h, w = I_left.shape[0], I_left.shape[1]
    if cfg is None:
        cfg = dataclasses.replace(operating_point(op_point, width=w),
                                  use_var_ref=False)
    pads = pad_to_divisible(w, h, cfg.coarsest_scale)
    pt, _, pl, _ = pads

    def fn(a, b):
        I0p = pad_replicate(a, pads)
        I1p = pad_replicate(b, pads)
        disp = stereo_disparity_padded(I0p, I1p, cfg, cam_lr)
        disp2 = torch.stack([disp, torch.zeros_like(disp)], dim=-1)
        full = upsample_flow_to_full(disp2, cfg, I0p.shape[0], I0p.shape[1])
        return full[pt:pt + h, pl:pl + w, 0]

    return graphs.run("compute_disparity", fn, (I_left, I_right),
                      static=(cfg, cam_lr))
