"""Row-sharded DIS with halo exchange: the fine scales computed in place
(port of ``flowonthego_tpu/parallel/spatial_fine.py``).

``parallel/spatial.py`` replicates every DIS scale after one gather; here
the patch machinery of the fine scales runs sharded over 'space', with
the halo accounting of the JAX package:

  * template extraction needs ps/2 rows beyond the strip: an edge halo;
  * target sampling needs the patch displacement bound (the outlier reset
    caps |p| at ps/2 at the scale it runs, and a warm start doubles the
    coarser bound: B(sl) = ps/2 * 2^(coarsest - sl)) plus interpolation
    rows: an I1 halo, and K2 samples the halo'd strip at a static offset
    (``ops/dis.optimize(..., sample_offset)``, K2's strip entry);
  * densification writes up to ps/2 rows across the boundary: margin rows
    folded into the neighbour (``halo.exchange_accumulate_rows``).

A scale is sharded where its strip is tall enough for those halos;
coarser scales fall back to the replicated path behind one gather (K2-K5
as in the unsharded pipeline, computed once per distinct device).
Variational refinement of a sharded scale runs sharded with a halo
exchange before every half-sweep (``varref_sharded.py``).
Forward-backward consistency, the robust costs and ``res_thresh > 0`` run
sharded too: the backward grid takes the same halos and its reversed-flow
merge is a strip scatter folded into the neighbours.

The worker is a function over the list of shards (``parallel/halo.py``);
a shard's index is a Python int, so its strip start, first patch row,
sample offset and violation window are static.  An on-device count of the
patches whose sampling or fb scatter would reach beyond the provisioned
halo certifies the result: 0 means the sharded flow is the unsharded one
up to float association.  The recovering form reads it on the host,
outside any capture, and recomputes an uncertified frame unsharded.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DISConfig, pool_backend
from ..models.dis_flow import as_image, flow_full_padded
from ..ops import densify as densify_mod
from ..ops import dis as dis_mod
from ..ops import variational as var_mod
from ..ops.patches import PatchGrid, extract_templates_and_hessians
from ..ops.pyramid import central_diff, downsample_half, pad_replicate, \
    pyramid_level
from ..ops.resize import resize_rows_strip
from ..utils.device import device_constant
from .halo import (all_gather, exchange_accumulate_rows, exchange_rows,
                   per_device, send, total)
from .mesh import SPACE_AXIS, Mesh, Sharding
from .spatial import cut, run_sharded
from .varref_sharded import variational_refine_sharded

ROWS = 1              # the row dim of [B, h, w(, C)] shards


def displacement_bound(cfg: DISConfig, sl: int) -> float:
    """Largest |p| at scale sl from the DIS machinery alone: the outlier
    reset caps surviving |p| at ps/2, and a warm start doubles the coarser
    bound.  Variational refinement adds an increment that is not bounded
    in theory; :func:`_halo_slack` budgets for it."""
    return cfg.outlier_thresh * (2.0 ** (cfg.coarsest_scale - sl))


def _halo_slack(cfg: DISConfig) -> int:
    """Halo rows beyond the DIS displacement bound: with var-ref the warm
    start is 2x a refined flow, whose SOR increment stays well under a
    patch in practice; 2*ps rows of slack.  Sampling beyond the halo
    reads its clamped edge (and the violation count says so)."""
    return 2 * cfg.patch_size if cfg.use_var_ref else 0


def _axis_layout(steps: int, offset: int, n_patches: int, extent: int,
                 n_shards: int):
    """Per-shard patch layout along one axis: (start index of each shard's
    first patch, patch count of each shard, the uniform slot count).  Slot
    k of shard i is global patch (start[i] + k); slots past a shard's
    count are invalid."""
    starts, counts = [], []
    for i in range(n_shards):
        lo, hi = i * extent, (i + 1) * extent
        j0 = max(0, math.ceil((lo - offset) / steps))
        j1 = min(n_patches, math.ceil((hi - offset) / steps))
        starts.append(j0)
        counts.append(max(0, j1 - j0))
    return starts, counts, max(counts)


def sharded_scale_levels(cfg: DISConfig, H: int, n_space: int,
                         min_rows_factor: float = 1.0) -> list:
    """The scales that run sharded: a strip must cover the target-sampling
    halo (var-ref slack included) and the densification fold margin (ps +
    r*steps); coarser scales run replicated."""
    ps, st = cfg.patch_size, cfg.steps
    r = -(-ps // st)
    densify_margin = ps + r * st
    out = []
    for sl in range(cfg.finest_scale, cfg.coarsest_scale + 1):
        hl_sl = (H // n_space) >> sl
        halo = (int(math.ceil(displacement_bound(cfg, sl))) + cfg.padding
                + _halo_slack(cfg))
        if hl_sl >= max(halo, densify_margin) * min_rows_factor and \
                (H // n_space) % (1 << sl) == 0:
            out.append(sl)
    return out


# ------------------------------------------------------- shared machinery

def dynamic_start(start: int, size: int, extent: int) -> int:
    """``lax.dynamic_slice``'s start rule: clamped so the slice fits."""
    return min(max(start, 0), extent - size)


def extract_block(img_halo, gx_halo, gy_halo, grid: PatchGrid,
                  cfg: DISConfig, row0: int, col0: int, n_rows: int,
                  n_cols: int):
    """Templates, gradients and Hessians of an n_rows x n_cols block of
    patches from halo'd [B, h + 2*pad, w + 2*pad, C] levels; (row0, col0):
    the block's first midpoint in the shard's unpadded coordinates.  The
    windows are :func:`..ops.patches.extract_windows`'s on a grid whose
    first midpoint is that one (the region's start clamped as
    ``lax.dynamic_slice`` clamps it)."""
    ps, st, pad = grid.patch_size, grid.steps, cfg.padding
    top = dynamic_start(row0 + pad - ps // 2, (n_rows - 1) * st + ps,
                        img_halo.shape[1])
    left = dynamic_start(col0 + pad - ps // 2, (n_cols - 1) * st + ps,
                         img_halo.shape[2])
    block = dataclasses.replace(grid, n_h=n_rows, n_w=n_cols, padding=pad,
                                offset_h=top - pad + ps // 2,
                                offset_w=left - pad + ps // 2)
    return extract_templates_and_hessians(img_halo, gx_halo, gy_halo, block,
                                          cfg)


def block_state(templates, gx, gy, Hs, mid_org, valid) -> dis_mod.PatchState:
    """A block's fresh patch state: zero flow, invalid slots converged.
    ``mid_org`` [1, n_h, n_w, 2] and ``valid`` (broadcasting to [1, n_h,
    n_w]) are the block's constants."""
    B = templates.shape[0]
    shape = (B,) + tuple(mid_org.shape[1:3])
    zeros2 = torch.zeros(shape + (2,), dtype=templates.dtype,
                         device=templates.device)
    return dis_mod.PatchState(
        p_cur=zeros2, p_org=zeros2, mid_org=mid_org.expand(*shape, 2),
        H=Hs, templates=templates, tgrad_x=gx, tgrad_y=gy,
        converged=(~valid).expand(*shape),
        cost_px=torch.zeros_like(templates), diff=torch.zeros_like(templates))


def warm_block(state: dis_mod.PatchState, warm: torch.Tensor, iy, ix,
               grid: PatchGrid) -> dis_mod.PatchState:
    """Warm start from the shard's coarser flow [B, hc, wc, 2] at the
    local (iy, ix) lookups (x2, nearest); a warm-started midpoint outside
    the box freezes its patch."""
    p = warm[:, iy][:, :, ix] * 2.0
    mid = state.mid_org + p
    oob = ((mid[..., 0] < grid.l_bound) | (mid[..., 1] < grid.l_bound)
           | (mid[..., 0] > grid.u_bound_w) | (mid[..., 1] > grid.u_bound_h))
    return state._replace(p_cur=p, p_org=p, converged=state.converged | oob)


def overlap_add_block(state: dis_mod.PatchState, grid: PatchGrid,
                      cfg: DISConfig, rows: int, cols: int, top: int,
                      left: int, valid) -> torch.Tensor:
    """The block's (weight, weight*u, weight*v) overlap-add canvas placed
    in a zero accumulator [B, rows, cols, 3] with its (0, 0) at (top,
    left) (a ``lax.dynamic_update_slice`` into an accumulator as large as
    the canvas needs, then cropped)."""
    ps, st = grid.patch_size, grid.steps
    absw = densify_mod._pixel_weights(state, cfg)
    absw = torch.where(valid[..., None, None], absw, 0.0)
    u = state.p_cur[..., 0][..., None, None]
    v = state.p_cur[..., 1][..., None, None]
    contrib = torch.stack([absw, absw * u, absw * v], dim=-1)
    canvas = densify_mod.overlap_add_canvas(contrib, ps, st)
    Yp, Xp = canvas.shape[1], canvas.shape[2]
    top = dynamic_start(top, Yp, rows + Yp)
    left = dynamic_start(left, Xp, cols + Xp)
    acc = F.pad(canvas, (0, 0, left, cols - left, top, rows - top))
    return acc[:, :rows, :cols]


def normalize(acc: torch.Tensor, compl_acc=None) -> torch.Tensor:
    """(weight, weight*u, weight*v) -> the flow where the weight is
    positive, 0 elsewhere; ``compl_acc`` (the fb merge) added first."""
    if compl_acc is not None:
        acc = acc + compl_acc
    weight = acc[..., 0:1]
    return torch.where(weight > 0, acc[..., 1:3] / weight, 0.0)


def merge_block(state: dis_mod.PatchState, grid: PatchGrid, cfg: DISConfig,
                rows: int, cols: int, row_base: int, col_base: int,
                valid) -> torch.Tensor:
    """The fb merge of a block (``densify._fb_merge_scatter``'s strip and
    tile form): each valid complementary patch scatters its NEGATED flow,
    spread bilinearly over the 4 cells of its optimized position (global
    coordinates), into an accumulator [B, rows, cols, 3] whose (0, 0) is
    global (row_base, col_base); the reference's validity box is global,
    and a cell outside the accumulator is dropped.  (JAX's strip form
    wraps a cell one row above its accumulator to the accumulator's end;
    only a patch that the violation count reports can reach it.)  Corners
    outer, patches in grid order within a corner, frame after frame, as
    ``densify._fb_merge_scatter``."""
    ps = grid.patch_size
    B = state.p_cur.shape[0]
    pos = state.mid_org + state.p_cur
    px, py = pos[..., 0], pos[..., 1]
    cx = torch.ceil(px + 1e-5).to(torch.int64)
    cy = torch.ceil(py + 1e-5).to(torch.int64)
    fx, fy = torch.floor(px), torch.floor(py)
    rx = (px - fx)[..., None, None]
    ry = (py - fy)[..., None, None]
    wbil = [rx * ry, (1 - rx) * ry, rx * (1 - ry), (1 - rx) * (1 - ry)]
    corner_off = [(0, 0), (1, 0), (0, 1), (1, 1)]

    absw = densify_mod._pixel_weights(state, cfg)
    absw = torch.where(valid[..., None, None], absw, 0.0)
    u = state.p_cur[..., 0][..., None, None]
    v = state.p_cur[..., 1][..., None, None]
    base = torch.stack([absw, -u * absw, -v * absw], dim=-1)

    lb = -ps // 2
    ar = torch.arange(lb, lb + ps, device=pos.device)
    xt = cx[..., None, None] + ar[None, :]
    yt = cy[..., None, None] + ar[:, None]
    ok = ((xt >= 1) & (yt >= 1) & (xt < grid.width - 1)
          & (yt < grid.height - 1))
    n = rows * cols
    idx, vals = [], []
    for (ox, oy), wb in zip(corner_off, wbil):
        yc, xc = yt - oy - row_base, xt - ox - col_base
        okc = ok & (yc >= 0) & (yc < rows) & (xc >= 0) & (xc < cols)
        idx.append(torch.where(okc, yc * cols + xc, -1).reshape(B, -1))
        vals.append(torch.where(okc[..., None], wb[..., None] * base, 0.0)
                    .reshape(B, -1, 3))
    idx = torch.stack(idx, dim=1)                       # [B, 4, values]
    frame = (torch.arange(B, device=pos.device) * n)[:, None, None]
    idx = torch.where(idx >= 0, idx + frame, B * n).reshape(-1)
    vals = torch.stack(vals, dim=1).reshape(-1, 3)
    acc = torch.zeros((B * n + 1, 3), dtype=base.dtype, device=base.device)
    acc = densify_mod.scatter_add(acc, idx, vals)
    return acc[:B * n].reshape(B, rows, cols, 3)


def replicated_scale(s0, s1, warm, warm_bw, grid: PatchGrid, cfg: DISConfig,
                     sl: int, gather: Callable, crop: Callable):
    """A scale too coarse to shard: gather the shards' levels (and warm
    starts), run the unsharded scale (the level by G1, extraction by G2,
    K2, densify by G3, var-ref by K5, G4 and K3/K4) once per distinct
    device, and crop each shard's part.
    Returns the shards' (flow, backward flow or None)."""
    pad = cfg.padding
    fb = cfg.use_fb_consistency
    a_full, b_full = gather(s0), gather(s1)
    warm = None if warm is None else gather(warm)
    warm_bw = None if warm_bw is None else gather(warm_bw)

    def dis_full(src, tgt, init):
        st = dis_mod.init_state(*extract_templates_and_hessians(
            *pyramid_level(src.contiguous(), pad, backend=pool_backend(cfg)),
            grid, cfg), grid)
        if init is not None:
            st = dis_mod.init_from_coarser(st, init, grid)
        return dis_mod.optimize(st, pad_replicate(tgt, pad), grid, cfg)

    def scale(i):
        state = dis_full(a_full[i], b_full[i], None if warm is None
                         else warm[i])
        state_bw = (dis_full(b_full[i], a_full[i], None if warm_bw is None
                             else warm_bw[i]) if fb else None)
        flow = densify_mod.densify(state, grid, cfg, compl_state=state_bw)
        bw = None
        if state_bw is not None and sl > cfg.finest_scale:
            bw = densify_mod.densify(state_bw, grid, cfg, compl_state=state)
        if cfg.use_var_ref:
            flow = var_mod.variational_refine_auto(flow, a_full[i], b_full[i],
                                                   cfg, sl)
            if bw is not None:
                bw = var_mod.variational_refine_auto(bw, b_full[i],
                                                     a_full[i], cfg, sl)
        return flow, bw

    done = per_device([x.device for x in s0], scale)
    flows = [crop(f, i) for i, (f, _) in enumerate(done)]
    bws = (None if done[0][1] is None
           else [crop(b, i) for i, (_, b) in enumerate(done)])
    return flows, bws


def _const(key, device, build) -> torch.Tensor:
    return device_constant(("spatial",) + key, device, build)


# ------------------------------------------------------------ the strips

def _fine_strips(i0s: List[torch.Tensor], i1s: List[torch.Tensor],
                 cfg: DISConfig, H: int, W: int, sharded_levels,
                 slack: int):
    """The worker over the 'space' shards: frame strips [B, hl0, W, C] ->
    (flow strips [B, hl0, W, 2], the per-shard violation counts)."""
    n = len(i0s)
    hl0 = H // n
    pad = cfg.padding
    fs = cfg.finest_scale
    fb = cfg.use_fb_consistency
    backend = pool_backend(cfg)
    shards = range(n)
    viols = [torch.zeros((), dtype=torch.int32, device=x.device)
             for x in i0s]

    # local pyramid strips (a 2x2 pool needs no halo)
    strips = {0: (i0s, i1s)}
    a, b = i0s, i1s
    for sl in range(1, cfg.coarsest_scale + 1):
        a = [downsample_half(x, backend) for x in a]
        b = [downsample_half(x, backend) for x in b]
        strips[sl] = (a, b)

    def halo_padded(xs, halo):
        """Rows from the neighbours (edge at the image border), columns
        edge-padded by ``pad``: [B, hl + 2*halo, W + 2*pad, C]."""
        return [pad_replicate(x, (0, 0, pad, pad))
                for x in exchange_rows(xs, halo, "edge", dim=ROWS)]

    def grads_halo(rows_halo, i, hl_sl):
        """Gradients of a row-halo'd strip with the reference's zero
        border: rows outside the image and the column pads are zero."""
        gx, gy = central_diff(rows_halo)
        if i == 0:
            gx[:, :pad] = 0.0
            gy[:, :pad] = 0.0
        if i == n - 1:
            gx[:, pad + hl_sl:] = 0.0
            gy[:, pad + hl_sl:] = 0.0
        return (F.pad(gx, (0, 0, pad, pad)), F.pad(gy, (0, 0, pad, pad)))

    flow_strip = None     # [B, hl_sl, W_sl, 2] at the previous scale
    flow_bw_strip = None  # the backward chain (fb consistency)
    for sl in range(cfg.coarsest_scale, fs - 1, -1):
        w_sl, h_sl = W >> sl, H >> sl
        hl_sl = hl0 >> sl
        grid = PatchGrid.create(cfg, w_sl, h_sl)
        s0, s1 = strips[sl]

        if sl not in sharded_levels:
            flow_strip, bw = replicated_scale(
                s0, s1, flow_strip, flow_bw_strip, grid, cfg, sl,
                lambda xs: all_gather(xs, dim=ROWS),
                lambda f, i: f[:, i * hl_sl:(i + 1) * hl_sl])
            if bw is not None:
                flow_bw_strip = bw
            continue

        # --- a sharded scale ---
        starts, counts, n_loc = _axis_layout(grid.steps, grid.offset_h,
                                             grid.n_h, hl_sl, n)
        halo_t = int(math.ceil(displacement_bound(cfg, sl))) + pad + slack
        mx = (np.arange(grid.n_w) * grid.steps + grid.offset_w)

        def strip_consts(i, dev):
            """Shard i's static patch layout: slot validity [1, n_loc, 1],
            global midpoints [1, n_loc, n_w, 2], its first patch row."""
            my = grid.offset_h + (starts[i] + np.arange(n_loc)) * grid.steps
            key = (grid, n_loc, starts[i], counts[i])
            valid = _const(("valid",) + key, dev, lambda: (
                np.arange(n_loc) < counts[i])[None, :, None])
            mid = _const(("mid",) + key, dev, lambda: np.stack(
                np.broadcast_arrays(mx[None, :], my[:, None]),
                -1).astype(np.float32)[None])
            return valid, mid, my, grid.offset_h + starts[i] * grid.steps \
                - i * hl_sl

        consts = [strip_consts(i, s0[i].device) for i in shards]

        def reach(i, p, mask):
            """Shard i's patches whose rows at displacement p reach beyond
            the halo_t rows around the strip (where sampling clamps and a
            scatter drops: a silent divergence from the unsharded
            pipeline)."""
            valid, mid = consts[i][:2]
            rows = mid[..., 1] + p[..., 1]
            lo = i * hl_sl - (halo_t - pad)
            hi = (i + 1) * hl_sl + (halo_t - pad)
            bad = (((rows - grid.patch_size // 2 - 1) < lo)
                   | ((rows + grid.patch_size // 2 + 1) > hi)) & mask & valid
            return bad.sum(dtype=torch.int32)

        def run_strip(src, tgt, warm):
            """Extract from ``src``, warm-start, optimize against ``tgt``;
            returns the shards' states and violation counts."""
            imgh = halo_padded(src, pad)
            rows_halo = exchange_rows(src, pad, "edge", dim=ROWS)
            imgth = halo_padded(tgt, halo_t)
            states, counted = [], []
            for i in shards:
                valid, mid, my, row0 = consts[i]
                dev = src[i].device
                gxh, gyh = grads_halo(rows_halo[i], i, hl_sl)
                st = block_state(*extract_block(
                    imgh[i], gxh, gyh, grid, cfg, row0, grid.offset_w,
                    n_loc, grid.n_w), mid, valid)
                if warm is not None:
                    wh = warm[i].shape[ROWS]
                    iy = _const(("iy", grid, n_loc, starts[i], i, hl_sl,
                                 wh), dev,
                                lambda: np.clip(my // 2 - i * (hl_sl // 2),
                                                0, wh - 1))
                    ix = _const(("ix", grid, warm[i].shape[2]), dev,
                                lambda: np.clip(mx // 2, 0,
                                                warm[i].shape[2] - 1))
                    st = warm_block(st, warm[i], iy, ix, grid)
                # local row 0 of the target strip is global padded row
                # i*hl_sl - (halo_t - pad): the samples' offset
                offset = (0.0, float((halo_t - pad) - i * hl_sl))
                # an accepted GN step stays within outlier_thresh of the
                # grid row; only the warm start can outrun the halo
                counted.append(reach(i, st.p_cur, ~st.converged))
                states.append(dis_mod.optimize(st, imgth[i], grid, cfg,
                                               sample_offset=offset))
            return states, counted

        def add(vs):
            for i in shards:
                viols[i] = viols[i] + vs[i]

        state, v = run_strip(s0, s1, flow_strip)
        add(v)
        state_bw = None
        if fb:
            state_bw, v = run_strip(s1, s0, flow_bw_strip)
            add(v)

        def merged(st):
            """The strips' fb-merge accumulators of the states ``st``."""
            accs = [merge_block(st[i], grid, cfg, hl_sl + 2 * halo_t, w_sl,
                                i * hl_sl - halo_t, 0, consts[i][0])
                    for i in shards]
            return exchange_accumulate_rows(accs, halo_t, dim=ROWS)

        def densified(st, compl):
            """The strips' flows of the states ``st`` (overlap-add, the
            margins folded into the neighbours)."""
            r = -(-grid.patch_size // grid.steps)
            margin = grid.patch_size + r * grid.steps
            ps2 = grid.patch_size // 2
            accs = [overlap_add_block(
                st[i], grid, cfg, hl_sl + 2 * margin, w_sl + 2 * margin,
                consts[i][3] - ps2 + margin,
                margin + grid.offset_w - ps2, consts[i][0]) for i in shards]
            accs = exchange_accumulate_rows(accs, margin, dim=ROWS)
            return [normalize(acc[:, :, margin:margin + w_sl],
                              None if compl is None else compl[i])
                    for i, acc in enumerate(accs)]

        compl = None
        if state_bw is not None:
            # the fb scatter lands at mid_org + p_cur of every valid patch,
            # converged or not: its reach is counted too
            add([reach(i, state_bw[i].p_cur, True)
                 + reach(i, state[i].p_cur, True) for i in shards])
            compl = merged(state_bw)
        new_flow = densified(state, compl)
        if state_bw is not None and sl > fs:
            flow_bw_strip = densified(state_bw, merged(state))
        flow_strip = new_flow

        if cfg.use_var_ref:
            warp_halo = int(math.ceil(displacement_bound(cfg, sl))) + 2 + slack
            flow_strip = variational_refine_sharded(flow_strip, s0, s1, cfg,
                                                    sl, h_sl, warp_halo)
            if state_bw is not None and sl > fs:
                flow_bw_strip = variational_refine_sharded(
                    flow_bw_strip, s1, s0, cfg, sl, h_sl, warp_halo)

    # the strips' rows of the full-resolution upsample
    if fs == 0:
        return flow_strip, viols
    scale = float(2 ** fs)
    small = all_gather(flow_strip, dim=ROWS)
    return [resize_rows_strip(small[i] * scale, scale, scale, i * hl0, hl0,
                              W) for i in shards], viols


def make_fine_spatial_flow(mesh: Mesh, cfg: DISConfig, H: int, W: int,
                           with_diagnostics: bool = True,
                           halo_slack: Optional[int] = None):
    """``fn(I0, I1)`` for padded [H, W, C] frames, rows sharded over the
    'space' devices of the mesh's first data row, the fine scales computed
    in place under halo exchange.

    Returns ``(flow, halo_violations)`` by default: the full-resolution
    flow [H, W, 2] on the mesh's first device and the int32 count of
    patches whose target sampling or fb scatter would have reached beyond
    the provisioned halo (0 certifies the sharded result: the unsharded
    pipeline's up to float association).  ``with_diagnostics=False``
    returns the flow alone.  ``halo_slack`` replaces :func:`_halo_slack`'s
    rows.  On a one-device CUDA mesh a call is one CUDA graph."""
    n_space = mesh.shape[SPACE_AXIS]
    if H % (n_space * (2 ** cfg.coarsest_scale)) != 0:
        raise ValueError("H must divide over shards with 2^cs divisibility")
    levels = frozenset(sharded_scale_levels(cfg, H, n_space))
    slack = _halo_slack(cfg) if halo_slack is None else halo_slack
    rows = Sharding(mesh, (SPACE_AXIS,))

    def run(I0, I1):
        flows, viols = _fine_strips([x[None] for x in cut(I0, rows)],
                                    [x[None] for x in cut(I1, rows)], cfg,
                                    H, W, levels, slack)
        flow = torch.cat([send(f, I0.device) for f in flows], dim=ROWS)[0]
        return (flow, total(viols)) if with_diagnostics else flow

    def fn(I0, I1):
        return run_sharded(mesh, ("make_fine_spatial_flow", cfg, H, W,
                                  with_diagnostics, slack, levels),
                           run, I0, I1)

    return fn


def make_fine_spatial_flow_recovering(mesh: Mesh, cfg: DISConfig, H: int,
                                      W: int,
                                      halo_slack: Optional[int] = None):
    """Row-sharded flow with recovery: ``fn(I0, I1) -> (flow,
    halo_violations)``.  A count of 0 returns the sharded flow; above 0
    (a warm start outran the halo and sampling clamped) the frame is
    recomputed unsharded (:func:`with_replicated_recovery`), so the call
    never returns clamped flow.  The count is returned either way."""
    sharded = make_fine_spatial_flow(mesh, cfg, H, W, with_diagnostics=True,
                                     halo_slack=halo_slack)
    return with_replicated_recovery(sharded, cfg, H, W)


def with_replicated_recovery(sharded_fn, cfg: DISConfig, H: int, W: int):
    """Wrap a ``(flow, count)`` sharded flow function: where the count is
    above 0 the flow is ``flow_full_padded`` of the frames on the device
    the flow lies on.  The count is read on the host after the sharded
    call (outside its capture), as the JAX package reads it outside
    ``jit``."""
    def fn(I0, I1):
        flow, viol = sharded_fn(I0, I1)
        if int(viol) > 0:
            flow = flow_full_padded(as_image(I0, flow.device),
                                    as_image(I1, flow.device), cfg)
        return flow, viol

    return fn
