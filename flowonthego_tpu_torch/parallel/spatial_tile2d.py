"""2-D (rows x cols) tile-sharded DIS: the whole pipeline on a tile mesh
(port of ``flowonthego_tpu/parallel/spatial_tile2d.py``).

``spatial_fine.py``'s strips on a (rows, cols) mesh: on many devices the
strips of a 4K frame grow too shallow for their halos, while tiles keep
the halo perimeter small.  Every fine-scale stage runs on the tiles:

  * template extraction: a 2-D edge halo of ``padding`` rows and columns
    (two hops; the corners ride on the lateral neighbour's row halo);
  * target sampling: the I1 tile halo'd by the displacement bound and the
    var-ref slack on both axes; K2 samples it at a static (column, row)
    offset;
  * densification: the overlap-add into a margin'd tile canvas, folded
    into the four neighbours, rows first and then columns (the column
    fold's margins carry the folded corners);
  * variational refinement: ``varref_tiled2d.variational_refine_tile``;
  * coarse scales whose tiles cannot hold their halos run replicated
    behind a gather over both axes.

Forward-backward consistency runs tiled too.  The tiles are a row-major
list, one per mesh position (``parallel/halo.py``); the violation count
certifies the result as in ``spatial_fine.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import DISConfig, pool_backend
from ..ops import dis as dis_mod
from ..ops.patches import PatchGrid
from ..ops.pyramid import central_diff, downsample_half
from ..ops.resize import resize_matmul
from .halo import (all_gather, along, exchange_accumulate_cols,
                   exchange_accumulate_rows, per_device, total)
from .mesh import COL_AXIS, ROW_AXIS, Mesh, Sharding, make_tile_mesh
from .spatial import cut, run_sharded
from .spatial_fine import (_axis_layout, _const, _halo_slack, block_state,
                           displacement_bound, extract_block, merge_block,
                           normalize, overlap_add_block, replicated_scale,
                           warm_block, with_replicated_recovery)
from .varref_tiled2d import exchange_2d, gather_tiles, variational_refine_tile

__all__ = ["make_tile_mesh", "make_tile2d_flow",
           "make_tile2d_flow_recovering", "tiled2d_scale_levels"]

ROWS, COLS = 1, 2     # the row and column dims of [B, h, w(, C)] tiles


def tiled2d_scale_levels(cfg: DISConfig, H: int, W: int, n_r: int,
                         n_c: int) -> list:
    """The scales whose tiles cover every halo on both axes (the sampling
    halo with var-ref slack, the densification fold margin, the var-ref
    warp halo); coarser scales run replicated."""
    ps, st = cfg.patch_size, cfg.steps
    r = -(-ps // st)
    densify_margin = ps + r * st
    out = []
    for sl in range(cfg.finest_scale, cfg.coarsest_scale + 1):
        hl = (H // n_r) >> sl
        wl = (W // n_c) >> sl
        halo = (int(math.ceil(displacement_bound(cfg, sl))) + cfg.padding
                + _halo_slack(cfg))
        warp_halo = (int(math.ceil(displacement_bound(cfg, sl))) + 2
                     + _halo_slack(cfg))
        need = max(halo, densify_margin, warp_halo)
        if (min(hl, wl) >= need and (H // n_r) % (1 << sl) == 0
                and (W // n_c) % (1 << sl) == 0):
            out.append(sl)
    return out


def _fine_tiles(i0s, i1s, cfg: DISConfig, H: int, W: int, n_r: int,
                n_c: int, tiled_levels, slack: int):
    """The worker over the row-major tiles [B, hl0, wl0, C] -> (flow tiles
    [B, hl0, wl0, 2], the per-tile violation counts)."""
    hl0, wl0 = H // n_r, W // n_c
    pad = cfg.padding
    fs = cfg.finest_scale
    fb = cfg.use_fb_consistency
    backend = pool_backend(cfg)
    tiles = range(n_r * n_c)
    pos = [divmod(k, n_c) for k in tiles]
    viols = [torch.zeros((), dtype=torch.int32, device=x.device)
             for x in i0s]

    levels = {0: (i0s, i1s)}
    a, b = i0s, i1s
    for sl in range(1, cfg.coarsest_scale + 1):
        a = [downsample_half(x, backend) for x in a]
        b = [downsample_half(x, backend) for x in b]
        levels[sl] = (a, b)

    def gather_full(xs):
        xs = along(xs, n_r, n_c, 1, lambda line: all_gather(line, COLS))
        return along(xs, n_r, n_c, 0, lambda line: all_gather(line, ROWS))

    def halo2d(xs, halo, mode="edge"):
        return exchange_2d(xs, n_r, n_c, halo, halo, mode)

    flow_tile = None
    flow_bw_tile = None   # the backward chain (fb consistency)
    for sl in range(cfg.coarsest_scale, fs - 1, -1):
        w_sl, h_sl = W >> sl, H >> sl
        hl, wl = hl0 >> sl, wl0 >> sl
        grid = PatchGrid.create(cfg, w_sl, h_sl)
        s0, s1 = levels[sl]

        if sl not in tiled_levels:
            flow_tile, bw = replicated_scale(
                s0, s1, flow_tile, flow_bw_tile, grid, cfg, sl, gather_full,
                lambda f, k: f[:, pos[k][0] * hl:(pos[k][0] + 1) * hl,
                               pos[k][1] * wl:(pos[k][1] + 1) * wl])
            if bw is not None:
                flow_bw_tile = bw
            continue

        # --- a tiled scale ---
        st = grid.steps
        starts_r, counts_r, n_loc_r = _axis_layout(st, grid.offset_h,
                                                   grid.n_h, hl, n_r)
        starts_c, counts_c, n_loc_c = _axis_layout(st, grid.offset_w,
                                                   grid.n_w, wl, n_c)
        halo_t = int(math.ceil(displacement_bound(cfg, sl))) + pad + slack

        def tile_consts(k, dev):
            """Tile k's static patch layout: slot validity [1, n_loc_r,
            n_loc_c], global midpoints [1, n_loc_r, n_loc_c, 2], the global
            midpoints per axis and the first midpoint in tile
            coordinates."""
            r, c = pos[k]
            my = grid.offset_h + (starts_r[r] + np.arange(n_loc_r)) * st
            mx = grid.offset_w + (starts_c[c] + np.arange(n_loc_c)) * st
            key = (grid, n_loc_r, n_loc_c, starts_r[r], starts_c[c],
                   counts_r[r], counts_c[c])
            valid = _const(("tile_valid",) + key, dev, lambda: (
                (np.arange(n_loc_r) < counts_r[r])[:, None]
                & (np.arange(n_loc_c) < counts_c[c])[None, :])[None])
            mid = _const(("tile_mid",) + key, dev, lambda: np.stack(
                np.broadcast_arrays(mx[None, :], my[:, None]),
                -1).astype(np.float32)[None])
            return (valid, mid, my, mx,
                    grid.offset_h + starts_r[r] * st - r * hl,
                    grid.offset_w + starts_c[c] * st - c * wl)

        consts = [tile_consts(k, s0[k].device) for k in tiles]

        def reach(k, p, mask):
            """Tile k's patches whose window at displacement p reaches
            beyond the halo_t rows and columns around the tile."""
            valid, mid = consts[k][:2]
            r, c = pos[k]
            ps2 = grid.patch_size // 2
            rows = mid[..., 1] + p[..., 1]
            cols = mid[..., 0] + p[..., 0]
            reach_r, reach_c = halo_t - pad, halo_t - pad
            bad = (((rows - ps2 - 1) < r * hl - reach_r)
                   | ((rows + ps2 + 1) > (r + 1) * hl + reach_r)
                   | ((cols - ps2 - 1) < c * wl - reach_c)
                   | ((cols + ps2 + 1) > (c + 1) * wl + reach_c))
            return (bad & mask & valid).sum(dtype=torch.int32)

        def run_tile(src, tgt, warm):
            """Extract from ``src`` (2-D halo), warm-start, optimize
            against ``tgt``.  The gradients of the halo'd tile are the
            unsharded ones inside the image (its halo pixels are real) and
            zero outside it, the reference's zero border."""
            imgh = halo2d(src, pad)
            imgth = halo2d(tgt, halo_t)
            states, counted = [], []
            for k in tiles:
                valid, mid, my, mx, row0, col0 = consts[k]
                r, c = pos[k]
                dev = src[k].device
                gxh, gyh = central_diff(imgh[k])
                ok = _const(("tile_grad_ok", h_sl, w_sl, hl, wl, r, c, pad),
                            dev, lambda: (
                                ((np.arange(hl + 2 * pad) - pad + r * hl
                                  >= 0)
                                 & (np.arange(hl + 2 * pad) - pad + r * hl
                                    < h_sl))[:, None, None]
                                & ((np.arange(wl + 2 * pad) - pad + c * wl
                                    >= 0)
                                   & (np.arange(wl + 2 * pad) - pad + c * wl
                                      < w_sl))[None, :, None])[None])
                gxh = torch.where(ok, gxh, 0.0)
                gyh = torch.where(ok, gyh, 0.0)
                st_k = block_state(*extract_block(
                    imgh[k], gxh, gyh, grid, cfg, row0, col0, n_loc_r,
                    n_loc_c), mid, valid)
                if warm is not None:
                    wh, ww = warm[k].shape[ROWS], warm[k].shape[COLS]
                    iy = _const(("tile_iy", grid, n_loc_r, starts_r[r], r,
                                 hl, wh), dev,
                                lambda: np.clip(my // 2 - r * (hl // 2), 0,
                                                wh - 1))
                    ix = _const(("tile_ix", grid, n_loc_c, starts_c[c], c,
                                 wl, ww), dev,
                                lambda: np.clip(mx // 2 - c * (wl // 2), 0,
                                                ww - 1))
                    st_k = warm_block(st_k, warm[k], iy, ix, grid)
                offset = (float((halo_t - pad) - c * wl),
                          float((halo_t - pad) - r * hl))
                counted.append(reach(k, st_k.p_cur, ~st_k.converged))
                states.append(dis_mod.optimize(st_k, imgth[k], grid, cfg,
                                               sample_offset=offset))
            return states, counted

        def add(vs):
            for k in tiles:
                viols[k] = viols[k] + vs[k]

        def fold(accs, margin):
            accs = along(accs, n_r, n_c, 0, lambda line:
                         exchange_accumulate_rows(line, margin, dim=ROWS))
            return along(accs, n_r, n_c, 1, lambda line:
                         exchange_accumulate_cols(line, margin, dim=COLS))

        def merged(states):
            return fold([merge_block(
                states[k], grid, cfg, hl + 2 * halo_t, wl + 2 * halo_t,
                pos[k][0] * hl - halo_t, pos[k][1] * wl - halo_t,
                consts[k][0]) for k in tiles], halo_t)

        def densified(states, compl):
            r_ = -(-grid.patch_size // st)
            margin = grid.patch_size + r_ * st
            ps2 = grid.patch_size // 2
            accs = fold([overlap_add_block(
                states[k], grid, cfg, hl + 2 * margin, wl + 2 * margin,
                consts[k][4] - ps2 + margin, consts[k][5] - ps2 + margin,
                consts[k][0]) for k in tiles], margin)
            return [normalize(acc, None if compl is None else compl[k])
                    for k, acc in enumerate(accs)]

        state, v = run_tile(s0, s1, flow_tile)
        add(v)
        state_bw = None
        if fb:
            state_bw, v = run_tile(s1, s0, flow_bw_tile)
            add(v)

        compl = None
        if state_bw is not None:
            add([reach(k, state_bw[k].p_cur, True)
                 + reach(k, state[k].p_cur, True) for k in tiles])
            compl = merged(state_bw)
        new_flow = densified(state, compl)
        if state_bw is not None and sl > fs:
            flow_bw_tile = densified(state_bw, merged(state))
        flow_tile = new_flow

        if cfg.use_var_ref:
            warp_halo = int(math.ceil(displacement_bound(cfg, sl))) + 2 + slack
            flow_tile = variational_refine_tile(flow_tile, s0, s1, cfg, sl,
                                                n_r, n_c, h_sl, w_sl,
                                                warp_halo)
            if state_bw is not None and sl > fs:
                flow_bw_tile = variational_refine_tile(
                    flow_bw_tile, s1, s0, cfg, sl, n_r, n_c, h_sl, w_sl,
                    warp_halo)

    # the finest tile upsampled: the gathered field resized (once per
    # distinct device), each tile's part cut out
    if fs == 0:
        return flow_tile, viols
    scale = float(2 ** fs)
    small = gather_full(flow_tile)
    full = per_device([x.device for x in flow_tile],
                      lambda k: resize_matmul(small[k] * scale, H, W))
    return [full[k][:, r * hl0:(r + 1) * hl0, c * wl0:(c + 1) * wl0]
            for k, (r, c) in enumerate(pos)], viols


def make_tile2d_flow(mesh: Mesh, cfg: DISConfig, H: int, W: int,
                     with_diagnostics: bool = True,
                     halo_slack: Optional[int] = None):
    """``fn(I0, I1)`` for padded [H, W, C] frames on the (rows, cols) tiles
    of ``mesh`` (:func:`make_tile_mesh`): the fine scales whose tiles
    cover their halos run tiled, the coarser ones replicated.  Returns
    ``(flow, halo_violations)`` by default, the flow [H, W, 2] gathered on
    the mesh's first device (see ``spatial_fine.make_fine_spatial_flow``);
    ``with_diagnostics=False`` returns the flow alone.  On a one-device
    CUDA mesh a call is one CUDA graph."""
    n_r, n_c = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
    div = 2 ** cfg.coarsest_scale
    if H % (n_r * div) or W % (n_c * div):
        raise ValueError(f"{H}x{W} must divide over the {n_r}x{n_c} tile "
                         f"mesh with 2^{cfg.coarsest_scale} divisibility")
    levels = frozenset(tiled2d_scale_levels(cfg, H, W, n_r, n_c))
    slack = _halo_slack(cfg) if halo_slack is None else halo_slack
    sharding = Sharding(mesh, (ROW_AXIS, COL_AXIS))

    def run(I0, I1):
        # a tile is a strided view of the frame: each gets its own copy
        # (the pool kernel reads a dense [h, w*C] block)
        flows, viols = _fine_tiles(
            [x[None].contiguous() for x in cut(I0, sharding)],
            [x[None].contiguous() for x in cut(I1, sharding)],
            cfg, H, W, n_r, n_c, levels, slack)
        flow = gather_tiles(flows, n_r, n_c, I0.device)[0]
        return (flow, total(viols)) if with_diagnostics else flow

    def fn(I0, I1):
        return run_sharded(mesh, ("make_tile2d_flow", cfg, H, W,
                                  with_diagnostics, slack, levels),
                           run, I0, I1)

    return fn


def make_tile2d_flow_recovering(mesh: Mesh, cfg: DISConfig, H: int, W: int,
                                halo_slack: Optional[int] = None):
    """Tile-sharded flow with recovery: a count above 0 recomputes the
    frame unsharded (``spatial_fine.with_replicated_recovery``)."""
    sharded = make_tile2d_flow(mesh, cfg, H, W, with_diagnostics=True,
                               halo_slack=halo_slack)
    return with_replicated_recovery(sharded, cfg, H, W)
