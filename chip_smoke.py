#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``flowonthego_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the five CUDA kernels from ``flowonthego_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the op-2, op-3 and op-4 paths give it, with CUDA-event times
     for both; K3 against K4 on fields both can take, and both timed on
     the field sizes of the op-3 path (the var-ref resolver's threshold);
  4. the main paths at real size, each with the launch counters reset
     just before it and read just after: op 2 (``compute_flow`` on a
     seeded 1024x436 pair moving (16, 8) px, ``stream_flow`` over four
     3840x2160 frames), op 4 (``compute_flow`` on that pair, and on one
     moving (2, 2) px, which stays inside the outlier radius at every
     scale so every patch iterates), op 3 (``stream_flow`` over four
     1024x436 frames) and op 1 (``compute_flow`` on the first pair); then
     the same inputs through the plain path on the card, the op-2 and
     op-3 1024x448 finest-scale flows against the JAX goldens in
     ``tests/data`` (the GPU run needs no JAX), and one
     ``compute_flow_timed`` op-4 call with its TIME lines.
It prints one JSON line of per-kernel results and, last, the device line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = {op: os.path.join(REPO, "tests", "data",
                           f"torch_port_golden_op{op}_1024x448.npz")
          for op in (2, 3)}

# Kernel-vs-plain tolerances (the CPU tests' bounds against JAX).
TOL_POOL = dict(rtol=1e-6, atol=1e-4)
TOL_GN_P = dict(rtol=1e-4, atol=1e-4)
TOL_GN_COST = dict(rtol=1e-3, atol=1e-3)
TOL_VARREF = dict(rtol=1e-4, atol=1e-5)
# K5 computes the plain warp's operations in its order: bit-exact.
# K2 at op 4 runs 128 iterations, over which an ulp of a reduction can
# flip a patch's outlier reset and send it elsewhere; at most this share
# of patches may fall outside TOL_GN_P / TOL_GN_COST there.
GN_FLIP_SHARE = 0.01
# Whole-flow band: mean / 99th-percentile endpoint difference (px).
BAND_MEAN, BAND_P99 = 1e-3, 1e-2
SHIFT_TOL = 0.1   # median flow inside the image vs the known motion (px)
# The streams: (height, width, texture factor, motion per frame, frames).
# The motion is a multiple of 2^finest_scale (32 at 4K op 2, 2 at
# 1024-wide op 3), so every processed pyramid level moves by whole pixels.
STREAM_4K = (2160, 3840, 64, (32, 32), 4)
STREAM_OP3 = (436, 1024, 16, (12, -6), 4)
# A second op-4 pair whose motion stays inside the 6-px outlier radius at
# scales 1 and 0, so K2 runs all 128 iterations on the two largest grids.
SMALL_SHIFT = (2, 2)
# K3 vs K4 on the op-3 fields at 1024x448 (h, w, level) and two sizes
# between the first two, where the two kernels cross.
SWEEP = ((14, 32, 5), (28, 32, 4), (28, 48, 4), (28, 64, 4), (56, 128, 3),
         (112, 256, 2), (224, 512, 1))


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean wall time of ``fn`` over ``reps`` calls, ending in a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def share_off(got, ref, rtol, atol) -> float:
    """Share of patches (the two leading dims) with any value outside
    ``atol + rtol * |ref|``."""
    bad = (got - ref).abs() > atol + rtol * ref.abs()
    return float(bad.reshape(bad.shape[0], bad.shape[1], -1).any(-1)
                 .float().mean())


def flow_band(got, ref, what):
    epe = torch.linalg.vector_norm(got.double() - ref.double(), dim=-1)
    mean, p99 = float(epe.mean()), float(torch.quantile(epe.flatten()[::7],
                                                        0.99))
    log(f"  {what}: mean EPE {mean:.3g} px, p99 {p99:.3g} px "
        f"(band {BAND_MEAN:g} / {BAND_P99:g})")
    assert mean <= BAND_MEAN and p99 <= BAND_P99, what


def check_shift(flow, shift, border, what):
    inner = flow[border:-border, border:-border].reshape(-1, 2)
    med = inner.median(dim=0).values.cpu().numpy()
    log(f"  {what}: median flow {med.tolist()} vs shift {list(shift)}")
    assert np.abs(med - np.asarray(shift)).max() <= SHIFT_TOL, what


# ------------------------------------------------------------------ kernels

def kernel_phase(dev):
    from flowonthego_tpu_torch import operating_point
    from flowonthego_tpu_torch.ops import dis as dis_mod
    from flowonthego_tpu_torch.ops.cuda import (dis_gn, pool, varref_fused,
                                                varref_tiled, warp)
    from flowonthego_tpu_torch.ops.patches import (
        PatchGrid, extract_templates_and_hessians)
    from flowonthego_tpu_torch.ops.pyramid import build_pyramid
    from flowonthego_tpu_torch.utils.synth import synthetic_frames

    g = torch.Generator().manual_seed(0)
    results = {}

    # K1 at the 4K level-0 flat shape (f32; uint8 + bias) and a small one
    errs = []
    for shape, C, dtype, bias, timed in [
            ((2176, 11520), 3, torch.float32, None, True),
            ((2176, 11520), 3, torch.uint8, 1.5, False),
            ((34, 366), 3, torch.float32, None, False),
            ((40, 122), 1, torch.float32, 0.25, False)]:
        x = (torch.rand(shape, generator=g) * 255).to(dtype).to(dev)
        got = pool.pool2x2_flat(x, C, bias)
        ref = pool.pool2x2_flat_plain(x, C, bias)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, **TOL_POOL)
        errs.append(max_err(got, ref))
        line = f"K1 pool {shape} {dtype} bias={bias}: max_abs_err {errs[-1]:.3g}"
        if timed:
            ms = cuda_ms(lambda: pool.pool2x2_flat(x, C, bias), 50)
            plain_ms = cuda_ms(lambda: pool.pool2x2_flat_plain(x, C, bias), 20)
            results["pool"] = dict(ms=ms, plain_ms=plain_ms)
            line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        log(line)
    results["pool"]["max_abs_err"] = max(errs)

    # K2 at the op-2 scales with 448 (1024x448, scale 3) and 510 (4K,
    # scale 5) patches, cold and warm; at op 4's scale 1 of 1024x448
    # (ps 12, 128 iterations, 12,825 patches), warm
    errs = []
    for op, h, w, names in ((2, 56, 128, ("cold", "warm")),
                            (2, 68, 120, ("cold", "warm")),
                            (4, 224, 512, ("warm",))):
        cfg = operating_point(op)
        i0, i1 = synthetic_frames(1, 2, h, w, (1, 1), factor=4)
        lvl0 = build_pyramid(torch.as_tensor(i0, device=dev), 1, cfg.padding)[0]
        lvl1 = build_pyramid(torch.as_tensor(i1, device=dev), 1, cfg.padding)[0]
        grid = PatchGrid.create(cfg, w, h)
        cold = dis_mod.init_state(*extract_templates_and_hessians(
            lvl0.image, lvl0.grad_x, lvl0.grad_y, grid, cfg), grid)
        coarse = (torch.randn((h // 2, w // 2, 2), generator=g) * 2.0).to(dev)
        states = {"cold": cold,
                  "warm": dis_mod.init_from_coarser(cold, coarse, grid)}
        for name in names:
            st = states[name]
            args = (lvl1.image, st.templates, st.tgrad_x, st.tgrad_y, st.H,
                    st.mid_org, st.p_cur, st.p_org, ~st.converged)
            kw = dict(n_iters=cfg.grad_descent_iter, padding=grid.padding,
                      thresh=cfg.outlier_thresh, l_bound=grid.l_bound,
                      ub_w=grid.u_bound_w, ub_h=grid.u_bound_h, mean_on=1.0)
            p, cost = dis_gn.gn_scale_loop(*args, **kw)
            rp, rcost = dis_gn.gn_scale_loop_plain(*args, **kw)
            torch.cuda.synchronize()
            line = (f"K2 gn op {op} {h}x{w} ({grid.n_patches} patches, "
                    f"{cfg.grad_descent_iter} iterations, {name}): "
                    f"p max_abs_err {max_err(p, rp):.3g}, cost max_abs_err "
                    f"{max_err(cost, rcost):.3g}")
            if op == 2:
                torch.testing.assert_close(p, rp, **TOL_GN_P)
                torch.testing.assert_close(cost, rcost, **TOL_GN_COST)
                errs.append(max_err(p, rp))
            else:
                off_p = share_off(p, rp, **TOL_GN_P)
                off_c = share_off(cost, rcost, **TOL_GN_COST)
                line += (f"; patches outside tolerance: p {off_p:.3g}, "
                         f"cost {off_c:.3g} (bound {GN_FLIP_SHARE:g})")
                assert off_p <= GN_FLIP_SHARE and off_c <= GN_FLIP_SHARE, line
            if (op, h, name) == (2, 68, "cold"):
                ms = cuda_ms(lambda: dis_gn.gn_scale_loop(*args, **kw), 50)
                plain_ms = cuda_ms(
                    lambda: dis_gn.gn_scale_loop_plain(*args, **kw), 10)
                results["gn"] = dict(ms=ms, plain_ms=plain_ms)
                line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            if op == 4:
                ms = cuda_ms(lambda: dis_gn.gn_scale_loop(*args, **kw), 10)
                plain_ms = cuda_ms(
                    lambda: dis_gn.gn_scale_loop_plain(*args, **kw), 1, 1)
                line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            log(line)
    results["gn"]["max_abs_err"] = max(errs)

    def varref_planes(cfg, h, w, seed=2):
        i0, i1 = synthetic_frames(seed, 2, h, w, (1, 0), factor=4)
        flow = ((torch.randn((h, w, 2), generator=g) * 0.3
                 + torch.tensor([1.0, 0.0])).to(dev))
        return varref_fused.warp_and_derivs(
            flow, torch.as_tensor(i0, device=dev),
            torch.as_tensor(i1, device=dev), cfg)

    # K3 on the fields it gets on the main paths: the coarsest of 1024x448
    # (14x32, level 5; ops 2-4) and of the 4K stream (17x30, level 7)
    cfg = operating_point(2)
    errs = []
    for h, w, level in ((14, 32, 5), (17, 30, 7)):
        P = varref_planes(cfg, h, w)
        uu, vv = varref_fused.refine_inner(*P, cfg, level + 1)
        ru, rv = varref_fused.refine_inner_plain(*P, cfg, level + 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(uu, ru, **TOL_VARREF)
        torch.testing.assert_close(vv, rv, **TOL_VARREF)
        errs.append(max(max_err(uu, ru), max_err(vv, rv)))
        line = f"K3 varref {h}x{w} level {level}: max_abs_err {errs[-1]:.3g}"
        if level == 5:
            ms = cuda_ms(lambda: varref_fused.refine_inner(
                *P, cfg, level + 1), 20)
            plain_ms = cuda_ms(lambda: varref_fused.refine_inner_plain(
                *P, cfg, level + 1), 5)
            results["varref"] = dict(ms=ms, plain_ms=plain_ms)
            line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        log(line)
    results["varref"]["max_abs_err"] = max(errs)

    # K4 at op-3/op-4 scale 1 and op-4 scale 0 of 1024x448 against the
    # plain loop, and against K3 (the same loop) on the op-2 4K level-5
    # field and the op-3 scale-2 field
    cfg = operating_point(3)
    errs = []
    for h, w, level in ((224, 512, 1), (448, 1024, 0)):
        P = varref_planes(cfg, h, w)
        uu, vv = varref_tiled.refine_inner_tiled(*P, cfg, level + 1)
        ru, rv = varref_tiled.refine_inner_plain(*P, cfg, level + 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(uu, ru, **TOL_VARREF)
        torch.testing.assert_close(vv, rv, **TOL_VARREF)
        errs.append(max(max_err(uu, ru), max_err(vv, rv)))
        line = f"K4 varref {h}x{w} level {level}: max_abs_err {errs[-1]:.3g}"
        if level == 0:
            ms = cuda_ms(lambda: varref_tiled.refine_inner_tiled(
                *P, cfg, level + 1), 20)
            plain_ms = cuda_ms(lambda: varref_tiled.refine_inner_plain(
                *P, cfg, level + 1), 3)
            results["varref_tiled"] = dict(ms=ms, plain_ms=plain_ms)
            line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        log(line)
    results["varref_tiled"]["max_abs_err"] = max(errs)
    for h, w, level in ((68, 120, 5), (112, 256, 2)):
        P = varref_planes(cfg, h, w)
        u4, v4 = varref_tiled.refine_inner_tiled(*P, cfg, level + 1)
        u3, v3 = varref_fused.refine_inner(*P, cfg, level + 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(u4, u3, **TOL_VARREF)
        torch.testing.assert_close(v4, v3, **TOL_VARREF)
        log(f"K4 vs K3 {h}x{w} level {level}: max_abs_err "
            f"{max(max_err(u4, u3), max_err(v4, v3)):.3g}")

    log("K3 vs K4 on the op-3 path's field sizes (the resolver's threshold):")
    for h, w, level in SWEEP:
        P = varref_planes(cfg, h, w, seed=3)
        k3 = cuda_ms(lambda: varref_fused.refine_inner(*P, cfg, level + 1), 20)
        k4 = cuda_ms(lambda: varref_tiled.refine_inner_tiled(
            *P, cfg, level + 1), 20)
        log(f"  {h}x{w} ({h * w} px) level {level}: K3 {k3:.4f} ms, "
            f"K4 {k4:.4f} ms")

    # K5 at op-4 scale 0 of 1024x448 (timed) and a ragged field; flows of
    # +-(outlier_thresh + 2) px, so border clamps fire
    bound = cfg.outlier_thresh + 2.0
    for h, w, timed in ((448, 1024, True), (37, 61, False)):
        src = (torch.rand((h, w, 3), generator=g) * 255).to(dev)
        wx, wy = (((torch.rand((h, w), generator=g) * 2 - 1) * bound).to(dev)
                  for _ in range(2))
        got, gm = warp.warp_image(src, wx, wy)
        ref, rm = warp.warp_image_plain(src, wx, wy)
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and torch.equal(gm, rm), "K5 not exact"
        line = f"K5 warp {h}x{w}x3 |flow| <= {bound:g}: bit-exact"
        if timed:
            ms = cuda_ms(lambda: warp.warp_image(src, wx, wy), 50)
            plain_ms = cuda_ms(lambda: warp.warp_image_plain(src, wx, wy), 20)
            results["warp"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=0.0)
            line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        log(line)
    return results


# ------------------------------------------------------------------ slice

def slice_phase(dev):
    import flowonthego_tpu_torch as port
    from flowonthego_tpu_torch.config import pad_to_divisible
    from flowonthego_tpu_torch.models.dis_flow import dis_flow_padded
    from flowonthego_tpu_torch.ops.cuda import (dis_gn, pool, varref_fused,
                                                varref_tiled, warp)
    from flowonthego_tpu_torch.ops.pyramid import pad_replicate
    from flowonthego_tpu_torch.utils.synth import (synthetic_frames,
                                                   synthetic_pair)
    wrappers = {"pool": pool, "gn": dis_gn, "varref": varref_fused,
                "varref_tiled": varref_tiled, "warp": warp}

    def plain(cfg):
        return dataclasses.replace(cfg, gn_backend="xla", varref_backend="xla")

    def counted(name, fn, expect):
        """Run one path with the counters from zero; check that every
        kernel in ``expect`` launched; return (result, counts)."""
        for m in wrappers.values():
            m.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {k: m.launches for k, m in wrappers.items()}
        log(f"{name} launches: {counts}")
        assert all(counts[k] > 0 for k in expect), (name, counts)
        return out, counts

    def padded_frames(stream, cfg, seed):
        h, w, factor, shift, n = stream
        pads = pad_to_divisible(w, h, cfg.coarsest_scale)
        return [pad_replicate(torch.as_tensor(f, device=dev), pads)
                for f in synthetic_frames(seed, n, h, w, shift, factor=factor)]

    def run_stream(frames, cfg):
        return list(port.stream_flow(frames, cfg, fetch=False))

    def timed_stream(frames, cfg):
        run_stream(frames, cfg)                           # first run
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flows = run_stream(frames, cfg)
        torch.cuda.synchronize()
        return flows, (time.perf_counter() - t0) * 1e3 / len(flows)

    def timed_pair(cfg, reps, pair):
        flow = port.compute_flow(*pair, cfg)              # first call
        return flow, host_ms(lambda: port.compute_flow(*pair, cfg), reps)

    # inputs: the goldens' 1024x436 pair, four 4K frames and four 1024x436
    # frames (edge-padded)
    golden = {op: np.load(path) for op, path in GOLDEN.items()}
    seed = int(golden[2]["seed"])
    shift = tuple(int(s) for s in golden[2]["shift"])
    for g in golden.values():
        assert int(g["seed"]) == seed and tuple(g["shift"]) == shift
    i0, i1 = (torch.as_tensor(x, device=dev)
              for x in synthetic_pair(seed, 436, 1024, shift))
    small = tuple(torch.as_tensor(x, device=dev)
                  for x in synthetic_pair(seed, 436, 1024, SMALL_SHIFT))
    cfg = {op: port.operating_point(op, width=1024) for op in (1, 2, 3, 4)}
    pads = pad_to_divisible(1024, 436, cfg[2].coarsest_scale)
    i0p, i1p = pad_replicate(i0, pads), pad_replicate(i1, pads)
    cfg_4k = port.operating_point(2, width=STREAM_4K[1])
    frames_4k = padded_frames(STREAM_4K, cfg_4k, 7)
    frames_op3 = padded_frames(STREAM_OP3, cfg[3], 5)
    log(f"slice inputs: 1024x436 pairs shift {shift} and {SMALL_SHIFT} "
        f"(padded {tuple(i0p.shape)}); {len(frames_4k)} frames "
        f"{tuple(frames_4k[0].shape)} shift {STREAM_4K[3]}; "
        f"{len(frames_op3)} frames {tuple(frames_op3[0].shape)} shift "
        f"{STREAM_OP3[3]}; cs/fs of op 1-4 at 1024: "
        f"{[(c.coarsest_scale, c.finest_scale) for c in cfg.values()]}, "
        f"of op 2 at 4K: ({cfg_4k.coarsest_scale}, {cfg_4k.finest_scale})")

    # ---- the main paths through the kernels, counters from zero each ----
    (pair2, ms2), n_pair2 = counted(
        "op 2 compute_flow 1024x436 x21",
        lambda: timed_pair(cfg[2], 20, (i0, i1)),
        ("pool", "gn", "varref", "warp"))
    (flows_4k, ms_4k), n_4k = counted(
        "op 2 stream_flow 4K, twice", lambda: timed_stream(frames_4k, cfg_4k),
        ("pool", "gn", "varref_tiled", "warp"))
    (pair4, ms4), n_pair4 = counted(
        "op 4 compute_flow 1024x436 x6",
        lambda: timed_pair(cfg[4], 5, (i0, i1)),
        ("pool", "gn", "varref", "varref_tiled", "warp"))
    (pair4s, ms4s), n_pair4s = counted(
        f"op 4 compute_flow 1024x436 shift {SMALL_SHIFT} x6",
        lambda: timed_pair(cfg[4], 5, small),
        ("pool", "gn", "varref", "varref_tiled", "warp"))
    (flows_op3, ms_op3), n_op3 = counted(
        "op 3 stream_flow 1024x448, twice",
        lambda: timed_stream(frames_op3, cfg[3]),
        ("pool", "gn", "varref_tiled", "warp"))
    (pair1, ms1), n_pair1 = counted(
        "op 1 compute_flow 1024x436 x11",
        lambda: timed_pair(cfg[1], 10, (i0, i1)),
        ("pool", "gn"))
    assert not any(n_pair1[k] for k in ("varref", "varref_tiled", "warp"))
    launches = {k: sum(n[k] for n in (n_pair2, n_4k, n_pair4, n_pair4s,
                                      n_op3, n_pair1))
                for k in wrappers}

    # ---- checks: finite, known motion, plain path, JAX goldens ----
    for op, pair, motion, flow, ms, reps in (
            (2, (i0, i1), shift, pair2, ms2, 5),
            (4, (i0, i1), shift, pair4, ms4, 1),
            (4, small, SMALL_SHIFT, pair4s, ms4s, 1),
            (1, (i0, i1), shift, pair1, ms1, 5)):
        what = f"op {op} pair {motion}"
        assert flow.shape == (436, 1024, 2) and torch.isfinite(flow).all()
        log(f"compute_flow {what} 1024x436: {ms:.3f} ms/pair (kernels, "
            "device-resident pair, host clock to sync)")
        check_shift(flow, motion, 16, f"{what} vs known shift")
        ref, ms_plain = timed_pair(plain(cfg[op]), reps, pair)
        log(f"compute_flow {what} 1024x436 plain path: {ms_plain:.3f} "
            "ms/pair")
        flow_band(flow, ref, f"{what} kernels vs plain path")
    for op in (2, 3):
        fin = dis_flow_padded(i0p, i1p, cfg[op])
        flow_band(fin, torch.as_tensor(golden[op]["flow"], device=dev),
                  f"op {op} 1024x448 finest flow vs JAX golden")

    for what, frames, cfg_s, flows, ms, motion, border in (
            ("op 2 4K", frames_4k, cfg_4k, flows_4k, ms_4k, STREAM_4K[3], 64),
            ("op 3 1024x448", frames_op3, cfg[3], flows_op3, ms_op3,
             STREAM_OP3[3], 32)):
        log(f"stream_flow {what} {tuple(frames[0].shape)}, {len(flows)} "
            f"pairs: {ms:.3f} ms/frame (kernels, device-resident frames, "
            "fetch=False)")
        refs, ms_plain = timed_stream(frames, plain(cfg_s))
        log(f"stream_flow {what} plain path: {ms_plain:.3f} ms/frame")
        for k, (fk, fp) in enumerate(zip(flows, refs)):
            assert fk.shape == frames[0].shape[:2] + (2,)
            assert torch.isfinite(fk).all()
            check_shift(fk, motion, border, f"{what} pair {k} vs known shift")
            flow_band(fk, fp, f"{what} pair {k} kernels vs plain path")

    log("compute_flow_timed op 4 1024x436:")
    timed = port.compute_flow_timed(i0, i1, cfg[4],
                                    printer=lambda s: log("  " + s))
    flow_band(timed, pair4, "compute_flow_timed vs compute_flow")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from flowonthego_tpu_torch.models.dis_flow import pin_fp32
    from flowonthego_tpu_torch.ops.cuda import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    pin_fp32()

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(lib_path, REPO)}")

    kernels = kernel_phase(dev)
    launches = slice_phase(dev)

    src = "flowonthego_tpu_torch/csrc/"
    pallas = "flowonthego_tpu/ops/pallas/"
    meta = {
        "pool": ("pool2x2_flat", "pool.cu", "pool.py:204"),
        "gn": ("gn_scale_loop", "dis_gn.cu", "dis_gn.py:310"),
        "varref": ("variational_refine_fused", "varref_fused.cu",
                   "varref_fused.py:250"),
        "varref_tiled": ("variational_refine_tiled", "varref_tiled.cu",
                         "varref_fused.py:327"),
        "warp": ("warp_image_banded", "warp.cu", "warp.py:121"),
    }
    rows = []
    for key, (name, source, replaces) in meta.items():
        r = kernels[key]
        rows.append({"name": name, "route": "cuda", "source": src + source,
                     "replaces": pallas + replaces,
                     "launches": launches[key],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
