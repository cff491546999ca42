#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``flowonthego_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the three CUDA kernels from ``flowonthego_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the op-2 path, with CUDA-event times for both;
  4. the op-2 main path at real size, launch counters reset just before:
     ``compute_flow`` on a seeded 1024x436 pair and ``stream_flow`` over
     six 3840x2160 frames (edge-padded to 3840x2176), both with a known
     integer motion; then the same inputs through the plain path on the
     card, and the 1024x448 finest-scale flow against the JAX golden in
     ``tests/data`` (the GPU run needs no JAX).
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
GOLDEN = os.path.join(REPO, "tests", "data",
                      "torch_port_golden_op2_1024x448.npz")

# Kernel-vs-plain tolerances (the CPU tests' bounds against JAX).
TOL_POOL = dict(rtol=1e-6, atol=1e-4)
TOL_GN_P = dict(rtol=1e-4, atol=1e-4)
TOL_GN_COST = dict(rtol=1e-3, atol=1e-3)
TOL_VARREF = dict(rtol=1e-4, atol=1e-5)
# Whole-flow band: mean / 99th-percentile endpoint difference (px).
BAND_MEAN, BAND_P99 = 1e-3, 1e-2
SHIFT_TOL = 0.1   # median flow inside the image vs the known motion (px)
# The stream: (height, width, texture factor, motion per frame).  The
# motion is a multiple of 2^finest_scale (32 at 4K), so every processed
# pyramid level moves by whole pixels.
STREAM = (2160, 3840, 64, (32, 32))


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
    from flowonthego_tpu_torch.ops.cuda import dis_gn, pool, varref_fused
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
    # scale 5) patches, cold and warm
    cfg = operating_point(2)
    errs = []
    for h, w in ((56, 128), (68, 120)):
        i0, i1 = synthetic_frames(1, 2, h, w, (1, 1), factor=4)
        lvl0 = build_pyramid(torch.as_tensor(i0, device=dev), 1, cfg.padding)[0]
        lvl1 = build_pyramid(torch.as_tensor(i1, device=dev), 1, cfg.padding)[0]
        grid = PatchGrid.create(cfg, w, h)
        cold = dis_mod.init_state(*extract_templates_and_hessians(
            lvl0.image, lvl0.grad_x, lvl0.grad_y, grid, cfg), grid)
        coarse = (torch.randn((h // 2, w // 2, 2), generator=g) * 2.0).to(dev)
        warm_state = dis_mod.init_from_coarser(cold, coarse, grid)
        for name, st in (("cold", cold), ("warm", warm_state)):
            args = (lvl1.image, st.templates, st.tgrad_x, st.tgrad_y, st.H,
                    st.mid_org, st.p_cur, st.p_org, ~st.converged)
            kw = dict(n_iters=cfg.grad_descent_iter, padding=grid.padding,
                      thresh=cfg.outlier_thresh, l_bound=grid.l_bound,
                      ub_w=grid.u_bound_w, ub_h=grid.u_bound_h, mean_on=1.0)
            p, cost = dis_gn.gn_scale_loop(*args, **kw)
            rp, rcost = dis_gn.gn_scale_loop_plain(*args, **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(p, rp, **TOL_GN_P)
            torch.testing.assert_close(cost, rcost, **TOL_GN_COST)
            errs.append(max_err(p, rp))
            line = (f"K2 gn {h}x{w} ({grid.n_patches} patches, {name}): "
                    f"p max_abs_err {errs[-1]:.3g}, cost max_abs_err "
                    f"{max_err(cost, rcost):.3g}")
            if (h, w, name) == (68, 120, "cold"):
                ms = cuda_ms(lambda: dis_gn.gn_scale_loop(*args, **kw), 50)
                plain_ms = cuda_ms(
                    lambda: dis_gn.gn_scale_loop_plain(*args, **kw), 10)
                results["gn"] = dict(ms=ms, plain_ms=plain_ms)
                line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            log(line)
    results["gn"]["max_abs_err"] = max(errs)

    # K3 at 56x128 level 3 and 68x120 level 5
    errs = []
    for h, w, level in ((56, 128, 3), (68, 120, 5)):
        i0, i1 = synthetic_frames(2, 2, h, w, (1, 0), factor=4)
        flow = ((torch.randn((h, w, 2), generator=g) * 0.3
                 + torch.tensor([1.0, 0.0])).to(dev))
        wx, wy, mask, dIs = varref_fused.warp_and_derivs(
            flow, torch.as_tensor(i0, device=dev),
            torch.as_tensor(i1, device=dev))
        uu, vv = varref_fused.refine_inner(wx, wy, mask, dIs, cfg, level + 1)
        ru, rv = varref_fused.refine_inner_plain(wx, wy, mask, dIs, cfg,
                                                 level + 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(uu, ru, **TOL_VARREF)
        torch.testing.assert_close(vv, rv, **TOL_VARREF)
        errs.append(max(max_err(uu, ru), max_err(vv, rv)))
        line = f"K3 varref {h}x{w} level {level}: max_abs_err {errs[-1]:.3g}"
        if level == 5:
            ms = cuda_ms(lambda: varref_fused.refine_inner(
                wx, wy, mask, dIs, cfg, level + 1), 20)
            plain_ms = cuda_ms(lambda: varref_fused.refine_inner_plain(
                wx, wy, mask, dIs, cfg, level + 1), 5)
            results["varref"] = dict(ms=ms, plain_ms=plain_ms)
            line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        log(line)
    results["varref"]["max_abs_err"] = max(errs)
    return results


# ------------------------------------------------------------------ slice

def slice_phase(dev):
    import flowonthego_tpu_torch as port
    from flowonthego_tpu_torch.config import pad_to_divisible
    from flowonthego_tpu_torch.models.dis_flow import dis_flow_padded
    from flowonthego_tpu_torch.ops.cuda import dis_gn, pool, varref_fused
    from flowonthego_tpu_torch.ops.pyramid import pad_replicate
    from flowonthego_tpu_torch.utils.synth import (synthetic_frames,
                                                   synthetic_pair)
    wrappers = {"pool": pool, "gn": dis_gn, "varref": varref_fused}

    def plain(cfg):
        return dataclasses.replace(cfg, gn_backend="xla", varref_backend="xla")

    # inputs: the golden's 1024x436 pair, six 4K frames (edge-padded)
    golden = np.load(GOLDEN)
    seed = int(golden["seed"])
    shift = tuple(int(s) for s in golden["shift"])
    i0, i1 = (torch.as_tensor(x, device=dev)
              for x in synthetic_pair(seed, 436, 1024, shift))
    cfg_pair = port.operating_point(2, width=1024)
    pads = pad_to_divisible(1024, 436, cfg_pair.coarsest_scale)
    i0p, i1p = pad_replicate(i0, pads), pad_replicate(i1, pads)

    sh, sw, factor, shift4k = STREAM
    cfg_4k = port.operating_point(2, width=sw)
    pads4k = pad_to_divisible(sw, sh, cfg_4k.coarsest_scale)
    frames = [pad_replicate(torch.as_tensor(f, device=dev), pads4k)
              for f in synthetic_frames(7, 6, sh, sw, shift4k, factor=factor)]
    log(f"slice inputs: 1024x436 pair shift {shift} (padded "
        f"{tuple(i0p.shape)}), 6 frames {tuple(frames[0].shape)} "
        f"shift {shift4k}, op 2 cs/fs {cfg_pair.coarsest_scale}/"
        f"{cfg_pair.finest_scale} and {cfg_4k.coarsest_scale}/"
        f"{cfg_4k.finest_scale}")

    def stream(cfg):
        return list(port.stream_flow(frames, cfg, fetch=False))

    # ---- the main path through the kernels, counters from zero ----
    for m in wrappers.values():
        m.launches = 0
    pair_k = port.compute_flow(i0, i1, cfg_pair)          # first call
    ms_pair = host_ms(lambda: port.compute_flow(i0, i1, cfg_pair), 20)
    after_pair = {k: m.launches for k, m in wrappers.items()}
    fin_k = dis_flow_padded(i0p, i1p, cfg_pair)
    stream(cfg_4k)                                        # first run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flows_k = stream(cfg_4k)
    torch.cuda.synchronize()
    ms_frame = (time.perf_counter() - t0) * 1e3 / len(flows_k)
    launches = {k: m.launches for k, m in wrappers.items()}
    log(f"main path launches: compute_flow x21 {after_pair}, "
        f"total with stream_flow {launches}")
    assert all(n > 0 for n in after_pair.values()), after_pair
    assert all(launches[k] > after_pair[k] for k in launches), launches

    # ---- checks: finite, known motion, plain path, JAX golden ----
    log(f"compute_flow op 2 1024x436: {ms_pair:.3f} ms/pair (kernels, "
        "device-resident pair, host clock to sync)")
    assert pair_k.shape == (436, 1024, 2) and torch.isfinite(pair_k).all()
    check_shift(pair_k, shift, 16, "pair vs known shift")
    pair_p = port.compute_flow(i0, i1, plain(cfg_pair))
    ms_pair_plain = host_ms(
        lambda: port.compute_flow(i0, i1, plain(cfg_pair)), 5)
    log(f"compute_flow op 2 1024x436 plain path: {ms_pair_plain:.3f} ms/pair")
    flow_band(pair_k, pair_p, "pair kernels vs plain path")
    flow_band(fin_k, torch.as_tensor(golden["flow"], device=dev),
              "1024x448 finest flow vs JAX golden")

    log(f"stream_flow op 2 {tuple(frames[0].shape)}, {len(flows_k)} pairs: "
        f"{ms_frame:.3f} "
        "ms/frame (kernels, device-resident frames, fetch=False)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    flows_p = stream(plain(cfg_4k))
    torch.cuda.synchronize()
    ms_frame_plain = (time.perf_counter() - t0) * 1e3 / len(flows_p)
    log(f"stream_flow op 2 plain path: {ms_frame_plain:.3f} ms/frame")
    for k, (fk, fp) in enumerate(zip(flows_k, flows_p)):
        assert fk.shape == frames[0].shape[:2] + (2,)
        assert torch.isfinite(fk).all()
        check_shift(fk, shift4k, 64, f"stream pair {k} vs known shift")
        flow_band(fk, fp, f"stream pair {k} kernels vs plain path")
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
    meta = {
        "pool": ("pool2x2_flat", src + "pool.cu",
                 "flowonthego_tpu/ops/pallas/pool.py:204"),
        "gn": ("gn_scale_loop", src + "dis_gn.cu",
               "flowonthego_tpu/ops/pallas/dis_gn.py:310"),
        "varref": ("variational_refine_fused", src + "varref_fused.cu",
                   "flowonthego_tpu/ops/pallas/varref_fused.py:250"),
    }
    rows = []
    for key, (name, source, replaces) in meta.items():
        r = kernels[key]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[key],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
