"""Device times of the densify layer's kernels, G3 and G5, on one GPU.

    python flowonthego_tpu_torch/probes/densify_times.py [--root DIR]
        [--json OUT]

``--root`` is the checkout whose ``flowonthego_tpu_torch`` is imported
(default: the one holding this file), so two trees can be timed by one
script in one run on one card: run it for the parent tree and for the
change in turns (parent, change, change, parent).  It needs only the
wrappers' public calls, ``ops.cuda.densify.densify(state, grid, cfg,
merge)`` and ``ops.cuda.fb_merge.fb_merge(state, grid, cfg, h, w)``.

G3 is timed at the glue levels of ``chip_smoke.py`` (op 4's scale 0 of
1024x448 first), C = 3 and 1, one frame and four, with and without an fb
merge's accumulator, on seeded patch flows and costs.  G5 is timed on
the merges of the op-2 and op-4 fb pairs of a seeded 1024x448 (16, 8)-px
scene (the largest of each; every one of op 4's), on a pile-up of op 2's
scale 3, and split by ``torch.profiler`` into its bin launches (every
kernel whose name holds ``fb_merge_bin``) and its cell launch; beside it
``index_put_(accumulate=True)`` alone on the plain merge's contributions
at op 4's scale 0.  Times: back-to-back calls between CUDA events behind
a spin kernel (``chip_smoke.device_ms``'s method), in ms.  The last line
is one JSON object of every number, also written to ``--json``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

GLUE_LEVELS = (("op 4 scale 0", 4, 448, 1024), ("op 2 scale 3", 2, 56, 128),
               ("op 2 scale 5", 2, 14, 32), ("op 1 scale 3", 1, 56, 128),
               ("4K op 2 scale 5", 2, 68, 120), ("a 4x8 cut", 2, 4, 8),
               ("op 4 1030 wide", 4, 448, 1030))
SM_HZ = 2e9


def device_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` calls enqueued behind a
    spin kernel that outlasts their enqueue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2.0 * enqueue * reps + 5e-4) * SM_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def split_ms(fn, reps: int) -> dict:
    """Device ms a call of G5's bin launches and of its cell launch (the
    profile's first step is a warm-up: the tracer can lose the device
    events at a profile's start)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for step in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            if step == 0:
                prof.step()
    per = collections.Counter()
    for e in prof.events():
        if "fb_merge" in e.name:
            key = "bins" if "fb_merge_bin" in e.name else "cells"
            per[key] += e.time_range.elapsed_us() / 1e3 / reps
    return dict(per)


def g3_times(dev, out):
    from flowonthego_tpu_torch import operating_point
    from flowonthego_tpu_torch.ops.cuda import densify
    from flowonthego_tpu_torch.ops.dis import PatchState
    from flowonthego_tpu_torch.ops.patches import PatchGrid
    g = torch.Generator().manual_seed(30)
    for what, op, h, w in GLUE_LEVELS:
        cfg = operating_point(op)
        grid = PatchGrid.create(cfg, w, h)
        ps = grid.patch_size
        for C in (3, 1):
            for n in (1, 4):
                lead = (n, grid.n_h, grid.n_w)
                p = (torch.randn(lead + (2,), generator=g) * 3).to(dev)
                cost = (torch.rand(lead + (ps, ps, C), generator=g) ** 2
                        * 50).to(dev)
                state = PatchState(p, p, None, None, None, None, None, None,
                                   cost, None)
                merge = torch.cat([torch.rand((n, h, w, 1), generator=g),
                                   torch.randn((n, h, w, 2), generator=g)],
                                  dim=-1).to(dev)
                for m in (None, merge):
                    ms = device_ms(lambda: densify.densify(state, grid, cfg,
                                                           m), 50)
                    key = (f"G3 {what} {n}x{h}x{w}x{C}"
                           f"{' + merge' if m is not None else ''}")
                    out[key] = ms
                    print(f"{key}: {ms:.4f} ms", flush=True)


def merge_calls(fn):
    """The inputs of every G5 call in one eager run of ``fn()``."""
    from flowonthego_tpu_torch.ops.cuda import fb_merge
    from flowonthego_tpu_torch.utils import graphs
    calls, launch = [], fb_merge.fb_merge

    def recorder(state, grid, cfg, out_h, out_w):
        calls.append((state._replace(p_cur=state.p_cur.clone(),
                                     mid_org=state.mid_org.clone(),
                                     cost_px=state.cost_px.clone()),
                      grid, cfg, out_h, out_w))
        return launch(state, grid, cfg, out_h, out_w)

    fb_merge.fb_merge = recorder
    try:
        with graphs.eager():
            fn()
    finally:
        fb_merge.fb_merge = launch
    return calls


def g5_times(dev, out):
    import dataclasses
    import flowonthego_tpu_torch as port
    from flowonthego_tpu_torch.ops import densify as densify_mod
    from flowonthego_tpu_torch.ops.cuda import fb_merge
    from flowonthego_tpu_torch.ops.dis import PatchState
    from flowonthego_tpu_torch.ops.patches import PatchGrid
    from flowonthego_tpu_torch.utils.synth import synthetic_pair
    pair = [torch.as_tensor(x, device=dev)
            for x in synthetic_pair(0, 448, 1024, (16, 8))]
    for op in (2, 4):
        cfg = dataclasses.replace(port.operating_point(op, width=1024),
                                  use_fb_consistency=True)
        calls = merge_calls(lambda: port.compute_flow(*pair, cfg))
        largest = max(calls, key=lambda c: c[1].n_patches)
        for k, call in enumerate(calls):
            if op == 2 and call is not largest:
                continue
            state, grid, c, h, w = call
            fn = lambda: fb_merge.fb_merge(state, grid, c, h, w)  # noqa
            key = f"G5 op {op} fb merge {k} {h}x{w} {grid.n_patches} patches"
            out[key] = device_ms(fn, 50 if op == 2 else 20)
            out[key + " split"] = split_ms(fn, 5)
            print(f"{key}: {out[key]:.4f} ms, split "
                  f"{out[key + ' split']}", flush=True)
        if op == 4:
            state, grid, c, h, w = largest
            idx, vals = densify_mod.fb_merge_contributions(state, grid, c,
                                                           h, w)
            acc = torch.zeros((h * w + 1, 3), device=dev)
            key = f"index_put_ op 4 {h}x{w} {grid.n_patches} patches"
            out[key] = device_ms(
                lambda: acc.index_put_((idx,), vals, accumulate=True), 5)
            print(f"{key}: {out[key]:.4f} ms", flush=True)
    # a pile-up of op 2's scale 3: every patch of two frames on one cell
    g = torch.Generator().manual_seed(50)
    cfg = port.operating_point(2)
    grid = PatchGrid.create(cfg, 128, 56)
    lead = (2, grid.n_h, grid.n_w)
    mid = torch.as_tensor(np.stack(grid.midpoints(), -1),
                          dtype=torch.float32, device=dev)
    mid = mid[None].expand(lead + (2,))
    frac = torch.rand(lead + (2,), generator=g).to(dev) - 0.5
    p = torch.tensor([64.0, 20.0], device=dev) - mid + frac
    cost = (torch.rand(lead + (8, 8, 3), generator=g) ** 2 * 50).to(dev)
    st = PatchState(p, p, mid, None, None, None, None, None, cost, None)
    fn = lambda: fb_merge.fb_merge(st, grid, cfg, 56, 128)  # noqa: E731
    out["G5 pile-up op 2 2x56x128"] = device_ms(fn, 5)
    print(f"G5 pile-up op 2 2x56x128: {out['G5 pile-up op 2 2x56x128']:.4f}"
          " ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="the checkout whose flowonthego_tpu_torch is timed")
    ap.add_argument("--json", help="also write the numbers here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("densify_times: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from flowonthego_tpu_torch.models.dis_flow import pin_fp32
    from flowonthego_tpu_torch.ops.cuda import _build
    import flowonthego_tpu_torch
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{card}; package {os.path.dirname(flowonthego_tpu_torch.__file__)}",
          flush=True)
    pin_fp32()
    _build.load_library()
    dev = torch.device("cuda", 0)
    out = {"card": card, "root": os.path.abspath(args.root)}
    g3_times(dev, out)
    g5_times(dev, out)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
