"""Device times of the patch solve's kernel, K2, on one GPU, with a digest
of its outputs and, where the wrapper takes ``counts``, its window reuse.

    python flowonthego_tpu_torch/probes/gn_times.py [--root DIR]
        [--json OUT]

``--root`` is the checkout whose ``flowonthego_tpu_torch`` is imported
(default: the one holding this file), so two trees can be timed by one
script in one run on one card: run it for the parent tree and for the
change in turns (parent, change, change, parent).  It needs only
``ops.cuda.dis_gn.gn_scale_loop``.

K2 runs at ``chip_smoke.py``'s shapes: op 4's scale 1 (224x512, 12,825
patches, 128 iterations) and scale 0 (448x1024, 51,300 patches), warm
started from a seeded random coarse flow of +-2 px, at C = 3 and 1, and
float32 and bf16 operands at scale 1; op 2's 56x128 scale cold.  A row
gives the device ms a call (back-to-back calls between CUDA events behind
a spin kernel), a SHA-1 of (p, cost) that two trees must share where
their flows are bit-identical, and, where counted, the trips and window
loads of one call and the share of trips that loaded nothing.  The last
line is one JSON object of every number, also written to ``--json``.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# (what, op, height, width, start, channels, bf16, reps)
CASES = (("op 4 scale 1", 4, 224, 512, "warm", 3, False, 10),
         ("op 4 scale 1", 4, 224, 512, "warm", 1, False, 10),
         ("op 4 scale 1", 4, 224, 512, "warm", 3, True, 10),
         ("op 4 scale 0", 4, 448, 1024, "warm", 3, False, 5),
         ("op 2 scale 3", 2, 56, 128, "cold", 3, False, 50))
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


def gn_case(dev, op, h, w, start, channels, seed):
    """K2's positional and keyword arguments at one scale of ``op`` on a
    seeded pair moving (1, 1) px, cold or warm started."""
    from flowonthego_tpu_torch import operating_point
    from flowonthego_tpu_torch.ops import dis as dis_mod
    from flowonthego_tpu_torch.ops.patches import (
        PatchGrid, extract_templates_and_hessians)
    from flowonthego_tpu_torch.ops.pyramid import build_pyramid
    from flowonthego_tpu_torch.utils.synth import synthetic_frames
    cfg = operating_point(op)
    f0, f1 = synthetic_frames(1, 2, h, w, (1, 1), channels=channels,
                              factor=4)
    lvl0, lvl1 = (build_pyramid(torch.as_tensor(f, device=dev)[None], 1,
                                cfg.padding)[0] for f in (f0, f1))
    grid = PatchGrid.create(cfg, w, h)
    st = dis_mod.init_state(*extract_templates_and_hessians(
        lvl0.image, lvl0.grad_x, lvl0.grad_y, grid, cfg), grid)
    if start == "warm":
        g = torch.Generator().manual_seed(seed)
        coarse = torch.randn((1, h // 2, w // 2, 2), generator=g) * 2.0
        st = dis_mod.init_from_coarser(st, coarse.to(dev), grid)
    args = (lvl1.image, st.templates, st.tgrad_x, st.tgrad_y, st.H,
            st.mid_org, st.p_cur, st.p_org, ~st.converged)
    kw = dict(n_iters=cfg.grad_descent_iter, padding=grid.padding,
              thresh=cfg.outlier_thresh, l_bound=grid.l_bound,
              ub_w=grid.u_bound_w, ub_h=grid.u_bound_h, mean_on=1.0)
    return args, kw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="the checkout whose flowonthego_tpu_torch is timed")
    ap.add_argument("--json", help="also write the numbers here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gn_times: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    import flowonthego_tpu_torch
    from flowonthego_tpu_torch.models.dis_flow import pin_fp32
    from flowonthego_tpu_torch.ops.cuda import _build, dis_gn
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"{card}; package {os.path.dirname(flowonthego_tpu_torch.__file__)}",
          flush=True)
    pin_fp32()
    _build.load_library()
    dev = torch.device("cuda", 0)
    counted = "counts" in inspect.signature(dis_gn.gn_scale_loop).parameters
    out = {"card": card, "root": os.path.abspath(args.root)}
    for k, (what, op, h, w, start, C, bf16, reps) in enumerate(CASES):
        gargs, kw = gn_case(dev, op, h, w, start, C, seed=k)
        kw = dict(kw, bf16=bf16)
        p, cost = dis_gn.gn_scale_loop(*gargs, **kw)
        torch.cuda.synchronize()
        digest = hashlib.sha1(p.cpu().numpy().tobytes()
                              + cost.cpu().numpy().tobytes()).hexdigest()
        key = (f"K2 {what} {h}x{w}x{C} {'bf16' if bf16 else 'float32'} "
               f"{start} ({int(np.prod(gargs[8].shape))} patches)")
        row = {"ms": device_ms(lambda: dis_gn.gn_scale_loop(*gargs, **kw),
                               reps),
               "sha1": digest[:16]}
        if counted:
            counts = torch.zeros(gargs[8].shape + (2,), dtype=torch.int32,
                                 device=dev)
            dis_gn.gn_scale_loop(*gargs, **kw, counts=counts)
            trips, loads = counts.long().sum((0, 1, 2)).tolist()
            row.update(trips=trips, loads=loads,
                       reuse=100.0 * (1.0 - loads / max(trips, 1)))
        out[key] = row
        print(f"{key}: " + ", ".join(
            f"{n} {v:.4f}" if isinstance(v, float) else f"{n} {v}"
            for n, v in row.items()), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
