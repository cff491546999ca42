"""Device times of G6, the reference-form solve, and its 1-D form, on one
GPU.

    python flowonthego_tpu_torch/probes/ref_times.py [--root DIR]
        [--save OUT.npz] [--compare IN.npz] [--json OUT]
        [--phases [--phase-source FILE]]

``--root`` is the checkout whose ``flowonthego_tpu_torch`` is imported
(default: the one holding this file), so two trees can be timed by one
script in one run on one card: run it for the parent tree and for the
change in turns (parent, change, change, parent).  It needs only the
wrapper's public calls, ``ops.cuda.dis_ref.optimize_reference(state,
I1, grid, cfg)`` and ``optimize_1d(state, I1, grid, cfg, cam_lr)``.

The shapes (``SHAPES``): op 2's scale 3 of 1024x448 (56x128, 448 patches
a frame) under huber and l1, C = 3 and 1, one frame and four; op 4's
scales 1 (224x512, 12,825 patches) and 0 (448x1024, 51,300) under huber;
the 1-D form at op 2's scale 3 (l2, cam_lr 0, C = 3 and a batch of four
at C = 1).  Every input is made on the CPU from a seed with the plain
pyramid and extraction (``chip_smoke.solve_inputs``' scene: a pair moving
(1, 1) px, the warm start a random coarser flow), then copied to the
card, so both trees solve the same bits.  Times: back-to-back calls
between CUDA events behind a spin kernel (``chip_smoke.device_ms``'s
method), in ms.

``--save`` writes every shape's outputs (p, diff, cost_px) to an
``.npz``; ``--compare`` reads one and says, shape by shape, whether this
tree's outputs are bit-identical to it, else how far they lie and on
what share of the patches.

``--phases`` also builds ``probes/ref_phases.cu`` around the tree's
``csrc/dis_ref.cu`` (or ``--phase-source``: a copy of a kernel source
with the same ``REF_PHASE`` hooks) and prints the ``clock64`` split of a
trip into its phases at op 2's scale 3 (huber, and the 1-D form) and op
4's scale 1 (huber): cycles a trip, summed over the patches' warps, and
each phase's share.  The last line is one JSON object of every number,
also written to ``--json``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SM_HZ = 2e9
# name -> (op, level h, level w, cost, C, frames, 1-D, reps)
SHAPES = {
    "op 2 scale 3 huber C3 B1": (2, 56, 128, "huber", 3, 1, False, 50),
    "op 2 scale 3 huber C1 B1": (2, 56, 128, "huber", 1, 1, False, 50),
    "op 2 scale 3 huber C3 B4": (2, 56, 128, "huber", 3, 4, False, 50),
    "op 2 scale 3 l1 C3 B1": (2, 56, 128, "l1", 3, 1, False, 50),
    "op 2 scale 3 l1 C1 B4": (2, 56, 128, "l1", 1, 4, False, 50),
    "op 4 scale 1 huber C3 B1": (4, 224, 512, "huber", 3, 1, False, 10),
    "op 4 scale 0 huber C3 B1": (4, 448, 1024, "huber", 3, 1, False, 5),
    "1-D op 2 scale 3 l2 C3 B1": (2, 56, 128, "l2", 3, 1, True, 50),
    "1-D op 2 scale 3 l2 C1 B4": (2, 56, 128, "l2", 1, 4, True, 50),
}
PHASE_SHAPES = ("op 2 scale 3 huber C3 B1", "op 4 scale 1 huber C3 B1",
                "1-D op 2 scale 3 l2 C3 B1")
PHASES = ("blend", "mean butterfly", "transform (+ partials)",
          "sums' butterfly", "projection pass", "step and test", "address")


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


def shape_inputs(name, dev):
    """(cfg, grid, state on ``dev``, the target level on ``dev``, one_d)
    for one of ``SHAPES``, made on the CPU from a seed."""
    from flowonthego_tpu_torch import operating_point
    from flowonthego_tpu_torch.ops import dis as dis_mod
    from flowonthego_tpu_torch.ops.patches import (
        PatchGrid, extract_templates_and_hessians)
    from flowonthego_tpu_torch.ops.pyramid import build_pyramid
    from flowonthego_tpu_torch.utils.synth import synthetic_frames
    op, h, w, cost, C, n, one_d, _ = SHAPES[name]
    g = torch.Generator().manual_seed(60 + sorted(SHAPES).index(name))
    cfg = dataclasses.replace(operating_point(op), cost_fn=cost)
    shift = (-2, 0) if one_d else (1, 1)
    pairs = [synthetic_frames(1 + b, 2, h, w, shift, channels=C, factor=4)
             for b in range(n)]
    lvl0, lvl1 = (build_pyramid(torch.as_tensor(
        np.stack([p[k] for p in pairs])), 1, cfg.padding)[0]
        for k in (0, 1))
    grid = PatchGrid.create(cfg, w, h)
    cold = dis_mod.init_state(*extract_templates_and_hessians(
        lvl0.image, lvl0.grad_x, lvl0.grad_y, grid, cfg), grid)
    coarse = torch.randn((n, h // 2, w // 2, 2), generator=g) * 2.0
    if one_d:
        coarse[..., 1] = 0.0
    warm = dis_mod.init_from_coarser(cold, coarse, grid)
    state = dis_mod.PatchState(*(x.contiguous().to(dev) for x in warm))
    return cfg, grid, state, lvl1.image.contiguous().to(dev), one_d


def solve(dis_ref, name, inputs):
    cfg, grid, st, I1, one_d = inputs
    if one_d:
        return lambda: dis_ref.optimize_1d(st, I1, grid, cfg, 0)
    return lambda: dis_ref.optimize_reference(st, I1, grid, cfg)


def compare(out, saved):
    """Shape by shape: bit-identical to ``saved``, or how far and on what
    share of the patches."""
    report = {}
    for name, fields in out.items():
        if f"{name}/p" not in saved:
            continue
        worst, patches = 0.0, None
        same = True
        for field, got in fields.items():
            ref = saved[f"{name}/{field}"]
            if np.array_equal(got.view(np.uint32), ref.view(np.uint32)):
                continue
            same = False
            diff = np.abs(got.astype(np.float64) - ref)
            worst = max(worst, float(np.nanmax(diff)))
            lead = got.shape[:3]
            bad = (got.view(np.uint32) != ref.view(np.uint32)).reshape(
                lead + (-1,)).any(-1)
            patches = bad if patches is None else patches | bad
        report[name] = ("bit-identical" if same else
                        f"differs: max abs {worst:.3g} on "
                        f"{100 * patches.mean():.3g}% of the patches")
        print(f"compare {name}: {report[name]}", flush=True)
    return report


def phase_library(source):
    """Build this script's ref_phases.cu around ``source`` into the tree's
    build directory; the loaded library."""
    from flowonthego_tpu_torch.ops.cuda import _build
    probe = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "ref_phases.cu")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"libref_phases_{os.getpid()}.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                    f"-DREF_SOURCE=\"{os.path.abspath(source)}\"", "-o",
                    str(out), probe], check=True)
    lib = ctypes.CDLL(str(out))
    lib.fot_dis_ref.argtypes = _build.SIGNATURES["fot_dis_ref"]
    lib.fot_dis_ref.restype = ctypes.c_int
    lib.fot_ref_phases_buffer.argtypes = [ctypes.c_void_p]
    lib.fot_ref_phases_buffer.restype = ctypes.c_int
    return lib


def phase_split(lib, name, inputs, dev):
    """The clock64 split of one shape's trips: cycles a trip (summed over
    the patches' warps) by phase, and their shares; from %globaltimer, the
    launch's span, the warps running on an SM on average over it, and its
    tail: the time from when fewer than half the most warps that ran at
    once still run to the end."""
    from flowonthego_tpu_torch.ops.cuda import _build, dis_ref
    cfg, grid, st, I1, one_d = inputs
    n = st.p_cur.shape[0] * st.p_cur.shape[1] * st.p_cur.shape[2]
    buf = torch.zeros((n, 16), dtype=torch.int64, device=dev)
    assert lib.fot_ref_phases_buffer(buf.data_ptr()) == 0
    outs = (torch.empty_like(st.p_cur), torch.empty_like(st.templates),
            torch.empty_like(st.templates))
    if "converged_out" in inspect.signature(dis_ref.launch).parameters:
        outs += (torch.empty_like(st.converged),)

    def run():
        dis_ref.launch(lib, st, I1, grid, cfg, one_d, 0, None, *outs,
                       _build.stream_handle(I1))
    run()
    buf.zero_()
    run()
    torch.cuda.synchronize()
    rows = buf.cpu().numpy()
    rows = rows[rows[:, 8] > 0]           # the patches that started
    ph = rows[:, :8].sum(0)
    trips = int(ph[7]) - len(rows)        # samples less the first
    per = {PHASES[k]: ph[k] / max(trips, 1) for k in range(len(PHASES))}
    total = sum(per.values())
    start, end = rows[:, 8], rows[:, 9]
    span = int(end.max() - start.min())
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    busy = float((end - start).sum()) / span / n_sm
    t = np.concatenate([start, end])
    order = np.argsort(t, kind="stable")
    running = np.cumsum(np.where(order < len(rows), 1, -1))
    late = t[order][running >= running.max() / 2].max()
    tail = int(end.max() - late)
    ms = device_ms(run, 5)
    text = ", ".join(f"{k} {v:.0f} ({100 * v / total:.0f}%)"
                     for k, v in per.items() if v)
    print(f"phases {name}: {trips} trips, {total:.0f} cycles a trip: "
          f"{text}; span {span / 1e6:.4f} ms, {busy:.1f} warps an SM on "
          f"average (at most {running.max()} at once), tail "
          f"{tail / 1e6:.4f} ms; the probe's launch {ms:.4f} ms",
          flush=True)
    return dict(trips=trips, cycles_per_trip=per, probe_ms=ms,
                span_ms=span / 1e6, warps_per_sm=busy,
                most_warps=int(running.max()), tail_ms=tail / 1e6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="the checkout whose flowonthego_tpu_torch is timed")
    ap.add_argument("--save", help="write the outputs to this .npz")
    ap.add_argument("--compare", help="compare the outputs with this .npz")
    ap.add_argument("--json", help="also write the numbers here")
    ap.add_argument("--phases", action="store_true",
                    help="also the clock64 split of a trip")
    ap.add_argument("--phase-source",
                    help="the kernel source for --phases (default: the "
                    "tree's csrc/dis_ref.cu)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ref_times: needs a CUDA device")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from flowonthego_tpu_torch.models.dis_flow import pin_fp32
    from flowonthego_tpu_torch.ops.cuda import _build, dis_ref
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
    result = {"card": card, "root": root}
    out = {}
    inputs = {}
    for name in SHAPES:
        inputs[name] = shape_inputs(name, dev)
        fn = solve(dis_ref, name, inputs[name])
        got = fn()
        torch.cuda.synchronize()
        out[name] = {"p": got.p_cur.cpu().numpy(),
                     "diff": got.diff.cpu().numpy(),
                     "cost": got.cost_px.cpu().numpy()}
        ms = device_ms(fn, SHAPES[name][-1])
        result[name] = ms
        print(f"G6 {name} ({inputs[name][2].p_cur[..., 0].numel()} "
              f"patches): {ms:.4f} ms", flush=True)
    if args.save:
        np.savez(args.save, **{f"{n}/{k}": v for n, f in out.items()
                               for k, v in f.items()})
    if args.compare:
        with np.load(args.compare) as saved:
            result["compare"] = compare(out, dict(saved))
    if args.phases:
        source = args.phase_source or os.path.join(
            root, "flowonthego_tpu_torch", "csrc", "dis_ref.cu")
        lib = phase_library(source)
        result["phases"] = {name: phase_split(lib, name, inputs[name], dev)
                            for name in PHASE_SHAPES}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
