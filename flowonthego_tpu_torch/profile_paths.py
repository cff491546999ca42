"""Where the device time goes on the port's main paths (one NVIDIA GPU).

    python -m flowonthego_tpu_torch.profile_paths [--reps N] [--eager]

Every path runs as its entry point runs it on the card: replayed from its
CUDA graph (``utils/graphs.py``; the device events are the graph's
kernels).  ``--eager`` runs them launch by launch instead
(``graphs.eager()``), as they ran before the captures.  Each path's calls
run inside ``utils.profiling.annotate(<path name>)``, so a trace taken
around this script (``utils.profiling.trace``) shows the paths by name.

For each path: the wall time per pair without the profiler (host clock,
ending in a sync), then ``torch.profiler`` over the same calls: device
time per pair split by kernel (K1-K5, the glue kernels G1-G4, the fb
merge G5, the reference-form solve G6, the small PyTorch kernels left,
GEMMs, copies, the plain fb merge's sorted scatter where it still runs),
device launches per pair, and the busy share (device time over the
unprofiled wall time).
The inputs are the seeded 1024x436 scenes of ``chip_smoke.py``: the
(16, 8)-px pair, a (2, 2)-px pair whose motion stays inside the
op-3/op-4 outlier radius at every scale, a four-frame op-3 stream moving
(12, -6) px per frame, and a horizontal (-16, 0)-px pair for depth.
Besides op 1, 3 and 4, op 2 runs as the command line's modes run it:
plain, with forward-backward consistency (op 4 too), with the
pseudo-Huber cost (the reference-form solve; op 4 too, on the (2, 2) and
(16, 8) pairs), on gray input (C = 1), as stereo depth and with K2's
bf16 operands (op 4 too); and batched:
``batched_flow`` on four pairs (each moving its own motion) and a
four-stream ``MultiStream`` tick, counted per frame.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import itertools
import subprocess
import time

import torch

# device-kernel name fragment -> the row it is counted under, first match
CATEGORIES = (("dis_gn_kernel", "K2 gn"),
              ("fb_merge_warp_kernel", "G5 fb merge cells"),   # not K5
              ("varref_cluster_kernel", "K4 cluster"),
              ("varref_tiled_kernel", "K4 grid"),
              ("varref_kernel", "K3"), ("warp_kernel", "K5 warp"),
              ("pool2x2_kernel", "K1 pool"),
              ("glue_level_kernel", "G1 level"),
              ("glue_extract_kernel", "G2 extract"),
              ("glue_densify_kernel", "G3 densify"),
              ("glue_derivs_kernel", "G4 derivs"),
              ("fb_merge_bin", "G5 fb merge bins"),   # the sort's launches
              ("fb_merge_kernel", "G5 fb merge cells"),
              ("dis_ref_1d_kernel", "G6 dis_ref 1-D"),
              ("dis_ref_kernel", "G6 dis_ref"), ("Memcpy", "copies"),
              ("memcpy", "copies"),     # CUDA's own copy kernels
              ("Memset", "copies"), ("gemm", "GEMM"),
              ("indexing_backward_kernel", "index_put sort+sum"),
              ("RadixSort", "index_put sort+sum"))


def category(name: str) -> str:
    for frag, cat in CATEGORIES:
        if frag in name:
            return cat
    return "small torch kernels"


def device_breakdown(fn, reps: int, skip: str = ""):
    """(total device ms, {category: (ms, launches)}) of ``reps`` calls;
    ``skip`` names an ``annotate`` range around the calls, whose span on
    the device timeline is no kernel.  The tracer sometimes loses the
    device events at the start of what it records, and sometimes shows
    the warm-up step's in the recorded one, so the profile starts in a
    warm-up step of 32 throw-away kernels that no path runs (lgamma) and
    the recorded step begins with 32 others (digamma): both are left out,
    and a profile that does not show exactly 32 digamma kernels is taken
    again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    scratch = torch.ones(1, device="cuda")

    def throw_away(op):
        for _ in range(32):
            op()
        torch.cuda.synchronize()

    for _ in range(8):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            throw_away(scratch.lgamma_)
            prof.step()
            throw_away(scratch.digamma_)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = collections.defaultdict(lambda: [0.0, 0])
        thrown = 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or e.name == skip:
                continue
            if "digamma" in e.name or "lgamma" in e.name:
                thrown += "digamma" in e.name
                continue
            row = per[category(e.name)]
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
        if thrown == 32:
            return sum(ms for ms, _ in per.values()), per
        print(f"   (incomplete profile: {thrown} of 32 throw-away kernels "
              "shown; taken again)", flush=True)
    raise RuntimeError("eight profiles in a row were incomplete")


def wall_ms(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def report(name: str, fn, reps: int, pairs_per_call: int = 1) -> dict:
    from flowonthego_tpu_torch.utils.profiling import annotate
    inner = fn

    def fn():
        with annotate(name):
            return inner()

    fn()                            # first call: eager, and records
    fn()                            # second: the first replay
    wall = wall_ms(fn, reps) / pairs_per_call
    dev_ms, per = device_breakdown(fn, reps, skip=name)
    n = reps * pairs_per_call
    launches = sum(k for _, k in per.values()) / n
    per_call = (f" ({wall * pairs_per_call:.3f} ms and "
                f"{launches * pairs_per_call:.0f} launches per call of "
                f"{pairs_per_call} pairs)" if pairs_per_call > 1 else "")
    print(f"{name}: unprofiled wall {wall:.3f} ms/pair; device "
          f"{dev_ms / n:.3f} ms/pair ({100 * dev_ms / n / wall:.1f}% busy); "
          f"device launches/pair {launches:.0f}{per_call}", flush=True)
    for cat, (ms, k) in sorted(per.items(), key=lambda kv: -kv[1][0]):
        print(f"   {cat:<22} {ms / n:8.3f} ms/pair  n/pair={k / n:.0f}",
              flush=True)
    return dict(wall=wall, device=dev_ms / n, launches=launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5,
                    help="calls per path, unprofiled and profiled")
    ap.add_argument("--eager", action="store_true",
                    help="run launch by launch, not from the CUDA graphs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths: needs a CUDA device")
    if args.eager:
        from flowonthego_tpu_torch.utils import graphs
        with graphs.eager():
            return run(args)
    return run(args)


def run(args) -> int:
    import flowonthego_tpu_torch as port
    from flowonthego_tpu_torch.config import pad_to_divisible
    from flowonthego_tpu_torch.models.dis_flow import pin_fp32
    from flowonthego_tpu_torch.ops.pyramid import pad_replicate
    from flowonthego_tpu_torch.utils.synth import (synthetic_frames,
                                                   synthetic_pair)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    pin_fp32()
    dev = torch.device("cuda", 0)
    cfg = {op: port.operating_point(op, width=1024) for op in (1, 2, 3, 4)}
    pairs = {s: [torch.as_tensor(x, device=dev)
                 for x in synthetic_pair(0, 436, 1024, s)]
             for s in ((16, 8), (2, 2), (-16, 0))}
    gray = [port.prepare_input(x, "gray") for x in pairs[(16, 8)]]
    pads = pad_to_divisible(1024, 436, cfg[3].coarsest_scale)
    frames = [pad_replicate(torch.as_tensor(f, device=dev), pads)
              for f in synthetic_frames(5, 4, 436, 1024, (12, -6), factor=16)]

    def pair(op, shift):
        return lambda: port.compute_flow(*pairs[shift], cfg[op])

    def op2(**fields):
        return dataclasses.replace(cfg[2], **fields)

    report("op 2 pair (16, 8)", pair(2, (16, 8)), args.reps)
    report("op 2 fb pair (16, 8)", lambda: port.compute_flow(
        *pairs[(16, 8)], op2(use_fb_consistency=True)), args.reps)
    report("op 2 huber pair (16, 8)", lambda: port.compute_flow(
        *pairs[(16, 8)], op2(cost_fn="huber")), args.reps)
    report("op 2 gray pair (16, 8)",
           lambda: port.compute_flow(*gray, cfg[2]), args.reps)
    report("op 2 depth pair (-16, 0)", lambda: port.compute_disparity(
        *pairs[(-16, 0)], op2(use_var_ref=False)), args.reps)
    report("op 1 pair (16, 8)", pair(1, (16, 8)), args.reps)
    report("op 4 pair (16, 8)", pair(4, (16, 8)), args.reps)
    report("op 4 pair (2, 2)", pair(4, (2, 2)), args.reps)
    report("op 4 fb pair (16, 8)", lambda: port.compute_flow(
        *pairs[(16, 8)], dataclasses.replace(cfg[4], use_fb_consistency=True)),
        args.reps)
    for shift in ((2, 2), (16, 8)):
        report(f"op 4 huber pair {shift}", lambda s=shift: port.compute_flow(
            *pairs[s], dataclasses.replace(cfg[4], cost_fn="huber")),
            args.reps)
    report("op 2 bf16 pair (16, 8)", lambda: port.compute_flow(
        *pairs[(16, 8)], op2(dtype="bfloat16")), args.reps)
    report("op 4 bf16 pair (2, 2)", lambda: port.compute_flow(
        *pairs[(2, 2)], dataclasses.replace(cfg[4], dtype="bfloat16")),
        args.reps)
    report("op 3 stream, 4 frames (12, -6)",
           lambda: list(port.stream_flow(frames, cfg[3], fetch=False)),
           max(1, args.reps // 2), pairs_per_call=len(frames) - 1)

    # four pairs / streams, frame b moving shifts[b]
    shifts = ((16, 8), (-8, 8), (8, -16), (-16, -8))
    pads = pad_to_divisible(1024, 436, cfg[2].coarsest_scale)
    videos = [torch.stack([pad_replicate(torch.as_tensor(f, device=dev), pads)
                           for f in synthetic_frames(20 + b, 4, 436, 1024, s)])
              for b, s in enumerate(shifts)]
    I0, I1 = (torch.stack([v[k] for v in videos]) for k in (0, 1))
    report("op 2 batched_flow, 4 pairs", lambda: port.batched_flow(
        I0, I1, cfg[2]), args.reps, pairs_per_call=len(shifts))
    streams = port.MultiStream(cfg[2], *I0.shape[1:3], n_streams=len(shifts),
                               device=dev)
    streams.start(I0)
    ticks = itertools.count()

    def tick():
        t = 1 + next(ticks) % 3
        return streams.push(torch.stack([v[t] for v in videos]))

    report("op 2 MultiStream tick, 4 streams", tick, args.reps,
           pairs_per_call=len(shifts))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
