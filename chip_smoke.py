#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``flowonthego_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (K1-K5; G1-G4, the per-scale glue; G5, the
     fb merge, and G6, the reference-form solve with its 1-D form) from
     ``flowonthego_tpu_torch/csrc``;
  3. the time of a kernel that does nothing (the floor under every
     launch); each kernel against its plain PyTorch version on the card,
     at the shapes the op-2, op-3 and op-4 paths give it, with CUDA-event
     times for both, its bound (``ops/cuda/bounds.py``: the least time
     the card could take for the call's bytes and operations) and, for
     K1 and K5, the time of the one PyTorch call that computes the same
     function (``avg_pool2d``, ``grid_sample``; yardsticks, used nowhere
     in the port); K2 in every compiled form and its generic form, and
     its strip-offset entry on the op-4 patches cut by a few rows; K3
     against both routes of K4 (cluster and grid) bit for bit on the
     fields all can take, and all timed on the field sizes of the paths
     at C = 3 and C = 1 (the var-ref resolver's two thresholds), beside
     the cluster entry with one CTA; a K3 or cluster launch that cannot
     fit must raise; K5 on a random flow and on a smooth one (two motions
     and a sub-pixel part, as the pipeline gives it), on a strided crop,
     far outside the image and in its generic form; then the glue
     kernels (``glue_phase``): G1 (a pyramid level's borders and
     gradients, also into a stream's fixed tensors), G2 (template
     extraction and Hessians, mean normalisation on and off), G3 (densify,
     squared and abs weights, with an fb merge's accumulator) and G4 (the
     var-ref derivatives of a strided crop) against their plain versions
     at op 4's scale 0, op 2's scales 3 and 5 and op 1's scale 3 of
     1024x448, the 4K stream's finest scale and a 4x8 cut, C = 3 and 1,
     one frame and four in one launch, timed at op 4's scale 0 with their
     bounds (G3 also at every level, with and without a merge, and at
     448x1030, where op 4's last chunk of patch columns ends inside the
     patches' reach): G1, G3 and G4 bit for bit, G2's windows bit for bit, its
     templates within 1e-4 and its Hessians within 1e-5 of the largest
     entry, its det == 0 bumps (flat and striped patches) exactly; then
     (``merge_solve_phase``) G5 bit for bit against the plain merge on
     the op-2 and op-4 fb pairs' own merges at 1024x448 (the card's sorted
     ``index_put_`` folds each cell in order; where it does not, G5 is
     held to the in-order fold of the card's contributions on the CPU),
     the 4K stream's finest scale, four frames in one launch, every patch
     outside the frame, every patch on one cell (op 2's scale 3, and op
     4's scale 2, whose tile takes its candidates in windows), the abs
     weights and C = 1, timed on the op-2 pair's largest merge and at op
     4's scale 0 with its bound, beside ``index_put_`` alone, split into
     its sort and cell launches; G6
     against its plain version at op 2's scale 3 under l1, huber, l1 with
     ``min_iter`` 4 and ``res_thresh`` 5, C = 3 and 1, one frame and four,
     cold and warm, with a strip offset, and at op 4's scales 1 and 0 under
     huber, its 1-D form at cam_lr 0 and 1 (p within ``TOL_GN_P``, cost
     and diff within ``TOL_GN_COST``, as x|x| under the robust costs, on
     all but ``GN_FLIP_SHARE`` of the patches), each timed with its bound
     on the trips its patches ran;
  4. the main paths at real size, each from scratch (no cached graph)
     with the wrappers' launch counters reset just before it and read
     just after, under ``torch.profiler``, whose device events say how
     often each kernel ran, replays of a CUDA graph included (numpy frames
     with no ``device`` must come back on the card): op 2 (``compute_flow`` on a
     seeded 1024x436 pair moving (16, 8) px, ``stream_flow`` over four
     3840x2160 frames), op 4 (``compute_flow`` on that pair, and on one
     moving (2, 2) px, which stays inside the outlier radius at every
     scale so every patch iterates), op 3 (``stream_flow`` over four
     1024x436 frames), op 1 (``compute_flow`` on the first pair) and op
     2 and op 4 once each on a pair whose left half moves (2, 2) px and
     whose right half (16, 8) px (against the plain path and the known
     field, each half's median within ``SHIFT_TOL``); then
     the same inputs through the plain path on the card, the op-2 and
     op-3 1024x448 finest-scale flows against the JAX goldens in
     ``tests/data`` (the GPU run needs no JAX), the op-2 finest flows with
     forward-backward consistency and with the l1 cost and ``min_iter=4``
     against their JAX goldens, and one ``compute_flow_timed`` op-4 call
     with its TIME lines;
  5. K2-K5 against their plain versions at C = 1 (the gray and gradmag
     modes' shapes), timed;
  6. the command line at full width on that pair written as PPM files:
     ``python -m flowonthego_tpu_torch`` once as a user runs it (op 2 with
     ``--viz``), then ``cli.run`` in-process for every mode (``--fb``,
     ``--cost huber``, ``--cost l1 --min-iter 4``, ``--densify-weight
     abs``, ``--channels gray|gradmag``, ``--mode depth`` on a horizontal
     pair, the 13-parameter form at verbosity 2 with ``--fb``), each with
     the counters from zero, held to the known motion and against the
     same command with a plain-path config, and the ``--fb`` flow run
     twice and compared bit for bit;
  7. K1-K5 on batches of four frames (op 2 and op 4 shapes at 1024x448)
     against their plain versions and against one launch per frame (bit
     for bit), K3 against K4's two routes at B = 4 on the sweep's fields,
     and K2's bf16 operand kernel against its plain version and the
     float32 kernel, timed, each with its bound;
  8. the batched paths at 1024x436, each with the counters from zero:
     ``batched_flow`` on four pairs, each moving its own motion, at op 2
     and op 4 (each kernel must launch as often as for one pair: once per
     scale for the batch; each frame against its single-pair
     ``compute_flow`` and its motion), a four-stream ``MultiStream`` at op
     2 against ``stream_flow`` on each stream, ``stream_video_chunks`` on a
     9-frame video in four chunks, and the bf16 solve's flow against the
     float32 flow, with ms per batch, frame and tick;
  9. the captured paths (``utils/graphs.py``: every entry point of phases
     4-8 already ran through its CUDA graph from its second call on) at
     full width, each counted as in phase 4: op 2, op 4 on the (2,
     2) pair, op 2 and op 4 with forward-backward consistency (through G5,
     with no device event of the plain merge's sorted scatter), op 2 under
     huber (G6, no K2) through ``compute_flow`` at 1024x436, op 2 depth
     through ``compute_disparity`` (G6's 1-D form), the last three also
     against the plain path, ``batched_flow`` of four, the op-2
     3840x2160 stream, the op-3 stream and a four-stream ``MultiStream``
     tick: the captured flow equals the eager flow bit for bit and two
     flows held at once do not alias; per call, eagerly and captured, the
     device events and the host's launch calls (``torch.profiler``; a
     captured call must make one graph launch, which must run each device
     event of the eager call as often and only its own copies more; an
     eager call must run each kernel as often as its wrapper counted), ms
     as host wall and as
     CUDA-event time over calls queued back to back (median of 3
     trials) and the busy share (profiled device time over wall time);
     the table of captured and eager entries; the allocator's bytes
     before and after the 4K stream's capture and after ``clear()``;
 10. the native I/O library (``io/native.py``): ``native: built`` or
     ``native: unavailable`` with the compiler's message (then the
     Python twins serve, and the phase ends there); on a host without
     ``png.h`` or ``jpeglib.h`` the build is the one without those two
     decoders, and the full build's message is printed; when built, a .flo round trip, a PPM decode against ``load_image``,
     the colour wheel against ``flow_to_color`` and
     ``stream_flow(FrameStream(directory of PPM frames))`` against
     ``stream_flow`` over the loaded frames, bit for bit;
 11. the device-list forms on a one-device mesh:
     ``make_data_parallel_flow`` against ``batched_flow`` and
     ``MultiStream(devices=[cuda:0])`` against ``MultiStream(device=)``,
     bit for bit;
 12. the spatial forms on meshes whose positions are all this card, each
     counted as in phase 4 (3 calls: the eager first call, which records,
     and two replays): ``make_fine_spatial_flow`` on 2 strips and
     ``make_tile2d_flow`` on 2x2 tiles at op 4 on a 3840x2304 pair (scales
     2 and 3 sharded; K2's strip entry once per sharded scale and shard a
     call), ``make_spatial_flow`` on 4 strips at op 2 on 3840x2176 and
     ``make_batch_spatial_flow`` of 2 on a 2x2 (data x space) mesh: replays
     equal the eager call bit for bit, violation count 0, each against the
     unsharded path at the JAX package's bar, the op-4 medians against the
     motion; ms per call captured, eager and of the unsharded path; a
     starved halo counts violations and the recovering form returns the
     unsharded flow;
 13. ``python -m flowonthego_tpu_torch.tools.flow_stream`` (in-process)
     over PPM frames: its .flo files equal ``stream_flow``'s flows.
A kernel's ``ms`` is the device's time for back-to-back launches of its
wrapper (:func:`device_ms`); a plain version's is the time between two
events with the host's enqueue time in it.  It prints one JSON line of
per-kernel results (``ms``, ``plain_ms``, ``bound_ms``, ``bound_by``,
``library_ms``; ``launches``: how often the kernel ran on the device in
the main paths' runs of phases 4, 6, 9 and 12, from those runs'
profiles; the batched and bf16 rows with those of phase 8; K4 as two rows,
one for each route; K2's strip-offset entry as its own row, timed in
phase 3 on the op-4 patches, launched in phase 12; G6's 1-D form as its
own row, launched by the depth runs of phases 6 and 9) and, last, the
device line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = {op: os.path.join(REPO, "tests", "data",
                           f"torch_port_golden_op{op}_1024x448.npz")
          for op in (2, 3)}
# JAX's op-2 finest flow on the split pair (SPLIT_SHIFTS)
GOLDEN_SPLIT = os.path.join(REPO, "tests", "data",
                            "torch_port_golden_op2_split_1024x448.npz")
# op-2 goldens of two modes: (file, config fields)
GOLDEN_MODES = {
    "fb": ("torch_port_golden_op2_fb_1024x448.npz",
           dict(use_fb_consistency=True)),
    "l1 min_iter 4": ("torch_port_golden_op2_l1_1024x448.npz",
                      dict(cost_fn="l1", min_iter=4)),
}

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
# K3 and K4's two routes on the fields of the paths at 1024x448 (h, w,
# level) and sizes between them, where the forms cross: K3 | cluster
# between 14x32 and 28x32, cluster | grid between 40x96 and 56x128.
SWEEP = ((14, 32, 5), (18, 32, 5), (22, 32, 5), (28, 32, 4), (32, 32, 4),
         (28, 48, 4), (28, 64, 4), (40, 96, 4), (56, 128, 3), (112, 256, 2),
         (224, 512, 1))
# Up to this size the sweep also times the cluster entry with one CTA (the
# work planes in shared memory, the inputs in device memory, a cluster
# barrier): what K3 gains over it is what staging the inputs and
# __syncthreads() buy.
ONE_CTA_MAX_PIXELS = 28 * 64
# A second 1024x436 pair, whose halves move differently (left, right), so
# the true flow is known per pixel and is not uniform.
SPLIT_SHIFTS = ((2, 2), (16, 8))
# The command line's runs: (name, arguments after the three paths,
# kernels that must launch, kernels that must not).  The robust costs and
# min_iter take the reference-form solve (no K2), as in the JAX package;
# depth runs the pyramid (K1) and a 1-D solve with no refinement.
# ALL: the kernels every l2 path runs; the fb merge (G5) runs with
# forward-backward consistency, the reference-form solve (G6, "dis_ref")
# in K2's place under the robust costs, min_iter and depth (its 1-D form
# counted under "dis_ref" and, apart, "dis_ref_1d")
ALL = ("pool", "gn", "varref", "varref_cluster", "varref_tiled", "warp",
       "level", "extract", "densify", "derivs")
COUNTED = ALL + ("fb_merge", "dis_ref")
FB = ALL + ("fb_merge",)
NO_GN = ALL[:1] + ALL[2:]
REF = NO_GN + ("dis_ref",)
# the var-ref's kernels: K3, K4's two routes, K5 and G4
VARREF = ("varref", "varref_cluster", "varref_tiled", "warp", "derivs")
NO_VARREF = tuple(k for k in ALL if k not in VARREF)
DEPTH = ("pool", "level", "extract", "densify", "dis_ref")
CLI_RUNS = (
    ("fb", ["2", "--fb"], FB, ("dis_ref",)),
    ("cost huber", ["2", "--cost", "huber"], REF, ("gn", "fb_merge")),
    ("cost l1 min-iter 4", ["2", "--cost", "l1", "--min-iter", "4"], REF,
     ("gn", "fb_merge")),
    ("densify-weight abs", ["2", "--densify-weight", "abs"], ALL,
     ("fb_merge", "dis_ref")),
    ("channels gray", ["2", "--channels", "gray"], ALL,
     ("fb_merge", "dis_ref")),
    ("channels gradmag", ["2", "--channels", "gradmag"], ALL,
     ("fb_merge", "dis_ref")),
    ("mode depth", ["2", "--mode", "depth"], DEPTH,
     VARREF + ("gn", "fb_merge")),
    ("13-param verbosity 2 fb",
     "5 3 12 8 0.4 1 1 10 10 5 3 1.6 2 --fb".split(), FB, ("dis_ref",)),
)
# a device event of the plain merge's sorted scatter: none may run on a
# path through G5
SORTED_SCATTER = ("indexing_backward_kernel", "RadixSort")
DEPTH_SHIFT = (-16, 0)   # a horizontal pair: disparity <= 0 (cam 0)


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``reps`` calls between two CUDA events:
    the device's time where it is the slower side, the host's enqueue
    time where that is (the plain versions, chains of small ops)."""
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


SM_HZ = 2e9   # cycles per second assumed for the spin below (an upper bound)


def device_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events).  A wrapper call costs the host tens of microseconds, more
    than most kernels here take, so the calls are enqueued behind a spin
    kernel that keeps the device busy for twice their enqueue time: the
    events then bracket the device's work alone, launch gaps included."""
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


def kernel_row(ms, plain_ms, bound, max_abs_err=None, library_ms=None):
    """One kernel's numbers for the ``kernels`` line; no time may be under
    its bound."""
    assert bound.bound_ms <= ms, (ms, bound)
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound.bound_ms,
               bound_by=bound.bound_by, library_ms=library_ms)
    if max_abs_err is not None:
        row["max_abs_err"] = max_abs_err
    return row


def timing_text(row) -> str:
    text = (f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.3g} ms by {row['bound_by']} "
            f"({100 * row['bound_ms'] / row['ms']:.3g}% of the kernel's time)")
    if row["library_ms"] is not None:
        text += f", library call {row['library_ms']:.4f} ms"
    return text


def pool_library(x, C):
    """K1's yardstick: ``avg_pool2d`` on the [H, W, C] view of a flat
    level (channels last), which gives the kernel's [H/2, W/2 * C] layout."""
    import torch.nn.functional as F
    H, WC = x.shape
    nchw = x.view(1, H, WC // C, C).permute(0, 3, 1, 2)
    return lambda: F.avg_pool2d(nchw, 2).permute(0, 2, 3, 1).reshape(
        H // 2, WC // 2)


def warp_library(src, wx, wy):
    """K5's yardstick: ``grid_sample`` (bilinear, border padding,
    align_corners) on [B, h, w, C] frames.  It clamps coordinates, not
    taps, and returns no mask: the same function only where the flow stays
    inside the image."""
    import torch.nn.functional as F
    B, h, w, _ = src.shape
    jj = torch.arange(h, dtype=src.dtype, device=src.device)[:, None]
    ii = torch.arange(w, dtype=src.dtype, device=src.device)[None, :]
    grid = torch.stack([(ii + wx) / (w - 1) * 2 - 1,
                        (jj + wy) / (h - 1) * 2 - 1], dim=-1)
    nchw = src.permute(0, 3, 1, 2)
    return lambda: F.grid_sample(
        nchw, grid, mode="bilinear", padding_mode="border",
        align_corners=True).permute(0, 2, 3, 1)


def inside_flow(h, w, B, bound, gen, dev):
    """Flows of up to ``bound`` px that keep every sample inside the
    image (for K5's yardstick)."""
    jj = torch.arange(h, dtype=torch.float32)[:, None]
    ii = torch.arange(w, dtype=torch.float32)[None, :]
    wx = (torch.rand((B, h, w), generator=gen) * 2 - 1) * bound
    wy = (torch.rand((B, h, w), generator=gen) * 2 - 1) * bound
    wx = (ii + wx).clamp(0, w - 1) - ii
    wy = (jj + wy).clamp(0, h - 1) - jj
    return wx.to(dev), wy.to(dev)


def smooth_flow(h, w, B, dev):
    """Flows like those the pipeline gives the warp: the split pair's known
    field (two motions, a seam) plus a smooth sub-pixel part (std ~0.5
    px); frame b from seed 40 + b."""
    from flowonthego_tpu_torch.utils.synth import (smooth_texture,
                                                   synthetic_split_pair)
    field = synthetic_split_pair(0, h, w, *SPLIT_SHIFTS)[2]
    flows = np.stack([field + (smooth_texture(40 + b, h, w, 2) - 128.0)
                      / 100.0 for b in range(B)])
    flows = torch.as_tensor(flows, dtype=torch.float32, device=dev)
    return flows[..., 0].contiguous(), flows[..., 1].contiguous()


def host_ms(fn, reps: int) -> float:
    """Mean wall time of ``fn`` over ``reps`` calls, ending in a sync,
    after one call that is not timed (an entry point's first call runs
    eagerly and records its CUDA graph)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def share_off(got, ref, rtol, atol) -> float:
    """Share of patches (the three leading dims: frame, grid row, grid
    column) with any value outside ``atol + rtol * |ref|``."""
    bad = (got - ref).abs() > atol + rtol * ref.abs()
    return float(bad.reshape(*bad.shape[:3], -1).any(-1).float().mean())


def check_gn(op, got, ref):
    """K2's (p, cost) against the plain version's: within TOL_GN_P and
    TOL_GN_COST at op 2; at op 4 (128 iterations) at most GN_FLIP_SHARE of
    the patches outside them.  Returns (p max_abs_err, text to log)."""
    (p, cost), (rp, rcost) = got, ref
    err = max_err(p, rp)
    text = f"p max_abs_err {err:.3g}, cost max_abs_err {max_err(cost, rcost):.3g}"
    if op == 2:
        torch.testing.assert_close(p, rp, **TOL_GN_P)
        torch.testing.assert_close(cost, rcost, **TOL_GN_COST)
    else:
        off_p = share_off(p, rp, **TOL_GN_P)
        off_c = share_off(cost, rcost, **TOL_GN_COST)
        text += (f"; patches outside tolerance: p {off_p:.3g}, cost "
                 f"{off_c:.3g} (bound {GN_FLIP_SHARE:g})")
        assert max(off_p, off_c) <= GN_FLIP_SHARE, text
    return err, text


def flow_band(got, ref, what):
    epe = torch.linalg.vector_norm(got.double() - ref.double(), dim=-1)
    mean, p99 = float(epe.mean()), float(torch.quantile(epe.flatten()[::7],
                                                        0.99))
    log(f"  {what}: mean EPE {mean:.3g} px, p99 {p99:.3g} px "
        f"(band {BAND_MEAN:g} / {BAND_P99:g})")
    assert mean <= BAND_MEAN and p99 <= BAND_P99, what


def plain(cfg):
    """``cfg`` on the plain path: every kernel's plain PyTorch version."""
    return dataclasses.replace(cfg, gn_backend="xla", varref_backend="xla")


def kernel_modules():
    from flowonthego_tpu_torch.ops.cuda import (densify, derivs, dis_gn,
                                                dis_ref, extract, fb_merge,
                                                level, pool, varref_fused,
                                                varref_tiled, warp)
    return {"pool": pool, "gn": dis_gn, "varref": varref_fused,
            "varref_tiled": varref_tiled, "warp": warp, "level": level,
            "extract": extract, "densify": densify, "derivs": derivs,
            "fb_merge": fb_merge, "dis_ref": dis_ref}


def _name_re(name):
    return re.compile(rf"(?<![A-Za-z0-9_]){name}(?![A-Za-z0-9_])")


# The kernels' names on the device, as a profile shows them (K2's bf16
# form is the same kernel compiled for __nv_bfloat16 loads; G5 counts by
# its cell launch, one a call: a tile a CTA, or a warp a cell on a small
# frame).
KERNEL_NAMES = {"pool": "pool2x2_kernel", "gn": "dis_gn_kernel",
                "varref": "varref_kernel",
                "varref_cluster": "varref_cluster_kernel",
                "varref_tiled": "varref_tiled_kernel", "warp": "warp_kernel",
                "level": "glue_level_kernel", "extract": "glue_extract_kernel",
                "densify": "glue_densify_kernel",
                "derivs": "glue_derivs_kernel",
                "fb_merge": "fb_merge_(?:warp_)?kernel",
                "dis_ref": "dis_ref_kernel"}
KERNEL_RE = {k: _name_re(name) for k, name in KERNEL_NAMES.items()}
# K2's strip-offset entry (the spatial forms' sharded scales), counted
# under "gn" and, apart, under "gn_offset"; G6's 1-D form likewise under
# "dis_ref" and "dis_ref_1d"
GN_STRIP_RE = _name_re("dis_gn_strip_kernel")
REF_1D_RE = _name_re("dis_ref_1d_kernel")
# host runtime calls that put work on the device
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                "cudaGraphLaunch")
# A copy between two device tensors shows in a profile as a memcpy
# activity or as one of CUDA's own copy kernels (memcpy32_post,
# memcpy128, ...), the same copy now as one, now as the other, and as
# PyTorch's copy kernel where a side is strided: all are counted under
# this name.
THROW_AWAY = 32     # kernels a profile spends before what it measures
PROFILE_TRIES = 8
COPY = "device-to-device copy"
COPY_RE = re.compile(r"^Memcpy DtoD|^memcpy\d+|direct_copy_kernel_cuda")


def profiled(fn, before=None, ms_by_name=None):
    """Run ``fn`` under ``torch.profiler`` to a sync: (result, Counter of
    the device events' names, device ms, the host's launch calls, of which
    graph launches).  The device events are what ran on the card, whether
    launched one by one or replayed from a CUDA graph.

    The tracer sometimes loses the device events at the start of what it
    records (a few, or some hundreds), and sometimes shows the warm-up
    step's in the recorded one.  So the profile starts in a warm-up step
    of THROW_AWAY kernels that no path runs (lgamma), and the recorded
    step begins with THROW_AWAY others (digamma): both are left out of the
    counts, and a profile that does not show exactly THROW_AWAY digamma
    kernels is incomplete, is discarded and taken again (``before()`` is
    called ahead of every attempt).  ``ms_by_name``, a dict, gets the
    complete profile's device ms by event name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    scratch = torch.ones(1, device="cuda")

    def throw_away(op):
        for _ in range(THROW_AWAY):
            op()
        torch.cuda.synchronize()

    for _ in range(PROFILE_TRIES):
        if before is not None:
            before()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            throw_away(scratch.lgamma_)
            prof.step()
            throw_away(scratch.digamma_)
            out = fn()
            torch.cuda.synchronize()
        names = collections.Counter()
        by_name = collections.Counter()
        host_n = graph_n = thrown = 0
        dev_us = 0.0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                if "digamma" in e.name or "lgamma" in e.name:
                    thrown += "digamma" in e.name
                    continue
                names[COPY if COPY_RE.search(e.name) else e.name] += 1
                dev_us += e.time_range.elapsed_us()
                by_name[e.name] += e.time_range.elapsed_us() / 1e3
            elif e.name.startswith(LAUNCH_CALLS):
                host_n += 1
                graph_n += e.name.startswith("cudaGraphLaunch")
        if thrown == THROW_AWAY:
            if ms_by_name is not None:
                ms_by_name.update(by_name)
            return out, names, dev_us / 1e3, host_n - thrown, graph_n
        log(f"  (the tracer showed {thrown} of the {THROW_AWAY} throw-away "
            "kernels that lead a profile: profile discarded, taken again)")
    raise AssertionError(f"{PROFILE_TRIES} profiles in a row were incomplete")


def kernel_counts(names) -> dict:
    """How often each kernel of the port ran, from a profile's device
    events.  "varref_tiled" is K4's grid route, "varref_cluster" its
    cluster route, "gn_bf16" K2's launches with bf16 operands and
    "gn_offset" those of its strip-offset entry (both counted under "gn"
    too)."""
    counts = dict.fromkeys(COUNTED + ("gn_bf16", "gn_offset",
                                      "dis_ref_1d"), 0)
    for name, n in names.items():
        strip = GN_STRIP_RE.search(name) is not None
        one_d = REF_1D_RE.search(name) is not None
        for k, pattern in KERNEL_RE.items():
            if (pattern.search(name) or (k == "gn" and strip)
                    or (k == "dis_ref" and one_d)):
                counts[k] += n
                if k == "gn" and "bfloat16" in name:
                    counts["gn_bf16"] += n
                if k == "gn" and strip:
                    counts["gn_offset"] += n
                if k == "dis_ref" and one_d:
                    counts["dis_ref_1d"] += n
    return counts


def wrapper_counts(reset=False) -> dict:
    """The wrappers' own launch counts (each adds one where it launches
    its kernel, eagerly or into a capture), keyed as kernel_counts."""
    wrappers = kernel_modules()
    counts = {k: m.launches for k, m in wrappers.items()}
    counts["gn_bf16"] = wrappers["gn"].launches_bf16
    counts["gn_offset"] = wrappers["gn"].launches_offset
    counts["dis_ref_1d"] = wrappers["dis_ref"].launches_1d
    counts["varref_cluster"] = wrappers["varref_tiled"].launches_cluster
    counts["varref_tiled"] -= counts["varref_cluster"]
    if reset:
        for m in wrappers.values():
            m.launches = 0
        wrappers["gn"].launches_bf16 = 0
        wrappers["gn"].launches_offset = 0
        wrappers["dis_ref"].launches_1d = 0
        wrappers["varref_tiled"].launches_cluster = 0
    return counts


def counted(name, fn, expect, absent=()):
    """Drive one path from scratch (no cached graph) with the wrappers'
    launch counters from zero, under the profiler; return (result, how
    often each kernel ran on the device in this run).  Every kernel in
    ``expect`` must have been launched by its wrapper and have run on the
    device, and none in ``absent``.  A call that replays a CUDA graph
    calls no wrapper, so the device's count is the one kept: it is read
    from this run's device events by kernel name.  With "gn_bf16" in
    ``expect`` every K2 launch must be a bf16 one, else none.  With
    "fb_merge" in ``expect`` no event of the plain merge's sorted scatter
    (``SORTED_SCATTER``) may run."""
    from flowonthego_tpu_torch.utils import graphs

    def from_scratch():
        graphs.clear()
        wrapper_counts(reset=True)

    out, names, _, _, graph_n = profiled(fn, before=from_scratch)
    wrapped = wrapper_counts()
    counts = kernel_counts(names)
    log(f"{name}: kernels run on the device {counts}; launched by the "
        f"wrappers {wrapped}; graph launches {graph_n}")
    for k in expect:
        assert wrapped[k] > 0 and counts[k] > 0, (name, k, counts, wrapped)
    for k in absent:
        assert wrapped[k] == 0 and counts[k] == 0, (name, k, counts, wrapped)
    assert counts["gn_bf16"] == (counts["gn"] if "gn_bf16" in expect
                                 else 0), (name, counts)
    if "fb_merge" in expect:
        sorted_scatter = {e: c for e, c in names.items()
                          if any(f in e for f in SORTED_SCATTER)}
        assert not sorted_scatter, (name, sorted_scatter)
    return out, counts


def check_shift(flow, shift, border, what):
    inner = flow[border:-border, border:-border].reshape(-1, len(shift))
    med = inner.median(dim=0).values.cpu().numpy()
    log(f"  {what}: median flow {med.tolist()} vs shift {list(shift)}")
    assert np.abs(med - np.asarray(shift)).max() <= SHIFT_TOL, what


# ------------------------------------------------------------------ kernels

# K2 at the op-2 scales with 448 (1024x448, scale 3) and 510 (4K, scale 5)
# patches, cold and warm; at op 4's scale 1 of 1024x448 (ps 12, 128
# iterations, 12,825 patches), warm
GN_SHAPES = ((2, 56, 128, ("cold", "warm")), (2, 68, 120, ("cold", "warm")),
             (4, 224, 512, ("warm",)))
# K2's forms: the patch sizes compiled with the per-value state in
# registers (8 and 12) and two that take the generic form (6 and 10), each
# at C = 1 and 3 with float32 and bf16 operands, on a 56x128 level
GN_FORM_SIZES = (8, 12, 6, 10)
# K2's strip entry: the target cut by (rows, columns) at its top left
STRIP_CUT = (2, 3)


def solve_inputs(dev, op, h, w, g, channels=3, n_frames=1, patch_size=None,
                 shift=(1, 1)):
    """One scale of operating point ``op`` (with another ``patch_size`` if
    given) for ``n_frames`` seeded pairs moving ``shift`` (frame b from
    seed 1 + b): (cfg, grid, {"cold"/"warm": PatchState}, the target
    level [n_frames, Hp, Wp, C]); the warm start is a random coarser
    flow (horizontal only where ``shift`` is)."""
    from flowonthego_tpu_torch import operating_point
    from flowonthego_tpu_torch.ops import dis as dis_mod
    from flowonthego_tpu_torch.ops.patches import (
        PatchGrid, extract_templates_and_hessians)
    from flowonthego_tpu_torch.ops.pyramid import build_pyramid
    from flowonthego_tpu_torch.utils.synth import synthetic_frames
    cfg = operating_point(op)
    if patch_size is not None:
        cfg = dataclasses.replace(cfg, patch_size=patch_size)
    pairs = [synthetic_frames(1 + b, 2, h, w, shift, channels=channels,
                              factor=4) for b in range(n_frames)]
    lvl0, lvl1 = (build_pyramid(torch.as_tensor(
        np.stack([p[k] for p in pairs]), device=dev), 1, cfg.padding)[0]
        for k in (0, 1))
    grid = PatchGrid.create(cfg, w, h)
    cold = dis_mod.init_state(*extract_templates_and_hessians(
        lvl0.image, lvl0.grad_x, lvl0.grad_y, grid, cfg), grid)
    coarse = (torch.randn((n_frames, h // 2, w // 2, 2), generator=g)
              * 2.0).to(dev)
    if shift[1] == 0:
        coarse[..., 1] = 0.0
    states = {"cold": cold,
              "warm": dis_mod.init_from_coarser(cold, coarse, grid)}
    return cfg, grid, states, lvl1.image


def gn_inputs(dev, op, h, w, g, channels=3, n_frames=1, patch_size=None):
    """K2's arguments at one scale (:func:`solve_inputs`): (cfg, grid,
    {"cold"/"warm": positional args}, keyword args)."""
    cfg, grid, states, I1 = solve_inputs(dev, op, h, w, g, channels,
                                         n_frames, patch_size)
    args = {name: (I1, st.templates, st.tgrad_x, st.tgrad_y, st.H,
                   st.mid_org, st.p_cur, st.p_org, ~st.converged)
            for name, st in states.items()}
    kw = dict(n_iters=cfg.grad_descent_iter, padding=grid.padding,
              thresh=cfg.outlier_thresh, l_bound=grid.l_bound,
              ub_w=grid.u_bound_w, ub_h=grid.u_bound_h, mean_on=1.0)
    return cfg, grid, args, kw


def gn_bound_of(args, kw, bf16=False):
    """K2's bound on these inputs: the iterations its patches really run
    (counted by the plain version) and the patches that were started."""
    from flowonthego_tpu_torch.ops.cuda import bounds, dis_gn
    I1, templates = args[0], args[1]
    B, n_h, n_w, ps, _, C = templates.shape
    iters = dis_gn.gn_scale_loop_plain(*args, **dict(kw, bf16=bf16),
                                       count_iters=True)[2]
    live = int(iters.sum())
    b = bounds.gn_bound(B, n_h * n_w, ps, C, I1.shape[1], I1.shape[2],
                        kw["n_iters"], patch_iters=live,
                        n_started=int(args[8].sum()), bf16=bf16)
    return b, live / (iters.numel() * kw["n_iters"])


def varref_inputs(dev, cfg, h, w, g, seed=2, channels=3, n_frames=1):
    """The var-ref loop's planes for flows near (1, 0) on ``n_frames``
    seeded pairs (frame b from seed + b)."""
    from flowonthego_tpu_torch.ops.cuda import varref_fused
    from flowonthego_tpu_torch.utils.synth import synthetic_frames
    pairs = [synthetic_frames(seed + b, 2, h, w, (1, 0), channels=channels,
                              factor=4) for b in range(n_frames)]
    flow = ((torch.randn((n_frames, h, w, 2), generator=g) * 0.3
             + torch.tensor([1.0, 0.0])).to(dev))
    im1, im2 = (torch.as_tensor(np.stack([p[k] for p in pairs]), device=dev)
                for k in (0, 1))
    return varref_fused.warp_and_derivs(flow, im1, im2, cfg)


def varref_forms(h, w, C=3):
    """The forms of the var-ref loop that can take an h x w field of C
    channels: {name: fn(planes, cfg, inner_iter)}.  The grid route takes
    every field and comes first."""
    from flowonthego_tpu_torch.ops.cuda import varref_fused, varref_tiled
    forms = {"K4 grid": lambda P, cfg, n: varref_tiled.refine_inner_tiled(
        *P, cfg, n, route="grid")}
    if varref_tiled.cluster_plan(h, w).fits:
        forms["K4 cluster"] = lambda P, cfg, n: \
            varref_tiled.refine_inner_tiled(*P, cfg, n, route="cluster")
    if varref_fused.fused_plan(h, w, C).fits:
        forms["K3"] = lambda P, cfg, n: varref_fused.refine_inner(*P, cfg, n)
    return forms


def one_cta_cluster(P, cfg, n):
    """K4's cluster entry with a cluster of one CTA, a thread a pixel."""
    from flowonthego_tpu_torch.ops.cuda import varref_fused
    h, w = P[0].shape[1:]
    threads = min(1024, -(-h * w // 32) * 32)
    return varref_fused.launch_loop("fot_varref_cluster", *P, cfg, n,
                                    (1, h, threads))


def assert_forms_agree(outs, h, w):
    """Every form's (uu, vv) equals the grid route's, bit for bit."""
    for name, out in outs.items():
        assert all(torch.equal(a, b)
                   for a, b in zip(out, outs["K4 grid"])), \
            f"{name} differs from K4 grid at {h}x{w}"


def crossover(sizes, a, b):
    """The field size where form a stops being the faster of a and b, by
    linear interpolation between the two sweep points around it (None if
    a is never, or always, the faster)."""
    for k in range(len(sizes) - 1):
        d0, d1 = b[k] - a[k], b[k + 1] - a[k + 1]
        if d0 >= 0 > d1:
            return sizes[k] + (sizes[k + 1] - sizes[k]) * d0 / (d0 - d1)
    return None


def varref_sweep(dev, cfg, g, n_frames, reps, C=3):
    """K3 and both routes of K4 on the sweep's fields: bit-identical where
    more than one can take the field, each timed; the crossovers that the
    resolver's two thresholds stand for."""
    from flowonthego_tpu_torch.ops import variational
    sizes, times = [], {"K3": [], "K4 cluster": [], "K4 grid": []}
    for h, w, level in SWEEP:
        P = varref_inputs(dev, cfg, h, w, g, seed=3, channels=C,
                          n_frames=n_frames)
        forms = varref_forms(h, w, C)
        if h * w <= ONE_CTA_MAX_PIXELS:
            forms["1-CTA cluster"] = one_cta_cluster
        outs = {name: fn(P, cfg, level + 1) for name, fn in forms.items()}
        torch.cuda.synchronize()
        assert_forms_agree(outs, h, w)
        ms = {name: device_ms(lambda: fn(P, cfg, level + 1), reps)
              for name, fn in forms.items()}
        sizes.append(h * w)
        for name in times:
            times[name].append(ms.get(name, float("inf")))
        log(f"  {n_frames} x {h}x{w}x{C} ({h * w} px a field) level {level}: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
            + f"; bit-identical; resolver -> "
            f"{variational.varref_backend_for(cfg, h, w, 'cuda', C)}")
    # K3 against the cluster route on the sizes K3 takes
    n3 = sum(t < float("inf") for t in times["K3"])
    c1 = crossover(sizes[:n3], times["K3"][:n3], times["K4 cluster"][:n3])
    if c1 is None and times["K3"][n3 - 1] <= times["K4 cluster"][n3 - 1]:
        k3 = (f"none: K3 is the faster on every field it takes, up to "
              f"{sizes[n3 - 1]} px")
    else:
        k3 = "none" if c1 is None else f"{round(c1)} px"
    c2 = crossover(sizes, times["K4 cluster"], times["K4 grid"])
    log(f"  crossovers at B={n_frames}, C={C}: K3 | cluster at {k3} "
        f"(FUSED_MAX_PIXELS {variational.FUSED_MAX_PIXELS}), cluster | grid "
        f"at {'none' if c2 is None else round(c2)} px (CLUSTER_MAX_PIXELS "
        f"{variational.CLUSTER_MAX_PIXELS})")


def kernel_phase(dev):
    from flowonthego_tpu_torch import operating_point
    from flowonthego_tpu_torch.ops.cuda import (_build, bounds, dis_gn, pool,
                                                varref_fused, varref_tiled,
                                                warp)

    g = torch.Generator().manual_seed(0)
    results = {}

    log(f"a kernel that does nothing: "
        f"{device_ms(lambda: _build.empty_launch(dev), 200) * 1e3:.2f} us a "
        "launch back to back (CUDA events): the floor under every kernel's "
        "time below")

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
            lib = pool_library(x, C)
            torch.testing.assert_close(lib(), got, **TOL_POOL)
            results["pool"] = kernel_row(
                device_ms(lambda: pool.pool2x2_flat(x, C, bias), 50),
                cuda_ms(lambda: pool.pool2x2_flat_plain(x, C, bias), 20),
                bounds.pool_bound(*shape), library_ms=device_ms(lib, 50))
            line += ", " + timing_text(results["pool"]) + " (avg_pool2d)"
        log(line)
    results["pool"]["max_abs_err"] = max(errs)

    # K2 at GN_SHAPES, at C = 3 and at C = 1 (the gray and gradmag modes);
    # C = 1 draws from g1, so the C = 3 inputs stay as they were.  The
    # bound counts the iterations these inputs' patches really run.
    g1 = torch.Generator().manual_seed(1)
    errs = []
    for C, gen in ((3, g), (1, g1)):
        for op, h, w, names in GN_SHAPES:
            cfg, grid, gn_args, kw = gn_inputs(dev, op, h, w, gen, C)
            for name in names:
                args = gn_args[name]
                p, cost = dis_gn.gn_scale_loop(*args, **kw)
                rp, rcost = dis_gn.gn_scale_loop_plain(*args, **kw)
                torch.cuda.synchronize()
                err, text = check_gn(op, (p, cost), (rp, rcost))
                again = dis_gn.gn_scale_loop(*args, **kw)
                assert (torch.equal(again[0], p)
                        and torch.equal(again[1], cost)), \
                    "K2 differs between two runs"
                line = (f"K2 gn C={C} op {op} {h}x{w} ({grid.n_patches} "
                        f"patches, {cfg.grad_descent_iter} iterations, "
                        f"{name}): {text}; two runs bit-identical")
                if op == 2:
                    errs.append(err)
                if (op, h, name) == (2, 68, "cold") or op == 4:
                    b, live = gn_bound_of(args, kw)
                    row = kernel_row(
                        device_ms(lambda: dis_gn.gn_scale_loop(*args, **kw),
                                  50 if op == 2 else 10),
                        cuda_ms(lambda: dis_gn.gn_scale_loop_plain(
                            *args, **kw), *((10,) if op == 2 else (1, 1))),
                        b)
                    if (op, C) == (2, 3):
                        results["gn"] = row
                    line += (f", {timing_text(row)}; {100 * live:.3g}% of "
                             "the patch-iterations live")
                log(line)
    results["gn"]["max_abs_err"] = max(errs)

    # K2's strip-offset entry on the timed op-4 patches (scale 1 of
    # 1024x448, warm), the target cut by STRIP_CUT rows and columns and
    # the offset mapping the global midpoints into the cut, beside the
    # entry without an offset; its row in the kernels line is measured on
    # the spatial forms' own shard inputs (spatial_phase)
    cfg, grid, gn_args, kw = gn_inputs(dev, 4, 224, 512, g)
    r0, c0 = STRIP_CUT
    args = (gn_args["warm"][0][:, r0:, c0:].contiguous(),) + \
        gn_args["warm"][1:]
    ko = dict(kw, offset=(float(-c0), float(-r0)))
    got = dis_gn.gn_scale_loop(*args, **ko)
    ref = dis_gn.gn_scale_loop_plain(*args, **ko)
    torch.cuda.synchronize()
    err, text = check_gn(4, got, ref)
    b, live = gn_bound_of(args, ko)
    row = kernel_row(
        device_ms(lambda: dis_gn.gn_scale_loop(*args, **ko), 10),
        cuda_ms(lambda: dis_gn.gn_scale_loop_plain(*args, **ko), 1, 1), b,
        max_abs_err=err)
    whole = device_ms(lambda: dis_gn.gn_scale_loop(*gn_args["warm"], **kw),
                      10)
    log(f"K2 gn strip entry op 4 224x512 cut by {STRIP_CUT} ({grid.n_patches}"
        f" patches, warm): {text}, {timing_text(row)}; "
        f"{100 * live:.3g}% of the patch-iterations live; the entry without "
        f"an offset on the whole target, same call: {whole:.4f} ms")

    # K2's compiled and generic forms, float32 and bf16 operands
    for ps in GN_FORM_SIZES:
        for C, gen in ((3, g), (1, g1)):
            cfg, grid, gn_args, kw = gn_inputs(dev, 2, 56, 128, gen, C,
                                               patch_size=ps)
            for bf16 in (False, True):
                kb = dict(kw, bf16=bf16)
                got = dis_gn.gn_scale_loop(*gn_args["warm"], **kb)
                ref = dis_gn.gn_scale_loop_plain(*gn_args["warm"], **kb)
                torch.cuda.synchronize()
                _, text = check_gn(2, got, ref)
                log(f"K2 gn form ps {ps} C={C} "
                    f"{'bf16' if bf16 else 'float32'} ({grid.n_patches} "
                    f"patches, warm): {text}")

    def varref_planes(cfg, h, w, seed=2, C=3):
        return varref_inputs(dev, cfg, h, w, g if C == 3 else g1, seed, C)

    def check_varref(what, run, P, cfg, level):
        uu, vv = run(*P, cfg, level + 1)
        ru, rv = varref_fused.refine_inner_plain(*P, cfg, level + 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(uu, ru, **TOL_VARREF)
        torch.testing.assert_close(vv, rv, **TOL_VARREF)
        err = max(max_err(uu, ru), max_err(vv, rv))
        return err, f"{what}: max_abs_err {err:.3g}"

    def time_varref(run, P, cfg, level, bound, plain_reps):
        return kernel_row(
            device_ms(lambda: run(*P, cfg, level + 1), 20),
            cuda_ms(lambda: varref_fused.refine_inner_plain(
                *P, cfg, level + 1), plain_reps), bound)

    # K3 on the fields it gets on the main paths, the coarsest of 1024x448
    # (14x32, level 5; ops 2-4) and of the 4K stream (17x30, level 7); at
    # C = 3 and C = 1
    cfg = operating_point(2)
    errs = []
    for C in (3, 1):
        for h, w, level in ((14, 32, 5), (17, 30, 7)):
            P = varref_planes(cfg, h, w, C=C)
            err, line = check_varref(f"K3 varref C={C} {h}x{w} level {level}",
                                     varref_fused.refine_inner, P, cfg, level)
            errs.append(err)
            row = time_varref(
                varref_fused.refine_inner, P, cfg, level,
                bounds.varref_fused_bound(1, h, w, C, level + 1,
                                          cfg.var_ref_iter), 5)
            if (C, level) == (3, 5):
                results["varref"] = row
            log(line + ", " + timing_text(row))
    results["varref"]["max_abs_err"] = max(errs)

    # K4's grid route at op-3/op-4 scale 1 and op-4 scale 0 of 1024x448,
    # and its cluster route at scale 4 (28x64; timed) and scale 3 (56x128)
    # of 1024x448 and scale 6 of the 4K stream (34x60), against the plain
    # loop; each timed field on the other route too
    cfg = operating_point(3)

    def tiled(route):
        return lambda *a: varref_tiled.refine_inner_tiled(*a, route=route)

    for key, route, fields, timed in (
            ("varref_tiled", "grid", ((224, 512, 1), (448, 1024, 0)),
             {(448, 1024): 3}),
            ("varref_cluster", "cluster",
             ((28, 64, 4), (34, 60, 6), (56, 128, 3)),
             {(28, 64): 3, (56, 128): 3})):
        other = "cluster" if route == "grid" else "grid"
        errs = []
        for C in (3, 1):
            for h, w, level in fields:
                P = varref_planes(cfg, h, w, C=C)
                err, line = check_varref(
                    f"K4 varref {route} route C={C} {h}x{w} level {level}",
                    tiled(route), P, cfg, level)
                errs.append(err)
                if (h, w) in timed:
                    row = time_varref(
                        tiled(route), P, cfg, level,
                        bounds.varref_tiled_bound(1, h, w, C, level + 1,
                                                  cfg.var_ref_iter),
                        timed[(h, w)])
                    if C == 3 and key not in results:
                        results[key] = row
                    line += ", " + timing_text(row)
                    if varref_tiled.cluster_plan(h, w).fits:
                        ms = device_ms(lambda: tiled(other)(
                            *P, cfg, level + 1), 20)
                        line += f"; {other} route {ms:.4f} ms"
                log(line)
        results[key]["max_abs_err"] = max(errs)
    # the three forms of one loop, bit for bit, on two more fields
    for h, w, level in ((24, 40, 5), (32, 32, 4)):
        P = varref_planes(cfg, h, w)
        outs = {name: fn(P, cfg, level + 1)
                for name, fn in varref_forms(h, w).items()}
        torch.cuda.synchronize()
        assert len(outs) == 3
        assert_forms_agree(outs, h, w)
        log(f"K3, K4 cluster, K4 grid {h}x{w} level {level}: bit-identical")
    # a field of more pixels than K3 has threads: the launch is refused and
    # the wrapper raises (it is never sent to K4)
    P = varref_planes(cfg, 56, 128)
    assert not varref_fused.fused_plan(56, 128, 3).fits
    n0 = varref_fused.launches
    try:
        varref_fused.refine_inner(*P, cfg, 4)
    except RuntimeError as e:
        log(f"K3 on 56x128x3 (does not fit): raises ({e})")
    else:
        raise AssertionError("a K3 launch that cannot fit did not raise")
    assert varref_fused.launches == n0, "a refused launch was counted"
    torch.cuda.synchronize()
    # a field whose rows do not fit a cluster's shared memory: the launch
    # is refused and the wrapper raises (it is never sent to the grid)
    P = varref_planes(cfg, 224, 512)
    n0 = varref_tiled.launches
    try:
        varref_tiled.refine_inner_tiled(*P, cfg, 2, route="cluster")
    except RuntimeError as e:
        log(f"K4 cluster route on 224x512 (does not fit): raises ({e})")
    else:
        raise AssertionError("a cluster launch that cannot fit did not raise")
    assert varref_tiled.launches == n0, "a refused launch was counted"
    torch.cuda.synchronize()

    log("K3, K4 cluster, K4 grid on the paths' field sizes (the resolver's "
        "two thresholds):")
    varref_sweep(dev, cfg, g, 1, 20)
    varref_sweep(dev, cfg, g1, 1, 20, C=1)

    # K5 at op-4 scale 0 of 1024x448 (timed) and a ragged field (w % 4 !=
    # 0, h % 4 != 0); flows of +-(outlier_thresh + 2) px, so border clamps
    # fire; the timed field also on a smooth flow, as the pipeline gives
    bound = cfg.outlier_thresh + 2.0
    for C, gen in ((3, g), (1, g1)):
        for h, w, timed in ((448, 1024, True), (37, 61, False)):
            src = (torch.rand((1, h, w, C), generator=gen) * 255).to(dev)
            wx, wy = (((torch.rand((1, h, w), generator=gen) * 2 - 1)
                       * bound).to(dev) for _ in range(2))
            got, gm = warp.warp_image(src, wx, wy)
            ref, rm = warp.warp_image_plain(src, wx, wy)
            torch.cuda.synchronize()
            assert torch.equal(got, ref) and torch.equal(gm, rm), \
                "K5 not exact"
            line = f"K5 warp {h}x{w}x{C} |flow| <= {bound:g}: bit-exact"
            if timed:
                # the yardstick on flows that stay inside the image, where
                # it is the same function (its coordinates are normalised,
                # so it agrees to a fraction of a grey level, not bit for bit)
                ix, iy = inside_flow(h, w, 1, bound, gen, dev)
                lib = warp_library(src, ix, iy)
                lib_err = max_err(lib(), warp.warp_image(src, ix, iy)[0])
                assert lib_err <= 0.25, lib_err
                row = kernel_row(
                    device_ms(lambda: warp.warp_image(src, wx, wy), 50),
                    cuda_ms(lambda: warp.warp_image_plain(src, wx, wy), 20),
                    bounds.warp_bound(1, h, w, C), 0.0,
                    library_ms=device_ms(lib, 50))
                if C == 3:
                    results["warp"] = row
                line += (f", {timing_text(row)} (grid_sample, the same "
                         f"function only inside the image: max |diff| "
                         f"{lib_err:.3g} there)")
                sx, sy = smooth_flow(h, w, 1, dev)
                got, ref = (f(src, sx, sy) for f in (warp.warp_image,
                                                     warp.warp_image_plain))
                assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
                    "K5 not exact on the smooth flow"
                ms = device_ms(lambda: warp.warp_image(src, sx, sy), 50)
                lib_ms = device_ms(warp_library(src, sx, sy), 50)
                line += (f"; on a smooth flow (two motions + ~0.5 px): "
                         f"bit-exact, kernel {ms:.4f} ms, library call "
                         f"{lib_ms:.4f} ms")
            log(line)
    # K5 on a strided crop of padded frames (what the pipeline hands it),
    # on flows that leave the image by far, and with five channels (the
    # generic form)
    for C, h, w, pad, reach in ((3, 30, 44, 8, 100.0), (1, 17, 30, 4, 1e4),
                                (5, 9, 13, 2, 20.0)):
        padded = (torch.rand((2, h + 2 * pad, w + 2 * pad, C), generator=g)
                  * 255).to(dev)
        src = padded[:, pad:pad + h, pad:pad + w, :]
        wx, wy = (((torch.rand((2, h, w), generator=g) * 2 - 1) * reach)
                  .to(dev) for _ in range(2))
        got = warp.warp_image(src, wx, wy)
        ref = warp.warp_image_plain(src, wx, wy)
        torch.cuda.synchronize()
        assert not src.is_contiguous()
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
            "K5 not exact on a strided crop"
        log(f"K5 warp B=2 {h}x{w}x{C} strided crop, |flow| <= {reach:g} "
            f"({100 * float(1 - got[1].mean()):.3g}% of the samples outside "
            "the image): bit-exact")
    return results


# ------------------------------------------------------------------ glue

# The glue kernels' levels (name, operating point, h, w): op 4's scale 0
# of 1024x448 (timed), op 2's finest and coarsest scales of 1024x448, op
# 1's finest scale of 1024x448 (ps 8, steps 5: the only geometry where
# ps % steps != 0, G2's strided windows and a pixel under patches of
# three steps in G3), the 4K op-2 stream's finest scale (5 of 3840x2176),
# and a 4x8 cut (a field of at most 4 pixels in one direction: a second
# derivative replicates the first derivative's edge, and the pyramid's
# and densify's borders meet)
GLUE_LEVELS = (("op 4 scale 0", 4, 448, 1024), ("op 2 scale 3", 2, 56, 128),
               ("op 2 scale 5", 2, 14, 32), ("op 1 scale 3", 1, 56, 128),
               ("4K op 2 scale 5", 2, 68, 120), ("a 4x8 cut", 2, 4, 8))
# G2 against its plain version: the windows are copies (exact); the
# templates subtract a mean of up to 432 values near 128 summed in another
# order (an ulp of the sum is ~4e-3, 1e-5 of the mean); the Hessians are
# such sums, held within 1e-5 of the largest entry (h01 cancels, so a
# relative bound per entry is too strict), as in the CPU tests against JAX
# G3's chunk-edge shape: op 4 at 448x1030, whose last chunk of patch
# columns ends inside the patches' reach
G3_EDGE_HW = (448, 1030)
GLUE_TEMPLATE_ATOL = 1e-4
GLUE_H_RTOL = 1e-5


def glue_inputs(dev, op, h, w, C, n, seed):
    """(cfg, level [n, h, w, C]) on the card: seeded smooth textures, each
    with a flat block (flat patches, det == 0) and a block of vertical
    stripes (gy == 0 < |gx|: det == 0 where H00 > 0)."""
    from flowonthego_tpu_torch import operating_point
    from flowonthego_tpu_torch.utils.synth import plant_stripes, smooth_texture
    frames = np.stack([smooth_texture(seed + b, h, w, C, factor=4)
                       for b in range(n)])
    frames[:, :max(1, h // 3), :max(1, w // 4)] = 128.0
    plant_stripes(frames)
    return operating_point(op), torch.as_tensor(frames, device=dev)


def glue_phase(dev):
    """G1-G4 against their plain versions on the card at the paths' level
    shapes, C = 3 and 1, one frame and B frames in one launch: G1, G3 and
    G4 bit for bit, G2's windows bit for bit and its templates and
    Hessians within their bars; each timed at op 4's scale 0 of 1024x448
    with its bound.  Returns the rows' numbers (B = 1 and B = 4)."""
    from flowonthego_tpu_torch import operating_point
    from flowonthego_tpu_torch.ops import densify as densify_mod
    from flowonthego_tpu_torch.ops import patches, pyramid
    from flowonthego_tpu_torch.ops.cuda import (bounds, densify, derivs,
                                                extract, level)
    from flowonthego_tpu_torch.ops.dis import PatchState
    from flowonthego_tpu_torch.ops.patches import PatchGrid
    g = torch.Generator().manual_seed(30)
    results = {}
    errs = collections.defaultdict(list)

    def equal(got, ref, what):
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
            f"{what} differs from its plain version"
        return max(max_err(a, b) for a, b in zip(got, ref))

    def rows(key, timed, fn, plain_fn, bound, reps, plain_reps):
        if timed:
            results[key] = kernel_row(device_ms(fn, reps),
                                      cuda_ms(plain_fn, plain_reps), bound)
            return ", " + timing_text(results[key])
        return ""

    for what, op, h, w in GLUE_LEVELS:
        timed = what == GLUE_LEVELS[0][0]
        for C in (3, 1):
            for n in (1, B):
                key = lambda k: k if n == 1 else k + "_b4"   # noqa: E731
                timed_here = timed and C == 3
                cfg, img = glue_inputs(dev, op, h, w, C, n, 30)
                pad, ps = cfg.padding, cfg.patch_size
                shape = f"{n}x{h}x{w}x{C}"
                # G1: the level, and the stream paths' out= form
                lvl = level.pyramid_level(img, pad)
                ref = pyramid.pyramid_level_plain(img, pad)
                buf = pyramid.PyramidLevel(*(torch.zeros_like(x)
                                             for x in ref))
                level.pyramid_level(img, pad, out=buf)
                torch.cuda.synchronize()
                errs[key("level")].append(equal(lvl, ref, f"G1 {what}"))
                equal(buf, ref, f"G1 {what} (out=)")
                line = f"G1 level {what} {shape} pad {pad}: bit-exact"
                line += rows(key("level"), timed_here,
                             lambda: level.pyramid_level(img, pad),
                             lambda: pyramid.pyramid_level_plain(img, pad),
                             bounds.level_bound(n, h, w, C, pad), 50, 10)
                log(line)

                # G2, mean normalisation on and (once) off
                grid = PatchGrid.create(cfg, w, h)
                for mean in ((True, False) if (C, n) == (3, 1) else (True,)):
                    cm = dataclasses.replace(cfg, use_mean_normalization=mean)
                    got = extract.extract_templates_and_hessians(*ref, grid,
                                                                 cm)
                    exp = patches.extract_templates_and_hessians_plain(
                        *ref, grid, cm)
                    torch.cuda.synchronize()
                    equal(got[1:3], exp[1:3], f"G2 {what} windows")
                    torch.testing.assert_close(got[0], exp[0], rtol=0,
                                               atol=GLUE_TEMPLATE_ATOL)
                    H, Hr = got[3], exp[3]
                    torch.testing.assert_close(
                        H, Hr, rtol=GLUE_H_RTOL,
                        atol=GLUE_H_RTOL * float(Hr.abs().max()))
                    # flat patches: h00 == 0, det == 0, both bump
                    flat = Hr[..., 0] <= 1e-10
                    assert torch.equal(H[flat][:, :2], Hr[flat][:, :2]), \
                        f"G2 {what}: the det == 0 decisions differ"
                    # striped patches: h01 == h11 == 0 < h00, det == 0, so
                    # h11 is bumped (a rule on h00 alone would leave it 0)
                    striped = ((Hr[..., 1] == 0) & (Hr[..., 2] <= 1e-10)
                               & (Hr[..., 0] > 1e-10))
                    assert (striped.any() or h < 14) and torch.equal(
                        H[striped][:, 1:], Hr[striped][:, 1:]), \
                        f"G2 {what}: the det == 0 decisions differ (stripes)"
                    err = max_err(got[0], exp[0])
                    errs[key("extract")].append(err)
                    line = (f"G2 extract {what} {shape} ps {ps} steps "
                            f"{grid.steps} ({grid.n_patches} patches a frame"
                            f", mean normalisation {mean}): windows "
                            f"bit-exact, templates max_abs_err {err:.3g}, H "
                            f"max_abs_err {max_err(H, Hr):.3g} (largest "
                            f"{float(Hr.abs().max()):.3g}), "
                            f"{int(flat.sum())} flat and "
                            f"{int(striped.sum())} striped patches bumped "
                            "alike")
                    if mean:
                        line += rows(
                            key("extract"), timed_here,
                            lambda: extract.extract_templates_and_hessians(
                                *ref, grid, cm),
                            lambda: patches.extract_templates_and_hessians_plain(
                                *ref, grid, cm),
                            bounds.extract_bound(n, h + 2 * pad, w + 2 * pad,
                                                 C, grid.n_patches, ps),
                            20, 5)
                    log(line)

                # G3 on seeded patch flows and costs (the clamp at
                # min_errval and large costs both taken), squared and abs
                # weights, and with an fb merge's accumulator
                P = (n, grid.n_h, grid.n_w)
                p_cur = (torch.randn(P + (2,), generator=g) * 3).to(dev)
                cost = (torch.rand(P + (ps, ps, C), generator=g) ** 2
                        * 50).to(dev)
                state = PatchState(p_cur, p_cur, None, None, None, None,
                                   None, None, cost, None)
                merge = torch.cat([torch.rand((n, h, w, 1), generator=g),
                                   torch.randn((n, h, w, 2), generator=g)],
                                  dim=-1).to(dev)
                for weight, m in (("squared", None), ("abs", None),
                                  ("squared", merge)):
                    cw = dataclasses.replace(cfg, densify_weight=weight)
                    got = densify.densify(state, grid, cw, m)
                    exp = densify_mod.densify_plain(state, grid, cw, m)
                    torch.cuda.synchronize()
                    errs[key("densify")].append(
                        equal((got,), (exp,), f"G3 {what} {weight}"))
                plan = densify.densify_plan(grid, n)
                alone, merged = (device_ms(
                    lambda m=m: densify.densify(state, grid, cfg, m), 50)
                    for m in (None, merge))
                line = (f"G3 densify {what} {shape} (bands {plan.n_bands}, "
                        f"chunks {plan.n_chunks} of {plan.nc} columns, "
                        f"{plan.shared_bytes} B shared): squared, abs and "
                        f"with an fb merge bit-exact; device ms {alone:.4f}"
                        f", with the merge {merged:.4f}")
                line += rows(key("densify"), timed_here,
                             lambda: densify.densify(state, grid, cfg),
                             lambda: densify_mod.densify_plain(state, grid,
                                                               cfg),
                             bounds.densify_bound(n, h, w, C, grid.n_patches,
                                                  ps), 50, 10)
                log(line)

                # G4 on the level's crop (a strided view, as the var-ref
                # gets it) and another texture as the warped frame
                im1 = ref.image[:, pad:pad + h, pad:pad + w, :]
                w_im2 = glue_inputs(dev, op, h, w, C, n, 40)[1]
                got = derivs.derivatives(im1, w_im2)
                exp = derivs.derivatives_plain(im1, w_im2)
                torch.cuda.synchronize()
                errs[key("derivs")].append(
                    equal((got,), (exp,), f"G4 {what}"))
                line = f"G4 derivs {what} {shape} (im1 strided): bit-exact"
                line += rows(key("derivs"), timed_here,
                             lambda: derivs.derivatives(im1, w_im2),
                             lambda: derivs.derivatives_plain(im1, w_im2),
                             bounds.derivs_bound(n, h, w, C), 50, 10)
                log(line)
    # G3 where the last chunk ends inside the patches' reach: op 4 at
    # 1030 columns (345 patch columns, chunks of 25)
    h, w = G3_EDGE_HW
    for C in (3, 1):
        for n in (1, B):
            cfg = operating_point(4)
            grid = PatchGrid.create(cfg, w, h)
            plan = densify.densify_plan(grid, n)
            assert grid.n_w % plan.nc and plan.n_chunks > 1, plan
            ps = grid.patch_size
            P = (n, grid.n_h, grid.n_w)
            p_cur = (torch.randn(P + (2,), generator=g) * 3).to(dev)
            cost = (torch.rand(P + (ps, ps, C), generator=g) ** 2
                    * 50).to(dev)
            state = PatchState(p_cur, p_cur, None, None, None, None, None,
                               None, cost, None)
            merge = torch.cat([torch.rand((n, h, w, 1), generator=g),
                               torch.randn((n, h, w, 2), generator=g)],
                              dim=-1).to(dev)
            for m in (None, merge):
                got = densify.densify(state, grid, cfg, m)
                exp = densify_mod.densify_plain(state, grid, cfg, m)
                torch.cuda.synchronize()
                equal((got,), (exp,), "G3 at the chunk edge")
            log(f"G3 densify op 4 {n}x{h}x{w}x{C} ({grid.n_w} patch columns"
                f" in {plan.n_chunks} chunks of {plan.nc}): with and without"
                " an fb merge bit-exact")
    for k, e in errs.items():
        results[k]["max_abs_err"] = max(e)
    return results


# ------------------------------------------------------------------ G5, G6

# G6 at op 2's scale 3 of 1024x448 in the modes that take the
# reference-form solve: (name, config fields)
REF_MODES = (("l1", dict(cost_fn="l1")), ("huber", dict(cost_fn="huber")),
             ("l1 min_iter 4", dict(cost_fn="l1", min_iter=4)),
             ("l2 res_thresh 5", dict(res_thresh=5.0)))
# the merge's pile-up: every patch lands on this cell of op 2's scale 3
PILE_UP_CELL = (64, 20)


def merge_split(fn, reps=5):
    """Device ms a call of G5's sort launches ("bins": every kernel whose
    name holds fb_merge_bin) and of its cell launch, from a profile of
    ``reps`` calls."""
    by_name = {}
    profiled(lambda: [fn() for _ in range(reps)], ms_by_name=by_name)
    split = collections.Counter()
    for name, ms in by_name.items():
        if "fb_merge" in name:
            split["bins" if "fb_merge_bin" in name else "cells"] += ms / reps
    return {k: round(v, 5) for k, v in split.items()}


def merge_calls(fn):
    """The inputs of every G5 call in one eager run of ``fn()``, cloned:
    [(state, grid, cfg, out_h, out_w)]."""
    from flowonthego_tpu_torch.ops.cuda import fb_merge
    calls = []
    launch = fb_merge.fb_merge

    def recorder(state, grid, cfg, out_h, out_w):
        calls.append((state._replace(p_cur=state.p_cur.clone(),
                                     mid_org=state.mid_org.clone(),
                                     cost_px=state.cost_px.clone()),
                      grid, cfg, out_h, out_w))
        return launch(state, grid, cfg, out_h, out_w)

    fb_merge.fb_merge = recorder
    try:
        from flowonthego_tpu_torch.utils import graphs
        with graphs.eager():
            fn()
    finally:
        fb_merge.fb_merge = launch
    return calls


def check_merge(state, grid, cfg, h, w, what):
    """G5 against the plain merge on the card, bit for bit; where the
    card's sorted ``index_put_`` does not fold in order, against the plain
    merge's contributions computed on the card and folded in order on the
    CPU (``index_add_``), bit for bit.  Returns (the accumulator, the
    plain merge's max abs difference from it, the contributions that land,
    text to log)."""
    from flowonthego_tpu_torch.ops import densify as densify_mod
    from flowonthego_tpu_torch.ops.cuda import fb_merge
    got = fb_merge.fb_merge(state, grid, cfg, h, w)
    again = fb_merge.fb_merge(state, grid, cfg, h, w)
    ref = densify_mod.fb_merge_plain(state, grid, cfg, h, w)
    idx, vals = densify_mod.fb_merge_contributions(state, grid, cfg, h, w)
    torch.cuda.synchronize()
    assert torch.equal(again, got), f"G5 {what}: two runs differ"
    B, n = got.shape[0], h * w
    landed = int((idx < B * n).sum())
    if torch.equal(got, ref):
        return got, 0.0, landed, "bit-exact with the plain merge"
    acc = torch.zeros((B * n + 1, 3))
    acc.index_add_(0, idx.cpu(), vals.cpu())
    fold = acc[:B * n].reshape(B, h, w, 3)
    err = max_err(got, ref)
    assert torch.equal(got.cpu(), fold), \
        f"G5 {what}: differs from the in-order fold (index_put_ by {err:.3g})"
    return got, err, landed, ("bit-exact with the in-order fold of the "
                              f"card's contributions; index_put_ differs by "
                              f"{err:.3g}")


def check_ref(got, ref, cfg):
    """G6's state against its plain version's: p within TOL_GN_P, cost_px
    and diff within TOL_GN_COST (compared as x|x| under l1 and huber,
    whose residual has an infinite slope at 0), on all but GN_FLIP_SHARE
    of the patches.  Returns (p max_abs_err, text to log)."""
    def sq(x):
        return x if cfg.cost_fn == "l2" else x * x.abs()

    assert got.converged.all()
    off_p = share_off(got.p_cur, ref.p_cur, **TOL_GN_P)
    off_c = share_off(sq(got.cost_px), sq(ref.cost_px), **TOL_GN_COST)
    off_d = share_off(sq(got.diff), sq(ref.diff), **TOL_GN_COST)
    err = max_err(got.p_cur, ref.p_cur)
    text = (f"p max_abs_err {err:.3g}, cost max_abs_err "
            f"{max_err(got.cost_px, ref.cost_px):.3g}; patches outside "
            f"tolerance: p {off_p:.3g}, cost {off_c:.3g}, diff {off_d:.3g} "
            f"(bound {GN_FLIP_SHARE:g})")
    assert max(off_p, off_c, off_d) <= GN_FLIP_SHARE, text
    return err, text


def merge_solve_phase(dev):
    """G5 and G6 (with its 1-D form) against their plain versions on the
    card: G5 bit for bit on the five merges of the op-2 fb pair and the
    eleven of the op-4 one at 1024x448, the 4K stream's finest scale,
    four frames in one launch,
    every patch outside the frame, every patch piled on one cell and the
    abs weights; G6 within the flip-share rule at op 2's scale 3 in every
    mode that takes it, C = 3 and 1, one frame and four, cold and warm,
    with a strip offset, and at op 4's scales 1 and 0 under huber (scale 0,
    51,300 patches, two runs bit-identical and timed); its 1-D form
    for cam_lr 0 and 1; its generic form (ps 6 and 10, the state in shared
    memory), 2-D and 1-D, l1 and huber, C = 3 and 1.  Each timed with its bound, G5 beside
    ``index_put_`` alone.  Returns the rows' numbers."""
    import flowonthego_tpu_torch as port
    from flowonthego_tpu_torch.models import stereo
    from flowonthego_tpu_torch.ops import densify as densify_mod
    from flowonthego_tpu_torch.ops import dis as dis_mod
    from flowonthego_tpu_torch.ops.cuda import bounds, dis_ref, fb_merge
    from flowonthego_tpu_torch.ops.patches import PatchGrid
    from flowonthego_tpu_torch.utils.synth import synthetic_pair
    g = torch.Generator().manual_seed(50)
    results = {}

    # ---- G5 on the op-2 fb pair's own five merges (timed on the
    # largest), and op 4's eleven, down to its scale 0 (51,300 patches) ----
    gold = np.load(GOLDEN[2])
    seed, shift = int(gold["seed"]), tuple(int(s) for s in gold["shift"])
    pair = tuple(torch.as_tensor(x, device=dev)
                 for x in synthetic_pair(seed, 436, 1024, shift))
    errs, largest = [], {}
    for op, n_merges in ((2, 5), (4, 11)):
        cfg_fb = dataclasses.replace(port.operating_point(op, width=1024),
                                     use_fb_consistency=True)
        calls = merge_calls(lambda: port.compute_flow(*pair, cfg_fb))
        assert len(calls) == n_merges, (op, len(calls))
        for k, (state, grid, cfg, h, w) in enumerate(calls):
            got, err, landed, text = check_merge(state, grid, cfg, h, w,
                                                 f"op {op} fb merge {k}")
            errs.append(err)
            n_all = 4 * grid.n_patches * grid.patch_size ** 2
            log(f"G5 fb_merge op {op} fb pair 1024x448, merge {k}: {h}x{w}, "
                f"{grid.n_patches} patches, {n_all} contributions, "
                f"{n_all - landed} dropped: {text}")
            if op not in largest or landed > largest[op][-1]:
                largest[op] = (state, grid, cfg, h, w, landed)
    for op, key, reps in ((2, "fb_merge", 50), (4, "fb_merge_op4", 20)):
        state, grid, cfg, h, w, landed = largest[op]
        C = state.cost_px.shape[-1]
        idx, vals = densify_mod.fb_merge_contributions(state, grid, cfg, h,
                                                       w)
        acc = torch.zeros((h * w + 1, 3), device=dev)
        run = lambda: fb_merge.fb_merge(state, grid, cfg, h, w)  # noqa
        results[key] = kernel_row(
            device_ms(run, reps),
            cuda_ms(lambda: densify_mod.fb_merge_plain(state, grid, cfg, h,
                                                       w), 10 // (op - 1)),
            bounds.fb_merge_bound(1, grid.n_patches, grid.patch_size, C, h,
                                  w, landed),
            library_ms=device_ms(
                lambda: acc.index_put_((idx,), vals, accumulate=True),
                20 // (op - 1)))
        plan = fb_merge.merge_plan(1, grid.n_patches, grid.patch_size, h, w)
        log(f"G5 fb_merge timed on op {op}'s largest merge ({h}x{w}, "
            f"{grid.n_patches} patches, {landed} contributions land; "
            f"{plan.n_chunks} sort chunks, {plan.passes} radix passes, "
            f"{plan.tiles_x}x{plan.tiles_y} tiles): "
            f"{timing_text(results[key])} (index_put_ alone, on the plain "
            "merge's indices and values); device ms by launch: "
            f"{merge_split(run)}")

    # ---- G5 on seeded states: the 4K finest scale, a batch of four, all
    # outside, a pile-up, the abs weights ----
    def seeded(op, h, w, n, C=3):
        cfg = port.operating_point(op)
        grid = PatchGrid.create(cfg, w, h)
        lead = (n, grid.n_h, grid.n_w)
        ps = grid.patch_size
        mid = torch.as_tensor(np.stack(grid.midpoints(), -1),
                              dtype=torch.float32, device=dev)
        p = (torch.randn(lead + (2,), generator=g) * 3).to(dev)
        cost = (torch.rand(lead + (ps, ps, C), generator=g) ** 2
                * 50).to(dev)
        st = dis_mod.PatchState(p, p, mid[None].expand(lead + (2,)), None,
                                None, None, None, None, cost, None)
        return cfg, grid, st

    big = results["fb_merge"]
    for what, op, h, w, n, change in (
            ("4K op 2 scale 5", 2, 68, 120, 1, None),
            (f"op 2 scale 3, B={B}", 2, 56, 128, B, None),
            ("op 2 scale 3, every patch outside", 2, 56, 128, 2, "outside"),
            ("op 2 scale 3, every patch on one cell", 2, 56, 128, 2,
             "pile-up"),
            ("op 2 scale 3, abs weights", 2, 56, 128, 1, "abs"),
            ("op 2 scale 3, C=1", 2, 56, 128, 2, "gray"),
            ("op 4 scale 2, every patch on one cell (windows of patches)",
             4, 112, 256, 1, "pile-up"),
            ("op 4 scale 4, a warp a cell", 4, 28, 64, 2, None),
            ("op 4 scale 4, every patch on one cell (a warp's list walk)",
             4, 28, 64, 1, "pile-up")):
        cfg, grid, st = seeded(op, h, w, n, 1 if change == "gray" else 3)
        if change == "outside":
            st = st._replace(p_cur=st.p_cur + 1e4)
        elif change == "pile-up":
            cell = torch.tensor(PILE_UP_CELL if op == 2 else (w / 2, h / 3),
                                dtype=torch.float32, device=dev)
            frac = torch.rand(st.p_cur.shape, generator=g).to(dev) - 0.5
            st = st._replace(p_cur=(cell - st.mid_org) + frac)
        elif change == "abs":
            cfg = dataclasses.replace(cfg, densify_weight="abs")
        got, err, landed, text = check_merge(st, grid, cfg, h, w, what)
        errs.append(err)
        if change == "outside":
            assert landed == 0 and not got.any(), what
        log(f"G5 fb_merge {what} ({n}x{h}x{w}, {grid.n_patches} patches a "
            f"frame, {landed} contributions land): {text}")
        if change == "pile-up":
            ms = device_ms(lambda: fb_merge.fb_merge(st, grid, cfg, h, w),
                           5)
            log(f"  the pile-up's time: {ms:.4f} ms (spread: "
                f"{big['ms']:.4f} ms)")
    results["fb_merge_op4"]["max_abs_err"] = max(errs)
    big["max_abs_err"] = max(errs)

    # ---- G6 at op 2's scale 3, every mode, C = 3 and 1, B = 1 and 4 ----
    errs = []
    for C in (3, 1):
        for n in (1, B):
            cfg0, grid, states, I1 = solve_inputs(dev, 2, 56, 128, g, C, n)
            for mode, fields in REF_MODES:
                cfg = dataclasses.replace(cfg0, **fields)
                for start, st in states.items():
                    got = dis_ref.optimize_reference(st, I1, grid, cfg)
                    again = dis_ref.optimize_reference(st, I1, grid, cfg)
                    ref = dis_mod.optimize_reference_plain(st, I1, grid, cfg)
                    torch.cuda.synchronize()
                    assert all(torch.equal(a, b) for a, b in
                               zip(got, again)), "G6 differs between runs"
                    err, text = check_ref(got, ref, cfg)
                    errs.append(err)
                    log(f"G6 dis_ref op 2 {n}x56x128x{C} ({grid.n_patches} "
                        f"patches a frame, {start}) {mode}: {text}; two "
                        "runs bit-identical")
                    if (C, n, mode, start) == (3, 1, "huber", "warm"):
                        timed = (st, I1, grid, cfg)
    st, I1, grid, cfg = timed
    ref, trips = dis_mod.optimize_reference_plain(st, I1, grid, cfg,
                                                  count_iters=True)
    b = bounds.ref_bound(1, grid.n_patches, grid.patch_size, 3,
                         I1.shape[1], I1.shape[2], int(trips.sum()),
                         int((~st.converged).sum()), cfg.cost_fn)
    results["dis_ref"] = kernel_row(
        device_ms(lambda: dis_ref.optimize_reference(st, I1, grid, cfg), 50),
        cuda_ms(lambda: dis_mod.optimize_reference_plain(st, I1, grid, cfg),
                5), b)
    log(f"G6 dis_ref timed at op 2 56x128x3 huber warm ({int(trips.sum())} "
        f"trips): {timing_text(results['dis_ref'])}")
    # the strip offset: the target cut by STRIP_CUT, as K2's strip entry
    r0, c0 = STRIP_CUT
    cut = I1[:, r0:, c0:].contiguous()
    off = (float(-c0), float(-r0))
    got = dis_ref.optimize_reference(st, cut, grid, cfg, off)
    ref = dis_mod.optimize_reference_plain(st, cut, grid, cfg, off)
    torch.cuda.synchronize()
    err, text = check_ref(got, ref, cfg)
    errs.append(err)
    log(f"G6 dis_ref op 2 56x128x3 huber warm, target cut by {STRIP_CUT}, "
        f"offset {off}: {text}")
    # a block of the grid's rows, as a spatial form's shard solves it: the
    # block's patches, the global grid's box, the cut target and offset
    blk = dis_mod.PatchState(*(x[:, 4:9] for x in st))
    got = dis_mod.optimize_reference(blk, cut, grid, cfg, off)
    ref = dis_mod.optimize_reference_plain(blk, cut, grid, cfg, off)
    torch.cuda.synchronize()
    err, text = check_ref(got, ref, cfg)
    errs.append(err)
    log(f"G6 dis_ref op 2 huber warm, grid rows 4-8 of {grid.n_h} as a "
        f"block, the same offset: {text}")
    # op 4's scale 1 under huber: 12,825 patches, 128 trips
    cfg0, grid, states, I1 = solve_inputs(dev, 4, 224, 512, g)
    cfg = dataclasses.replace(cfg0, cost_fn="huber")
    st = states["warm"]
    got = dis_ref.optimize_reference(st, I1, grid, cfg)
    ref, trips = dis_mod.optimize_reference_plain(st, I1, grid, cfg,
                                                  count_iters=True)
    torch.cuda.synchronize()
    _, text = check_ref(got, ref, cfg)
    b4 = bounds.ref_bound(1, grid.n_patches, 12, 3, I1.shape[1], I1.shape[2],
                          int(trips.sum()), int((~st.converged).sum()),
                          "huber")
    row4 = kernel_row(
        device_ms(lambda: dis_ref.optimize_reference(st, I1, grid, cfg), 5),
        cuda_ms(lambda: dis_mod.optimize_reference_plain(st, I1, grid, cfg),
                1, 1), b4)
    log(f"G6 dis_ref op 4 224x512x3 huber warm ({grid.n_patches} patches, "
        f"{int(trips.sum())} trips): {text}; {timing_text(row4)}")
    # op 4's scale 0 under huber (448x1024, 51,300 patches): the largest
    # solve an op-4 huber pair launches, the kernels line's own row
    cfg0, grid, states, I1 = solve_inputs(dev, 4, 448, 1024, g)
    cfg = dataclasses.replace(cfg0, cost_fn="huber")
    st = states["warm"]
    got = dis_ref.optimize_reference(st, I1, grid, cfg)
    again = dis_ref.optimize_reference(st, I1, grid, cfg)
    ref, trips = dis_mod.optimize_reference_plain(st, I1, grid, cfg,
                                                  count_iters=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again)), \
        "G6 differs between runs at op 4's scale 0"
    err, text = check_ref(got, ref, cfg)
    errs.append(err)
    b0 = bounds.ref_bound(1, grid.n_patches, 12, 3, I1.shape[1], I1.shape[2],
                          int(trips.sum()), int((~st.converged).sum()),
                          "huber")
    results["dis_ref_op4"] = kernel_row(
        device_ms(lambda: dis_ref.optimize_reference(st, I1, grid, cfg), 5),
        cuda_ms(lambda: dis_mod.optimize_reference_plain(st, I1, grid, cfg),
                1, 1), b0)
    log(f"G6 dis_ref op 4 448x1024x3 huber warm ({grid.n_patches} patches, "
        f"{int(trips.sum())} trips): {text}; two runs bit-identical; "
        f"{timing_text(results['dis_ref_op4'])}")
    results["dis_ref"]["max_abs_err"] = max(errs)
    results["dis_ref_op4"]["max_abs_err"] = max(errs)

    # ---- G6's 1-D form (stereo), cam_lr 0 and 1 ----
    errs = []
    for cam_lr, C, n in ((0, 3, 1), (0, 1, B), (1, 3, 1), (1, 1, 1)):
        sx = DEPTH_SHIFT[0] if cam_lr == 0 else -DEPTH_SHIFT[0]
        cfg0, grid, states, I1 = solve_inputs(dev, 2, 56, 128, g, C, n,
                                              shift=(sx // 8, 0))
        cfg = dataclasses.replace(cfg0, use_var_ref=False)
        for start, st in states.items():
            got = dis_ref.optimize_1d(st, I1, grid, cfg, cam_lr)
            ref = stereo.optimize_1d_plain(st, I1, grid, cfg, cam_lr)
            torch.cuda.synchronize()
            assert (got.p_cur[..., 1] == 0).all()
            err, text = check_ref(got, ref, cfg)
            errs.append(err)
            log(f"G6 dis_ref 1-D op 2 {n}x56x128x{C} cam_lr {cam_lr} "
                f"({start}): {text}")
            if (cam_lr, C, n, start) == (0, 3, 1, "warm"):
                timed = (st, I1, grid, cfg)
    st, I1, grid, cfg = timed
    ref, trips = stereo.optimize_1d_plain(st, I1, grid, cfg, 0,
                                          count_iters=True)
    b = bounds.ref_bound(1, grid.n_patches, grid.patch_size, 3,
                         I1.shape[1], I1.shape[2], int(trips.sum()),
                         int((~st.converged).sum()), cfg.cost_fn, one_d=True)
    results["dis_ref_1d"] = kernel_row(
        device_ms(lambda: dis_ref.optimize_1d(st, I1, grid, cfg, 0), 50),
        cuda_ms(lambda: stereo.optimize_1d_plain(st, I1, grid, cfg, 0), 5),
        b, max_abs_err=max(errs))
    log(f"G6 dis_ref 1-D timed at op 2 56x128x3 cam_lr 0 warm "
        f"({int(trips.sum())} trips): {timing_text(results['dis_ref_1d'])}")

    # ---- G6's generic form: the patch sizes other than 8 and 12 (K2's
    # generic sizes in GN_FORM_SIZES), 2-D and 1-D, l1 and huber ----
    for ps in (6, 10):
        for C in (3, 1):
            for one_d in (False, True):
                shift = (DEPTH_SHIFT[0] // 8, 0) if one_d else (1, 1)
                cfg0, grid, states, I1 = solve_inputs(
                    dev, 2, 56, 128, g, C, patch_size=ps, shift=shift)
                for cost_fn in ("l1", "huber"):
                    cfg = dataclasses.replace(cfg0, cost_fn=cost_fn)
                    for start, st in states.items():
                        if one_d:
                            got = dis_ref.optimize_1d(st, I1, grid, cfg, 0)
                            ref = stereo.optimize_1d_plain(st, I1, grid, cfg,
                                                           0)
                        else:
                            got = dis_ref.optimize_reference(st, I1, grid,
                                                             cfg)
                            ref = dis_mod.optimize_reference_plain(
                                st, I1, grid, cfg)
                        torch.cuda.synchronize()
                        err, text = check_ref(got, ref, cfg)
                        row = results["dis_ref_1d" if one_d else "dis_ref"]
                        row["max_abs_err"] = max(row["max_abs_err"], err)
                        log(f"G6 dis_ref generic form ps {ps} "
                            f"{'1-D ' if one_d else ''}op 2 56x128x{C} "
                            f"({grid.n_patches} patches, {start}) "
                            f"{cost_fn}: {text}")
    return results


# ------------------------------------------------------------------ batch

B = 4            # frames of a batch, streams of a MultiStream
BATCH_LEVEL0 = (448, 1024)   # level 0 of a 1024x436 batch: K1, K4, K5
# K2 on a batch: op 2's finest scale of 1024x448 (448 patches a frame) and
# op 4's scale 1 (12,825 patches a frame, 128 iterations)
GN_SHAPES_B = ((2, 56, 128, ("cold", "warm")), (4, 224, 512, ("warm",)))
# K2's bf16 operand mode: op 2 at 4K scale 5 (510 patches), op 4 scale 1
GN_SHAPES_BF16 = ((2, 68, 120, ("cold", "warm")), (4, 224, 512, ("warm",)))


def frames_equal(batch_out, single_fn, inputs, what):
    """Each frame of a batched launch's outputs equals its own launch on
    that frame alone, bit for bit; returns the time of the B single
    launches (CUDA events)."""
    for b in range(B):
        one = single_fn(*(x[b:b + 1] for x in inputs))
        for x, y in zip(batch_out, one):
            assert torch.equal(x[b], y[0]), f"{what}: frame {b} differs"
    return device_ms(lambda: [single_fn(*(x[b:b + 1] for x in inputs))
                              for b in range(B)], 10)


def batch_kernel_phase(dev):
    """K1-K5 on batches of B frames against their plain versions and
    against one launch per frame, and K2's bf16 kernel against its plain
    version and against the float32 kernel; returns the rows' numbers."""
    from flowonthego_tpu_torch import operating_point
    from flowonthego_tpu_torch.ops.cuda import (bounds, dis_gn, pool,
                                                varref_fused, varref_tiled,
                                                warp)
    g = torch.Generator().manual_seed(10)
    results = {}

    # K1: level 0 of a batch at 1024x448, the frames stacked as rows
    H0, W0 = BATCH_LEVEL0
    x = (torch.rand((B * H0, W0 * 3), generator=g) * 255).to(dev)
    got = pool.pool2x2_flat(x, 3)
    ref = pool.pool2x2_flat_plain(x, 3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **TOL_POOL)
    frames = x.reshape(B, H0, W0 * 3)
    single = frames_equal((got.reshape(B, H0 // 2, W0 * 3 // 2),),
                          lambda f: (pool.pool2x2_flat(f[0], 3)[None],),
                          (frames,), "K1 batch")
    lib = pool_library(x, 3)
    torch.testing.assert_close(lib(), got, **TOL_POOL)
    results["pool_b4"] = kernel_row(
        device_ms(lambda: pool.pool2x2_flat(x, 3), 50),
        cuda_ms(lambda: pool.pool2x2_flat_plain(x, 3), 20),
        bounds.pool_bound(*x.shape), max_err(got, ref),
        library_ms=device_ms(lib, 50))
    log(f"K1 pool B={B} {tuple(x.shape)}: max_abs_err "
        f"{results['pool_b4']['max_abs_err']:.3g}, frames bit-identical to "
        f"single launches; {timing_text(results['pool_b4'])} (avg_pool2d), "
        f"{B} single launches {single:.4f} ms")

    # K2 on the batch
    errs = []
    for op, h, w, names in GN_SHAPES_B:
        cfg, grid, gn_args, kw = gn_inputs(dev, op, h, w, g, n_frames=B)
        for name in names:
            args = gn_args[name]
            got = dis_gn.gn_scale_loop(*args, **kw)
            ref = dis_gn.gn_scale_loop_plain(*args, **kw)
            torch.cuda.synchronize()
            err, text = check_gn(op, got, ref)
            line = (f"K2 gn B={B} op {op} {h}x{w} ({B} x {grid.n_patches} "
                    f"patches, {name}): {text}")
            single = frames_equal(
                got, lambda *a: dis_gn.gn_scale_loop(*a, **kw), args,
                f"K2 batch op {op} {name}")
            line += "; frames bit-identical to single launches"
            if op == 2:
                errs.append(err)
            if name == ("cold" if op == 2 else "warm"):
                b, live = gn_bound_of(args, kw)
                row = kernel_row(
                    device_ms(lambda: dis_gn.gn_scale_loop(*args, **kw),
                              20 if op == 2 else 3),
                    cuda_ms(lambda: dis_gn.gn_scale_loop_plain(*args, **kw),
                            5 if op == 2 else 1, 1), b)
                if op == 2:
                    results["gn_b4"] = row
                line += (f"; {timing_text(row)}, {B} single launches "
                         f"{single:.4f} ms; {100 * live:.3g}% of the "
                         "patch-iterations live")
            log(line)
    results["gn_b4"]["max_abs_err"] = max(errs)

    # K2's bf16 operand kernel (one frame) against the plain version on
    # the same bf16-rounded operands, and timed against the float32 kernel
    errs = []
    for op, h, w, names in GN_SHAPES_BF16:
        cfg, grid, gn_args, kw = gn_inputs(dev, op, h, w, g)
        kb = dict(kw, bf16=True)
        for name in names:
            args = gn_args[name]
            n0 = dis_gn.launches_bf16
            got = dis_gn.gn_scale_loop(*args, **kb)
            assert dis_gn.launches_bf16 == n0 + 1
            ref = dis_gn.gn_scale_loop_plain(*args, **kb)
            torch.cuda.synchronize()
            err, text = check_gn(op, got, ref)
            f32 = dis_gn.gn_scale_loop(*args, **kw)
            line = (f"K2 gn bf16 op {op} {h}x{w} ({grid.n_patches} patches, "
                    f"{name}): {text}; p vs the float32 kernel "
                    f"{max_err(got[0], f32[0]):.3g} px")
            if op == 2:
                errs.append(err)
            if name == ("cold" if op == 2 else "warm"):
                reps = 50 if op == 2 else 10
                b, live = gn_bound_of(args, kw, bf16=True)
                row = kernel_row(
                    device_ms(lambda: dis_gn.gn_scale_loop(*args, **kb), reps),
                    cuda_ms(lambda: dis_gn.gn_scale_loop_plain(*args, **kb),
                            10 if op == 2 else 1, 1), b)
                ms32 = device_ms(lambda: dis_gn.gn_scale_loop(*args, **kw),
                                 reps)
                if op == 2:
                    results["gn_bf16"] = row
                line += (f"; bf16 (its wrapper's rounding launches included)"
                         f" {timing_text(row)}; float32 kernel {ms32:.4f} ms")
            log(line)
    results["gn_bf16"]["max_abs_err"] = max(errs)

    # K3 (one CTA per field), K4's cluster route (one cluster per field)
    # and its grid route (one launch over the batch) on the batch's
    # coarsest field, its scale-4 field and op 4's level 0 at 1024x448
    def tiled(route):
        return lambda *a: varref_tiled.refine_inner_tiled(*a, route=route)

    for key, what, run, bound_fn, cfg, h, w, level in (
            ("varref_b4", "K3", varref_fused.refine_inner,
             bounds.varref_fused_bound, operating_point(2), 14, 32, 5),
            ("varref_cluster_b4", "K4 cluster route", tiled("cluster"),
             bounds.varref_tiled_bound, operating_point(2), 28, 64, 4),
            ("varref_tiled_b4", "K4 grid route", tiled("grid"),
             bounds.varref_tiled_bound, operating_point(4), H0, W0, 0)):
        P = varref_inputs(dev, cfg, h, w, g, n_frames=B)
        uu, vv = run(*P, cfg, level + 1)
        ru, rv = varref_fused.refine_inner_plain(*P, cfg, level + 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(uu, ru, **TOL_VARREF)
        torch.testing.assert_close(vv, rv, **TOL_VARREF)
        single = frames_equal((uu, vv), lambda *a: run(*a, cfg, level + 1),
                              P, f"{key} batch")
        results[key] = kernel_row(
            device_ms(lambda: run(*P, cfg, level + 1), 20),
            cuda_ms(lambda: varref_fused.refine_inner_plain(
                *P, cfg, level + 1), 2, 1),
            bound_fn(B, h, w, 3, level + 1, cfg.var_ref_iter),
            max(max_err(uu, ru), max_err(vv, rv)))
        log(f"{what} varref B={B} {h}x{w} level {level}: max_abs_err "
            f"{results[key]['max_abs_err']:.3g}, frames bit-identical to "
            f"single launches; {timing_text(results[key])}, {B} single "
            f"launches {single:.4f} ms")

    # K5 at level 0 of the batch, flows of +-(outlier_thresh + 2) px
    bound = operating_point(3).outlier_thresh + 2.0
    src = (torch.rand((B, H0, W0, 3), generator=g) * 255).to(dev)
    wx, wy = (((torch.rand((B, H0, W0), generator=g) * 2 - 1) * bound)
              .to(dev) for _ in range(2))
    got = warp.warp_image(src, wx, wy)
    ref = warp.warp_image_plain(src, wx, wy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, ref)), "K5 not exact"
    single = frames_equal(got, warp.warp_image, (src, wx, wy), "K5 batch")
    ix, iy = inside_flow(H0, W0, B, bound, g, dev)
    lib = warp_library(src, ix, iy)
    lib_err = max_err(lib(), warp.warp_image(src, ix, iy)[0])
    assert lib_err <= 0.25, lib_err
    results["warp_b4"] = kernel_row(
        device_ms(lambda: warp.warp_image(src, wx, wy), 50),
        cuda_ms(lambda: warp.warp_image_plain(src, wx, wy), 20),
        bounds.warp_bound(B, H0, W0, 3), 0.0, library_ms=device_ms(lib, 50))
    sx, sy = smooth_flow(H0, W0, B, dev)
    assert all(torch.equal(a, b) for a, b in zip(
        warp.warp_image(src, sx, sy), warp.warp_image_plain(src, sx, sy))), \
        "K5 not exact on the smooth flow"
    ms = device_ms(lambda: warp.warp_image(src, sx, sy), 50)
    lib_ms = device_ms(warp_library(src, sx, sy), 50)
    log(f"K5 warp B={B} {H0}x{W0}x3: bit-exact, frames bit-identical to "
        f"single launches; {timing_text(results['warp_b4'])} (grid_sample, "
        f"inside the image), {B} single launches {single:.4f} ms; on a "
        f"smooth flow: bit-exact, kernel {ms:.4f} ms, library call "
        f"{lib_ms:.4f} ms")

    log(f"K3, K4 cluster, K4 grid at B={B} on the paths' field sizes:")
    varref_sweep(dev, operating_point(3), g, B, 10)
    return results


# ------------------------------------------------------------------ slice

def slice_phase(dev):
    import flowonthego_tpu_torch as port
    from flowonthego_tpu_torch.config import pad_to_divisible
    from flowonthego_tpu_torch.models.dis_flow import dis_flow_padded
    from flowonthego_tpu_torch.ops.pyramid import pad_replicate
    from flowonthego_tpu_torch.utils.synth import (synthetic_frames,
                                                   synthetic_pair,
                                                   synthetic_split_pair)

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

    def pair_thrice(cfg, pair):
        """One eager call (which records the path) and two replays."""
        return [port.compute_flow(*pair, cfg) for _ in range(3)][-1]

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
    # numpy frames and no device: the entry points run on the card
    host_pair = synthetic_pair(seed, 436, 1024, shift)
    for what, out in (
            ("compute_flow", port.compute_flow(*host_pair, cfg[2])),
            ("stream_flow", next(iter(port.stream_flow(
                [f.cpu().numpy() for f in frames_op3[:2]], cfg[3],
                fetch=False))))):
        assert out.device.type == "cuda", (what, out.device)
        log(f"{what} on numpy frames with no device: ran on {out.device}")
    assert torch.equal(port.compute_flow(*host_pair, cfg[2]),
                       port.compute_flow(i0, i1, cfg[2]))

    # (the runs are profiled to count what ran on the device; the times
    # are taken afterwards, unprofiled)
    pair2, n_pair2 = counted("op 2 compute_flow 1024x436 x3",
                             lambda: pair_thrice(cfg[2], (i0, i1)), ALL)
    flows_4k, n_4k = counted(
        "op 2 stream_flow 4K, twice",
        lambda: [run_stream(frames_4k, cfg_4k) for _ in range(2)][-1], ALL)
    pair4, n_pair4 = counted("op 4 compute_flow 1024x436 x3",
                             lambda: pair_thrice(cfg[4], (i0, i1)), ALL)
    pair4s, n_pair4s = counted(
        f"op 4 compute_flow 1024x436 shift {SMALL_SHIFT} x3",
        lambda: pair_thrice(cfg[4], small), ALL)
    flows_op3, n_op3 = counted(
        "op 3 stream_flow 1024x448, twice",
        lambda: [run_stream(frames_op3, cfg[3]) for _ in range(2)][-1], ALL)
    pair1, n_pair1 = counted("op 1 compute_flow 1024x436 x3",
                             lambda: pair_thrice(cfg[1], (i0, i1)),
                             NO_VARREF, VARREF)
    ms2 = timed_pair(cfg[2], 10, (i0, i1))[1]
    ms4 = timed_pair(cfg[4], 3, (i0, i1))[1]
    ms4s = timed_pair(cfg[4], 3, small)[1]
    ms1 = timed_pair(cfg[1], 10, (i0, i1))[1]
    ms_4k = timed_stream(frames_4k, cfg_4k)[1]
    ms_op3 = timed_stream(frames_op3, cfg[3])[1]
    # the pair whose halves move differently, once at op 2 and at op 4
    s0, s1, split_field, split_known = synthetic_split_pair(
        seed, 436, 1024, *SPLIT_SHIFTS)
    split = tuple(torch.as_tensor(x, device=dev) for x in (s0, s1))
    split_flows, n_split = {}, []
    for op in (2, 4):
        split_flows[op], n = counted(
            f"op {op} compute_flow 1024x436, halves moving {SPLIT_SHIFTS}",
            lambda: port.compute_flow(*split, cfg[op]), ALL)
        n_split.append(n)
    launches = {k: sum(n[k] for n in (n_pair2, n_4k, n_pair4, n_pair4s,
                                      n_op3, n_pair1, *n_split))
                for k in n_pair1}

    # ---- checks: finite, known motion, plain path, JAX goldens ----
    for op, pair, motion, flow, ms, reps in (
            (2, (i0, i1), shift, pair2, ms2, 1),
            (4, (i0, i1), shift, pair4, ms4, 1),
            (4, small, SMALL_SHIFT, pair4s, ms4s, 1),
            (1, (i0, i1), shift, pair1, ms1, 1)):
        what = f"op {op} pair {motion}"
        assert flow.shape == (436, 1024, 2) and torch.isfinite(flow).all()
        log(f"compute_flow {what} 1024x436: {ms:.3f} ms/pair (kernels, "
            "captured, device-resident pair, host clock to sync)")
        check_shift(flow, motion, 16, f"{what} vs known shift")
        ref, ms_plain = timed_pair(plain(cfg[op]), reps, pair)
        log(f"compute_flow {what} 1024x436 plain path: {ms_plain:.3f} "
            "ms/pair")
        flow_band(flow, ref, f"{what} kernels vs plain path")
    known = torch.as_tensor(split_known, device=dev)
    truth = torch.as_tensor(split_field, device=dev)
    seam = 1024 // 2
    reach = max(abs(v) for sh in SPLIT_SHIFTS for v in sh)
    for op, flow in split_flows.items():
        what = f"op {op} split pair {SPLIT_SHIFTS}"
        assert flow.shape == (436, 1024, 2) and torch.isfinite(flow).all()
        ref = port.compute_flow(*split, plain(cfg[op]))
        flow_band(flow, ref, f"{what} kernels vs plain path")
        # each half away from the seam and the border, against its motion
        for side, cols, motion in (
                ("left", slice(16, seam - 2 * reach), SPLIT_SHIFTS[0]),
                ("right", slice(seam + reach, 1024 - 16), SPLIT_SHIFTS[1])):
            part = flow[16:-16, cols].reshape(-1, 2)
            med = part.median(dim=0).values.cpu().numpy()
            log(f"  {what}: {side} half median flow {med.tolist()} vs "
                f"{list(motion)}")
            assert np.abs(med - np.asarray(motion)).max() <= SHIFT_TOL, what
        epe = torch.linalg.vector_norm(flow - truth, dim=-1)[known]
        log(f"  {what}: mean EPE vs the known field {float(epe.mean()):.3g} "
            f"px over the {100 * float(known.float().mean()):.3g}% of the "
            "pixels where it is known")
    for op in (2, 3):
        fin = dis_flow_padded(i0p[None], i1p[None], cfg[op])[0]
        flow_band(fin, torch.as_tensor(golden[op]["flow"], device=dev),
                  f"op {op} 1024x448 finest flow vs JAX golden")
    g = np.load(GOLDEN_SPLIT)
    assert int(g["seed"]) == seed
    assert tuple(map(tuple, g["shift"].tolist())) == SPLIT_SHIFTS
    fin = dis_flow_padded(pad_replicate(split[0], pads)[None],
                          pad_replicate(split[1], pads)[None], cfg[2])[0]
    flow_band(fin, torch.as_tensor(g["flow"], device=dev),
              "op 2 split pair 1024x448 finest flow vs JAX golden")
    for what, flow in (("the card", fin),
                       ("JAX", torch.as_tensor(g["flow"]))):
        left = flow[2:-2, 2:seam // 8 - 4].reshape(-1, 2) * 8.0
        log(f"  op 2 split pair, left half median on {what}: "
            f"{left.median(dim=0).values.tolist()} (motion "
            f"{list(SPLIT_SHIFTS[0])})")
    for what, (name, fields) in GOLDEN_MODES.items():
        g = np.load(os.path.join(REPO, "tests", "data", name))
        assert int(g["seed"]) == seed and tuple(g["shift"]) == shift
        fin = dis_flow_padded(i0p[None], i1p[None],
                              dataclasses.replace(cfg[2], **fields))[0]
        flow_band(fin, torch.as_tensor(g["flow"], device=dev),
                  f"op 2 {what} 1024x448 finest flow vs JAX golden")

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


# ------------------------------------------------------------------ batch paths

# The batch's pairs at 1024x436: frame b from seed BATCH_SEED + b, moving
# BATCH_SHIFTS[b] (multiples of 8 px, 2^finest_scale at op 2, so every
# processed level moves whole pixels); the streams move the same way.
BATCH_SEED = 20
BATCH_HW = (436, 1024)
BATCH_SHIFTS = ((16, 8), (-8, 8), (8, -16), (-16, -8))
BATCH_OPS = (2, 4)
BATCH_TOL = 1e-5    # a batched frame vs its single-pair flow (px)
MOTION_TOL = 1e-3   # a batched frame's median vs its motion (px)
STREAM_FRAMES = 4   # frames per MultiStream stream
VIDEO = (9, 4)      # stream_video_chunks: frames, chunks
# bf16 flow vs the float32 flow (px, mean / p99): a sanity bound well
# below the motion.  bf16 keeps 8 significant bits, so grey levels near 200
# round by up to 0.5; the JAX package's own test bounds its bf16 patch
# solve at max 0.5 px on a small scene.
BF16_MEAN, BF16_P99 = 0.1, 1.0
BF16_RUNS = ((2, "pair"), (4, "pair"), (4, "small"))


def batch_phase(dev):
    """The batched entry points at 1024x436 and the bf16 solve, each
    path with the counters from zero; returns (launches of the batched
    paths, bf16 launches of the bf16 paths)."""
    import flowonthego_tpu_torch as port
    from flowonthego_tpu_torch.config import pad_to_divisible
    from flowonthego_tpu_torch.ops.pyramid import pad_replicate
    from flowonthego_tpu_torch.utils.synth import (synthetic_frames,
                                                   synthetic_pair)
    h, w = BATCH_HW
    launches = dict.fromkeys(ALL, 0)

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    def total(counts):
        return sum(counts[k] for k in launches)

    def inner_median(flow, border=16):
        inner = flow[border:-border, border:-border].reshape(-1, 2)
        return inner.median(dim=0).values.cpu().numpy()

    pairs = [tuple(torch.as_tensor(x, device=dev)
                   for x in synthetic_pair(BATCH_SEED + b, h, w, s))
             for b, s in enumerate(BATCH_SHIFTS)]
    for op in BATCH_OPS:
        cfg = port.operating_point(op, width=w)
        pads = pad_to_divisible(w, h, cfg.coarsest_scale)
        pt, pl = pads[0], pads[2]
        I0, I1 = (torch.stack([pad_replicate(p[k], pads) for p in pairs])
                  for k in (0, 1))
        flows, n_batch = counted(f"op {op} batched_flow B={B} "
                                 f"{tuple(I0.shape)}",
                                 lambda: port.batched_flow(I0, I1, cfg),
                                 ALL)
        _, n_single = counted(f"op {op} compute_flow, frame 0 alone",
                              lambda: port.compute_flow(*pairs[0], cfg),
                              ALL)
        assert n_batch == n_single, \
            f"op {op}: the batch did not launch each kernel once per scale"
        add(n_batch)
        assert flows.shape == (B,) + tuple(I0.shape[1:3]) + (2,)
        assert torch.isfinite(flows).all()
        flows = flows[:, pt:pt + h, pl:pl + w]
        for b, (pair, motion) in enumerate(zip(pairs, BATCH_SHIFTS)):
            single = port.compute_flow(*pair, cfg)
            err = max_err(flows[b], single)
            med = inner_median(flows[b])
            off = float(np.abs(med - np.asarray(motion)).max())
            log(f"  op {op} batch frame {b} {motion}: max |batch - "
                f"compute_flow| {err:.3g} px (bound {BATCH_TOL:g}); median "
                f"{med.tolist()}, {off:.3g} px off (bound {MOTION_TOL:g})")
            assert err <= BATCH_TOL and off <= MOTION_TOL, (op, b)
        reps = 5 if op == 2 else 2
        ms = host_ms(lambda: port.batched_flow(I0, I1, cfg), reps)
        ms_single = host_ms(lambda: [port.compute_flow(*p, cfg)
                                     for p in pairs], reps)
        log(f"op {op} batched_flow B={B} {h}x{w}: {ms:.3f} ms/batch, "
            f"{ms / B:.3f} ms/frame, {total(n_batch)} kernel launches/batch;"
            f" {B} compute_flow calls: {ms_single:.3f} ms, "
            f"{ms_single / B:.3f} ms/frame, {B * total(n_single)} kernel "
            "launches (host clock to sync, device-resident pairs)")

    # MultiStream: B streams x STREAM_FRAMES frames, op 2, against
    # stream_flow on each stream's frames
    cfg = port.operating_point(2, width=w)
    pads = pad_to_divisible(w, h, cfg.coarsest_scale)
    pt, pl = pads[0], pads[2]
    videos = [torch.stack([pad_replicate(torch.as_tensor(f, device=dev), pads)
                           for f in synthetic_frames(BATCH_SEED + k,
                                                     STREAM_FRAMES, h, w, s)])
              for k, s in enumerate(BATCH_SHIFTS)]
    Hp, Wp = videos[0].shape[1:3]

    def run_streams():
        ms = port.MultiStream(cfg, Hp, Wp, n_streams=B, device=dev)
        ms.start(torch.stack([v[0] for v in videos]))
        return [ms.push(torch.stack([v[t] for v in videos]))
                for t in range(1, STREAM_FRAMES)]

    ticks, n_ms = counted(f"MultiStream {B} streams x {STREAM_FRAMES} "
                          f"frames op 2 ({Hp}x{Wp})", run_streams, ALL)
    _, n_sf = counted("stream_flow, stream 0 alone",
                      lambda: list(port.stream_flow(videos[0], cfg,
                                                    fetch=False)), ALL)
    assert n_ms == n_sf, "MultiStream did not launch once per scale a tick"
    add(n_ms)
    for k, (v, motion) in enumerate(zip(videos, BATCH_SHIFTS)):
        want = list(port.stream_flow(v, cfg, fetch=False))
        err = max(max_err(t[k], f) for t, f in zip(ticks, want))
        log(f"  stream {k} {motion}: max |MultiStream - stream_flow| "
            f"{err:.3g} px over {len(want)} pairs (bound {BATCH_TOL:g})")
        assert err <= BATCH_TOL, k
        for t in ticks:
            check_shift(t[k, pt:pt + h, pl:pl + w], motion, 16,
                        f"stream {k} tick vs known shift")
    stream = port.MultiStream(cfg, Hp, Wp, n_streams=B, device=dev)
    feed = ping_pong([torch.stack([v[t] for v in videos])
                      for t in range(STREAM_FRAMES)])
    stream.start(next(feed))
    stream.push(next(feed))         # the first tick records the path
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(6):
        stream.push(next(feed))
    torch.cuda.synchronize()
    tick = (time.perf_counter() - t0) * 1e3 / 6
    stream.close()
    seq = host_ms(lambda: [list(port.stream_flow(v, cfg, fetch=False))
                           for v in videos], 1) / (STREAM_FRAMES - 1)
    log(f"MultiStream op 2 {B} streams: {tick:.3f} ms/tick, "
        f"{tick / B:.3f} ms/frame, {total(n_ms) // (STREAM_FRAMES - 1)} "
        f"kernel launches/tick; {B} stream_flow loops: {seq:.3f} ms per "
        "frame of every stream (host clock to sync)")

    # stream_video_chunks: one video as B chunks
    n_frames, n_chunks = VIDEO
    motion = BATCH_SHIFTS[0]
    video = torch.stack([pad_replicate(torch.as_tensor(f, device=dev), pads)
                         for f in synthetic_frames(BATCH_SEED + 9, n_frames,
                                                   h, w, motion)])
    out, n_chunks_run = counted(
        f"stream_video_chunks {n_frames} frames as {n_chunks} chunks",
        lambda: port.stream_video_chunks(video, cfg, n_chunks, dev),
        ALL)
    add(n_chunks_run)
    assert out.shape == (n_frames - 1, Hp, Wp, 2)
    starts = [k * (n_frames - 1) // n_chunks for k in range(n_chunks + 1)]
    err = 0.0
    for k in range(n_chunks):
        lo, hi = starts[k], starts[k + 1]
        for p, f in zip(range(lo, hi), port.stream_flow(video[lo:hi + 1], cfg,
                                                        fetch=False)):
            err = max(err, max_err(torch.as_tensor(out[p], device=dev), f))
    log(f"  stream_video_chunks: max |chunk - stream_flow over the chunk| "
        f"{err:.3g} px (bound {BATCH_TOL:g})")
    assert err <= BATCH_TOL
    for p in range(n_frames - 1):
        check_shift(torch.as_tensor(out[p, pt:pt + h, pl:pl + w]), motion,
                    16, f"chunked video pair {p} vs known shift")

    # bf16 operand mode: the flow against the float32 flow
    g = np.load(GOLDEN[2])
    seed, shift = int(g["seed"]), tuple(int(x) for x in g["shift"])
    inputs = {"pair": (shift, synthetic_pair(seed, h, w, shift)),
              "small": (SMALL_SHIFT, synthetic_pair(seed, h, w, SMALL_SHIFT))}
    bf16 = 0
    for op, which in BF16_RUNS:
        motion, pair = inputs[which]
        pair = tuple(torch.as_tensor(x, device=dev) for x in pair)
        cfg = port.operating_point(op, width=w)
        bf = dataclasses.replace(cfg, dtype="bfloat16")
        flow, counts = counted(f"op {op} bf16 compute_flow {motion}",
                               lambda: port.compute_flow(*pair, bf),
                               ALL + ("gn_bf16",))
        bf16 += counts["gn_bf16"]
        ref = port.compute_flow(*pair, cfg)
        epe = torch.linalg.vector_norm(flow.double() - ref.double(), dim=-1)
        mean = float(epe.mean())
        p99 = float(torch.quantile(epe.flatten()[::7], 0.99))
        check_shift(flow, motion, 16, f"op {op} bf16 {motion} vs known shift")
        ms = host_ms(lambda: port.compute_flow(*pair, bf), 3)
        ms32 = host_ms(lambda: port.compute_flow(*pair, cfg), 3)
        log(f"  op {op} bf16 vs float32 flow {motion}: mean EPE {mean:.3g} "
            f"px, p99 {p99:.3g} px (bounds {BF16_MEAN:g} / {BF16_P99:g}); "
            f"{ms:.3f} ms/pair bf16, {ms32:.3f} ms/pair float32")
        assert mean <= BF16_MEAN and p99 <= BF16_P99, (op, which)
    return launches, bf16


# ------------------------------------------------------------------ CLI

def cli_phase(dev):
    """The command line at full width on the golden pair, written as PPM
    files; returns the launches of its runs."""
    import tempfile

    from flowonthego_tpu_torch import cli, load_image, read_flo, read_pfm
    from flowonthego_tpu_torch.io.images import save_image
    from flowonthego_tpu_torch.utils.synth import synthetic_pair

    g = np.load(GOLDEN[2])
    seed, shift = int(g["seed"]), tuple(int(s) for s in g["shift"])
    launches = dict.fromkeys(COUNTED + ("dis_ref_1d",), 0)
    with tempfile.TemporaryDirectory() as d:
        pairs = {}
        for tag, motion in (("flow", shift), ("depth", DEPTH_SHIFT)):
            pairs[tag] = [os.path.join(d, f"{k}_{tag}.ppm") for k in "ab"]
            for path, img in zip(pairs[tag],
                                 synthetic_pair(seed, 436, 1024, motion)):
                save_image(path, img)
        log(f"CLI inputs: 1024x436 uint8 PPM pairs moving {shift} and "
            f"{DEPTH_SHIFT} px")

        def check(out, what, motion):
            res = read_pfm(out) if out.endswith(".pfm") else read_flo(out)
            res = torch.as_tensor(res)
            shape = (436, 1024) + ((2,) if len(motion) == 2 else ())
            assert tuple(res.shape) == shape, (what, tuple(res.shape))
            assert torch.isfinite(res).all(), what
            check_shift(res, motion, 16, f"{what} vs known motion")
            return res

        # as a user runs it, in a process of its own
        out, viz = os.path.join(d, "op2.flo"), os.path.join(d, "op2.ppm")
        argv = [sys.executable, "-m", "flowonthego_tpu_torch",
                *pairs["flow"], out, "2", "--viz", viz]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                              timeout=600)
        ms = (time.perf_counter() - t0) * 1e3
        log(f"python -m flowonthego_tpu_torch ... 2 --viz: rc "
            f"{proc.returncode}, {ms:.1f} ms for the process; it printed:")
        for line in (proc.stdout + proc.stderr).splitlines():
            log("  " + line)
        assert proc.returncode == 0, "python -m flowonthego_tpu_torch failed"
        check(out, "CLI op 2 (process)", shift)
        assert load_image(viz).shape == (436, 1024, 3)

        def timed_run(cmd):
            t0 = time.perf_counter()
            rc = cli.run(cmd)
            return rc, (time.perf_counter() - t0) * 1e3

        fb_first = None
        for name, args, expect, absent in CLI_RUNS:
            depth = "depth" in args
            suffix = ".pfm" if depth else ".flo"
            motion = DEPTH_SHIFT[:1] if depth else shift
            src = pairs["depth" if depth else "flow"]
            cmd = cli.parse_command(
                src + [os.path.join(d, name.replace(" ", "_") + suffix)]
                + args)
            rc, counts = counted(f"CLI {name}", lambda: cli.run(cmd), expect,
                                 absent)
            assert rc == 0, name
            rc, ms = timed_run(cmd)
            assert rc == 0, name
            for k in launches:
                launches[k] += counts[k]
            got = check(cmd.out, f"CLI {name}", motion)
            if depth:
                assert (got <= 0).all(), "disparity not sign-clamped"
            ref_cmd = dataclasses.replace(
                cmd, out=os.path.join(d, "plain" + suffix),
                overrides=dict(cmd.overrides, gn_backend="xla",
                               varref_backend="xla"))
            rc, plain_ms = timed_run(ref_cmd)
            assert rc == 0, name
            ref = check(ref_cmd.out, f"CLI {name} plain path", motion)
            if depth:
                got, ref = (torch.stack([x, torch.zeros_like(x)], -1)
                            for x in (got, ref))
            flow_band(got, ref, f"CLI {name} kernels vs plain path")
            log(f"CLI {name}: {ms:.3f} ms/call with the kernels, "
                f"{plain_ms:.3f} ms/call on the plain path (host clock, "
                "from reading the PPMs to writing the output)")
            if name == "fb":
                fb_first = got
        # the forward-backward merge is deterministic on the card
        cmd = cli.parse_command(pairs["flow"]
                                + [os.path.join(d, "fb_again.flo"), "2",
                                   "--fb"])
        rc, counts = counted("CLI fb again", lambda: cli.run(cmd), FB)
        for k in launches:
            launches[k] += counts[k]
        again = torch.as_tensor(read_flo(cmd.out))
        assert rc == 0 and torch.equal(again, fb_first), \
            "--fb flow differs between two runs"
        log("CLI fb: two runs bit-identical")
    return launches

# ------------------------------------------------------------------ graphs

GRAPH_TRIALS = 3     # trials of the chained timing (the median is kept)


def chained_ms(fn, n):
    """(host wall ms, CUDA-event ms, host enqueue ms) per call of ``fn``:
    ``n`` calls queued back to back, ending in a sync; the enqueue time is
    the host's up to its last call's return; medians of GRAPH_TRIALS."""
    walls, events, enqueues = [], [], []
    for _ in range(GRAPH_TRIALS):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        enqueues.append((time.perf_counter() - t0) * 1e3 / n)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / n)
        events.append(start.elapsed_time(end) / n)
    return tuple(float(np.median(x)) for x in (walls, events, enqueues))


def launch_profile(fn, n):
    """Per call of ``fn`` over ``n`` profiled calls: (Counter of device
    events by name, device ms, the host's launch calls, of which graph
    launches).  The tracer can lose an event anywhere in a profile, not
    only where the canary looks: a profile whose counts do not divide by
    ``n`` is taken again, and fails only if every try is so."""
    for _ in range(PROFILE_TRIES):
        _, names, dev_ms, host_n, graph_n = profiled(
            lambda: [fn() for _ in range(n)])
        uneven = {k: c for k, c in names.items() if c % n}
        if not uneven:
            break
        log(f"  device events not a multiple of the {n} calls: {uneven} "
            "(profile taken again)")
    assert not uneven, "the calls of one path ran different device events"
    per_call = collections.Counter({k: c // n for k, c in names.items()})
    return per_call, dev_ms / n, host_n / n, graph_n / n


def ping_pong(frames):
    """Frames 0, 1, ..., n-1, n-2, ..., 1, 0, 1, ... without end: every
    consecutive pair moves by plus or minus the stream's motion."""
    import itertools
    order = list(range(len(frames))) + list(range(len(frames) - 2, 0, -1))
    return (frames[k] for k in itertools.cycle(order))


def graph_phase(dev):
    """The captured paths against the eager ones; returns the launches of
    the captured runs."""
    import flowonthego_tpu_torch as port
    from flowonthego_tpu_torch.config import pad_to_divisible
    from flowonthego_tpu_torch.ops.pyramid import pad_replicate
    from flowonthego_tpu_torch.utils import graphs
    from flowonthego_tpu_torch.utils.synth import (synthetic_frames,
                                                   synthetic_pair)
    launches = dict.fromkeys(COUNTED + ("dis_ref_1d",), 0)
    log("captured and eager entries (utils/graphs.ENTRIES):")
    log(graphs.table())

    def memory(what):
        st = port.device_memory_stats()["cuda:0"]
        log(f"  allocator, {what}: {st['bytes_in_use'] / 2**20:.1f} MiB in "
            f"use, peak {st['peak_bytes_in_use'] / 2**20:.1f} MiB, limit "
            f"{st['bytes_limit'] / 2**20:.0f} MiB")
        return st

    def report(name, eager_fn, captured_fn, n, copies, per=1):
        """Profile and time both forms of one path; ``per`` frames a call.
        A captured call must be one graph launch that runs the eager
        call's device events, each as often, and ``copies`` device-to-
        device copies more (a stateless path's inputs into the graph's
        tensors, any path's result out of them)."""
        rows = {}
        for form, fn in (("eager", eager_fn), ("captured", captured_fn)):
            wall, event, enqueue = chained_ms(fn, n)
            names, dev_ms, host_n, graph_n = launch_profile(fn, min(n, 5))
            rows[form] = (names, graph_n)
            log(f"  {name} {form}: {wall:.3f} ms wall, {event:.3f} ms "
                f"between events, {enqueue:.3f} ms of host enqueue per call "
                f"({wall / per:.3f} wall a frame); "
                f"device {dev_ms:.3f} ms in {sum(names.values())} events, "
                f"{100 * dev_ms / wall:.1f}% busy; host launch calls "
                f"{host_n:.0f}, of them graph launches {graph_n:.0f}; "
                f"kernels {kernel_counts(names)}")
        (eager_names, eager_graphs), (names, graph_n) = (rows["eager"],
                                                         rows["captured"])
        assert graph_n == 1, \
            f"{name}: a captured call must be one graph launch"
        assert eager_graphs == 0
        more, fewer = names - eager_names, eager_names - names
        log(f"  {name}: device events of a captured call beyond the eager "
            f"call's {dict(more)}, missing from it {dict(fewer)}")
        assert kernel_counts(names) == kernel_counts(eager_names), \
            f"{name}: the graph does not run the eager call's kernels"
        assert not fewer and more == {COPY: copies}, \
            f"{name}: captured and eager device events differ"

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    # ---- stateless paths: compute_flow and batched_flow ----
    g = np.load(GOLDEN[2])
    seed, shift = int(g["seed"]), tuple(int(x) for x in g["shift"])
    h, w = BATCH_HW
    pair = tuple(torch.as_tensor(x, device=dev)
                 for x in synthetic_pair(seed, h, w, shift))
    small = tuple(torch.as_tensor(x, device=dev)
                  for x in synthetic_pair(seed, h, w, SMALL_SHIFT))
    cfg2 = port.operating_point(2, width=w)
    cfg4 = port.operating_point(4, width=w)
    fb = dataclasses.replace(cfg2, use_fb_consistency=True)
    fb4 = dataclasses.replace(cfg4, use_fb_consistency=True)
    huber = dataclasses.replace(cfg2, cost_fn="huber")
    depth = dataclasses.replace(cfg2, use_var_ref=False)
    stereo = tuple(torch.as_tensor(x, device=dev)
                   for x in synthetic_pair(seed, h, w, DEPTH_SHIFT))

    def as_flow(x):     # a disparity map as a flow with v = 0
        return x if x.dim() == 3 else torch.stack([x, torch.zeros_like(x)],
                                                  dim=-1)

    pads = pad_to_divisible(w, h, cfg2.coarsest_scale)
    pairs = [tuple(torch.as_tensor(x, device=dev)
                   for x in synthetic_pair(BATCH_SEED + b, h, w, s))
             for b, s in enumerate(BATCH_SHIFTS)]
    I0, I1 = (torch.stack([pad_replicate(p[k], pads) for p in pairs])
              for k in (0, 1))
    graphs.clear()
    plain_only = ("fb_merge", "dis_ref")
    # (name, call, calls timed, frames a call, kernels that must run and
    # must not, the call on the plain path to hold it against or None)
    for name, fn, n, per, expect, absent, plain_fn in (
            ("op 2 compute_flow 1024x436",
             lambda: port.compute_flow(*pair, cfg2), 10, 1, ALL,
             plain_only, None),
            (f"op 4 compute_flow 1024x436 {SMALL_SHIFT}",
             lambda: port.compute_flow(*small, cfg4), 5, 1, ALL,
             plain_only, None),
            ("op 2 fb compute_flow 1024x436",
             lambda: port.compute_flow(*pair, fb), 10, 1, FB, ("dis_ref",),
             lambda: port.compute_flow(*pair, plain(fb))),
            ("op 4 fb compute_flow 1024x436",
             lambda: port.compute_flow(*pair, fb4), 5, 1, FB, ("dis_ref",),
             None),
            ("op 2 huber compute_flow 1024x436",
             lambda: port.compute_flow(*pair, huber), 10, 1, REF,
             ("gn", "fb_merge"),
             lambda: port.compute_flow(*pair, plain(huber))),
            (f"op 2 depth compute_disparity 1024x436 {DEPTH_SHIFT}",
             lambda: port.compute_disparity(*stereo, depth), 10, 1, DEPTH,
             VARREF + ("gn", "fb_merge"),
             lambda: port.compute_disparity(*stereo, plain(depth))),
            (f"op 2 batched_flow B={B}",
             lambda: port.batched_flow(I0, I1, cfg2), 10, B, ALL,
             plain_only, None)):
        def eager_fn(fn=fn):
            with graphs.eager():
                return fn()
        # launched one by one, the device runs what the wrappers count
        ref, names = profiled(
            eager_fn, before=lambda: wrapper_counts(reset=True))[:2]
        assert kernel_counts(names) == wrapper_counts(), \
            f"{name}: the wrappers' counts differ from the device's"
        got, counts = counted(f"{name}, 3 calls (eager and recorded, then "
                              "two replays)",
                              lambda: [fn() for _ in range(3)], expect,
                              absent)
        if plain_fn is not None:
            flow_band(as_flow(ref), as_flow(plain_fn()),
                      f"{name} kernels vs plain path")
        add(counts)
        assert all(torch.equal(x, ref) for x in got), \
            f"{name}: captured differs from eager"
        assert len({x.data_ptr() for x in got}) == 3, f"{name}: flows alias"
        graphs.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        log(f"{name}: captured == eager bit for bit, 3 calls, no two flows "
            f"share memory; a path's first call (the eager run and the "
            f"recording) {(time.perf_counter() - t0) * 1e3:.1f} ms")
        report(name, eager_fn, fn, n, 3, per)
    log(f"cached paths (entry, replays): {graphs.cached_paths()}")

    # ---- streams: two alternating graphs over the carried state ----
    cfg4k = port.operating_point(2, width=STREAM_4K[1])
    cfg3 = port.operating_point(3, width=STREAM_OP3[1])
    for name, stream, cfg, seed_s, n in (
            ("op 2 stream 3840x2160", STREAM_4K, cfg4k, 7, 10),
            ("op 3 stream 1024x436", STREAM_OP3, cfg3, 5, 10)):
        sh, sw, factor, motion, n_frames = stream
        spads = pad_to_divisible(sw, sh, cfg.coarsest_scale)
        frames = [pad_replicate(torch.as_tensor(f, device=dev), spads)
                  for f in synthetic_frames(seed_s, n_frames, sh, sw, motion,
                                            factor=factor)]
        big = sw > 2000
        if big:
            graphs.clear()
            torch.cuda.reset_peak_memory_stats()
            before = memory(f"before the {name} capture")
        with graphs.eager():
            ref = list(port.stream_flow(frames, cfg, fetch=False))
        got, counts = counted(
            f"{name}, {n_frames} frames, twice",
            lambda: [list(port.stream_flow(frames, cfg, fetch=False))
                     for _ in range(2)], ALL)
        add(counts)
        for run in got:
            assert all(torch.equal(a, b) for a, b in zip(run, ref)), \
                f"{name}: captured differs from eager"
        first = got[1][0].clone()
        assert torch.equal(first, ref[0])      # held across two more steps
        log(f"{name}: captured == eager bit for bit over {len(ref)} pairs, "
            "twice (the second stream on the cached path); a flow held "
            "across later steps is unchanged")
        if big:
            after = memory(f"after the {name} capture (two graphs, one "
                           "pool, and the flows held)")
            log(f"  the capture's share: "
                f"{(after['bytes_in_use'] - before['bytes_in_use']) / 2**20:.1f}"
                " MiB")
        with graphs.eager():
            eager_stream = port.stream_flow(ping_pong(frames), cfg,
                                            fetch=False)
            next(eager_stream)
        captured_stream = port.stream_flow(ping_pong(frames), cfg,
                                           fetch=False)
        next(captured_stream)
        # both forms run the same step on fixed tensors; the captured one
        # copies the flow out of the graph's tensor
        report(name, lambda: next(eager_stream),
               lambda: next(captured_stream), n, 1)
        eager_stream.close()
        captured_stream.close()
        if big:
            graphs.clear()
            memory("after graphs.clear()")

    # ---- a MultiStream tick of B streams ----
    videos = [torch.stack([pad_replicate(torch.as_tensor(f, device=dev), pads)
                           for f in synthetic_frames(BATCH_SEED + k,
                                                     STREAM_FRAMES, h, w, s)])
              for k, s in enumerate(BATCH_SHIFTS)]
    Hp, Wp = videos[0].shape[1:3]
    batches = [torch.stack([v[t] for v in videos])
               for t in range(STREAM_FRAMES)]

    def ticks(n_ticks):
        ms = port.MultiStream(cfg2, Hp, Wp, n_streams=B, device=dev)
        feed = ping_pong(batches)
        ms.start(next(feed))
        out = [ms.push(next(feed)) for _ in range(n_ticks)]
        ms.close()
        return out

    with graphs.eager():
        ref = ticks(5)
    got, counts = counted(f"MultiStream {B} streams, 5 ticks, captured",
                          lambda: ticks(5), ALL)
    add(counts)
    assert all(torch.equal(a, b) for a, b in zip(got, ref)), \
        "MultiStream: captured differs from eager"
    assert len({x.data_ptr() for x in got}) == 5
    log(f"MultiStream op 2 {B} streams: captured == eager bit for bit over "
        "5 ticks, no two ticks share memory")
    streams = {}
    for form in ("eager", "captured"):
        with (graphs.eager() if form == "eager"
              else contextlib.nullcontext()):
            ms = port.MultiStream(cfg2, Hp, Wp, n_streams=B, device=dev)
            feed = ping_pong(batches)
            ms.start(next(feed))
            ms.push(next(feed))
        streams[form] = (ms, feed)

    def tick(form):
        ms, feed = streams[form]
        return lambda: ms.push(next(feed))

    report(f"MultiStream op 2 tick of {B}", tick("eager"), tick("captured"),
           10, 1, B)
    for ms, _ in streams.values():
        ms.close()
    log(f"cached paths (entry, replays): {graphs.cached_paths()}")
    return launches


# ------------------------------------------------------------------ native

def native_phase(dev):
    """The native I/O library, if this machine can build it."""
    import tempfile

    import flowonthego_tpu_torch as port
    from flowonthego_tpu_torch.io import native

    t0 = time.perf_counter()
    if not native.ensure_built():
        log("native: unavailable (the Python twins serve; FrameStream "
            "raises); the compiler said:")
        for line in native.build_log.splitlines()[:12]:
            log("  " + line)
        assert native.get_lib() is None
        try:
            native.FrameStream([])
        except RuntimeError as e:
            log(f"  FrameStream: raises ({e})")
        else:
            raise AssertionError("FrameStream without a library did not raise")
        return
    log(f"native: built ({native.variant}) in "
        f"{time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(native.library_path(native.variant), REPO)}")
    if native.variant != "full":
        log("  this host lacks libpng or libjpeg, so the build leaves the "
            "PNG and JPEG decoders out; the full build said:")
        for line in native.build_log.splitlines()[:8]:
            log("    " + line[:300])
    assert native.get_lib() is not None
    cfg = port.operating_point(2, width=1024)
    frames = native_frames()
    with tempfile.TemporaryDirectory() as d:
        flow = np.random.default_rng(0).standard_normal(
            (436, 1024, 2)).astype(np.float32) * 4
        a, b = os.path.join(d, "a.flo"), os.path.join(d, "b.flo")
        native.write_flo_native(a, flow)
        port.write_flo(b, flow)
        assert open(a, "rb").read() == open(b, "rb").read()
        assert np.array_equal(native.read_flo_native(a), flow)
        assert np.array_equal(port.read_flo(a), flow)
        log("native .flo: written bytes equal the Python writer's, read back "
            "bit for bit by both readers")
        paths = []
        for k, f in enumerate(frames):
            paths.append(os.path.join(d, f"frame_{k:03d}.ppm"))
            port.save_image(paths[-1], f)
        loaded = [port.load_image(p) for p in paths]
        for p, img in zip(paths, loaded):
            assert np.array_equal(native.load_image_native(p), img)
        log(f"native PPM decode: {len(paths)} frames 1024x448 equal "
            "load_image")
        color = native.flow_to_color_native(flow)
        twin = port.flow_to_color(flow)
        diff = np.abs(color.astype(int) - twin.astype(int))
        log(f"native colour wheel vs flow_to_color: max |diff| {diff.max()} "
            f"grey level, {100 * float((diff == 0).mean()):.2f}% of the "
            "bytes equal (bound 1 level, 97%: float32 against float64 cut to "
            "a byte)")
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.97
        want = list(port.stream_flow(loaded, cfg, fetch=False))
        stream = native.FrameStream(paths, max_pixels=448 * 1024)
        t0 = time.perf_counter()
        got = list(port.stream_flow(stream, cfg, fetch=False))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(got)
        stream.close()
        assert len(got) == len(want) == len(paths) - 1
        for x, y in zip(got, want):
            assert x.device.type == "cuda" and torch.equal(x, y)
            check_shift(x, (8, 8), 32, "FrameStream pair vs known shift")
        log(f"stream_flow(FrameStream({len(paths)} PPM frames)) == "
            f"stream_flow(loaded frames) bit for bit, on {got[0].device}; "
            f"{ms:.3f} ms/frame from file to flow (host clock)")


# ------------------------------------------------------------------ devices

def device_list_phase(dev):
    """The data-parallel forms on a mesh of this one card."""
    import flowonthego_tpu_torch as port
    from flowonthego_tpu_torch.config import pad_to_divisible
    from flowonthego_tpu_torch.ops.pyramid import pad_replicate
    from flowonthego_tpu_torch.utils.synth import synthetic_frames
    h, w = BATCH_HW
    cfg = port.operating_point(2, width=w)
    pads = pad_to_divisible(w, h, cfg.coarsest_scale)
    videos = [torch.stack([pad_replicate(torch.as_tensor(f, device=dev), pads)
                           for f in synthetic_frames(BATCH_SEED + k, 3, h, w,
                                                     s)])
              for k, s in enumerate(BATCH_SHIFTS)]
    batches = [torch.stack([v[t] for v in videos]) for t in range(3)]
    mesh = port.make_mesh()
    assert mesh.shape == {"data": torch.cuda.device_count(), "space": 1}
    mesh = port.make_mesh(devices=[dev])
    fn = port.make_data_parallel_flow(mesh, cfg)
    got = fn(batches[0], batches[1])
    assert got.device == dev
    assert torch.equal(got, port.batched_flow(batches[0], batches[1], cfg))
    log(f"make_data_parallel_flow on a 1-device mesh == batched_flow bit "
        f"for bit ({tuple(got.shape)})")
    Hp, Wp = batches[0].shape[1:3]
    a = port.MultiStream(cfg, Hp, Wp, n_streams=B, devices=[dev])
    b = port.MultiStream(cfg, Hp, Wp, n_streams=B, device=dev)
    for ms in (a, b):
        ms.start(batches[0])
    for t in (1, 2):
        assert torch.equal(a.push(batches[t]), b.push(batches[t]))
    a.close()
    b.close()
    log(f"MultiStream(devices=[{dev}]) == MultiStream(device={dev}) bit for "
        "bit over 2 ticks")


# ------------------------------------------------------------------ spatial

# The spatial forms at 4K on meshes of this one card.  The 4K texture of the
# stream phases, replicate-padded to 2304 rows (the strip and tile forms
# need H % (n * 2^coarsest_scale) == 0) or to 2176 (replicate-coarse):
# op 4 on 2 strips and 2x2 tiles shards scales 2 and 3; op 2 shards no
# scale, and make_spatial_flow is its form.
SPATIAL_4K = (2160, 3840, 64)           # height, width, texture factor
SPATIAL_OP4_MOTION = (16, 8)            # a multiple of 2^fs = 4 at op 4
SPATIAL_OP4_ROWS = 2304
SPATIAL_TOL_STRIPS = dict(rtol=1e-3, atol=1e-3)     # the JAX package's bars
SPATIAL_TOL_REPLICATED = dict(rtol=1e-4, atol=1e-4)
# the tiles' quantile bar: an ulp can flip a marginal outlier reset, which
# var-ref then diffuses (tests/test_spatial_tile2d.py)
SPATIAL_TILE_Q50, SPATIAL_TILE_Q95, SPATIAL_TILE_MAX = 5e-4, 5e-3, 0.05
# a halo slack that starves the op-4 strips: scale 3's sampling reach
# beyond the strip becomes -1 row (its var-ref warp halo 1 row)
SPATIAL_STARVED_SLACK = -97
SPATIAL_REPS = 4


def spatial_phase(dev):
    """The spatial forms on meshes of this card: the fine strips and the
    tiles at op 4 4K, the replicate-coarse form at op 2 4K and its batch
    form, captured against eager, against the unsharded path, K2's strip
    entry counted and held against its plain version on the shards' own
    inputs; a starved halo recovers.  Returns the launches of the counted
    runs and K2's strip-entry row."""
    import flowonthego_tpu_torch as port
    from flowonthego_tpu_torch import parallel as par
    from flowonthego_tpu_torch.config import pad_to_divisible
    from flowonthego_tpu_torch.ops.cuda import dis_gn
    from flowonthego_tpu_torch.ops.pyramid import pad_replicate
    from flowonthego_tpu_torch.utils import graphs
    from flowonthego_tpu_torch.utils.synth import synthetic_frames
    launches = dict.fromkeys(ALL + ("gn_offset",), 0)
    failed = []     # checks that failed; raised once every form has run

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    def check(ok, what):
        if not ok:
            log(f"  FAILED: {what}")
            failed.append(what)

    h, w, factor = SPATIAL_4K
    cfg4 = port.operating_point(4, width=w)
    cfg2 = port.operating_point(2, width=w)
    top = (SPATIAL_OP4_ROWS - h) // 2
    raw4 = synthetic_frames(7, 2, h, w, SPATIAL_OP4_MOTION, factor=factor)
    op4 = [pad_replicate(torch.as_tensor(f, device=dev),
                         (top, SPATIAL_OP4_ROWS - h - top, 0, 0))
           for f in raw4]
    pads2 = pad_to_divisible(w, h, cfg2.coarsest_scale)
    raw2 = synthetic_frames(7, 3, h, w, STREAM_4K[3], factor=factor)
    op2 = [pad_replicate(torch.as_tensor(f, device=dev), pads2) for f in raw2]
    H4, H2 = op4[0].shape[0], op2[0].shape[0]
    strips = par.make_mesh(n_space=2, devices=[dev] * 2)
    tiles = par.make_tile_mesh(2, 2, devices=[dev] * 4)
    log(f"spatial: op 4 {w}x{H4}: sharded scales on 2 strips "
        f"{par.sharded_scale_levels(cfg4, H4, 2)}, on 2x2 tiles "
        f"{par.tiled2d_scale_levels(cfg4, H4, w, 2, 2)}, on 4 strips "
        f"{par.sharded_scale_levels(cfg4, H4, 4)} (scales "
        f"{cfg4.coarsest_scale}..{cfg4.finest_scale}); op 2 {w}x{H2} on 4 "
        f"strips: {par.sharded_scale_levels(cfg2, H2, 4)}")
    n_sharded = {"strips": 2 * len(par.sharded_scale_levels(cfg4, H4, 2)),
                 "tiles": 4 * len(par.tiled2d_scale_levels(cfg4, H4, w, 2,
                                                           2))}

    graphs.clear()
    torch.cuda.synchronize()
    unsharded = {}
    t0 = time.perf_counter()
    unsharded["op4"] = port.flow_full_padded(*op4, cfg4)
    torch.cuda.synchronize()
    log(f"  flow_full_padded op 4 {w}x{H4}: first call "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    unsharded["op2"] = port.flow_full_padded(*op2[:2], cfg2)
    I0b, I1b = torch.stack(op2[:2]), torch.stack(op2[1:])
    unsharded["batch"] = port.batched_flow(I0b, I1b, cfg2)

    forms = {
        "strips": (par.make_fine_spatial_flow(strips, cfg4, H4, w), op4,
                   "op4"),
        "tiles": (par.make_tile2d_flow(tiles, cfg4, H4, w), op4, "op4"),
        "replicate-coarse 4 strips": (
            par.make_spatial_flow(par.make_mesh(n_space=4, devices=[dev] * 4),
                                  cfg2, H2, w), op2[:2], "op2"),
        "batch 2x2": (
            par.make_batch_spatial_flow(
                par.make_mesh(n_data=2, n_space=2, devices=[dev] * 4), cfg2,
                H2, w), (I0b, I1b), "batch")}
    # K2's strip entry at the shapes the main path gives it: the inputs of
    # every strip-entry call in one eager run of the strips and of the
    # tiles (scales 2 and 3 on each shard, with its real offset), each
    # held against the plain version; the row is timed on the largest
    # (scale 2 on strip 0, whose row offset is positive)
    errs, largest = [], None
    for name in n_sharded:
        fn, pair, _ = forms[name]
        calls = strip_entry_calls(fn, pair)
        check(len(calls) == n_sharded[name],
              f"spatial {name}: {len(calls)} strip-entry calls in one run")
        for args, kw in calls:
            got = dis_gn.gn_scale_loop(*args, **kw)
            ref = dis_gn.gn_scale_loop_plain(*args, **kw)
            torch.cuda.synchronize()
            n_patches = args[1].shape[1] * args[1].shape[2]
            what = (f"K2 strip entry, {name}: {n_patches} patches, target "
                    f"{tuple(args[0].shape[1:3])}, offset {kw['offset']}")
            try:
                err, text = check_gn(4, got, ref)
            except AssertionError as e:
                check(False, f"{what}: {e}")
                continue
            errs.append(err)
            log(f"  {what}: {text}")
            if largest is None or n_patches > largest[0]:
                largest = (n_patches, args, kw, what)
    _, args, kw, what = largest
    row = kernel_row(
        device_ms(lambda: dis_gn.gn_scale_loop(*args, **kw), 10),
        cuda_ms(lambda: dis_gn.gn_scale_loop_plain(*args, **kw), 1, 1),
        gn_bound_of(args, kw)[0], max_abs_err=max(errs))
    log(f"  timed: {what}: {timing_text(row)}")
    del calls, args, kw, largest

    for name, (fn, pair, ref_key) in forms.items():
        diag = name in n_sharded
        graphs.clear()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        got, counts = counted(
            f"spatial {name}, 3 calls (eager and recorded, then two replays)",
            lambda: [fn(*pair) for _ in range(3)], ALL)
        peak = torch.cuda.max_memory_allocated()
        add(counts)
        # a path's first call runs eagerly (and records); the two after it
        # replay the graph
        flows = [x[0] if diag else x for x in got]
        ref_flow = flows[0]
        check(all(torch.equal(f, ref_flow) for f in flows[1:]),
              f"spatial {name}: captured differs from eager")
        if diag:
            viol = [int(x[1]) for x in got]
            check(viol == [0] * 3, f"spatial {name}: violations {viol}")
        # the eager call and two replays each launch the strip entry once
        # per sharded scale and shard
        check(counts["gn_offset"] == 3 * n_sharded.get(name, 0),
              f"spatial {name}: K2 strip launches {counts['gn_offset']}")
        log(f"spatial {name}: captured == eager bit for bit over 3 calls"
            + (", violation count 0" if diag else "")
            + f"; K2 strip launches {counts['gn_offset'] // 3} a call (the "
            f"sharded scales x shards: {n_sharded.get(name, 0)}); allocator peak "
            f"{(peak - before) / 2**20:.0f} MiB above the "
            f"{before / 2**20:.0f} MiB held before the first call")
        ref = unsharded[ref_key]
        diff = (ref_flow - ref).abs()
        text = (f"max |diff| {float(diff.max()):.3g} px, share of values "
                f"beyond 1e-3 {float((diff > 1e-3).float().mean()):.3g}")
        if name == "tiles":
            q = torch.quantile(diff.flatten()[::7].float(),
                               torch.tensor([0.5, 0.95], device=dev))
            q50, q95 = (float(x) for x in q)
            log(f"  vs flow_full_padded: q50 {q50:.3g}, q95 {q95:.3g}, "
                f"{text} (bars {SPATIAL_TILE_Q50:g}, {SPATIAL_TILE_Q95:g}, "
                f"max {SPATIAL_TILE_MAX:g})")
            check(q50 < SPATIAL_TILE_Q50 and q95 < SPATIAL_TILE_Q95
                  and float(diff.max()) < SPATIAL_TILE_MAX,
                  f"spatial {name} vs flow_full_padded")
        else:
            tol = (SPATIAL_TOL_STRIPS if name == "strips"
                   else SPATIAL_TOL_REPLICATED)
            log(f"  vs {'batched_flow' if ref_key == 'batch' else 'flow_full_padded'}"
                f": {text} (bar rtol {tol['rtol']:g}, atol {tol['atol']:g})")
            check(torch.allclose(ref_flow, ref, **tol),
                  f"spatial {name} vs the unsharded path")
        if ref_key == "op4":
            inner = ref_flow[top + 64:top + h - 64, 64:-64].reshape(-1, 2)
            med = inner.median(dim=0).values.cpu().numpy()
            log(f"  median flow {med.tolist()} vs motion "
                f"{list(SPATIAL_OP4_MOTION)}")
            check(np.abs(med - np.asarray(SPATIAL_OP4_MOTION)).max()
                  <= SHIFT_TOL, f"spatial {name} median vs the motion")

        # a path's first call: the eager run and the recording
        graphs.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*pair)
        torch.cuda.synchronize()
        log(f"  {name}: a path's first call (the eager run and the "
            f"recording) {(time.perf_counter() - t0) * 1e3:.1f} ms")

        # the one-card cost of the form, beside the unsharded path's
        if ref_key == "batch":
            base = lambda: port.batched_flow(I0b, I1b, cfg2)   # noqa: E731
        else:
            base = (lambda p=pair, c=(cfg4 if ref_key == "op4" else cfg2):
                    port.flow_full_padded(*p, c))
        base()
        rows = {}
        for form, f in (("captured", lambda: fn(*pair)),
                        ("eager", lambda: _eager(fn, pair)),
                        ("unsharded captured", base)):
            wall, event, enqueue = chained_ms(
                f, 2 if form == "eager" else SPATIAL_REPS)
            rows[form] = event
            text = (f"  {name} {form}: {wall:.3f} ms wall, {event:.3f} ms "
                    f"between events, {enqueue:.3f} ms of host enqueue per "
                    "call")
            if form != "eager":     # eagerly, a host call per device event
                names, dev_ms, host_n, graph_n = launch_profile(f, 2)
                text += (f"; device {dev_ms:.3f} ms in "
                         f"{sum(names.values())} events; host launch calls "
                         f"{host_n:.0f}, of them graph launches {graph_n:.0f}")
            log(text)
        log(f"  {name}: captured / unsharded {rows['captured'] / rows['unsharded captured']:.3f}"
            " (between events; one card holds every shard)")
        graphs.clear()

    # a starved halo: the count is above 0 and the recovering form returns
    # the unsharded flow
    fn = par.make_fine_spatial_flow_recovering(
        strips, cfg4, H4, w, halo_slack=SPATIAL_STARVED_SLACK)
    flow, viol = fn(*op4)
    log(f"spatial strips, halo_slack {SPATIAL_STARVED_SLACK}: violation count "
        f"{int(viol)}; the recovering form's flow == flow_full_padded's: "
        f"{torch.equal(flow, unsharded['op4'])}")
    check(int(viol) > 0, "a starved halo counts no violation")
    check(torch.equal(flow, unsharded["op4"]), "recovered flow differs")
    graphs.clear()
    assert not failed, failed
    return launches, row


def strip_entry_calls(fn, pair):
    """The inputs of every call to K2's strip entry in one eager run of
    ``fn(*pair)``, cloned: [(args, kwargs)]."""
    from flowonthego_tpu_torch.ops.cuda import dis_gn
    calls = []
    launch = dis_gn.gn_scale_loop

    def recorder(*args, **kw):
        if kw.get("offset") is not None:
            calls.append((tuple(a.clone() if torch.is_tensor(a) else a
                                for a in args), dict(kw)))
        return launch(*args, **kw)

    dis_gn.gn_scale_loop = recorder
    try:
        _eager(fn, pair)
    finally:
        dis_gn.gn_scale_loop = launch
    return calls


def _eager(fn, pair):
    from flowonthego_tpu_torch.utils import graphs
    with graphs.eager():
        return fn(*pair)


def native_frames():
    """The native phase's frames: 5 seeded 1024x448 frames moving (8, 8)
    px, as bytes."""
    from flowonthego_tpu_torch.utils.synth import synthetic_frames
    return [np.clip(f, 0, 255).astype(np.uint8) for f in
            synthetic_frames(5, 5, 448, 1024, (8, 8))]


def tools_phase(dev):
    """The flow_stream script's twin over PPM frames on the card: its .flo
    files equal stream_flow's flows."""
    import tempfile

    import flowonthego_tpu_torch as port
    from flowonthego_tpu_torch.config import pad_to_divisible
    from flowonthego_tpu_torch.tools import flow_stream
    with tempfile.TemporaryDirectory() as d:
        for k, f in enumerate(native_frames()):
            port.save_image(os.path.join(d, f"frame_{k:03d}.ppm"), f)
        out = os.path.join(d, "flo")
        t0 = time.perf_counter()
        assert flow_stream.main([d, "--flo", out, "--device", "cuda"]) == 0
        ms = (time.perf_counter() - t0) * 1e3
        loaded = [port.load_image(p) for p in flow_stream.frame_paths(d, 99)]
        h, w = loaded[0].shape[:2]
        cfg = port.operating_point(2, width=w)
        pt, pb, pl, pr = pad_to_divisible(w, h, cfg.coarsest_scale)
        want = list(port.stream_flow(
            [np.pad(f, ((pt, pb), (pl, pr), (0, 0)), mode="edge")
             for f in loaded], cfg))
        for k, flow in enumerate(want):
            got = port.read_flo(os.path.join(out, f"flow_{k + 1:04d}.flo"))
            assert np.array_equal(got, flow[pt:pt + h, pl:pl + w]), k
        log(f"flow_stream twin over {len(loaded)} PPM frames: {len(want)} "
            f".flo files == stream_flow's flows bit for bit ({ms:.0f} ms for "
            "the command)")


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
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    pin_fp32()

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(lib_path, REPO)}")

    def phase(fn):
        t0 = time.perf_counter()
        out = fn(dev)
        torch.cuda.synchronize()
        log(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    kernels = phase(kernel_phase)
    kernels.update(phase(glue_phase))
    kernels.update(phase(merge_solve_phase))
    kernels.update(phase(batch_kernel_phase))
    launches = phase(slice_phase)
    for k, n in phase(cli_phase).items():
        launches[k] += n
    batch_launches, bf16_launches = phase(batch_phase)
    for k, n in batch_launches.items():
        launches[k + "_b4"] = n
    launches["gn_bf16"] = bf16_launches
    for k, n in phase(graph_phase).items():
        launches[k] += n
    phase(native_phase)
    phase(device_list_phase)
    spatial_launches, kernels["gn_offset"] = phase(spatial_phase)
    for k, n in spatial_launches.items():
        launches[k] = launches.get(k, 0) + n
    phase(tools_phase)

    src = "flowonthego_tpu_torch/csrc/"
    jax_pkg = "flowonthego_tpu/"
    meta = {
        "pool": ("pool2x2_flat", "pool.cu", "ops/pallas/pool.py:204"),
        "gn": ("gn_scale_loop", "dis_gn.cu", "ops/pallas/dis_gn.py:310"),
        "varref": ("variational_refine_fused", "varref_fused.cu",
                   "ops/pallas/varref_fused.py:250"),
        "varref_cluster": ("variational_refine_tiled (cluster route)",
                           "varref_tiled.cu",
                           "ops/pallas/varref_fused.py:327"),
        "varref_tiled": ("variational_refine_tiled (grid route)",
                         "varref_tiled.cu", "ops/pallas/varref_fused.py:327"),
        "warp": ("warp_image_banded", "warp.cu", "ops/pallas/warp.py:121"),
        # the glue: XLA fusions in the JAX package, no Pallas kernel; the
        # JAX function each computes
        "level": ("pyramid level (pad, gradients)", "level.cu",
                  "ops/pyramid.py:138"),
        "extract": ("extract_templates_and_hessians", "extract.cu",
                    "ops/patches.py:119"),
        "densify": ("densify", "densify.cu", "ops/densify.py:139"),
        "derivs": ("get_derivatives", "derivs.cu", "ops/variational.py:301"),
    }
    # the batched rows (a batch of B frames, one launch per scale) and
    # K2's bf16 operand kernel
    for key in ALL:
        name, source, replaces = meta[key]
        meta[key + "_b4"] = (f"{name} (batch of {B})", source, replaces)
    meta["gn_bf16"] = ("gn_scale_loop (bf16 operands)", "dis_gn.cu",
                       "ops/pallas/dis_gn.py:310")
    meta["gn_offset"] = ("gn_scale_loop (strip offset)", "dis_gn.cu",
                         "ops/pallas/dis_gn.py:310")
    # the fb merge and the reference-form solve: XLA in the JAX package
    meta["fb_merge"] = ("fb merge (_fb_merge_scatter)", "fb_merge.cu",
                        "ops/densify.py:46")
    # the same kernel timed at op 4's scale 0 (51,300 patches)
    meta["fb_merge_op4"] = ("fb merge (_fb_merge_scatter), op 4 scale 0",
                            "fb_merge.cu", "ops/densify.py:46")
    launches["fb_merge_op4"] = launches["fb_merge"]
    meta["dis_ref"] = ("optimize_reference", "dis_ref.cu", "ops/dis.py:291")
    # the same kernel timed at op 4's scale 0 under huber (51,300 patches)
    meta["dis_ref_op4"] = ("optimize_reference, op 4 scale 0 (huber)",
                           "dis_ref.cu", "ops/dis.py:291")
    launches["dis_ref_op4"] = launches["dis_ref"]
    meta["dis_ref_1d"] = ("optimize_reference (1-D form, stereo "
                          "_optimize_1d)", "dis_ref.cu",
                          "models/stereo.py:33")
    rows = []
    for key, (name, source, replaces) in meta.items():
        r = kernels[key]
        assert launches[key] > 0, f"{name} was not launched on its paths"
        rows.append({"name": name, "route": "cuda", "source": src + source,
                     "replaces": jax_pkg + replaces,
                     "launches": launches[key],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
