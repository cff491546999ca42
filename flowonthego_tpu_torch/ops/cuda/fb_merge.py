"""G5: the forward-backward merge of one scale (``csrc/fb_merge.cu``).

The JAX package leaves this to XLA (``flowonthego_tpu/ops/densify.py``,
``_fb_merge_scatter``: one scatter-add a corner).  Plain PyTorch
(``ops/densify.fb_merge_plain``) runs ~75 small kernels a merge and one
sorted ``index_put_(accumulate=True)``, which sends every dropped
contribution to one sink row: on the card that row is one warp's serial
chain of thousands of read-add-writes.  The kernel is two launches: one
CTA a frame bins the patches by landing cell (integer atomics for the
counts, a scan, each bin then sorted by patch index; a patch that cannot
reach the frame is dropped there), then one warp a cell tests the
patches of the <= 2 x 2 bins that can cover it in parallel, sorts its
hits by patch in shared memory and folds them in that order, corner
after corner.  Each cell's sum is then the left fold from +0.0 of its
contributions in the JAX package's order, as the plain version's stably
sorted scatter folds it: on the card the two agree bit for bit.  No
float atomics; every buffer's size follows from the shapes, so the call
records into a CUDA graph.  Its bound is by bytes (the costs read once,
the accumulator written once); what holds it at op 2's sizes is the
latency of a cell's few dependent loads and its chain of adds.

:func:`fb_merge` only checks and launches: its caller
(``ops/densify._fb_merge_scatter``) picks it or ``fb_merge_plain`` with
``config.use_kernel``, and a CPU tensor here raises.
"""

from __future__ import annotations

import torch

from . import _build
from ..dis import PatchState
from ..patches import PatchGrid

# Kernel launches since the last reset (read and reset by chip_smoke.py);
# each call counts once, for its two launches.
launches = 0


def bin_plan(ps: int, h: int, w: int) -> tuple[int, int, int]:
    """(S, nbx, nby): bins of S x S landing cells, nbx x nby a frame,
    over the landings from which a patch's pixel can reach [1, w-2] x
    [1, h-2] (``w + ps - 3`` columns of them, ``h + ps - 3`` rows)."""
    S = ps
    return S, max(0, -(-(w + ps - 3) // S)), max(0, -(-(h + ps - 3) // S))


def check_args(p_cur, mid_org, cost_px, grid: PatchGrid, out_h: int,
               out_w: int) -> None:
    """Raise unless the kernel can take these tensors (the patches are
    ``p_cur``'s [B, n_h, n_w])."""
    ps = grid.patch_size
    if not p_cur.is_cuda:
        raise ValueError(f"fb_merge: the kernel takes CUDA tensors, got "
                         f"p_cur on {p_cur.device}")
    if cost_px.dim() != 6 or p_cur.dim() != 4:
        raise ValueError(f"fb_merge: p_cur must be [B, n_h, n_w, 2] and "
                         f"cost_px [B, n_h, n_w, ps, ps, C], got "
                         f"{tuple(p_cur.shape)} and {tuple(cost_px.shape)}")
    B = p_cur.shape[0]
    lead = tuple(p_cur.shape[:3])
    for name, x, shape in (("p_cur", p_cur, lead + (2,)),
                           ("mid_org", mid_org, lead + (2,)),
                           ("cost_px", cost_px, lead + (ps, ps)
                            + tuple(cost_px.shape[5:]))):
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != p_cur.device):
            raise ValueError(f"fb_merge: {name} must be float32 {shape} on "
                             f"{p_cur.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if not (p_cur.is_contiguous() and cost_px.is_contiguous()):
        raise ValueError("fb_merge: p_cur and cost_px must be contiguous")
    # the midpoints: each frame's [n_h, n_w, 2] contiguous, the frames
    # apart or one shared grid (an expanded constant)
    if not (mid_org[0].is_contiguous()
            and (B == 1 or mid_org.stride(0) in (0, mid_org[0].numel()))):
        raise ValueError("fb_merge: mid_org must be contiguous a frame")
    if out_h < 1 or out_w < 1:
        raise ValueError(f"fb_merge: empty output {out_h}x{out_w}")


def launch(lib, p_cur, mid_org, cost_px, grid: PatchGrid, cfg, out_h: int,
           out_w: int, ints, wb, out, stream) -> None:
    """Launch the kernel on checked tensors (``lib``: the kernel library;
    ``ints``, ``wb``: scratch of :func:`scratch_sizes`)."""
    B, C = p_cur.shape[0], cost_px.shape[5]
    ps = grid.patch_size
    S, nbx, nby = bin_plan(ps, out_h, out_w)
    use_sqrt = cfg.densify_weight == "abs" and cfg.cost_fn == "l2"
    err = lib.fot_fb_merge(
        p_cur.data_ptr(), mid_org.data_ptr(),
        0 if B == 1 else mid_org.stride(0), cost_px.data_ptr(), B,
        p_cur.shape[1] * p_cur.shape[2], ps, C, out_h, out_w,
        float(cfg.min_errval),
        int(use_sqrt), S, nbx, nby, ints.data_ptr(), wb.data_ptr(),
        out.data_ptr(), stream)
    _build.check(err, "fb_merge")


def scratch_sizes(B: int, P: int, ps: int, h: int, w: int) -> tuple[int,
                                                                     int]:
    """(int32 values, float32 values) of the kernel's scratch: per patch
    its sorted list entry (patch, landing cell, 4 values), landing cell
    (2), bin, claimed slot and claim-order entry; per bin its start (+ one
    total a frame); per patch four bilinear weights."""
    _, nbx, nby = bin_plan(ps, h, w)
    return B * (9 * P + nbx * nby + 1), B * P * 4


def fb_merge(state: PatchState, grid: PatchGrid, cfg, out_h: int,
             out_w: int) -> torch.Tensor:
    """The merge's [B, out_h, out_w, 3] (weight, w*u, w*v) accumulator of
    the complementary state ``state`` (``p_cur``, ``mid_org``,
    ``cost_px``); one launch for the batch."""
    global launches
    p_cur, mid_org, cost_px = state.p_cur, state.mid_org, state.cost_px
    check_args(p_cur, mid_org, cost_px, grid, out_h, out_w)
    B, dev = p_cur.shape[0], p_cur.device
    n_ints, n_floats = scratch_sizes(B, p_cur.shape[1] * p_cur.shape[2],
                                     grid.patch_size, out_h, out_w)
    ints = torch.empty(n_ints, dtype=torch.int32, device=dev)
    wb = torch.empty(n_floats, dtype=torch.float32, device=dev)
    out = torch.empty((B, out_h, out_w, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        launch(_build.load_library(), p_cur, mid_org, cost_px, grid, cfg,
               out_h, out_w, ints, wb, out, _build.stream_handle(p_cur))
    launches += 1
    return out
