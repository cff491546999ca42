"""G5: the forward-backward merge of one scale (``csrc/fb_merge.cu``).

The JAX package leaves this to XLA (``flowonthego_tpu/ops/densify.py``,
``_fb_merge_scatter``: one scatter-add a corner).  Plain PyTorch
(``ops/densify.fb_merge_plain``) runs ~75 small kernels a merge and one
sorted ``index_put_(accumulate=True)``, which sends every dropped
contribution to one sink row: on the card that row is one warp's serial
chain of thousands of read-add-writes.  The kernel sorts the patches by
landing bin with a stable radix sort over chunks of patches (a patch that
cannot reach the frame is dropped there), so each bin's members are in
patch order, then gives a CTA a tile of cells: it merges its 2 x 2 bins'
members into patch order in shared memory, lists each position's hits
(the candidates that cover it, from bit masks per column and row) with
their densify weights, and each thread folds its cells' hits corner
after corner; a small frame takes a warp a cell instead.  Each cell's sum is then the
left fold from +0.0 of its contributions in the JAX package's order, as
the plain version's stably sorted scatter folds it: on the card the two
agree bit for bit.  No float atomics; :func:`merge_plan` sizes every
launch and buffer from the shapes, so the call records into a CUDA graph.
Its bound is by bytes (the costs read once, the accumulator written
once).  :func:`bin_sort_model` is the sort in plain PyTorch, chunk by
chunk as the kernels run it (the CPU tests hold it to a stable sort).

:func:`fb_merge` only checks and launches: its caller
(``ops/densify._fb_merge_scatter``) picks it or ``fb_merge_plain`` with
``config.use_kernel``, and a CPU tensor here raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from ..dis import PatchState
from ..patches import PatchGrid

# Kernel launches since the last reset (read and reset by chip_smoke.py);
# each call counts once, for all its launches.
launches = 0

SORT_CHUNK = 1024     # patches a sort CTA ranks
DIGIT_BITS = 8        # bits of the bin a radix pass sorts by
MIN_TILE = 16         # cells a tile's side at least (a CTA's 256 cells)
MAX_TILE = 32         # and at most: patches up to 32 px
WARP_CELLS = 2048     # frames of at most this many cells: a warp a cell


class MergePlan(NamedTuple):
    """G5's launches for B frames of P patches of ps px, an h x w frame:
    bins and cell tiles of S x S (landing cells, cells), nbx x nby bins a
    frame (a patch's bin is ((cy - Y0) // S, (cx - X0) // S) with X0 = Y0
    = 1 - lb - ps, lb = -ceil(ps / 2)), the sort in ``passes`` passes of
    DIGIT_BITS over ``n_chunks`` chunks of SORT_CHUNK patches (one chunk:
    one launch for the whole sort), tiles_x x tiles_y cell tiles a frame
    (or, ``warp_cells``, a warp a cell: a frame of at most WARP_CELLS
    cells is a few tiles, whose CTAs' chains of steps outlast it), and
    the scratch: ``n_ints`` int32 (landing cells 2 P, again in the
    sorted order 2 P, two key and patch buffers 4 P, ranks P, the (digit,
    chunk) counts, the bins' starts), ``n_floats`` float32 (the bilinear
    weights 4 P, again sorted 4 P, the sorted flows 2 P)."""
    S: int
    nbx: int
    nby: int
    n_chunks: int
    passes: int
    tiles_x: int
    tiles_y: int
    warp_cells: bool
    n_ints: int
    n_floats: int


def merge_plan(B: int, P: int, ps: int, h: int, w: int) -> MergePlan:
    """The plan of one call (see :class:`MergePlan`).  A tile needs only
    its bin and the next along each axis when S >= ps, and so does a
    cell's corner (a warp a cell, bins of S = ps)."""
    if not 1 <= ps <= MAX_TILE:
        raise ValueError(f"fb_merge: patches of {ps} px (the kernel takes "
                         f"1 to {MAX_TILE})")
    # a warp a cell tests every member of its <= 2 x 2 bins: small bins
    S = ps if h * w <= WARP_CELLS else max(ps, MIN_TILE)
    nbx = (w + ps - 3) // S + 1
    nby = (h + ps - 3) // S + 1
    nb = nbx * nby
    n_chunks = -(-P // SORT_CHUNK)
    passes = max(1, -(-nb.bit_length() // DIGIT_BITS))
    n_ints = B * (9 * P + (1 << DIGIT_BITS) * n_chunks + nb + 1)
    return MergePlan(S, nbx, nby, n_chunks, passes, -(-w // S), -(-h // S),
                     h * w <= WARP_CELLS, n_ints, B * P * 10)


def landing_bins(p_cur, mid_org, ps: int, h: int, w: int) -> torch.Tensor:
    """Each patch's bin as the kernels compute it ([B, P] int64; nb where
    no pixel of the patch can reach [1, w-2] x [1, h-2]): its landing
    cell ceil(mid + p + 1e-5) less (X0, Y0), within [1, w + ps - 3] x
    [1, h + ps - 3], in bins of S."""
    plan = merge_plan(1, 0, ps, h, w)
    X0 = 1 + (ps + 1) // 2 - ps
    B = p_cur.shape[0]
    pos = (mid_org + p_cur).reshape(B, -1, 2)
    cell = torch.ceil(pos + 1e-5).to(torch.int64) - X0
    xs, ys = cell[..., 0], cell[..., 1]
    reach = (xs >= 1) & (xs <= w + ps - 3) & (ys >= 1) & (ys <= h + ps - 3)
    return torch.where(reach, (ys // plan.S) * plan.nbx + xs // plan.S,
                       plan.nbx * plan.nby)


def bin_sort_model(bins: torch.Tensor, nb: int, passes: int,
                   chunk: int = SORT_CHUNK) -> torch.Tensor:
    """The kernels' bin sort of one frame in plain PyTorch: ``bins`` [P]
    int64 in [0, nb] (nb: dropped) -> the patch indices sorted by bin,
    patch order within a bin.  Each pass sorts by DIGIT_BITS more bits:
    a chunk's rank of an element is the number of its chunk's earlier
    elements with the same digit, its place the exclusive prefix of the
    (digit, chunk) counts, digit-major, plus that rank."""
    assert bins.numel() == 0 or int(bins.max()) <= nb
    assert nb < 1 << (DIGIT_BITS * passes)
    key, val = bins.clone(), torch.arange(len(bins))
    n_chunks = -(-len(bins) // chunk)
    for p in range(passes):
        digit = (key >> (DIGIT_BITS * p)) & ((1 << DIGIT_BITS) - 1)
        of_chunk = torch.arange(len(bins)) // chunk
        one_hot = torch.nn.functional.one_hot(digit, 1 << DIGIT_BITS)
        counts = torch.zeros((n_chunks, 1 << DIGIT_BITS), dtype=torch.int64)
        rank = torch.empty_like(digit)
        for c in range(n_chunks):
            mine = of_chunk == c
            seen = one_hot[mine].cumsum(0) - one_hot[mine]
            rank[mine] = seen.gather(1, digit[mine, None])[:, 0]
            counts[c] = one_hot[mine].sum(0)
        flat = counts.t().reshape(-1)            # digit-major
        first = (flat.cumsum(0) - flat).reshape(1 << DIGIT_BITS, n_chunks)
        at = first[digit, of_chunk] + rank
        key = torch.empty_like(key).index_put_((at,), key)
        val = torch.empty_like(val).index_put_((at,), val)
    return val


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
    if not 1 <= B <= 65535:
        raise ValueError(f"fb_merge: {B} frames in one launch (1 to 65,535)")
    merge_plan(B, p_cur.shape[1] * p_cur.shape[2], ps, out_h, out_w)


def launch(lib, p_cur, mid_org, cost_px, grid: PatchGrid, cfg, out_h: int,
           out_w: int, ints, wb, out, stream) -> None:
    """Launch the kernels on checked tensors (``lib``: the kernel
    library; ``ints``, ``wb``: the plan's scratch)."""
    B, C = p_cur.shape[0], cost_px.shape[5]
    P = p_cur.shape[1] * p_cur.shape[2]
    ps = grid.patch_size
    plan = merge_plan(B, P, ps, out_h, out_w)
    use_sqrt = cfg.densify_weight == "abs" and cfg.cost_fn == "l2"
    err = lib.fot_fb_merge(
        p_cur.data_ptr(), mid_org.data_ptr(),
        0 if B == 1 else mid_org.stride(0), cost_px.data_ptr(), B, P, ps, C,
        out_h, out_w, float(cfg.min_errval), int(use_sqrt), plan.S,
        plan.nbx, plan.nby, plan.n_chunks, plan.passes,
        int(plan.warp_cells), ints.data_ptr(),
        wb.data_ptr(), out.data_ptr(), stream)
    _build.check(err, "fb_merge")


def fb_merge(state: PatchState, grid: PatchGrid, cfg, out_h: int,
             out_w: int) -> torch.Tensor:
    """The merge's [B, out_h, out_w, 3] (weight, w*u, w*v) accumulator of
    the complementary state ``state`` (``p_cur``, ``mid_org``,
    ``cost_px``); one call for the batch (2 launches where a frame has at
    most SORT_CHUNK patches, 3 a sort pass + 2 above)."""
    global launches
    p_cur, mid_org, cost_px = state.p_cur, state.mid_org, state.cost_px
    check_args(p_cur, mid_org, cost_px, grid, out_h, out_w)
    B, dev = p_cur.shape[0], p_cur.device
    plan = merge_plan(B, p_cur.shape[1] * p_cur.shape[2], grid.patch_size,
                      out_h, out_w)
    ints = torch.empty(plan.n_ints, dtype=torch.int32, device=dev)
    wb = torch.empty(plan.n_floats, dtype=torch.float32, device=dev)
    out = torch.empty((B, out_h, out_w, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        launch(_build.load_library(), p_cur, mid_org, cost_px, grid, cfg,
               out_h, out_w, ints, wb, out, _build.stream_handle(p_cur))
    launches += 1
    return out
