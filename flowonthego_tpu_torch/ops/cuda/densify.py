"""G3: patch-to-dense flow aggregation (``csrc/densify.cu``).

The JAX package leaves this to XLA (``flowonthego_tpu/ops/densify.py``,
``densify``: ``_pixel_weights``, ``overlap_add_canvas``, the clip and the
normalisation), fusions inside its one compiled program.  Plain PyTorch
runs ~23 small kernels a scale and direction (op 2; ~42 at op 4's
ps = 12, steps = 3); the kernel is one launch.  Its CTA takes a band of
``steps`` output rows and a chunk of patch columns (:func:`densify_plan`):
every cost value the band needs is a contiguous run of its patch's rows,
read once, weighted (1 / sum_c max(min_errval, e_c)) into shared memory,
and each output pixel then folds its <= r^2 values (r = ceil(ps / steps))
from there in the plain canvas's order of adds, with no atomics, and
divides by the weight.  On the card it equals the plain version bit for
bit.  The fb merge is a kernel of its own (G5, :mod:`.fb_merge`); its
accumulator comes in as ``merge`` and is added before the normalisation,
as in the plain version.  Bound by bytes: the per-pixel costs read once
(each lands on one pixel), the flow written once.

:func:`densify` launches the kernel for CUDA tensors and runs
:func:`densify_plain` (``ops/densify.py``) for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import _build
from ..densify import densify_plain
from ..dis import PatchState
from ..patches import PatchGrid

# Kernel launches since the last reset (read and reset by chip_smoke.py).
launches = 0

CTA_SHARED_BYTES = 227 * 1024   # shared memory one CTA can use on Hopper
SHARED_BUDGET = 48 * 1024       # a chunk's shared memory aims below this
MAX_CHUNK = 32                  # Xq columns of a chunk at most
MIN_CTAS = 264                  # CTAs a launch aims at (two an SM of 132)


class DensifyPlan(NamedTuple):
    """How G3's launch covers the output: CTA (chunk c, band t, frame b)
    writes the output rows Y = Yq * steps + pr (pr < steps) of band Yq =
    ``yq0`` + t and the columns X = Xq * steps + qc of Xq in [``xq0`` +
    c * ``nc``, + ``nc``), canvas coordinates (image y = Y + ``oy``, x =
    X + ``ox``); it stages patch rows j = Yq - m (m < r) and patch
    columns [xq0 + c * nc - r + 1, xq0 + (c + 1) * nc - 1]."""
    r: int              # ceil(ps / steps): patches a pixel takes an axis
    oy: int
    ox: int
    yq0: int
    n_bands: int
    xq0: int
    nc: int
    n_chunks: int
    shared_bytes: int   # (w, w*u, w*v) of the staged patch pixels


def densify_plan(grid: PatchGrid, B: int = 1) -> DensifyPlan:
    """G3's bands and chunks for one scale's grid and B frames: the bands
    and Xq columns that cover the image (outside the canvas they stage
    only zeros), the chunk as wide as keeps a CTA's shared memory within
    ``SHARED_BUDGET`` (at most ``MAX_CHUNK`` columns, at least one), and
    narrower where the launch would have fewer than ``MIN_CTAS`` CTAs: a
    small level's time is the latency of a CTA's loads, one round of them
    a few rows.  Raises ValueError if even one column's CTA needs more
    than a CTA can have."""
    ps, st = grid.patch_size, grid.steps
    r = -(-ps // st)
    oy = grid.offset_h - ps // 2
    ox = grid.offset_w - ps // 2
    yq0, yq1 = (-oy) // st, (grid.height - 1 - oy) // st
    xq0, xq1 = (-ox) // st, (grid.width - 1 - ox) // st
    per_col = r * st * r * st * 3 * 4
    n_xq, n_bands = xq1 - xq0 + 1, yq1 - yq0 + 1
    nc = max(1, min(MAX_CHUNK, n_xq, SHARED_BUDGET // per_col - (r - 1)))
    chunks = -(-MIN_CTAS // (n_bands * B))      # chunks a band wanted
    nc = max(1, min(nc, -(-n_xq // chunks)))
    shared = (nc + r - 1) * per_col
    if shared > CTA_SHARED_BYTES:
        raise ValueError(
            f"densify: patches of {ps} px every {st} px need {shared} "
            f"bytes of shared memory a CTA, more than {CTA_SHARED_BYTES}")
    return DensifyPlan(r, oy, ox, yq0, n_bands, xq0, nc, -(-n_xq // nc),
                       shared)


def check_args(p_cur, cost_px, grid: PatchGrid, merge=None) -> None:
    """Raise unless the kernel can take these tensors."""
    B = p_cur.shape[0]
    ps = grid.patch_size
    for name, x, shape in (
            ("p_cur", p_cur, (B, grid.n_h, grid.n_w, 2)),
            ("cost_px", cost_px, (B, grid.n_h, grid.n_w, ps, ps)
             + tuple(cost_px.shape[5:])),
            ("merge", merge, (B, grid.height, grid.width, 3))):
        if x is None:
            continue
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != p_cur.device):
            raise ValueError(f"densify: {name} must be float32 {shape} on "
                             f"{p_cur.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"densify: {name} must be contiguous")
    if cost_px.dim() != 6:
        raise ValueError(f"densify: cost_px must be [B, n_h, n_w, ps, ps, "
                         f"C], got {tuple(cost_px.shape)}")
    if not 1 <= B <= 65535:
        raise ValueError(f"densify: {B} frames in one launch (1 to 65,535)")
    densify_plan(grid, B)


def launch(lib, p_cur, cost_px, grid: PatchGrid, cfg, merge, out,
           stream) -> None:
    """Launch the kernel on checked tensors (``lib``: the kernel library)."""
    B, C = p_cur.shape[0], cost_px.shape[5]
    use_sqrt = cfg.densify_weight == "abs" and cfg.cost_fn == "l2"
    plan = densify_plan(grid, B)
    err = lib.fot_densify(
        p_cur.data_ptr(), cost_px.data_ptr(),
        None if merge is None else merge.data_ptr(), B, grid.height,
        grid.width, C, grid.patch_size, grid.steps, grid.n_h, grid.n_w,
        grid.offset_h, grid.offset_w, float(cfg.min_errval), int(use_sqrt),
        plan.yq0, plan.n_bands, plan.xq0, plan.nc, plan.n_chunks,
        plan.shared_bytes, out.data_ptr(), stream)
    _build.check(err, "densify")


def densify(state: PatchState, grid: PatchGrid, cfg,
            merge: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense flows [B, h, w, 2] of the patch flows ``state.p_cur`` [B,
    n_h, n_w, 2] weighted by their per-pixel costs ``state.cost_px`` [B,
    n_h, n_w, ps, ps, C], plus the fb merge's accumulator ``merge`` where
    given; one launch for the batch.  CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    global launches
    if not state.p_cur.is_cuda:
        return densify_plain(state, grid, cfg, merge)
    p_cur, cost_px = state.p_cur, state.cost_px
    check_args(p_cur, cost_px, grid, merge)
    out = torch.empty((p_cur.shape[0], grid.height, grid.width, 2),
                      dtype=torch.float32, device=p_cur.device)
    with torch.cuda.device(p_cur.device):
        launch(_build.load_library(), p_cur, cost_px, grid, cfg, merge, out,
               _build.stream_handle(p_cur))
    launches += 1
    return out
