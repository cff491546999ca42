"""G3: patch-to-dense flow aggregation (``csrc/densify.cu``).

The JAX package leaves this to XLA (``flowonthego_tpu/ops/densify.py``,
``densify``: ``_pixel_weights``, ``overlap_add_canvas``, the clip and the
normalisation), fusions inside its one compiled program.  Plain PyTorch
runs ~23 small kernels a scale and direction (op 2; ~42 at op 4's
ps = 12, steps = 3); the kernel is one launch: one thread an output
pixel gathers the <= r^2 patch pixels that land on it (r = ceil(ps /
steps)), with their weights 1 / sum_c max(min_errval, e_c), in the
plain canvas's order of adds and with no atomics, then divides by the
weight.  On the card it equals the plain version bit for bit.  The fb
merge is a kernel of its own (G5, :mod:`.fb_merge`); its accumulator
comes in as ``merge`` and is added before the normalisation, as in the
plain version.  Bound by bytes: the per-pixel
costs read once (each lands on one pixel), the flow written once.

:func:`densify` launches the kernel for CUDA tensors and runs
:func:`densify_plain` (``ops/densify.py``) for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ..densify import densify_plain
from ..dis import PatchState
from ..patches import PatchGrid

# Kernel launches since the last reset (read and reset by chip_smoke.py).
launches = 0


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


def launch(lib, p_cur, cost_px, grid: PatchGrid, cfg, merge, out,
           stream) -> None:
    """Launch the kernel on checked tensors (``lib``: the kernel library)."""
    B, C = p_cur.shape[0], cost_px.shape[5]
    use_sqrt = cfg.densify_weight == "abs" and cfg.cost_fn == "l2"
    err = lib.fot_densify(
        p_cur.data_ptr(), cost_px.data_ptr(),
        None if merge is None else merge.data_ptr(), B, grid.height,
        grid.width, C, grid.patch_size, grid.steps, grid.n_h, grid.n_w,
        grid.offset_h, grid.offset_w, float(cfg.min_errval), int(use_sqrt),
        out.data_ptr(), stream)
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
