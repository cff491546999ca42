"""G2: template extraction and Gauss-Newton Hessians (``csrc/extract.cu``).

The JAX package leaves this to XLA (``flowonthego_tpu/ops/patches.py``,
``extract_templates_and_hessians`` and ``extract_windows``), fusions
inside its one compiled program.  Plain PyTorch runs ~27 small kernels a
scale and direction (the grouped or strided window gathers of three
levels, the mean, the three Hessian sums, the det == 0 bump); the kernel
is one launch: one warp a patch, each window row ps*C contiguous floats,
the four sums reduced across the warp.  It is bound by bytes (the three
windows of every patch written).  The windows are copies, equal to the
plain version's bit for bit; the mean and the Hessians sum in another
order, a few ulp of the sums apart (chip_smoke.py holds them to 1e-4 and
1e-5).

:func:`extract_templates_and_hessians` launches the kernel for CUDA
tensors and runs :func:`extract_templates_and_hessians_plain`
(``ops/patches.py``) for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build
from ..patches import PatchGrid, extract_templates_and_hessians_plain

# Kernel launches since the last reset (read and reset by chip_smoke.py).
launches = 0


def check_args(I0, Ix, Iy, grid: PatchGrid) -> None:
    """Raise unless the kernel can take these tensors."""
    for name, x in (("I0", I0), ("I0x", Ix), ("I0y", Iy)):
        if x.dim() != 4 or x.dtype != torch.float32:
            raise ValueError(f"extract_templates_and_hessians: {name} must "
                             f"be float32 [B, Hp, Wp, C], got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.shape != I0.shape or x.device != I0.device:
            raise ValueError(f"extract_templates_and_hessians: {name} is "
                             f"{tuple(x.shape)} on {x.device}, I0 "
                             f"{tuple(I0.shape)} on {I0.device}")
        if not x.is_contiguous():
            raise ValueError(f"extract_templates_and_hessians: {name} must "
                             "be contiguous")
    top, left = grid.window_origin()
    ps, st = grid.patch_size, grid.steps
    if (top < 0 or left < 0
            or top + (grid.n_h - 1) * st + ps > I0.shape[1]
            or left + (grid.n_w - 1) * st + ps > I0.shape[2]):
        raise ValueError("extract_templates_and_hessians: the patch grid's "
                         f"windows leave the padded level {tuple(I0.shape)}")


def launch(lib, I0, Ix, Iy, grid: PatchGrid, mean_on: bool, out,
           stream) -> None:
    """Launch the kernel on checked tensors (``lib``: the kernel
    library); ``out``: (templates, gx, gy, H)."""
    B, Hp, Wp, C = I0.shape
    top, left = grid.window_origin()
    err = lib.fot_extract(I0.data_ptr(), Ix.data_ptr(), Iy.data_ptr(), B,
                          Hp, Wp, C, grid.patch_size, grid.steps, grid.n_h,
                          grid.n_w, top, left, int(mean_on),
                          *(x.data_ptr() for x in out), stream)
    _build.check(err, "extract_templates_and_hessians")


def extract_templates_and_hessians(I0_pad, I0x_pad, I0y_pad,
                                   grid: PatchGrid, cfg):
    """(templates, tgrad_x, tgrad_y [B, n_h, n_w, ps, ps, C], H [B, n_h,
    n_w, 3]) of padded levels [B, Hp, Wp, C], one launch for the batch.
    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    global launches
    if not I0_pad.is_cuda:
        return extract_templates_and_hessians_plain(I0_pad, I0x_pad, I0y_pad,
                                                    grid, cfg)
    check_args(I0_pad, I0x_pad, I0y_pad, grid)
    B, C = I0_pad.shape[0], I0_pad.shape[3]
    ps = grid.patch_size
    win = (B, grid.n_h, grid.n_w, ps, ps, C)
    out = tuple(torch.empty(s, dtype=torch.float32, device=I0_pad.device)
                for s in (win, win, win, (B, grid.n_h, grid.n_w, 3)))
    with torch.cuda.device(I0_pad.device):
        launch(_build.load_library(), I0_pad, I0x_pad, I0y_pad, grid,
               cfg.use_mean_normalization, out, _build.stream_handle(I0_pad))
    launches += 1
    return out
