"""K5: the bilinear backward warp of variational refinement.

Replaces ``flowonthego_tpu/ops/pallas/warp.py`` (``warp_image_banded``,
kernel ``_kernel``) with ``csrc/warp.cu``.  On the card the warp is bound
by bytes (8 B of flow and (C + 1) * 4 B of output per pixel; the four
taps mostly hit L1/L2).  A warp's lanes sit on neighbouring pixels of a
row, so that on a smooth flow their taps share sectors, and a thread owns
that column of four consecutive rows, with all 16 C tap loads issued
before the first blend; the channel count is a compile-time constant (1
and 3; others take a generic form), row and frame come from the grid.
``probes/warp_probe.cu`` holds the forms that were measured against it.
The TPU kernel's banded stencil stood in for a gather the TPU lacks, and
needed ``|flow| <= bound``; the kernel needs no bound.  It computes the
plain version's arithmetic in the same order, so the two are bit-exact.
A batch of frames is one launch, the frame a grid dimension.

:func:`warp_image` launches the kernel for CUDA tensors and runs
:func:`warp_image_plain` (``ops/variational.warp_image``) for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build
from ..variational import warp_image as warp_image_plain

# Kernel launches since the last reset (read and reset by chip_smoke.py).
launches = 0


def warp_image(src: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor):
    """Backward-warp the frames ``src`` [B, H, W, C] by flows (wx, wy)
    [B, H, W] -> (warped [B, H, W, C], mask [B, H, W]), one launch for the
    batch.  ``src`` may be a crop whose frames and rows are strided (a
    view into padded levels); its pixels must be dense."""
    global launches
    if not src.is_cuda:
        return warp_image_plain(src, wx, wy)
    if src.dim() != 4:
        raise ValueError(f"warp_image: src must be [B, H, W, C], got "
                         f"{tuple(src.shape)}")
    B, h, w, C = src.shape
    if src.stride(3) != 1 or src.stride(2) != C:
        raise ValueError(f"warp_image: src pixels must be dense, got strides "
                         f"{src.stride()}")
    for name, x in (("src", src), ("wx", wx), ("wy", wy)):
        if x.dtype != torch.float32 or x.device != src.device:
            raise ValueError(f"warp_image: {name} must be float32 on "
                             f"{src.device}, got {x.dtype} on {x.device}")
    for name, x in (("wx", wx), ("wy", wy)):
        if tuple(x.shape) != (B, h, w) or not x.is_contiguous():
            raise ValueError(f"warp_image: {name} must be a contiguous "
                             f"{(B, h, w)} tensor, got {tuple(x.shape)}")
    out = torch.empty((B, h, w, C), dtype=torch.float32, device=src.device)
    mask = torch.empty((B, h, w), dtype=torch.float32, device=src.device)
    lib = _build.load_library()
    with torch.cuda.device(src.device):
        err = lib.fot_warp(src.data_ptr(), src.stride(0), src.stride(1),
                           wx.data_ptr(), wy.data_ptr(), B, h, w, C,
                           out.data_ptr(), mask.data_ptr(),
                           _build.stream_handle(src))
    _build.check(err, "warp_image")
    launches += 1
    return out, mask
