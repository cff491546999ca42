"""G4: the image derivatives of variational refinement (``csrc/derivs.cu``).

The JAX package leaves this to XLA (``flowonthego_tpu/ops/variational.py``,
``get_derivatives``: ``deriv5`` on the mean of the two images and on the
first derivatives), fusions inside its one compiled program, ahead of its
var-ref kernels.  Plain PyTorch runs ~129 small kernels a scale and
direction (each ``deriv5`` four index_selects and five ops, then the
stack into the planes K3 and K4 read); the kernel is one launch: one CTA
a 32 x 8 tile of one channel, the first derivatives on the tile and a
2-pixel halo in shared memory, each halo cell at its coordinate clamped
to the image, so a second derivative replicates the first derivative's
edge as the plain version does.  Bound by bytes (two images read, eight
planes written).  On the card it equals the plain version bit for bit.

:func:`derivatives` launches the kernel for CUDA tensors and runs
:func:`derivatives_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build
from ..variational import get_derivatives

# Kernel launches since the last reset (read and reset by chip_smoke.py).
launches = 0


def derivatives_plain(im1: torch.Tensor, w_im2: torch.Tensor) -> torch.Tensor:
    """The planes dIs [B, 8, C, h, w] (Ix, Iy, Iz, Ixx, Ixy, Iyy, Ixz, Iyz,
    channel-first) of images [B, h, w, C], in plain PyTorch
    (``ops/variational.get_derivatives``)."""
    d = get_derivatives(im1, w_im2)
    B, h, w, C = im1.shape
    # one 4-D stack: PyTorch's CUDA cat copies input by input above four
    # dims, eight launches where this is one
    dIs = torch.stack([x.reshape(B, h * w, C).transpose(1, 2) for x in d],
                      dim=1)
    return dIs.reshape(B, 8, C, h, w)


def check_args(im1: torch.Tensor, w_im2: torch.Tensor) -> None:
    """Raise unless the kernel can take these tensors: float32 [B, h, w,
    C] on one device, each with dense pixels (a strided crop of padded
    levels is taken as it is)."""
    for name, x in (("im1", im1), ("w_im2", w_im2)):
        if x.dim() != 4 or x.dtype != torch.float32:
            raise ValueError(f"derivatives: {name} must be float32 [B, h, "
                             f"w, C], got {x.dtype} {tuple(x.shape)}")
        if x.shape != im1.shape or x.device != im1.device:
            raise ValueError(f"derivatives: {name} is {tuple(x.shape)} on "
                             f"{x.device}, im1 {tuple(im1.shape)} on "
                             f"{im1.device}")
        if x.stride(3) != 1 or x.stride(2) != x.shape[3]:
            raise ValueError(f"derivatives: {name}'s pixels must be dense, "
                             f"got strides {x.stride()}")


def launch(lib, im1, w_im2, out, stream) -> None:
    """Launch the kernel on checked tensors (``lib``: the kernel library)."""
    B, h, w, C = im1.shape
    err = lib.fot_derivs(im1.data_ptr(), im1.stride(0), im1.stride(1),
                         w_im2.data_ptr(), w_im2.stride(0), w_im2.stride(1),
                         B, h, w, C, out.data_ptr(), stream)
    _build.check(err, "derivatives")


def derivatives(im1: torch.Tensor, w_im2: torch.Tensor) -> torch.Tensor:
    """dIs [B, 8, C, h, w] of ``im1`` and the warped ``w_im2`` [B, h, w,
    C], one launch for the batch.  CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    global launches
    if not im1.is_cuda:
        return derivatives_plain(im1, w_im2)
    check_args(im1, w_im2)
    B, h, w, C = im1.shape
    out = torch.empty((B, 8, C, h, w), dtype=torch.float32,
                      device=im1.device)
    with torch.cuda.device(im1.device):
        launch(_build.load_library(), im1, w_im2, out,
               _build.stream_handle(im1))
    launches += 1
    return out
