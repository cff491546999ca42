"""G1: one pyramid level's borders and gradients (``csrc/level.cu``).

The JAX package leaves this to XLA (``flowonthego_tpu/ops/pyramid.py``,
``build_pyramid``: ``pad_replicate``, ``central_diff``, ``pad_constant``
of each kept level), a fusion or two inside its one compiled program.
Plain PyTorch runs it as ~22 small kernels a level and frame; the kernel
is one launch for the batch: one thread an output float, the image
replicate-padded, the central differences (one subtraction each) inside
and zeros in the border, bit for bit the plain version's values.  It is
bound by bytes (the level read once, three padded tensors written).

:func:`pyramid_level` launches the kernel for a CUDA tensor and runs
:func:`pyramid_level_plain` (``ops/pyramid.py``) for a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ..pyramid import PyramidLevel, pyramid_level_plain

# Kernel launches since the last reset (read and reset by chip_smoke.py).
launches = 0


def check_args(img: torch.Tensor, padding: int, out=None) -> None:
    """Raise unless the kernel can take these tensors."""
    if img.dim() != 4 or img.dtype != torch.float32:
        raise ValueError(f"pyramid_level: img must be float32 [B, h, w, C], "
                         f"got {img.dtype} {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("pyramid_level: img must be contiguous")
    if padding < 0:
        raise ValueError(f"pyramid_level: padding {padding} < 0")
    if out is None:
        return
    B, h, w, C = img.shape
    shape = (B, h + 2 * padding, w + 2 * padding, C)
    for name, x in zip(PyramidLevel._fields, out):
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != img.device or not x.is_contiguous()):
            raise ValueError(f"pyramid_level: out.{name} must be a "
                             f"contiguous float32 {shape} tensor on "
                             f"{img.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def launch(lib, img, padding: int, out: PyramidLevel, stream) -> None:
    """Launch the kernel on checked tensors (``lib``: the kernel library)."""
    B, h, w, C = img.shape
    err = lib.fot_level(img.data_ptr(), B, h, w, C, padding,
                        out.image.data_ptr(), out.grad_x.data_ptr(),
                        out.grad_y.data_ptr(), stream)
    _build.check(err, "pyramid_level")


def pyramid_level(img: torch.Tensor, padding: int,
                  out: Optional[PyramidLevel] = None) -> PyramidLevel:
    """The padded level of the frames ``img`` [B, h, w, C]: (image,
    grad_x, grad_y) [B, h + 2p, w + 2p, C], written into ``out`` where
    given (a :func:`..pyramid.pyramid_buffers` level).  CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    global launches
    if not img.is_cuda:
        return pyramid_level_plain(img, padding, out)
    check_args(img, padding, out)
    if out is None:
        B, h, w, C = img.shape
        out = PyramidLevel(*(torch.empty(
            (B, h + 2 * padding, w + 2 * padding, C), dtype=torch.float32,
            device=img.device) for _ in range(3)))
    with torch.cuda.device(img.device):
        launch(_build.load_library(), img, padding, out,
               _build.stream_handle(img))
    launches += 1
    return out
