"""K1: 2x2 average pool on the flat ``[H, W*C]`` view (pyramid downsample).

Replaces ``flowonthego_tpu/ops/pallas/pool.py`` (``pool2x2_flat``, kernel
``_pool_kernel``) with ``csrc/pool.cu``.  On the card the pool is bound by
device-memory bandwidth (4 loads and 1 store per output; 125 MB per 4K
fp32 frame), so the kernel is one coalesced thread per output element.
uint8 frames are widened on load (a quarter of the bytes read), and an
optional scalar bias is added to every tap, so a streaming caller's
ingest rides the pool's own read.

:func:`pool2x2_flat` launches the kernel for a CUDA tensor and runs
:func:`pool2x2_flat_plain` for a CPU tensor.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

# Kernel launches since the last reset (read and reset by chip_smoke.py).
launches = 0


def _check_input(x: torch.Tensor, C: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"pool2x2_flat takes [H, W*C], got {tuple(x.shape)}")
    H, wc = x.shape
    if H % 2 or wc % (2 * C):
        raise ValueError(f"pool2x2_flat needs an even height and a flat width "
                         f"divisible by 2*C={2 * C}, got {H}x{wc}")
    if x.dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"pool2x2_flat takes float32 or uint8, got {x.dtype}")


def pool2x2_flat_plain(x: torch.Tensor, C: int,
                       bias: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: [H, W*C] -> [H/2, W*C/2] float32.

    Taps summed in reduce_window's row-major window order, ((a + b) + c)
    + d, then x0.25 — the kernel's order.
    """
    _check_input(x, C)
    H, wc = x.shape
    x = x.float()
    if bias is not None:
        x = x + float(bias)
    v = x.reshape(H // 2, 2, wc // (2 * C), 2, C)
    s = ((v[:, 0, :, 0] + v[:, 0, :, 1]) + v[:, 1, :, 0]) + v[:, 1, :, 1]
    return (s * 0.25).reshape(H // 2, wc // 2)


def pool2x2_flat(x: torch.Tensor, C: int,
                 bias: Optional[float] = None) -> torch.Tensor:
    """2x2 average pool [H, W*C] -> [H/2, W*C/2] float32 (+ optional bias
    added before pooling).  CUDA tensors launch the kernel; CPU tensors
    run the plain version."""
    global launches
    if not x.is_cuda:
        return pool2x2_flat_plain(x, C, bias)
    _check_input(x, C)
    if not x.is_contiguous():
        raise ValueError("pool2x2_flat needs a contiguous tensor")
    H, wc = x.shape
    out = torch.empty((H // 2, wc // 2), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    fn = lib.fot_pool2x2_u8 if x.dtype == torch.uint8 else lib.fot_pool2x2_f32
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), H, wc, C,
                 0.0 if bias is None else float(bias), int(bias is not None),
                 _build.stream_handle(x))
    _build.check(err, "pool2x2_flat")
    launches += 1
    return out
