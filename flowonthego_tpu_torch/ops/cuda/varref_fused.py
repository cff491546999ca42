"""K3: the variational-refinement inner loop as one kernel.

Replaces ``flowonthego_tpu/ops/pallas/varref_fused.py``
(``variational_refine_fused``, kernel ``_kernel`` -> ``_refine_block``)
with ``csrc/varref_fused.cu``.  The loop runs ``level + 1`` rounds of
smoothness, robust colour + gradient data term, sub-Laplacian and
``var_ref_iter`` red-black SOR sweeps; the warp and the image derivatives
stay outside in plain PyTorch (:func:`warp_and_derivs`), as on the TPU.

On the card the loop is bound by latency: an op-2 field holds at most
8,160 pixels, and each round is ~9 dependent stencil phases.  The plain
version issues ~100 small PyTorch ops per round; the kernel runs the
whole loop in one CTA of 1024 threads walking the field grid-stride, with
its ~10 work planes (<= 330 KB) in device memory, where they stay
L2-resident, and ``__syncthreads()`` between phases.  The TPU design (all
~34 planes in one VMEM block) does not fit a CTA's 227 KB of shared
memory.

:func:`refine_inner` launches the kernel for CUDA tensors and runs
:func:`refine_inner_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build
from ..variational import Derivatives, get_derivatives, refine_loop, warp_image

# Kernel launches since the last reset (read and reset by chip_smoke.py).
launches = 0

_N_SCRATCH = 10   # s, s_h, s_v, A11, A22, a12, b1, b2, du, dv


def warp_and_derivs(flow, im1, im2):
    """(wx, wy, mask [h, w], dIs [8, C, h, w]) with dIs = Ix, Iy, Iz, Ixx,
    Ixy, Iyy, Ixz, Iyz channel-first."""
    wx = flow[..., 0].float().contiguous()
    wy = flow[..., 1].float().contiguous()
    w_im2, mask = warp_image(im2, wx, wy)
    d = get_derivatives(im1, w_im2)
    dIs = torch.stack([x.permute(2, 0, 1) for x in d])
    return wx, wy, mask, dIs.contiguous()


def refine_inner_plain(wx, wy, mask, dIs, cfg, inner_iter: int):
    """Plain PyTorch version of the fused loop -> (uu, vv) [h, w]."""
    d = Derivatives(*(x.permute(1, 2, 0) for x in dIs))
    return refine_loop(wx, wy, mask, d, cfg, inner_iter)


def refine_inner(wx, wy, mask, dIs, cfg, inner_iter: int):
    """The fused loop: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    global launches
    if not wx.is_cuda:
        return refine_inner_plain(wx, wy, mask, dIs, cfg, inner_iter)
    h, w = wx.shape
    C = dIs.shape[1]
    for name, x, shape in (("wx", wx, (h, w)), ("wy", wy, (h, w)),
                           ("mask", mask, (h, w)),
                           ("dIs", dIs, (8, C, h, w))):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"refine_inner: {name} is {tuple(x.shape)} "
                             f"{x.dtype}, expected {shape} float32")
        if x.device != wx.device or not x.is_contiguous():
            raise ValueError(f"refine_inner: {name} must be contiguous on "
                             f"{wx.device}")
    scratch = torch.empty((_N_SCRATCH, h, w), dtype=torch.float32,
                          device=wx.device)
    uu = torch.empty_like(wx)
    vv = torch.empty_like(wx)
    lib = _build.load_library()
    with torch.cuda.device(wx.device):
        err = lib.fot_varref_fused(
            wx.data_ptr(), wy.data_ptr(), mask.data_ptr(), dIs.data_ptr(),
            h, w, C, inner_iter, cfg.var_ref_iter,
            float(cfg.var_ref_sor_weight), float(0.25 * cfg.var_ref_alpha),
            float(cfg.var_ref_delta * 0.5 / 3.0),
            float(cfg.var_ref_gamma * 0.5 / 3.0),
            scratch.data_ptr(), uu.data_ptr(), vv.data_ptr(),
            _build.stream_handle(wx))
    _build.check(err, "refine_inner")
    launches += 1
    return uu, vv


def variational_refine_fused(flow, im1, im2, cfg, level: int) -> torch.Tensor:
    """Refine a dense [h, w, 2] flow with the inner loop fused:
    warp + derivatives in PyTorch, then :func:`refine_inner`."""
    wx, wy, mask, dIs = warp_and_derivs(flow, im1, im2)
    uu, vv = refine_inner(wx, wy, mask, dIs, cfg, level + 1)
    return torch.stack([uu, vv], dim=-1)
