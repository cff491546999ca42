"""K3: the variational-refinement inner loop as one kernel.

Replaces ``flowonthego_tpu/ops/pallas/varref_fused.py``
(``variational_refine_fused``, kernel ``_kernel`` -> ``_refine_block``)
with ``csrc/varref_fused.cu``.  The loop runs ``level + 1`` rounds of
smoothness, robust colour + gradient data term, sub-Laplacian and
``var_ref_iter`` red-black SOR sweeps; the warp (K5,
:mod:`.warp`) and the image derivatives (G4, :mod:`.derivs`) come first,
in :func:`warp_and_derivs`, as on the TPU.

The resolver in ``ops/variational.py`` sends a field here when it is at
or below its pixel threshold and its plan fits (the coarsest scales of
every path), and to K4 (:mod:`.varref_tiled`) otherwise.  On such a field
the loop is bound by latency: 1 + rounds * (1 + 2 * ``var_ref_iter``)
dependent stencil phases over a few hundred pixels.  The plain version
launches ~100 small PyTorch ops per round; the kernel runs the whole loop
in one CTA with everything resident, as the TPU kernel keeps everything
in one VMEM block: a thread a pixel, what only the pixel itself reads in
the thread's registers for the whole loop (its 2x2 system, pair sums,
increment, base flow and mask), what a neighbour reads (du, dv, the
smoothness, the base flow) and the 8 C derivative planes in the CTA's
shared memory, 5 + 8 C planes in all, staged once at the start, and
``__syncthreads()`` between phases.  :func:`fused_plan` gives a field's
thread count and shared bytes and says whether it fits: at most 1,024
pixels (a thread each) within a CTA's 227 KB; the wrapper allocates no
scratch.  A field that does not fit is refused and raises: it is never
handed to K4 or to the plain version here.

A batch of B fields is one launch of B CTAs, one per field, each with its
own planes.

:func:`refine_inner` launches the kernel for CUDA tensors and runs
:func:`refine_inner_plain` for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build, derivs, warp
from ...config import use_kernel
from ..variational import Derivatives, refine_loop

# Kernel launches since the last reset (read and reset by chip_smoke.py).
launches = 0

_N_SCRATCH = 9   # K4's work planes: s_h, s_v, w11, w22, a12, b1, b2, du, dv
FUSED_SHARED_PLANES = 5         # K3's planes in shared memory: du, dv, s,
                                # wx, wy (and the 8 C derivative planes)
FUSED_MAX_PIXELS_PER_CTA = 1024  # K3 runs a thread a pixel
CTA_SHARED_BYTES = 227 * 1024   # shared memory one CTA can use on Hopper


class FusedPlan(NamedTuple):
    threads: int        # threads of a field's CTA (whole warps)
    shared_bytes: int   # shared memory the CTA needs for the field
    fits: bool          # a thread a pixel, within a CTA's shared memory


def fused_plan(h: int, w: int, C: int) -> FusedPlan:
    """How K3 runs an h x w field of C channels: a thread per pixel in
    whole warps, with du, dv, the smoothness, wx, wy and the 8 C
    derivative planes in the CTA's shared memory.  It fits if the field
    has at most 1,024 pixels and those planes at most 227 KB."""
    n = h * w
    threads = max(32, -(-n // 32) * 32)
    shared = (FUSED_SHARED_PLANES + 8 * C) * n * 4
    return FusedPlan(threads, shared, n <= FUSED_MAX_PIXELS_PER_CTA
                     and shared <= CTA_SHARED_BYTES)


def warp_and_derivs(flow, im1, im2, cfg):
    """(wx, wy, mask [B, h, w], dIs [B, 8, C, h, w]) for flows [B, h, w,
    2] and images [B, h, w, C], with dIs = Ix, Iy, Iz, Ixx, Ixy, Iyy, Ixz,
    Iyz channel-first.  The warp is K5 and the derivatives G4 where
    ``cfg.varref_backend`` selects the kernels for ``flow``."""
    wx = flow[..., 0].float().contiguous()
    wy = flow[..., 1].float().contiguous()
    if use_kernel(cfg.varref_backend, flow):
        w_im2, mask = warp.warp_image(im2, wx, wy)
        return wx, wy, mask, derivs.derivatives(im1, w_im2)
    w_im2, mask = warp.warp_image_plain(im2, wx, wy)
    return wx, wy, mask, derivs.derivatives_plain(im1, w_im2)


def refine_inner_plain(wx, wy, mask, dIs, cfg, inner_iter: int):
    """Plain PyTorch version of the loop (``refine_loop``) -> (uu, vv)."""
    d = Derivatives(*(dIs[:, k].permute(0, 2, 3, 1) for k in range(8)))
    return refine_loop(wx, wy, mask, d, cfg, inner_iter)


def launch_loop(entry: str, wx, wy, mask, dIs, cfg, inner_iter: int, extra):
    """Check the planes and launch the C entry ``entry`` once for the
    batch -> (uu, vv) [B, h, w].  ``extra`` are the entry's own arguments
    between the loop's weights and the outputs: K3's thread count, the
    cluster route's plan (CTAs per cluster, rows per CTA, threads), the
    grid route's 9 scratch planes in device memory."""
    B, h, w = wx.shape
    C = dIs.shape[2]
    for name, x, shape in (("wx", wx, (B, h, w)), ("wy", wy, (B, h, w)),
                           ("mask", mask, (B, h, w)),
                           ("dIs", dIs, (B, 8, C, h, w))):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"{entry}: {name} is {tuple(x.shape)} "
                             f"{x.dtype}, expected {shape} float32")
        if x.device != wx.device or not x.is_contiguous():
            raise ValueError(f"{entry}: {name} must be contiguous on "
                             f"{wx.device}")
    uu = torch.empty_like(wx)
    vv = torch.empty_like(wx)
    fn = getattr(_build.load_library(), entry)
    with torch.cuda.device(wx.device):
        err = fn(wx.data_ptr(), wy.data_ptr(), mask.data_ptr(),
                 dIs.data_ptr(), B, h, w, C, inner_iter, cfg.var_ref_iter,
                 float(cfg.var_ref_sor_weight), float(0.25 * cfg.var_ref_alpha),
                 float(cfg.var_ref_delta * 0.5 / 3.0),
                 float(cfg.var_ref_gamma * 0.5 / 3.0),
                 *extra, uu.data_ptr(), vv.data_ptr(),
                 _build.stream_handle(wx))
    _build.check(err, entry)
    return uu, vv


def refine_inner(wx, wy, mask, dIs, cfg, inner_iter: int):
    """The fused loop: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    global launches
    if not wx.is_cuda:
        return refine_inner_plain(wx, wy, mask, dIs, cfg, inner_iter)
    # a plan that does not fit is launched all the same: the card refuses
    # it and launch_loop raises
    plan = fused_plan(wx.shape[1], wx.shape[2], dIs.shape[2])
    out = launch_loop("fot_varref_fused", wx, wy, mask, dIs, cfg, inner_iter,
                      (plan.threads,))
    launches += 1
    return out


def variational_refine_fused(flow, im1, im2, cfg, level: int) -> torch.Tensor:
    """Refine dense flows [B, h, w, 2] with the inner loop fused:
    :func:`warp_and_derivs`, then :func:`refine_inner`."""
    wx, wy, mask, dIs = warp_and_derivs(flow, im1, im2, cfg)
    uu, vv = refine_inner(wx, wy, mask, dIs, cfg, level + 1)
    return torch.stack([uu, vv], dim=-1)
