"""K4: the variational-refinement inner loop on fields too large for one CTA.

Replaces ``flowonthego_tpu/ops/pallas/varref_fused.py``
(``variational_refine_tiled``, kernel ``_tiled_kernel``) with
``csrc/varref_tiled.cu``.  It is K3's function (:mod:`.varref_fused`) on
a field spread over the whole card: the op-3 and op-4 fine scales
(28,672 to 458,752 px at 1024x448).  There the loop is bound by bytes:
a data-term phase reads ~27 planes, and a round is ~9 dependent passes
over the field.  The kernel is one cooperative launch with as many CTAs
as fit on the card at once, walking the field grid-stride with a
grid-wide barrier between phases; the per-pixel arithmetic is K3's, from
the same source (``csrc/varref_common.cuh``).  Why a grid barrier and
not the TPU kernel's recompute halo is in the CUDA source.  A batch of
fields is one launch that walks every pixel of the batch.

:func:`refine_inner_tiled` launches the kernel for CUDA tensors and runs
:func:`refine_inner_plain` for CPU tensors.
"""

from __future__ import annotations

import torch

from .varref_fused import launch_loop, refine_inner_plain, warp_and_derivs

# Kernel launches since the last reset (read and reset by chip_smoke.py).
launches = 0


def refine_inner_tiled(wx, wy, mask, dIs, cfg, inner_iter: int):
    """The loop over the whole card: the kernel for CUDA tensors, the
    plain version for CPU tensors -> (uu, vv) [B, h, w]."""
    global launches
    if not wx.is_cuda:
        return refine_inner_plain(wx, wy, mask, dIs, cfg, inner_iter)
    out = launch_loop("fot_varref_tiled", wx, wy, mask, dIs, cfg, inner_iter)
    launches += 1
    return out


def variational_refine_tiled(flow, im1, im2, cfg, level: int) -> torch.Tensor:
    """Refine dense flows [B, h, w, 2]: warp + derivatives
    (:func:`warp_and_derivs`), then :func:`refine_inner_tiled`."""
    wx, wy, mask, dIs = warp_and_derivs(flow, im1, im2, cfg)
    uu, vv = refine_inner_tiled(wx, wy, mask, dIs, cfg, level + 1)
    return torch.stack([uu, vv], dim=-1)
