"""Bilinear resizes (port of ``flowonthego_tpu/ops/resize.py``).

* :func:`resize_matmul` — half-pixel centres, clamped taps, as two dense
  matrix products (the final flow upsample), matching
  ``jax.image.resize(method='linear', antialias=False)`` on upscales.
* :func:`resize_linear_antialias` — the warm-start downsample of
  ``stream_flow``.  ``jax.image.resize(..., method="linear")`` antialiases
  on downsampling (a triangle filter widened by the scale factor);
  ``F.interpolate(mode="bilinear", antialias=True)`` is the same filter,
  while torch's default ``antialias=False`` differs by up to 1.8 px on
  the op-2 warm-start shapes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _interp_matrix(out_len: int, in_len: int) -> np.ndarray:
    """Dense [out, in] bilinear interpolation matrix (half-pixel, clamped);
    each row has <= 2 nonzeros."""
    j = np.arange(out_len, dtype=np.float64)
    src = np.clip((j + 0.5) * in_len / out_len - 0.5, 0.0, in_len - 1)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    i1 = np.minimum(i0 + 1, in_len - 1)
    R = np.zeros((out_len, in_len), np.float32)
    R[j.astype(np.int64), i0] += (1.0 - frac).astype(np.float32)
    R[j.astype(np.int64), i1] += frac.astype(np.float32)
    return R


def resize_matmul(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize [..., H, W, C] -> [..., out_h, out_w, C] as two
    matmuls, batched over the leading dims (float32: the port's entry
    points keep TF32 off, batched products included)."""
    h, w = img.shape[-3], img.shape[-2]
    Rv = torch.as_tensor(_interp_matrix(out_h, h), device=img.device)
    Rh = torch.as_tensor(_interp_matrix(out_w, w), device=img.device)
    tmp = torch.einsum("oh,...hwc->...owc", Rv, img)
    return torch.einsum("pw,...owc->...opc", Rh, tmp)


def resize_linear_antialias(img: torch.Tensor, out_h: int,
                            out_w: int) -> torch.Tensor:
    """``jax.image.resize(img, (out_h, out_w, C), "linear")`` for [..., H,
    W, C] (antialiased when downsampling), batched over the leading dims."""
    *lead, H, W, C = img.shape
    x = img.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, C).contiguous()
