"""Bilinear resizes (port of ``flowonthego_tpu/ops/resize.py``).

* :func:`resize_matmul` — half-pixel centres, clamped taps, as two dense
  matrix products (the final flow upsample), matching
  ``jax.image.resize(method='linear', antialias=False)`` on upscales.
* :func:`resize_full` — the same resize as a gather of the four taps
  (the form ``resize_matmul`` is held against).
* :func:`resize_rows_strip` — rows [row_start, row_start + out_rows) of
  the gather form, by scale factors (a spatial shard upsamples its own
  rows of the flow, ``parallel/spatial.py``).
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

from ..utils.device import device_constant


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


def interp_matrix_on(out_len: int, in_len: int, device) -> torch.Tensor:
    """:func:`_interp_matrix` on ``device``, built on the host once per
    (sizes, device)."""
    return device_constant(("interp_matrix", out_len, in_len), device,
                           lambda: _interp_matrix(out_len, in_len))


def _src_index(out_start: int, out_len: int, scale: float, in_len: int,
               device):
    """(i0, i1, frac) for output samples [out_start, out_start + out_len)
    of the half-pixel, clamped bilinear resize by ``scale`` along one axis:
    src = (dst + 0.5) / scale - 0.5, in float32 on ``device`` as the JAX
    package computes it (no host-built tensor)."""
    j = torch.arange(out_len, dtype=torch.float32, device=device) + out_start
    src = ((j + 0.5) / scale - 0.5).clamp(0.0, float(in_len - 1))
    f = torch.floor(src)
    i0 = f.to(torch.int64)
    return i0, (i0 + 1).clamp(max=in_len - 1), src - f


def resize_full(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize [H, W, C] -> [out_h, out_w, C] (or with leading
    dims), half-pixel centres, clamped taps, as a gather of the four taps;
    no antialiasing."""
    h, w = img.shape[-3], img.shape[-2]
    return resize_rows_strip(img, out_h / h, out_w / w, 0, out_h, out_w)


def resize_rows_strip(img: torch.Tensor, scale_h: float, scale_w: float,
                      row_start: int, out_rows: int,
                      out_w: int) -> torch.Tensor:
    """Rows [row_start, row_start + out_rows) of the bilinear resize of
    [..., h, w, C] by (scale_h, scale_w), the four taps gathered and
    blended in the JAX package's order; ``row_start`` is a Python int (a
    shard's first row)."""
    h, w = img.shape[-3], img.shape[-2]
    y0, y1, fy = _src_index(row_start, out_rows, scale_h, h, img.device)
    x0, x1, fx = _src_index(0, out_w, scale_w, w, img.device)
    fx = fx[None, :, None]
    fy = fy[:, None, None]
    rows0 = img.index_select(-3, y0)
    rows1 = img.index_select(-3, y1)
    top = (rows0.index_select(-2, x0) * (1 - fx)
           + rows0.index_select(-2, x1) * fx)
    bot = (rows1.index_select(-2, x0) * (1 - fx)
           + rows1.index_select(-2, x1) * fx)
    return top * (1 - fy) + bot * fy


def resize_matmul(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize [..., H, W, C] -> [..., out_h, out_w, C] as two
    matmuls, batched over the leading dims (float32: the port's entry
    points keep TF32 off, batched products included)."""
    h, w = img.shape[-3], img.shape[-2]
    Rv = interp_matrix_on(out_h, h, img.device)
    Rh = interp_matrix_on(out_w, w, img.device)
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
