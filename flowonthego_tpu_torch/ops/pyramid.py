"""Image and gradient pyramids (port of ``flowonthego_tpu/ops/pyramid.py``).

Per level: downsample x0.5 (a 2x2 box average for even dims) ->
central-difference gradients (kernel {1, 0, -1}, replicate border, no 1/2
factor) -> replicate-pad the image and zero-pad the gradients by
``padding`` on every side.  A pyramid is built for a batch of frames
``[B, H, W, C]`` (a single pair is B = 1); the padding and stencil
helpers act on the last three dims, so they take ``[H, W, C]`` too.

Every downsample runs on the flat ``[B*H, W*C]`` view through
:func:`.cuda.pool.pool2x2_flat` — the K1 kernel for a CUDA tensor.  The
level heights above the coarsest are even (H is divisible by
2^(n_levels-1)), so a 2x2 window never spans two frames and the batch
pools as stacked rows in one launch with no change to the kernel.

Each kept level's borders and gradients are one launch of the G1 kernel
(:func:`.cuda.level.pyramid_level`) for a CUDA tensor, and
:func:`pyramid_level_plain` otherwise, chosen like the pool by
``backend``.

A stream's captured step keeps the carried pyramid in fixed tensors
(:func:`pyramid_buffers`): ``build_pyramid(..., out=levels)`` writes each
kept level straight into them, the same values by the same arithmetic,
so the pyramid is never copied from one frame's step to the next.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import use_kernel
from .cuda.pool import pool2x2_flat, pool2x2_flat_plain


class PyramidLevel(NamedTuple):
    """One pyramid level, each tensor [B, H + 2p, W + 2p, C] (padded)."""
    image: torch.Tensor      # replicate-padded image
    grad_x: Optional[torch.Tensor]   # zero-padded d/dx
    grad_y: Optional[torch.Tensor]   # zero-padded d/dy


def _edge_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    return torch.arange(-lo, n + hi, device=device).clamp_(0, n - 1)


def pad_replicate(img: torch.Tensor, pad, out=None) -> torch.Tensor:
    """Replicate-pad the spatial dims of [..., H, W, C]; ``pad`` is an int
    or (top, bottom, left, right).  With ``out`` (a contiguous tensor of
    the padded shape) the result is written there."""
    pt, pb, pl, pr = (pad,) * 4 if isinstance(pad, int) else pad
    H, W = img.shape[-3], img.shape[-2]
    rows = _edge_index(H, pt, pb, img.device)
    cols = _edge_index(W, pl, pr, img.device)
    tall = img.index_select(-3, rows)
    if out is None:
        return tall.index_select(-2, cols)
    return torch.index_select(tall, tall.dim() - 2, cols, out=out)


def pad_constant(img: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    """Constant-pad the spatial dims of [..., H, W, C]."""
    return F.pad(img, (0, 0, pad, pad, pad, pad), value=value)


def central_diff(img: torch.Tensor, out=None):
    """gx[y, x] = I[y, x+1] - I[y, x-1], gy likewise; replicate border;
    [..., H, W, C].  With ``out = (gx, gy)`` (views of that shape, which
    may be strided) the differences are written there."""
    ox, oy = (None, None) if out is None else out
    xpad = pad_replicate(img, (0, 0, 1, 1))
    gx = torch.sub(xpad[..., 2:, :], xpad[..., :-2, :], out=ox)
    ypad = pad_replicate(img, (1, 1, 0, 0))
    gy = torch.sub(ypad[..., 2:, :, :], ypad[..., :-2, :, :], out=oy)
    return gx, gy


def pyramid_buffers(B: int, H: int, W: int, C: int, n_levels: int,
                    padding: int, start_level: int, device) -> list:
    """Fixed tensors for ``build_pyramid(..., out=...)``: a zeroed
    :class:`PyramidLevel` [B, h + 2p, w + 2p, C] for every level from
    ``start_level`` on, None below it (those levels only feed the
    downsample chain and are not kept).  The gradients' zero border is
    written here, once; a build writes their interior only."""
    def level(lvl):
        shape = (B, (H >> lvl) + 2 * padding, (W >> lvl) + 2 * padding, C)
        return PyramidLevel(*(torch.zeros(shape, dtype=torch.float32,
                                          device=device) for _ in range(3)))
    return [level(lvl) if lvl >= start_level else None
            for lvl in range(n_levels)]


def _downsample_half_flat(x: torch.Tensor, C: int, bias=None,
                          backend: str = "auto") -> torch.Tensor:
    if use_kernel(backend, x):
        return pool2x2_flat(x, C, bias=bias)
    return pool2x2_flat_plain(x, C, bias=bias)


def pyramid_level_plain(img: torch.Tensor, padding: int,
                        out: Optional[PyramidLevel] = None) -> PyramidLevel:
    """A kept level of the frames ``img`` [B, h, w, C]: the image
    replicate-padded by ``padding``, its central differences zero-padded
    (plain PyTorch).  With ``out`` (a :func:`pyramid_buffers` level, its
    gradients' border already zero) the level is written there."""
    if out is None:
        gx, gy = central_diff(img)
        return PyramidLevel(image=pad_replicate(img, padding),
                            grad_x=pad_constant(gx, padding),
                            grad_y=pad_constant(gy, padding))
    h, w, p = img.shape[1], img.shape[2], padding
    central_diff(img, out=(out.grad_x[:, p:p + h, p:p + w, :],
                           out.grad_y[:, p:p + h, p:p + w, :]))
    pad_replicate(img, padding, out=out.image)
    return out


def pyramid_level(img: torch.Tensor, padding: int,
                  out: Optional[PyramidLevel] = None,
                  backend: str = "auto") -> PyramidLevel:
    """:func:`pyramid_level_plain`'s level, from the G1 kernel where
    ``backend`` selects the kernels for ``img``."""
    if use_kernel(backend, img):
        from .cuda.level import pyramid_level as kernel
        return kernel(img, padding, out)
    return pyramid_level_plain(img, padding, out)


def downsample_half(img: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """x0.5 bilinear downsample == 2x2 average pool of [..., H, W, C]
    (even dims); leading frames stack as rows of one flat pool."""
    *lead, H, W, C = img.shape
    out = _downsample_half_flat(img.reshape(-1, W * C), C, backend=backend)
    return out.reshape(*lead, H // 2, W // 2, C)


def build_pyramid(img: torch.Tensor, n_levels: int, padding: int,
                  start_level: int = 0, ingest_bias=None,
                  backend: str = "auto", out=None) -> List[PyramidLevel]:
    """Build ``n_levels`` levels (level 0 = full res) of padded image and
    gradient pyramids from the frames ``img`` [B, H, W, C] (float32 or
    uint8), H and W divisible by ``2**(n_levels-1)``.

    Levels below ``start_level`` only feed the downsample chain: they get
    no gradients and no padding (``image`` is the raw level).

    ``ingest_bias`` (a float): the pyramid equals ``build_pyramid(img +
    ingest_bias)`` on levels ``start_level`` and coarser, with the add
    fused into the first downsample's read.  Requires ``start_level >=
    1``; levels below ``start_level`` store the pre-bias image.

    ``backend`` selects the pool and the level kernel (G1) like a config
    backend field.

    ``out`` (from :func:`pyramid_buffers`, same sizes): the levels from
    ``start_level`` on are written into its tensors and ``out`` is
    returned; the levels below are not kept.
    """
    if img.dim() != 4:
        raise ValueError(f"build_pyramid takes frames [B, H, W, C], got "
                         f"{tuple(img.shape)}")
    B, H, W, C = img.shape
    if ingest_bias is not None and start_level < 1:
        raise ValueError("ingest_bias requires start_level >= 1 (the "
                         "full-resolution level would miss the bias)")
    if img.dtype == torch.uint8 and start_level < 1:
        img = img.float()
    levels = []
    cur = img.reshape(B * H, W * C)
    for lvl in range(n_levels):
        if lvl > 0:
            # rows 2k, 2k+1 of the stacked [B*h, W*C] view lie in one frame
            if (H >> (lvl - 1)) % 2:
                raise ValueError(f"level {lvl - 1} height {H >> (lvl - 1)} "
                                 "is odd: a 2x2 window would span frames")
            cur = _downsample_half_flat(
                cur, C, bias=ingest_bias if lvl == 1 else None,
                backend=backend)
        current = cur.reshape(B, H >> lvl, W >> lvl, C)
        if lvl < start_level:
            if out is None:
                levels.append(PyramidLevel(image=current, grad_x=None,
                                           grad_y=None))
            continue
        levels.append(pyramid_level(current, padding,
                                    None if out is None else out[lvl],
                                    backend))
    return levels if out is None else out
