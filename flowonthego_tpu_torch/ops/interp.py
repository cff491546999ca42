"""Bilinear patch sampling from the target image (port of
``flowonthego_tpu/ops/interp.py``, gather form only).

For each patch the four bilinear weights are constant over the patch
(pure translation), so a sampled patch is a blend of four integer-shifted
windows of the (ps+1)x(ps+1) window whose top-left sits at
(floor(my) - ps/2, floor(mx) - ps/2):

    value[r, c] = w_tl*W[r, c] + w_tr*W[r, c+1] + w_bl*W[r+1, c] + w_br*W[r+1, c+1]

The windows are gathered by plain indexing.  The TPU package's one-hot
and band-pair gathers exist only for the TPU and are not ported.
"""

from __future__ import annotations

import torch


def clamp_starts(start: torch.Tensor, n: int, window: int) -> torch.Tensor:
    """``lax.dynamic_slice`` start semantics: a negative start wraps once
    (+n), then every start clamps so the window stays in bounds."""
    start = torch.where(start < 0, start + n, start)
    return start.clamp(0, n - window)


def gather_windows(img_pad: torch.Tensor, mid_x: torch.Tensor,
                   mid_y: torch.Tensor, patch_size: int, padding: int):
    """(ps+1)x(ps+1) windows + bilinear fractions for float midpoints.

    img_pad: [B, Hp, Wp, C]; mid_x/mid_y: [B, n_h, n_w] midpoints in
    unpadded coordinates; frame b's patches read frame b's image.  Returns
    (windows [B, n_h, n_w, ps+1, ps+1, C], rx, ry).
    """
    ps = patch_size
    K = ps + 1
    B, Hp, Wp, C = img_pad.shape
    n_h, n_w = mid_x.shape[1:]

    fx = torch.floor(mid_x)
    fy = torch.floor(mid_y)
    rx = mid_x - fx
    ry = mid_y - fy
    start_y = clamp_starts(fy.to(torch.int64).reshape(B, -1)
                           + (padding - ps // 2), Hp, K)
    start_x = clamp_starts(fx.to(torch.int64).reshape(B, -1)
                           + (padding - ps // 2), Wp, K)
    ar = torch.arange(K, device=img_pad.device)
    # a lone frame needs no frame index (one launch less per gather)
    frame = (0 if B == 1 else
             torch.arange(B, device=img_pad.device)[:, None, None, None])
    iy = (start_y[..., None] + ar)[..., :, None]    # [B, P, K, 1]
    ix = (start_x[..., None] + ar)[..., None, :]    # [B, P, 1, K]
    windows = img_pad[frame, iy, ix]                # [B, P, K, K, C]
    return windows.reshape(B, n_h, n_w, K, K, C), rx, ry


def blend_windows(windows: torch.Tensor, rx: torch.Tensor,
                  ry: torch.Tensor) -> torch.Tensor:
    """Bilinear 4-shift blend of (ps+1)^2 windows [..., ps+1, ps+1, C] ->
    ps x ps samples."""
    ps = windows.shape[-3] - 1
    rx = rx[..., None, None, None]
    ry = ry[..., None, None, None]
    w_tl = (1.0 - rx) * (1.0 - ry)
    w_tr = rx * (1.0 - ry)
    w_bl = (1.0 - rx) * ry
    w_br = rx * ry
    return (w_tl * windows[..., :ps, :ps, :]
            + w_tr * windows[..., :ps, 1:, :]
            + w_bl * windows[..., 1:, :ps, :]
            + w_br * windows[..., 1:, 1:, :])


def sample_patches_bilinear(img_pad: torch.Tensor, mid_x: torch.Tensor,
                            mid_y: torch.Tensor, patch_size: int,
                            padding: int) -> torch.Tensor:
    """Sample ps x ps patches centred at float midpoints [B, n_h, n_w] of
    [B, Hp, Wp, C] -> [B, n_h, n_w, ps, ps, C]."""
    windows, rx, ry = gather_windows(img_pad, mid_x, mid_y, patch_size,
                                     padding)
    return blend_windows(windows, rx, ry)
