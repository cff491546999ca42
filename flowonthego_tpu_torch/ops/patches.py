"""Patch grid geometry, template extraction and Gauss-Newton Hessians
(port of ``flowonthego_tpu/ops/patches.py``).

Geometry:
    steps        = floor(patch_size * (1 - patch_stride))   (>=1)
    n_w          = ceil(width / steps),  n_h = ceil(height / steps)
    offset_w     = floor((width  - (n_w - 1) * steps) / 2)
    offset_h     = floor((height - (n_h - 1) * steps) / 2)
    midpoint[y, x] = (x * steps + offset_w, y * steps + offset_h)  (ints)

Patches are patch_size x patch_size, covering pixel rows
[mid - ps/2, mid + ps/2).

Extraction (windows, mean normalisation, Hessians) is one launch of the G2
kernel on the card (:mod:`.cuda.extract`) and plain PyTorch otherwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DISConfig, use_kernel


@dataclasses.dataclass(frozen=True)
class PatchGrid:
    """Static patch-grid geometry for one pyramid scale."""
    width: int
    height: int
    patch_size: int
    steps: int
    n_w: int
    n_h: int
    offset_w: int
    offset_h: int
    padding: int

    @classmethod
    def create(cls, cfg: DISConfig, width: int, height: int) -> "PatchGrid":
        steps = cfg.steps
        n_w = -(-width // steps)
        n_h = -(-height // steps)
        offset_w = (width - (n_w - 1) * steps) // 2
        offset_h = (height - (n_h - 1) * steps) // 2
        return cls(width=width, height=height, patch_size=cfg.patch_size,
                   steps=steps, n_w=n_w, n_h=n_h, offset_w=offset_w,
                   offset_h=offset_h, padding=cfg.padding)

    @property
    def n_patches(self) -> int:
        return self.n_w * self.n_h

    def window_origin(self, margin: int | None = None) -> tuple[int, int]:
        """(top, left): the row and column of patch (0, 0)'s window in a
        level padded by ``margin`` (default: the grid's padding); patch
        (y, x)'s lies ``steps`` * (y, x) further on."""
        margin = self.padding if margin is None else margin
        half = self.patch_size // 2
        return margin + self.offset_h - half, margin + self.offset_w - half

    def midpoints(self) -> tuple[np.ndarray, np.ndarray]:
        """Integer midpoints (mx[n_h, n_w], my[n_h, n_w]) as float32 numpy."""
        mx = (np.arange(self.n_w) * self.steps + self.offset_w)[None, :]
        my = (np.arange(self.n_h) * self.steps + self.offset_h)[:, None]
        return (np.broadcast_to(mx, (self.n_h, self.n_w)).astype(np.float32),
                np.broadcast_to(my, (self.n_h, self.n_w)).astype(np.float32))

    # Bounds of the patch-midpoint box constraint.
    @property
    def l_bound(self) -> float:
        return -float(self.patch_size) / 2.0

    @property
    def u_bound_w(self) -> float:
        return float(self.width + self.patch_size // 2 - 2)

    @property
    def u_bound_h(self) -> float:
        return float(self.height + self.patch_size // 2 - 2)


def extract_windows(img_pad: torch.Tensor, grid: PatchGrid) -> torch.Tensor:
    """All template windows of each frame as one tensor [B, n_h, n_w, ps,
    ps, C] from padded levels [B, Hp, Wp, C]:
    window[b, y, x, r, c] = img_pad[b, pad + my - ps/2 + r, pad + mx - ps/2 + c]."""
    ps, st = grid.patch_size, grid.steps
    B, C = img_pad.shape[0], img_pad.shape[3]
    top, left = grid.window_origin()
    rows = (grid.n_h - 1) * st + ps
    cols = (grid.n_w - 1) * st + ps
    region = img_pad[:, top:top + rows, left:left + cols, :]
    if ps % st == 0:
        # Grouped form: windows are k^2 contiguous reshaped tilings.  Both
        # cats stay at four dims or fewer (PyTorch's CUDA cat copies input
        # by input above four).
        k = ps // st
        T = region.reshape(B, grid.n_h - 1 + k, st, cols * C)
        rows_st = torch.cat([T[:, a:a + grid.n_h] for a in range(k)],
                            dim=2)                 # [B, n_h, ps, cols*C]
        X = rows_st.reshape(-1, grid.n_w - 1 + k, st * C)
        cols_st = torch.cat([X[:, b:b + grid.n_w] for b in range(k)],
                            dim=2)                 # [B*n_h*ps, n_w, ps*C]
        return cols_st.reshape(B, grid.n_h, ps, grid.n_w, ps, C).permute(
            0, 1, 3, 2, 4, 5).contiguous()
    # Strided form: the ps*ps static shifts as strided slices.
    shifted = [
        region[:, r:r + (grid.n_h - 1) * st + 1:st,
               c:c + (grid.n_w - 1) * st + 1:st, :]
        for r in range(ps) for c in range(ps)
    ]
    stacked = torch.stack(shifted, dim=3)   # [B, n_h, n_w, ps*ps, C]
    return stacked.reshape(B, grid.n_h, grid.n_w, ps, ps, C)


def extract_templates_and_hessians(
        I0_pad: torch.Tensor, I0x_pad: torch.Tensor, I0y_pad: torch.Tensor,
        grid: PatchGrid, cfg: DISConfig):
    """:func:`extract_templates_and_hessians_plain`'s result, from the G2
    kernel (:mod:`.cuda.extract`) where ``cfg.gn_backend`` selects the
    kernels for the levels, which it takes contiguous."""
    if use_kernel(cfg.gn_backend, I0_pad):
        from .cuda.extract import extract_templates_and_hessians as kernel
        return kernel(I0_pad.contiguous(), I0x_pad.contiguous(),
                      I0y_pad.contiguous(), grid, cfg)
    return extract_templates_and_hessians_plain(I0_pad, I0x_pad, I0y_pad,
                                                grid, cfg)


def extract_templates_and_hessians_plain(
        I0_pad: torch.Tensor, I0x_pad: torch.Tensor, I0y_pad: torch.Tensor,
        grid: PatchGrid, cfg: DISConfig):
    """Mean-normalized templates, their gradients, and 2x2 GN Hessians of
    padded levels [B, Hp, Wp, C] (plain PyTorch).

    * template = window(I0) - mean(window(I0)) over all ps*ps*C values
    * H = [[sum gx^2, sum gx gy], [sum gx gy, sum gy^2]]; where det == 0
      the diagonal gets +1e-10.

    Returns (templates, tgrad_x, tgrad_y, H): [B, n_h, n_w, ps, ps, C] x3
    and [B, n_h, n_w, 3] (H00, H01, H11).
    """
    templates = extract_windows(I0_pad, grid)
    gx = extract_windows(I0x_pad, grid)
    gy = extract_windows(I0y_pad, grid)
    patch = (-3, -2, -1)

    if cfg.use_mean_normalization:
        templates = templates - templates.mean(dim=patch, keepdim=True)

    h00 = (gx * gx).sum(dim=patch)
    h01 = (gx * gy).sum(dim=patch)
    h11 = (gy * gy).sum(dim=patch)
    det = h00 * h11 - h01 * h01
    bump = torch.where(det == 0.0, 1e-10, 0.0).to(h00.dtype)
    H = torch.stack([h00 + bump, h01, h11 + bump], dim=-1)
    return templates, gx, gy, H
