"""Row-sharded variational refinement with a halo exchange before every
SOR half-sweep (port of ``flowonthego_tpu/parallel/varref_sharded.py``).

Everything runs on the shards' [B, hl, W] strips, held as a list (one
per position of the mesh axis, ``parallel/halo.py``):

  * warp: backward bilinear against an im2 strip halo'd by the flow's
    displacement bound; sample rows clamp as the global warp does (to
    [0, H-1] globally, then to the rows the halo holds);
  * derivatives: 5-tap stencils on strips halo'd by 2 rows;
  * smoothness, data term, sub-Laplacian: recomputed every inner
    iteration from uu, vv strips halo'd by 2 rows (edge at the image
    border);
  * SOR: one boundary row of du and dv exchanged before every
    half-sweep, 2 x var_ref_iter x inner_iter exchanges a scale.

As in the JAX package this is plain tensor code (XLA there, no Pallas
kernel), the same per-pixel expressions as ``ops/variational.py``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..config import DISConfig
from ..ops.variational import EPS_SMOOTH, Derivatives, data_term
from .halo import exchange_rows

ROWS, COLS = 1, 2     # the row and column dims of [B, h, w(, C)] shards


def _edge_pad_cols(x: torch.Tensor, n: int) -> torch.Tensor:
    w = x.shape[COLS]
    idx = torch.arange(-n, w + n, device=x.device).clamp_(0, w - 1)
    return x.index_select(COLS, idx)


def _deriv5_rows(xh: torch.Tensor) -> torch.Tensor:
    """4th-order row derivative consuming a 2-row halo: [B, n+4, ...] ->
    [B, n, ...]."""
    return (8.0 * (xh[:, 3:-1] - xh[:, 1:-3]) - (xh[:, 4:] - xh[:, :-4])) / 12.0


def _deriv5_cols(x: torch.Tensor) -> torch.Tensor:
    xp = _edge_pad_cols(x, 2)
    return (8.0 * (xp[:, :, 3:-1] - xp[:, :, 1:-3])
            - (xp[:, :, 4:] - xp[:, :, :-4])) / 12.0


def _deriv3_rows(xh: torch.Tensor) -> torch.Tensor:
    return 0.5 * (xh[:, 2:] - xh[:, :-2])


def _deriv3_cols(x: torch.Tensor) -> torch.Tensor:
    xp = _edge_pad_cols(x, 1)
    return 0.5 * (xp[:, :, 2:] - xp[:, :, :-2])


def _global_rows(idx: int, hl: int, like: torch.Tensor) -> torch.Tensor:
    """[1, hl, 1] global row numbers of strip ``idx``."""
    return (torch.arange(hl, device=like.device) + idx * hl)[None, :, None]


def warp_strip(im2_halo: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
               halo: int, idx: int, hl: int, H: int):
    """Backward warp of a [B, hl, W, C] strip from an im2 strip with
    ``halo`` extra rows each side; flows wx, wy [B, hl, W].  Rows clamp as
    the global warp: to [0, H-1], then to the halo's rows.  Returns
    (warped, mask)."""
    B, h, w = wx.shape
    dev = wx.device
    jj = (torch.arange(h, dtype=torch.float32, device=dev)
          + float(idx * hl))[:, None]
    ii = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    xx = ii + wx
    yy = jj + wy
    x0 = torch.floor(xx)
    y0 = torch.floor(yy)
    dx = xx - x0
    dy = yy - y0
    mask = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < H)).to(wx.dtype)

    x1 = x0.clamp(0, w - 1).long()
    x2 = (x0 + 1).clamp(0, w - 1).long()
    base = idx * hl - halo
    rows = im2_halo.shape[ROWS]
    y1 = (y0.clamp(0, H - 1).long() - base).clamp(0, rows - 1)
    y2 = ((y0 + 1).clamp(0, H - 1).long() - base).clamp(0, rows - 1)
    fr = torch.arange(B, device=dev)[:, None, None]
    dxe = dx[..., None]
    dye = dy[..., None]
    warped = (im2_halo[fr, y1, x1] * (1 - dxe) * (1 - dye)
              + im2_halo[fr, y1, x2] * dxe * (1 - dye)
              + im2_halo[fr, y2, x1] * (1 - dxe) * dye
              + im2_halo[fr, y2, x2] * dxe * dye)
    return warped, mask


def _rows_halo(xs, halo: int, mode: str = "edge"):
    return exchange_rows(xs, halo, mode, dim=ROWS)


def variational_refine_sharded(flow: Sequence[torch.Tensor],
                               im1: Sequence[torch.Tensor],
                               im2: Sequence[torch.Tensor], cfg: DISConfig,
                               level: int, H: int,
                               warp_halo: int) -> List[torch.Tensor]:
    """Refine the flow strips [B, hl, W, 2] (one per shard, in mesh
    order) against the image strips [B, hl, W, C] of a field H rows tall;
    returns the refined strips."""
    n = len(flow)
    hl = flow[0].shape[ROWS]
    inner_iter = level + 1
    qa = 0.25 * cfg.var_ref_alpha
    hd3 = cfg.var_ref_delta * 0.5 / 3.0
    hg3 = cfg.var_ref_gamma * 0.5 / 3.0
    omega = cfg.var_ref_sor_weight
    shards = range(n)

    wx = [f[..., 0] for f in flow]
    wy = [f[..., 1] for f in flow]

    # ---- warp + derivatives (once per refine) ----
    im2h = _rows_halo(im2, warp_halo)
    warped = [warp_strip(im2h[i], wx[i], wy[i], warp_halo, i, hl, H)
              for i in shards]
    w_im2 = [x[0] for x in warped]
    mask = [x[1] for x in warped]

    def d5(xs):
        return ([_deriv5_rows(x) for x in _rows_halo(xs, 2)],
                [_deriv5_cols(x) for x in xs])

    mean = [0.5 * (im1[i] + w_im2[i]) for i in shards]
    Iz = [w_im2[i] - im1[i] for i in shards]
    Iy, Ix = d5(mean)
    Ixy, Ixx = d5(Ix)
    Iyy = [_deriv5_rows(x) for x in _rows_halo(Iy, 2)]
    Iyz, Ixz = d5(Iz)
    d = [Derivatives(Ix=Ix[i], Iy=Iy[i], Iz=Iz[i], Ixx=Ixx[i], Ixy=Ixy[i],
                     Iyy=Iyy[i], Ixz=Ixz[i], Iyz=Iyz[i]) for i in shards]

    w = wx[0].shape[COLS]
    rows_g = [_global_rows(i, hl, wx[0]) for i in shards]
    last_row = [g == H - 1 for g in rows_g]
    first_row = [g == 0 for g in rows_g]
    last_col = (torch.arange(w, device=wx[0].device) == w - 1)[None, None, :]

    def smoothness(uu, vv):
        uuh = _rows_halo(uu, 2)
        vvh = _rows_halo(vv, 2)
        out = []
        for i in shards:
            # s on rows [-1, hl+1): the derivatives on the 1-halo band
            ux, uy = _deriv3_cols(uuh[i][:, 1:-1]), _deriv3_rows(uuh[i])
            vx, vy = _deriv3_cols(vvh[i][:, 1:-1]), _deriv3_rows(vvh[i])
            s_band = qa / torch.sqrt(ux * ux + uy * uy + vx * vx + vy * vy
                                     + EPS_SMOOTH)
            s = s_band[:, 1:-1]
            s_down = s_band[:, 2:]                       # s[j+1]
            s_up = s_band[:, :-2]                        # s[j-1]
            zc = torch.zeros_like(s[..., :1])
            s_h = torch.where(last_col, 0.0,
                              torch.cat([s[..., :-1] + s[..., 1:], zc], -1))
            s_v = torch.where(last_row[i], 0.0, s + s_down)
            # the vertical weight of the row above, zero at the image's
            # first row; the horizontal left weight is local
            s_v_up = torch.where(first_row[i], 0.0, s_up + s)
            s_h_left = torch.cat([torch.zeros_like(s_h[..., :1]),
                                  s_h[..., :-1]], -1)
            out.append((s_h, s_v, s_v_up, s_h_left))
        return out

    def sub_laplacian(dst, srch, s_h, s_v, s_v_up):
        """dst += the weighted Laplacian; ``srch``: src with a 1-row halo."""
        src = srch[:, 1:-1]
        src_r = torch.cat([src[..., 1:], src[..., -1:]], -1)
        ch = s_h * (src_r - src)
        zc = torch.zeros_like(ch[..., :1])
        dst = dst + ch - torch.cat([zc, ch[..., :-1]], -1)
        cv = s_v * (srch[:, 2:] - src)
        cv_up = s_v_up * (src - srch[:, :-2])
        return dst + cv - cv_up

    def sig(xh, s_h, s_v, s_v_up, s_h_left):
        x = xh[:, 1:-1]
        zc = torch.zeros_like(x[..., :1])
        left = torch.cat([zc, x[..., :-1]], -1)
        right = torch.cat([x[..., 1:], zc], -1)
        return -(s_v_up * xh[:, :-2] + s_h_left * left
                 + s_v * xh[:, 2:] + s_h * right)

    du = [torch.zeros_like(x) for x in wx]
    dv = [torch.zeros_like(x) for x in wy]
    uu, vv = wx, wy
    parity = [(torch.arange(w, device=wx[0].device)[None, None, :]
               + rows_g[i]) % 2 for i in shards]
    wxh = _rows_halo(wx, 1)
    wyh = _rows_halo(wy, 1)

    for _ in range(inner_iter):
        sm = smoothness(uu, vv)
        systems = []
        for i in shards:
            s_h, s_v, s_v_up, s_h_left = sm[i]
            a11, a12, a22, b1, b2 = data_term(mask[i], du[i], dv[i], d[i],
                                              hd3, hg3)
            b1 = sub_laplacian(b1, wxh[i], s_h, s_v, s_v_up)
            b2 = sub_laplacian(b2, wyh[i], s_h, s_v, s_v_up)
            sum_dpsis = s_v_up + s_h_left + s_v + s_h
            systems.append((a11 + sum_dpsis, a12, a22 + sum_dpsis, b1, b2))

        def half_sweep(du, dv, want):
            duh = _rows_halo(du, 1, "zero")
            dvh = _rows_halo(dv, 1, "zero")
            new_u, new_v = [], []
            for i in shards:
                A11, a12, A22, b1, b2 = systems[i]
                B1 = b1 - sig(duh[i], *sm[i])
                B2 = b2 - sig(dvh[i], *sm[i])
                du_new = ((1.0 - omega) * du[i]
                          + omega / A11 * (B1 - a12 * dv[i]))
                dv_new = ((1.0 - omega) * dv[i]
                          + omega / A22 * (B2 - a12 * du_new))
                sel = parity[i] == want
                new_u.append(torch.where(sel, du_new, du[i]))
                new_v.append(torch.where(sel, dv_new, dv[i]))
            return new_u, new_v

        for _ in range(cfg.var_ref_iter):
            du, dv = half_sweep(du, dv, 1)
            du, dv = half_sweep(du, dv, 0)

        uu = [wx[i] + du[i] for i in shards]
        vv = [wy[i] + dv[i] for i in shards]

    return [torch.stack([uu[i], vv[i]], dim=-1) for i in shards]
