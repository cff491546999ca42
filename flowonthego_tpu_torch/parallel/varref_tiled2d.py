"""2-D tiled (rows x cols) variational refinement with a halo exchange
before every SOR half-sweep (port of
``flowonthego_tpu/parallel/varref_tiled2d.py``).

The row-strip form (``varref_sharded.py``) on a (rows, cols) tile mesh:
the tiles [B, hl, wl] are a row-major list, one per mesh position, and

  * a 2-D halo is two hops, rows then columns of the row-extended tile
    (the corners ride on the lateral neighbour's row halo,
    ``halo.exchange_cols``);
  * the warp reads an im2 tile halo'd by the displacement bound on both
    axes, clamping as the global warp (globally first, then to the halo);
  * derivatives are 5-tap stencils on tiles halo'd by 2 rows or columns;
  * the smoothness weights come from a +-1 band, so the neighbour-pair
    sums and their up/left shifts are local reads;
  * the boundary rows and columns of du and dv are exchanged before every
    half-sweep.

Plain tensor code, as XLA runs it in the JAX package (no Pallas kernel).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..config import DISConfig
from ..models.dis_flow import as_image
from ..ops.variational import EPS_SMOOTH, Derivatives, data_term
from .halo import along, exchange_cols, exchange_rows, send
from .mesh import COL_AXIS, ROW_AXIS, Mesh, Sharding, make_tile_mesh

ROWS, COLS = 1, 2     # the row and column dims of [B, h, w(, C)] tiles

__all__ = ["ROW_AXIS", "COL_AXIS", "make_tile_mesh", "make_tiled_varref",
           "variational_refine_tile", "warp_tile"]


def exchange_2d(xs: Sequence[torch.Tensor], n_r: int, n_c: int, hr: int,
                hc: int, mode: str = "edge") -> list:
    """Row-major tiles [B, h, w, ...] -> [B, h+2*hr, w+2*hc, ...]: rows
    over the 'rows' axis, then columns over 'cols'."""
    xs = list(xs)
    if hr:
        xs = along(xs, n_r, n_c, 0,
                   lambda line: exchange_rows(line, hr, mode, dim=ROWS))
    if hc:
        xs = along(xs, n_r, n_c, 1,
                   lambda line: exchange_cols(line, hc, mode, dim=COLS))
    return xs


def _deriv5_rows(xh):
    """4th-order row derivative consuming a 2-row halo."""
    return (8.0 * (xh[:, 3:-1] - xh[:, 1:-3]) - (xh[:, 4:] - xh[:, :-4])) / 12.0


def _deriv5_cols(xh):
    return (8.0 * (xh[:, :, 3:-1] - xh[:, :, 1:-3])
            - (xh[:, :, 4:] - xh[:, :, :-4])) / 12.0


def warp_tile(im2_halo: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
              halo: int, idx_r: int, idx_c: int, hl: int, wl: int, H: int,
              W: int):
    """Backward warp of a [B, hl, wl, C] tile from an im2 tile with
    ``halo`` extra rows and columns each side.  Coordinates clamp as the
    global warp: to [0, H-1] x [0, W-1], then to the halo's extent (a
    sample past the halo reads its edge).  Returns (warped, mask)."""
    B = wx.shape[0]
    dev = wx.device
    jj = (torch.arange(hl, dtype=torch.float32, device=dev)
          + float(idx_r * hl))[:, None]
    ii = (torch.arange(wl, dtype=torch.float32, device=dev)
          + float(idx_c * wl))[None, :]
    xx = ii + wx
    yy = jj + wy
    x0 = torch.floor(xx)
    y0 = torch.floor(yy)
    dx = xx - x0
    dy = yy - y0
    mask = ((xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)).to(wx.dtype)

    rbase = idx_r * hl - halo
    cbase = idx_c * wl - halo
    hh, hw = im2_halo.shape[ROWS], im2_halo.shape[COLS]

    def loc_r(y):
        return (y.clamp(0, H - 1).long() - rbase).clamp(0, hh - 1)

    def loc_c(x):
        return (x.clamp(0, W - 1).long() - cbase).clamp(0, hw - 1)

    y1, y2 = loc_r(y0), loc_r(y0 + 1)
    x1, x2 = loc_c(x0), loc_c(x0 + 1)
    fr = torch.arange(B, device=dev)[:, None, None]
    dxe = dx[..., None]
    dye = dy[..., None]
    warped = (im2_halo[fr, y1, x1] * (1 - dxe) * (1 - dye)
              + im2_halo[fr, y1, x2] * dxe * (1 - dye)
              + im2_halo[fr, y2, x1] * (1 - dxe) * dye
              + im2_halo[fr, y2, x2] * dxe * dye)
    return warped, mask


def variational_refine_tile(flow: Sequence[torch.Tensor],
                            im1: Sequence[torch.Tensor],
                            im2: Sequence[torch.Tensor], cfg: DISConfig,
                            level: int, n_r: int, n_c: int, H: int, W: int,
                            warp_halo: int) -> List[torch.Tensor]:
    """Refine the flow tiles [B, hl, wl, 2] (row-major over an n_r x n_c
    mesh) against the image tiles [B, hl, wl, C] of an H x W field;
    returns the refined tiles."""
    hl, wl = flow[0].shape[ROWS], flow[0].shape[COLS]
    inner_iter = level + 1
    qa = 0.25 * cfg.var_ref_alpha
    hd3 = cfg.var_ref_delta * 0.5 / 3.0
    hg3 = cfg.var_ref_gamma * 0.5 / 3.0
    omega = cfg.var_ref_sor_weight
    tiles = range(n_r * n_c)
    pos = [divmod(k, n_c) for k in tiles]

    def ex(xs, hr, hc, mode="edge"):
        return exchange_2d(xs, n_r, n_c, hr, hc, mode)

    wx = [f[..., 0] for f in flow]
    wy = [f[..., 1] for f in flow]

    # ---- warp + derivatives (once per refine) ----
    im2h = ex(im2, warp_halo, warp_halo)
    warped = [warp_tile(im2h[k], wx[k], wy[k], warp_halo, *pos[k], hl, wl,
                        H, W) for k in tiles]
    w_im2 = [x[0] for x in warped]
    mask = [x[1] for x in warped]

    def d5r(xs):
        return [_deriv5_rows(x) for x in ex(xs, 2, 0)]

    def d5c(xs):
        return [_deriv5_cols(x) for x in ex(xs, 0, 2)]

    mean = [0.5 * (im1[k] + w_im2[k]) for k in tiles]
    Iz = [w_im2[k] - im1[k] for k in tiles]
    Ix, Iy = d5c(mean), d5r(mean)
    Ixx, Ixy, Iyy = d5c(Ix), d5r(Ix), d5r(Iy)
    Ixz, Iyz = d5c(Iz), d5r(Iz)
    d = [Derivatives(Ix=Ix[k], Iy=Iy[k], Iz=Iz[k], Ixx=Ixx[k], Ixy=Ixy[k],
                     Iyy=Iyy[k], Ixz=Ixz[k], Iyz=Iyz[k]) for k in tiles]

    # global-border masks: the pair sums' zero rows and columns lie at the
    # image border, not at the tile border
    dev = wx[0].device
    gj = [(torch.arange(hl, device=dev) + r * hl)[None, :, None]
          for r, _ in pos]
    gi = [(torch.arange(wl, device=dev) + c * wl)[None, None, :]
          for _, c in pos]
    parity = [(gi[k] + gj[k]) % 2 for k in tiles]

    def smoothness(uu, vv):
        """Pair sums s_h, s_v and their left/up shifts from a +-1
        diffusivity band (s needs +-1 of the derivatives: a 2-halo)."""
        uuh = ex(uu, 2, 2)
        vvh = ex(vv, 2, 2)
        out = []
        for k in tiles:
            def band(xh):
                return (0.5 * (xh[:, 1:-1, 2:] - xh[:, 1:-1, :-2]),
                        0.5 * (xh[:, 2:, 1:-1] - xh[:, :-2, 1:-1]))
            ux, uy = band(uuh[k])
            vx, vy = band(vvh[k])
            s_band = qa / torch.sqrt(ux * ux + uy * uy + vx * vx + vy * vy
                                     + EPS_SMOOTH)
            s = s_band[:, 1:-1, 1:-1]
            s_h = torch.where(gi[k] == W - 1, 0.0, s + s_band[:, 1:-1, 2:])
            s_v = torch.where(gj[k] == H - 1, 0.0, s + s_band[:, 2:, 1:-1])
            s_h_left = torch.where(gi[k] == 0, 0.0,
                                   s_band[:, 1:-1, :-2] + s)
            s_v_up = torch.where(gj[k] == 0, 0.0, s_band[:, :-2, 1:-1] + s)
            out.append((s_h, s_v, s_h_left, s_v_up))
        return out

    def sub_laplacian(dst, srch, s_h, s_v, s_h_left, s_v_up):
        """dst += the weighted 5-point Laplacian; ``srch``: src with a 1-px
        2-D edge halo."""
        src = srch[:, 1:-1, 1:-1]
        ch = s_h * (srch[:, 1:-1, 2:] - src)
        ch_l = s_h_left * (src - srch[:, 1:-1, :-2])
        cv = s_v * (srch[:, 2:, 1:-1] - src)
        cv_u = s_v_up * (src - srch[:, :-2, 1:-1])
        return dst + ch - ch_l + cv - cv_u

    def sig(xh, s_h, s_v, s_h_left, s_v_up):
        return -(s_v_up * xh[:, :-2, 1:-1] + s_h_left * xh[:, 1:-1, :-2]
                 + s_v * xh[:, 2:, 1:-1] + s_h * xh[:, 1:-1, 2:])

    du = [torch.zeros_like(x) for x in wx]
    dv = [torch.zeros_like(x) for x in wy]
    uu, vv = wx, wy
    wxh = ex(wx, 1, 1)
    wyh = ex(wy, 1, 1)

    for _ in range(inner_iter):
        sm = smoothness(uu, vv)
        systems = []
        for k in tiles:
            a11, a12, a22, b1, b2 = data_term(mask[k], du[k], dv[k], d[k],
                                              hd3, hg3)
            b1 = sub_laplacian(b1, wxh[k], *sm[k])
            b2 = sub_laplacian(b2, wyh[k], *sm[k])
            s_h, s_v, s_h_left, s_v_up = sm[k]
            sum_dpsis = s_v_up + s_h_left + s_v + s_h
            systems.append((a11 + sum_dpsis, a12, a22 + sum_dpsis, b1, b2))

        def half_sweep(du, dv, want):
            duh = ex(du, 1, 1, "zero")
            dvh = ex(dv, 1, 1, "zero")
            new_u, new_v = [], []
            for k in tiles:
                A11, a12, A22, b1, b2 = systems[k]
                B1 = b1 - sig(duh[k], *sm[k])
                B2 = b2 - sig(dvh[k], *sm[k])
                du_new = ((1.0 - omega) * du[k]
                          + omega / A11 * (B1 - a12 * dv[k]))
                dv_new = ((1.0 - omega) * dv[k]
                          + omega / A22 * (B2 - a12 * du_new))
                sel = parity[k] == want
                new_u.append(torch.where(sel, du_new, du[k]))
                new_v.append(torch.where(sel, dv_new, dv[k]))
            return new_u, new_v

        for _ in range(cfg.var_ref_iter):
            du, dv = half_sweep(du, dv, 1)         # odd first
            du, dv = half_sweep(du, dv, 0)

        uu = [wx[k] + du[k] for k in tiles]
        vv = [wy[k] + dv[k] for k in tiles]

    return [torch.stack([uu[k], vv[k]], dim=-1) for k in tiles]


def gather_tiles(xs: Sequence[torch.Tensor], n_r: int, n_c: int,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Row-major tiles [B, hl, wl, ...] joined into [B, H, W, ...] on
    ``device`` (default: the first tile's)."""
    device = xs[0].device if device is None else device
    rows = [torch.cat([send(xs[r * n_c + c], device) for c in range(n_c)],
                      dim=COLS) for r in range(n_r)]
    return torch.cat(rows, dim=ROWS)


def make_tiled_varref(mesh: Mesh, cfg: DISConfig, level: int, H: int, W: int,
                      warp_halo: int):
    """``fn(flow, im1, im2)``: [H, W, 2], [H, W, C], [H, W, C] -> the
    refined [H, W, 2] on the mesh's first device, computed on the (rows,
    cols) tiles of ``mesh`` (eagerly; the JAX package returns this
    ``shard_map`` unjitted too).

    ``warp_halo`` must cover the largest flow component (the DIS
    displacement bound at this scale, ``spatial_fine.displacement_bound``,
    plus one interpolation pixel)."""
    n_r, n_c = mesh.shape[ROW_AXIS], mesh.shape[COL_AXIS]
    if H % n_r or W % n_c:
        raise ValueError(f"{H}x{W} field not divisible by the "
                         f"{n_r}x{n_c} tile mesh")
    hl, wl = H // n_r, W // n_c
    # a halo exchange is one hop: a halo wider than a tile would need
    # forwarding through several neighbours
    if min(hl, wl) < 2:
        raise ValueError(
            f"tile {hl}x{wl} too small for the 2-px stencil halos; use a "
            f"coarser mesh than {n_r}x{n_c} for a {H}x{W} field")
    if warp_halo > min(hl, wl):
        raise ValueError(
            f"warp_halo={warp_halo} exceeds the {hl}x{wl} tile: the "
            f"one-hop halo exchange cannot reach past one neighbour. "
            f"Lower the displacement bound or use fewer tiles "
            f"(mesh {n_r}x{n_c}, field {H}x{W})")
    tiles = Sharding(mesh, (ROW_AXIS, COL_AXIS))
    first = mesh.devices[0][0]

    def fn(flow, im1, im2):
        parts = [[send(p, d)[None] for p, d in
                  zip(tiles.shards(as_image(x, first)), tiles.devices)]
                 for x in (flow, im1, im2)]
        out = variational_refine_tile(*parts, cfg, level, n_r, n_c, H, W,
                                      warp_halo)
        return gather_tiles(out, n_r, n_c, first)[0]

    return fn
