"""Variational refinement — dense stencils in plain PyTorch (port of
``flowonthego_tpu/ops/variational.py``).

Warp + image derivatives once, then ``level + 1`` fixed-point rounds of
{smoothness, robust data term, sub-Laplacian, red-black SOR, flow
update}.  Every stencil is slicing and shifted adds on a batch of fields
[B, H, W(, C)], never a convolution (a cuDNN convolution could run in
TF32).

Energy constants: datanorm = 0.1^2, eps_color = eps_grad = eps_smooth =
0.001^2; weights quarter_alpha = alpha/4, half_delta_over3 = delta/6,
half_gamma_over3 = gamma/6.

:func:`variational_refine_auto` routes each field by
:func:`varref_backend_for`: the plain stencils here, the K3 kernel
(:mod:`.cuda.varref_fused`, one CTA with everything in its shared
memory) up to :data:`FUSED_MAX_PIXELS`, the
K4 kernel's cluster route (:mod:`.cuda.varref_tiled`, one thread-block
cluster a field) up to :data:`CLUSTER_MAX_PIXELS`, or its grid route (the
whole card) above that.  The choice is by the size of one field,
whatever the batch: K3 runs one CTA per frame, the cluster route one
cluster per frame, the grid route one launch over the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DISConfig, use_kernel_on

DATANORM = 0.1 * 0.1
EPS_COLOR = 0.001 * 0.001
EPS_GRAD = 0.001 * 0.001
EPS_SMOOTH = 0.001 * 0.001


# Both thresholds come from the kernels' times on an H100 80GB HBM3 at 700
# W, by the sweep that chip_smoke.py prints (device time of back-to-back
# launches, at B = 1 and B = 4, C = 3 and C = 1; PERF.md).
# Largest field (pixels) that goes to K3; larger ones go to K4.  K3 runs a
# thread a pixel, so 1,024 pixels is the most it takes, and it is the
# faster on every field it takes: 0.025 vs 0.055 ms for the cluster route
# at 448 px, 0.043 vs 0.047 at 1,024 px (C = 3; 0.030 vs 0.037 at C = 1).
FUSED_MAX_PIXELS = 1_024
# Largest field (pixels) on K4's cluster route; larger ones, and any field
# whose rows do not fit the cluster's shared memory, take the grid route.
# The cluster route is the faster at 3,840 px (0.061 vs 0.073 ms), the grid
# route at 7,168 px (0.059 vs 0.063 ms) and beyond, where 8 CTAs cannot
# get through a phase as fast as 28 can: the two cross at 5,850-6,330 px in
# the sweeps at C = 3 (7,700-8,000 at C = 1).
CLUSTER_MAX_PIXELS = 6_000


def varref_backend_for(cfg: DISConfig, h: int, w: int, device_type: str,
                       channels: int = 3) -> str:
    """Resolve ``cfg.varref_backend`` for an h x w field of ``channels``
    image channels on a device of ``device_type`` ("cpu", "cuda"): "xla"
    (the plain stencils), "fused" (K3), "cluster" or "tiled" (K4's cluster
    and grid routes).  A field goes to K3 or to the cluster route only if
    its planes fit the shared memory that route keeps them in
    (``fused_plan``, ``cluster_plan``).  The TPU package's Mosaic compile
    probe, its seeded verdicts and its 128-lane width rule guard a TPU
    compiler and have no counterpart here."""
    if not use_kernel_on(cfg.varref_backend, device_type):
        return "xla"
    if h * w <= FUSED_MAX_PIXELS:
        from .cuda.varref_fused import fused_plan
        if fused_plan(h, w, channels).fits:
            return "fused"
    if h * w <= CLUSTER_MAX_PIXELS:
        from .cuda.varref_tiled import cluster_plan
        if cluster_plan(h, w).fits:
            return "cluster"
    return "tiled"


def variational_refine_auto(flow, im1, im2, cfg: DISConfig, level: int):
    """Refine the fields ``flow`` [B, h, w, 2] on the backend of
    :func:`varref_backend_for` (chosen by the size h x w of one field and
    the images' channel count)."""
    backend = varref_backend_for(cfg, flow.shape[1], flow.shape[2],
                                 flow.device.type, im1.shape[-1])
    if backend == "fused":
        from .cuda.varref_fused import variational_refine_fused
        return variational_refine_fused(flow, im1, im2, cfg, level)
    if backend in ("cluster", "tiled"):
        from .cuda.varref_tiled import variational_refine_tiled
        return variational_refine_tiled(
            flow, im1, im2, cfg, level,
            route="cluster" if backend == "cluster" else "grid")
    return variational_refine(flow, im1, im2, cfg, level)


# ---------------------------------------------------------------- derivatives

def _edge_taps(x: torch.Tensor, axis: int, offsets):
    """x shifted by each offset along ``axis`` with replicate borders."""
    n = x.shape[axis]
    ar = torch.arange(n, device=x.device)
    return [x.index_select(axis, (ar + o).clamp(0, n - 1)) for o in offsets]


def deriv5(x: torch.Tensor, axis: int) -> torch.Tensor:
    """(8*(x[i+1] - x[i-1]) - (x[i+2] - x[i-2])) / 12, replicate border."""
    m2, m1, p1, p2 = _edge_taps(x, axis, (-2, -1, 1, 2))
    return (8.0 * (p1 - m1) - (p2 - m2)) / 12.0


def deriv3(x: torch.Tensor, axis: int) -> torch.Tensor:
    """0.5 * (x[i+1] - x[i-1]), replicate border."""
    m1, p1 = _edge_taps(x, axis, (-1, 1))
    return 0.5 * (p1 - m1)


# ------------------------------------------------------------------- warping

def warp_image(src: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor):
    """Backward-warp the frames ``src`` [B, H, W, C] by flows (wx, wy)
    [B, H, W]: bilinear with a clamp on each tap (within each frame) plus
    an in-bounds mask.  Returns (warped [B, H, W, C], mask [B, H, W])."""
    B, h, w = src.shape[:3]
    jj = torch.arange(h, dtype=src.dtype, device=src.device)[:, None]
    ii = torch.arange(w, dtype=src.dtype, device=src.device)[None, :]
    fr = torch.arange(B, device=src.device)[:, None, None]
    xx = ii + wx
    yy = jj + wy
    x0 = torch.floor(xx)
    y0 = torch.floor(yy)
    dx = xx - x0
    dy = yy - y0
    mask = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)).to(src.dtype)
    x1 = x0.clamp(0, w - 1).long()
    x2 = (x0 + 1).clamp(0, w - 1).long()
    y1 = y0.clamp(0, h - 1).long()
    y2 = (y0 + 1).clamp(0, h - 1).long()
    dxe = dx[..., None]
    dye = dy[..., None]
    warped = (src[fr, y1, x1] * (1 - dxe) * (1 - dye)
              + src[fr, y1, x2] * dxe * (1 - dye)
              + src[fr, y2, x1] * (1 - dxe) * dye
              + src[fr, y2, x2] * dxe * dye)
    return warped, mask


class Derivatives(NamedTuple):
    Ix: torch.Tensor
    Iy: torch.Tensor
    Iz: torch.Tensor
    Ixx: torch.Tensor
    Ixy: torch.Tensor
    Iyy: torch.Tensor
    Ixz: torch.Tensor
    Iyz: torch.Tensor


def get_derivatives(im1: torch.Tensor, w_im2: torch.Tensor) -> Derivatives:
    """Spatial/temporal derivatives on the mean of im1 and warped im2
    ([..., H, W, C]: x is dim -2, y dim -3)."""
    mean = 0.5 * (im1 + w_im2)
    Iz = w_im2 - im1
    Ix = deriv5(mean, axis=-2)
    Iy = deriv5(mean, axis=-3)
    return Derivatives(
        Ix=Ix, Iy=Iy, Iz=Iz,
        Ixx=deriv5(Ix, axis=-2),
        Ixy=deriv5(Ix, axis=-3),
        Iyy=deriv5(Iy, axis=-3),
        Ixz=deriv5(Iz, axis=-2),
        Iyz=deriv5(Iz, axis=-3),
    )


# ---------------------------------------------------------------- smoothness

def compute_smoothness(uu: torch.Tensor, vv: torch.Tensor,
                       quarter_alpha: float):
    """s = alpha/4 / sqrt(|grad u|^2 + |grad v|^2 + eps);
    s_horiz[j,i] = s[j,i] + s[j,i+1] (last column zero),
    s_vert[j,i] = s[j,i] + s[j+1,i] (last row zero); planes [..., H, W]."""
    ux = deriv3(uu, axis=-1)
    uy = deriv3(uu, axis=-2)
    vx = deriv3(vv, axis=-1)
    vy = deriv3(vv, axis=-2)
    s = quarter_alpha / torch.sqrt(ux * ux + uy * uy + vx * vx + vy * vy
                                   + EPS_SMOOTH)
    zc = torch.zeros_like(s[..., :1])
    zr = torch.zeros_like(s[..., :1, :])
    s_horiz = torch.cat([s[..., :-1] + s[..., 1:], zc], dim=-1)
    s_vert = torch.cat([s[..., :-1, :] + s[..., 1:, :], zr], dim=-2)
    return s_horiz, s_vert


# ----------------------------------------------------------------- data term

def data_term(mask: torch.Tensor, du: torch.Tensor, dv: torch.Tensor,
              d: Derivatives, half_delta_over3: float,
              half_gamma_over3: float):
    """Robust color + gradient constancy normal equations: the per-pixel
    2x2 system (a11, a12, a22, b1, b2), channels summed with per-channel
    normalization and a shared robust weight."""
    a11 = torch.zeros_like(du)
    a12 = torch.zeros_like(du)
    a22 = torch.zeros_like(du)
    b1 = torch.zeros_like(du)
    b2 = torch.zeros_like(du)
    due = du[..., None]
    dve = dv[..., None]

    if half_delta_over3 != 0.0:
        r = d.Iz + d.Ix * due + d.Iy * dve
        n = d.Ix * d.Ix + d.Iy * d.Iy + DATANORM
        t = mask * half_delta_over3 / torch.sqrt(
            (r * r / n).sum(-1) + EPS_COLOR)
        tc = t[..., None] / n
        a11 = a11 + (tc * d.Ix * d.Ix).sum(-1)
        a12 = a12 + (tc * d.Ix * d.Iy).sum(-1)
        a22 = a22 + (tc * d.Iy * d.Iy).sum(-1)
        b1 = b1 - (tc * d.Iz * d.Ix).sum(-1)
        b2 = b2 - (tc * d.Iz * d.Iy).sum(-1)

    n1 = d.Ixx * d.Ixx + d.Ixy * d.Ixy + DATANORM
    n2 = d.Iyy * d.Iyy + d.Ixy * d.Ixy + DATANORM
    r1 = d.Ixz + d.Ixx * due + d.Ixy * dve
    r2 = d.Iyz + d.Ixy * due + d.Iyy * dve
    t = mask * half_gamma_over3 / torch.sqrt(
        (r1 * r1 / n1 + r2 * r2 / n2).sum(-1) + EPS_GRAD)
    t1 = t[..., None] / n1
    t2 = t[..., None] / n2
    a11 = a11 + (t1 * d.Ixx * d.Ixx + t2 * d.Ixy * d.Ixy).sum(-1)
    a12 = a12 + (t1 * d.Ixx * d.Ixy + t2 * d.Ixy * d.Iyy).sum(-1)
    a22 = a22 + (t2 * d.Iyy * d.Iyy + t1 * d.Ixy * d.Ixy).sum(-1)
    b1 = b1 - (t1 * d.Ixx * d.Ixz + t2 * d.Ixy * d.Iyz).sum(-1)
    b2 = b2 - (t2 * d.Iyy * d.Iyz + t1 * d.Ixy * d.Ixz).sum(-1)
    return a11, a12, a22, b1, b2


# ------------------------------------------------------------- sub-Laplacian

def sub_laplacian(dst: torch.Tensor, src: torch.Tensor, s_horiz: torch.Tensor,
                  s_vert: torch.Tensor) -> torch.Tensor:
    """dst += weighted 5-point Laplacian of src (s_horiz's last column and
    s_vert's last row are zero, so no out-of-range tap contributes)."""
    src_r = torch.cat([src[..., 1:], src[..., -1:]], dim=-1)
    coeff_h = s_horiz * (src_r - src)
    zc = torch.zeros_like(coeff_h[..., :1])
    dst = dst + coeff_h - torch.cat([zc, coeff_h[..., :-1]], dim=-1)

    src_d = torch.cat([src[..., 1:, :], src[..., -1:, :]], dim=-2)
    coeff_v = s_vert * (src_d - src)
    zr = torch.zeros_like(coeff_v[..., :1, :])
    dst = dst + coeff_v - torch.cat([zr, coeff_v[..., :-1, :]], dim=-2)
    return dst


# ------------------------------------------------------------------ SOR

def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """result[..., j, i] = x[..., j+dy, i+dx], zero-filled."""
    h, w = x.shape[-2:]
    xp = torch.nn.functional.pad(x, (max(-dx, 0), max(dx, 0),
                                     max(-dy, 0), max(dy, 0)))
    return xp[..., max(dy, 0):max(dy, 0) + h, max(dx, 0):max(dx, 0) + w]


def sor_solve(du, dv, a11, a12, a22, b1, b2, s_horiz, s_vert,
              iterations: int, omega: float):
    """Red-black coupled SOR for the per-pixel 2x2 systems: each iteration
    sweeps the odd then the even checkerboard; within a cell the dv update
    uses the freshly written du.  Planes [..., H, W]; the checkerboard is
    each field's own."""
    h, w = du.shape[-2:]
    jj = torch.arange(h, device=du.device)[:, None]
    ii = torch.arange(w, device=du.device)[None, :]
    parity = (ii + jj) % 2

    s_vert_up = _shift(s_vert, -1, 0)
    s_horiz_left = _shift(s_horiz, 0, -1)
    sum_dpsis = s_vert_up + s_horiz_left + s_vert + s_horiz
    A11 = a11 + sum_dpsis
    A22 = a22 + sum_dpsis

    def half_sweep(du, dv, want_parity):
        sigma_u = -(s_vert_up * _shift(du, -1, 0)
                    + s_horiz_left * _shift(du, 0, -1)
                    + s_vert * _shift(du, 1, 0)
                    + s_horiz * _shift(du, 0, 1))
        sigma_v = -(s_vert_up * _shift(dv, -1, 0)
                    + s_horiz_left * _shift(dv, 0, -1)
                    + s_vert * _shift(dv, 1, 0)
                    + s_horiz * _shift(dv, 0, 1))
        B1 = b1 - sigma_u
        B2 = b2 - sigma_v
        du_new = (1.0 - omega) * du + omega / A11 * (B1 - a12 * dv)
        dv_new = (1.0 - omega) * dv + omega / A22 * (B2 - a12 * du_new)
        sel = parity == want_parity
        return torch.where(sel, du_new, du), torch.where(sel, dv_new, dv)

    for _ in range(iterations):
        du, dv = half_sweep(du, dv, 1)   # odd first
        du, dv = half_sweep(du, dv, 0)
    return du, dv


# ------------------------------------------------------------- orchestration

def refine_loop(wx, wy, mask, d: Derivatives, cfg: DISConfig,
                inner_iter: int):
    """The fixed-point loop: ``inner_iter`` rounds from du = dv = 0.
    Returns (uu, vv) = (wx + du, wy + dv)."""
    qa = 0.25 * cfg.var_ref_alpha
    hd3 = cfg.var_ref_delta * 0.5 / 3.0
    hg3 = cfg.var_ref_gamma * 0.5 / 3.0
    du = torch.zeros_like(wx)
    dv = torch.zeros_like(wy)
    uu, vv = wx, wy
    for _ in range(inner_iter):
        s_horiz, s_vert = compute_smoothness(uu, vv, qa)
        a11, a12, a22, b1, b2 = data_term(mask, du, dv, d, hd3, hg3)
        b1 = sub_laplacian(b1, wx, s_horiz, s_vert)
        b2 = sub_laplacian(b2, wy, s_horiz, s_vert)
        du, dv = sor_solve(du, dv, a11, a12, a22, b1, b2, s_horiz, s_vert,
                           cfg.var_ref_iter, cfg.var_ref_sor_weight)
        uu = wx + du
        vv = wy + dv
    return uu, vv


def variational_refine(flow: torch.Tensor, im1: torch.Tensor,
                       im2: torch.Tensor, cfg: DISConfig,
                       level: int) -> torch.Tensor:
    """Refine dense flows [B, H, W, 2] against the unpadded scale images
    [B, H, W, C]: warp + derivatives once, then ``level + 1`` fixed-point
    rounds."""
    wx = flow[..., 0]
    wy = flow[..., 1]
    w_im2, mask = warp_image(im2, wx, wy)
    d = get_derivatives(im1, w_im2)
    uu, vv = refine_loop(wx, wy, mask, d, cfg, level + 1)
    return torch.stack([uu, vv], dim=-1)
