"""Dense Inverse Search with variational refinement in plain PyTorch: the
benchmark's reference.

It computes what a deployment's configuration states (``configs/*.json``,
key ``dis``) on the frames the run made, and nothing of the program under
test goes into it: it imports no module of the program, takes none of its
tensors, tables or configuration objects, and runs float32 throughout with
TF32 off.  It follows Kroeger et al., "Fast Optical Flow using Dense
Inverse Search" (ECCV 2016), in the form the program implements it:

    replicate-pad to 2^coarsest divisibility -> image pyramid (2x2 means)
    with central-difference gradients -> per scale, coarse to fine:
    mean-normalised templates and Gauss-Newton Hessians on a patch grid;
    warm start from the coarser flow (nearest lookup at floor(mid/2), x2);
    ``grad_descent_iter`` inverse-search steps with the outlier reset;
    densify (weights 1 / sum_c max(min_errval, residual^2)); variational
    refinement (warp, 5-tap derivatives, level + 1 rounds of 3 red-black
    SOR sweeps) -> bilinear upsample of the finest flow -> crop.

Only the modes the benchmark's configurations state are here: the L2 cost,
fixed trips, squared densify weights, no forward-backward merge.  A
configuration asking for another mode is refused (:func:`check_params`).
Frames carry a leading batch axis [B, H, W, C]; the benchmark runs B = 1.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

DATANORM = 0.1 * 0.1
EPS = 0.001 * 0.001
PATCH = (-3, -2, -1)

# the configuration keys this reference implements, with the values it
# implements for the mode switches
FIXED = {"use_fb_consistency": False, "cost_fn": "l2",
         "densify_weight": "squared", "res_thresh": 0.0, "min_iter": None,
         "dtype": "float32"}


def check_params(p: dict) -> None:
    """Raise unless ``p`` (a configuration's ``dis`` object) states only
    what this reference computes."""
    for key, want in FIXED.items():
        if p.get(key, want) != want:
            raise ValueError(f"the reference computes {key}={want!r}, the "
                             f"configuration states {p[key]!r}")


def pin_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def steps_of(p: dict) -> int:
    return max(1, int(math.floor(p["patch_size"] * (1.0 - p["patch_stride"]))))


def pads_for(height: int, width: int, coarsest: int):
    """(top, bottom, left, right) replicate padding to a multiple of
    2^coarsest, split floor/ceil."""
    m = 2 ** coarsest
    ph, pw = (-height) % m, (-width) % m
    return ph // 2, ph - ph // 2, pw // 2, pw - pw // 2


# ------------------------------------------------------------------ pyramid

def pad_replicate(img, pad):
    pt, pb, pl, pr = (pad,) * 4 if isinstance(pad, int) else pad
    H, W = img.shape[-3], img.shape[-2]
    rows = torch.arange(-pt, H + pb, device=img.device).clamp(0, H - 1)
    cols = torch.arange(-pl, W + pr, device=img.device).clamp(0, W - 1)
    return img.index_select(-3, rows).index_select(-2, cols)


def pool2x2(img):
    """2x2 mean of [B, H, W, C]: ((a + b) + c) + d, then x0.25."""
    B, H, W, C = img.shape
    v = img.reshape(B, H // 2, 2, W // 2, 2, C)
    s = ((v[:, :, 0, :, 0] + v[:, :, 0, :, 1]) + v[:, :, 1, :, 0]) \
        + v[:, :, 1, :, 1]
    return s * 0.25


class Level(NamedTuple):
    image: torch.Tensor      # replicate-padded
    grad_x: torch.Tensor     # zero-padded I[x+1] - I[x-1]
    grad_y: torch.Tensor


def make_level(img, padding: int) -> Level:
    xp = pad_replicate(img, (0, 0, 1, 1))
    gx = xp[..., 2:, :] - xp[..., :-2, :]
    yp = pad_replicate(img, (1, 1, 0, 0))
    gy = yp[..., 2:, :, :] - yp[..., :-2, :, :]
    zero = (0, 0, padding, padding, padding, padding)
    return Level(pad_replicate(img, padding), F.pad(gx, zero), F.pad(gy, zero))


def pyramid(img, p: dict) -> dict:
    """{scale: Level} for scales finest..coarsest of frames [B, H, W, C]."""
    out = {}
    cur = img.float()
    for lvl in range(p["coarsest_scale"] + 1):
        if lvl > 0:
            cur = pool2x2(cur)
        if lvl >= p["finest_scale"]:
            out[lvl] = make_level(cur, p["patch_size"])
    return out


# -------------------------------------------------------------- patch grid

class Grid(NamedTuple):
    width: int
    height: int
    ps: int
    steps: int
    n_w: int
    n_h: int
    off_w: int
    off_h: int
    padding: int

    @property
    def l_bound(self):
        return -self.ps / 2.0

    @property
    def ub_w(self):
        return float(self.width + self.ps // 2 - 2)

    @property
    def ub_h(self):
        return float(self.height + self.ps // 2 - 2)


def make_grid(p: dict, width: int, height: int) -> Grid:
    st = steps_of(p)
    n_w, n_h = -(-width // st), -(-height // st)
    return Grid(width, height, p["patch_size"], st, n_w, n_h,
                (width - (n_w - 1) * st) // 2, (height - (n_h - 1) * st) // 2,
                p["patch_size"])


def midpoints(g: Grid, device):
    """[1, n_h, n_w, 2] float32 (x, y) patch centres."""
    mx = torch.arange(g.n_w, device=device) * g.steps + g.off_w
    my = torch.arange(g.n_h, device=device) * g.steps + g.off_h
    yy, xx = torch.meshgrid(my, mx, indexing="ij")
    return torch.stack([xx, yy], dim=-1)[None].float()


def windows(img_pad, g: Grid):
    """[B, n_h, n_w, ps, ps, C] template windows of padded levels."""
    ps, st = g.ps, g.steps
    top = g.padding + g.off_h - ps // 2
    left = g.padding + g.off_w - ps // 2
    r = torch.arange(ps, device=img_pad.device)
    iy = (top + torch.arange(g.n_h, device=img_pad.device) * st)[:, None] + r
    ix = (left + torch.arange(g.n_w, device=img_pad.device) * st)[:, None] + r
    rows = img_pad[:, iy.reshape(-1)].reshape(img_pad.shape[0], g.n_h, ps,
                                                *img_pad.shape[2:])
    win = rows[:, :, :, ix.reshape(-1)].reshape(
        img_pad.shape[0], g.n_h, ps, g.n_w, ps, img_pad.shape[3])
    return win.permute(0, 1, 3, 2, 4, 5)


def templates_and_hessians(lvl: Level, g: Grid, p: dict):
    T = windows(lvl.image, g)
    gx = windows(lvl.grad_x, g)
    gy = windows(lvl.grad_y, g)
    if p["use_mean_normalization"]:
        T = T - T.mean(dim=PATCH, keepdim=True)
    h00 = (gx * gx).sum(dim=PATCH)
    h01 = (gx * gy).sum(dim=PATCH)
    h11 = (gy * gy).sum(dim=PATCH)
    bump = torch.where(h00 * h11 - h01 * h01 == 0.0, 1e-10, 0.0)
    return T, gx, gy, (h00 + bump, h01, h11 + bump)


def sample(img_pad, mx, my, ps: int, padding: int):
    """ps x ps bilinear samples centred at float (mx, my) [B, n_h, n_w]."""
    B, Hp, Wp, C = img_pad.shape
    K = ps + 1
    fx, fy = torch.floor(mx), torch.floor(my)
    rx = (mx - fx)[..., None, None, None]
    ry = (my - fy)[..., None, None, None]

    def starts(f, n):
        s = f.long() + (padding - ps // 2)
        s = torch.where(s < 0, s + n, s)
        return s.clamp(0, n - K)

    ar = torch.arange(K, device=img_pad.device)
    iy = (starts(fy, Hp)[..., None] + ar)[..., :, None]
    ix = (starts(fx, Wp)[..., None] + ar)[..., None, :]
    b = torch.arange(B, device=img_pad.device).reshape(B, 1, 1, 1, 1)
    w = img_pad[b, iy, ix]                  # [B, n_h, n_w, K, K, C]
    return ((1.0 - rx) * (1.0 - ry) * w[..., :ps, :ps, :]
            + rx * (1.0 - ry) * w[..., :ps, 1:, :]
            + (1.0 - rx) * ry * w[..., 1:, :ps, :]
            + rx * ry * w[..., 1:, 1:, :])


def inverse_search(I1_pad, T, gx, gy, H, mid, p_init, started, g: Grid,
                   p: dict, count: bool = False):
    """``grad_descent_iter`` Gauss-Newton steps of every started patch from
    ``p_init``; a step beyond ps/2 of the midpoint or out of the box
    resets the patch to ``p_init`` and stops it.  Returns (p, cost_px)
    and, with ``count``, the steps each patch took."""
    N = T.shape[-3] * T.shape[-2] * T.shape[-1]
    mean_on = 1.0 if p["use_mean_normalization"] else 0.0
    gxs, gys = gx.sum(dim=PATCH), gy.sum(dim=PATCH)
    gxT, gyT = (gx * T).sum(dim=PATCH), (gy * T).sum(dim=PATCH)
    h00, h01, h11 = H
    det = h00 * h11 - h01 * h01
    thresh = p["patch_size"] / 2.0
    pos, active = p_init, started
    trips = torch.zeros_like(started, dtype=torch.int64)
    for _ in range(p["grad_descent_iter"]):
        trips += active
        m = mid + pos
        S = sample(I1_pad, m[..., 0], m[..., 1], g.ps, g.padding)
        mean = S.sum(dim=PATCH) / N * mean_on
        dpx = (S * gx).sum(dim=PATCH) - mean * gxs - gxT
        dpy = (S * gy).sum(dim=PATCH) - mean * gys - gyT
        step = torch.stack([(h11 * dpx - h01 * dpy) / det,
                            (h00 * dpy - h01 * dpx) / det], dim=-1)
        new = pos - step
        mn = mid + new
        disp = mn - mid
        out = ((torch.sqrt(disp[..., 0] ** 2 + disp[..., 1] ** 2) > thresh)
               | (mn[..., 0] < g.l_bound) | (mn[..., 1] < g.l_bound)
               | (mn[..., 0] > g.ub_w) | (mn[..., 1] > g.ub_h))
        new = torch.where(out[..., None], p_init, new)
        pos = torch.where(active[..., None], new, pos)
        active = active & ~out
    m = mid + pos
    S = sample(I1_pad, m[..., 0], m[..., 1], g.ps, g.padding)
    if mean_on:
        S = S - S.mean(dim=PATCH, keepdim=True)
    d = S - T
    cost_px = torch.where(started[..., None, None, None], d * d, 0.0)
    return (pos, cost_px, trips) if count else (pos, cost_px)


def densify(pos, cost_px, g: Grid, p: dict):
    """Dense [B, h, w, 2]: each patch's flow spread over its ps x ps pixels
    with weight 1 / sum_c max(min_errval, cost), normalised; pixels no
    patch covers get 0."""
    B = pos.shape[0]
    w = 1.0 / torch.clamp(cost_px, min=p["min_errval"]).sum(dim=-1)
    contrib = torch.stack([w, w * pos[..., 0][..., None, None],
                           w * pos[..., 1][..., None, None]], dim=-1)
    ps, st = g.ps, g.steps
    top = g.off_h - ps // 2
    left = g.off_w - ps // 2
    m = ps                        # margin for windows that stick out
    acc = torch.zeros(B, g.height + 2 * m, g.width + 2 * m, 3,
                      device=pos.device)
    for r in range(ps):
        for c in range(ps):
            y0, x0 = m + top + r, m + left + c
            acc[:, y0:y0 + (g.n_h - 1) * st + 1:st,
                x0:x0 + (g.n_w - 1) * st + 1:st] += contrib[:, :, :, r, c]
    acc = acc[:, m:m + g.height, m:m + g.width]
    weight = acc[..., 0:1]
    return torch.where(weight > 0, acc[..., 1:3] / weight, 0.0)


# -------------------------------------------------------- variational step

def _taps(x, axis, offsets):
    n = x.shape[axis]
    ar = torch.arange(n, device=x.device)
    return [x.index_select(axis, (ar + o).clamp(0, n - 1)) for o in offsets]


def deriv5(x, axis):
    m2, m1, p1, p2 = _taps(x, axis, (-2, -1, 1, 2))
    return (8.0 * (p1 - m1) - (p2 - m2)) / 12.0


def deriv3(x, axis):
    m1, p1 = _taps(x, axis, (-1, 1))
    return 0.5 * (p1 - m1)


def warp(src, wx, wy):
    """Bilinear backward warp of [B, h, w, C] by (wx, wy) [B, h, w], taps
    clamped, and the in-bounds mask."""
    B, h, w = src.shape[:3]
    jj = torch.arange(h, dtype=src.dtype, device=src.device)[:, None]
    ii = torch.arange(w, dtype=src.dtype, device=src.device)[None, :]
    b = torch.arange(B, device=src.device)[:, None, None]
    xx, yy = ii + wx, jj + wy
    x0, y0 = torch.floor(xx), torch.floor(yy)
    dx, dy = (xx - x0)[..., None], (yy - y0)[..., None]
    mask = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)).to(src.dtype)
    x1, x2 = x0.clamp(0, w - 1).long(), (x0 + 1).clamp(0, w - 1).long()
    y1, y2 = y0.clamp(0, h - 1).long(), (y0 + 1).clamp(0, h - 1).long()
    out = (src[b, y1, x1] * (1 - dx) * (1 - dy)
           + src[b, y1, x2] * dx * (1 - dy)
           + src[b, y2, x1] * (1 - dx) * dy + src[b, y2, x2] * dx * dy)
    return out, mask


def _shift(x, dy, dx):
    """out[..., j, i] = x[..., j + dy, i + dx], zero outside."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (max(-dx, 0), max(dx, 0), max(-dy, 0), max(dy, 0)))
    return xp[..., max(dy, 0):max(dy, 0) + h, max(dx, 0):max(dx, 0) + w]


def refine(flow, im1, im2, p: dict, level: int):
    """Variational refinement of [B, h, w, 2] against the unpadded scale
    images: ``level + 1`` rounds of smoothness, the robust colour and
    gradient constancy terms and ``var_ref_iter`` red-black SOR sweeps."""
    wx, wy = flow[..., 0], flow[..., 1]
    w2, mask = warp(im2, wx, wy)
    mean, Iz = 0.5 * (im1 + w2), w2 - im1
    Ix, Iy = deriv5(mean, -2), deriv5(mean, -3)
    Ixx, Ixy, Iyy = deriv5(Ix, -2), deriv5(Ix, -3), deriv5(Iy, -3)
    Ixz, Iyz = deriv5(Iz, -2), deriv5(Iz, -3)
    qa = 0.25 * p["var_ref_alpha"]
    hd3 = p["var_ref_delta"] * 0.5 / 3.0
    hg3 = p["var_ref_gamma"] * 0.5 / 3.0
    omega = p["var_ref_sor_weight"]
    h, w = wx.shape[-2:]
    parity = (torch.arange(w, device=wx.device)[None, :]
              + torch.arange(h, device=wx.device)[:, None]) % 2
    du, dv = torch.zeros_like(wx), torch.zeros_like(wy)
    uu, vv = wx, wy
    for _ in range(level + 1):
        ux, uy, vx, vy = deriv3(uu, -1), deriv3(uu, -2), deriv3(vv, -1), \
            deriv3(vv, -2)
        s = qa / torch.sqrt(ux * ux + uy * uy + vx * vx + vy * vy + EPS)
        sh = torch.cat([s[..., :-1] + s[..., 1:],
                        torch.zeros_like(s[..., :1])], dim=-1)
        sv = torch.cat([s[..., :-1, :] + s[..., 1:, :],
                        torch.zeros_like(s[..., :1, :])], dim=-2)
        due, dve = du[..., None], dv[..., None]
        a11 = a12 = a22 = b1 = b2 = torch.zeros_like(du)
        if hd3 != 0.0:
            r = Iz + Ix * due + Iy * dve
            n = Ix * Ix + Iy * Iy + DATANORM
            t = mask * hd3 / torch.sqrt((r * r / n).sum(-1) + EPS)
            tc = t[..., None] / n
            a11 = a11 + (tc * Ix * Ix).sum(-1)
            a12 = a12 + (tc * Ix * Iy).sum(-1)
            a22 = a22 + (tc * Iy * Iy).sum(-1)
            b1 = b1 - (tc * Iz * Ix).sum(-1)
            b2 = b2 - (tc * Iz * Iy).sum(-1)
        n1 = Ixx * Ixx + Ixy * Ixy + DATANORM
        n2 = Iyy * Iyy + Ixy * Ixy + DATANORM
        r1 = Ixz + Ixx * due + Ixy * dve
        r2 = Iyz + Ixy * due + Iyy * dve
        t = mask * hg3 / torch.sqrt((r1 * r1 / n1 + r2 * r2 / n2).sum(-1)
                                    + EPS)
        t1, t2 = t[..., None] / n1, t[..., None] / n2
        a11 = a11 + (t1 * Ixx * Ixx + t2 * Ixy * Ixy).sum(-1)
        a12 = a12 + (t1 * Ixx * Ixy + t2 * Ixy * Iyy).sum(-1)
        a22 = a22 + (t2 * Iyy * Iyy + t1 * Ixy * Ixy).sum(-1)
        b1 = b1 - (t1 * Ixx * Ixz + t2 * Ixy * Iyz).sum(-1)
        b2 = b2 - (t2 * Iyy * Iyz + t1 * Ixy * Ixz).sum(-1)
        b1 = _laplace(b1, wx, sh, sv)
        b2 = _laplace(b2, wy, sh, sv)
        du, dv = _sor(du, dv, a11, a12, a22, b1, b2, sh, sv, parity,
                      p["var_ref_iter"], omega)
        uu, vv = wx + du, wy + dv
    return torch.stack([uu, vv], dim=-1)


def _laplace(dst, src, sh, sv):
    src_r = torch.cat([src[..., 1:], src[..., -1:]], dim=-1)
    ch = sh * (src_r - src)
    dst = dst + ch - torch.cat([torch.zeros_like(ch[..., :1]), ch[..., :-1]],
                               dim=-1)
    src_d = torch.cat([src[..., 1:, :], src[..., -1:, :]], dim=-2)
    cv = sv * (src_d - src)
    return dst + cv - torch.cat([torch.zeros_like(cv[..., :1, :]),
                                 cv[..., :-1, :]], dim=-2)


def _sor(du, dv, a11, a12, a22, b1, b2, sh, sv, parity, iters, omega):
    svu, shl = _shift(sv, -1, 0), _shift(sh, 0, -1)
    A11 = a11 + (svu + shl + sv + sh)
    A22 = a22 + (svu + shl + sv + sh)

    def sweep(du, dv, want):
        su = -(svu * _shift(du, -1, 0) + shl * _shift(du, 0, -1)
               + sv * _shift(du, 1, 0) + sh * _shift(du, 0, 1))
        sv_ = -(svu * _shift(dv, -1, 0) + shl * _shift(dv, 0, -1)
                + sv * _shift(dv, 1, 0) + sh * _shift(dv, 0, 1))
        du_new = (1.0 - omega) * du + omega / A11 * ((b1 - su) - a12 * dv)
        dv_new = (1.0 - omega) * dv + omega / A22 * ((b2 - sv_) - a12 * du_new)
        sel = parity == want
        return torch.where(sel, du_new, du), torch.where(sel, dv_new, dv)

    for _ in range(iters):
        du, dv = sweep(du, dv, 1)
        du, dv = sweep(du, dv, 0)
    return du, dv


# -------------------------------------------------------------- resizes

def interp_matrix(out_len: int, in_len: int, device) -> torch.Tensor:
    """[out, in] bilinear weights, half-pixel centres, clamped taps."""
    j = np.arange(out_len, dtype=np.float64)
    src = np.clip((j + 0.5) * in_len / out_len - 0.5, 0.0, in_len - 1)
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    R = np.zeros((out_len, in_len), np.float32)
    R[j.astype(np.int64), i0] += (1.0 - frac).astype(np.float32)
    R[j.astype(np.int64), np.minimum(i0 + 1, in_len - 1)] += \
        frac.astype(np.float32)
    return torch.as_tensor(R, device=device)


def upsample(flow, out_h: int, out_w: int, factor: float):
    """Bilinear resize of ``flow * factor`` [B, h, w, 2] to out_h x out_w,
    as two float32 matrix products."""
    Rv = interp_matrix(out_h, flow.shape[1], flow.device)
    Rh = interp_matrix(out_w, flow.shape[2], flow.device)
    tmp = torch.einsum("oh,...hwc->...owc", Rv, flow * factor)
    return torch.einsum("pw,...owc->...opc", Rh, tmp)


def warm_start(finest, p: dict, init_h: int, init_w: int):
    """The next pair's warm start: the finest flow [B, h, w, 2] scaled to
    1/2^(coarsest + 1) and resized there with a triangle filter
    (antialiased linear)."""
    x = finest / (2.0 ** (p["coarsest_scale"] + 1 - p["finest_scale"]))
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(init_h, init_w),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).contiguous()


# ------------------------------------------------------------- pipeline

def flow_from_pyramids(pyr0, pyr1, p: dict, init: Optional[torch.Tensor],
                       count: Optional[dict] = None):
    """The finest-scale flow [B, H/2^fs, W/2^fs, 2] from two pyramids;
    ``init`` is the warm start at 1/2^(coarsest + 1) or None.  With
    ``count`` (a dict) each scale's patches, started patches and steps
    taken are added under the scale's number."""
    cs, fs = p["coarsest_scale"], p["finest_scale"]
    pad = p["patch_size"]
    H = pyr0[cs].image.shape[1] - 2 * pad << cs
    W = pyr0[cs].image.shape[2] - 2 * pad << cs
    flow = init
    for sl in range(cs, fs - 1, -1):
        w, h = W >> sl, H >> sl
        g = make_grid(p, w, h)
        l0, l1 = pyr0[sl], pyr1[sl]
        T, gx, gy, Hs = templates_and_hessians(l0, g, p)
        mid = midpoints(g, T.device)
        B = T.shape[0]
        if flow is None:
            pos = torch.zeros(B, g.n_h, g.n_w, 2, device=T.device)
            started = torch.ones(B, g.n_h, g.n_w, dtype=torch.bool,
                                 device=T.device)
        else:
            ch, cw = flow.shape[1], flow.shape[2]
            iy = torch.clamp(mid[0, :, 0, 1].long() // 2, max=ch - 1)
            ix = torch.clamp(mid[0, 0, :, 0].long() // 2, max=cw - 1)
            pos = flow[:, iy][:, :, ix] * 2.0
            m = mid + pos
            started = ~((m[..., 0] < g.l_bound) | (m[..., 1] < g.l_bound)
                        | (m[..., 0] > g.ub_w) | (m[..., 1] > g.ub_h))
        res = inverse_search(l1.image, T, gx, gy, Hs, mid, pos, started, g,
                             p, count=count is not None)
        if count is not None:
            c = count.setdefault(sl, [0, 0, 0])
            c[0] += started.numel()
            c[1] += int(started.sum())
            c[2] += int(res[2].sum())
        flow = densify(res[0], res[1], g, p)
        if p["use_var_ref"]:
            im1 = l0.image[:, pad:pad + h, pad:pad + w]
            im2 = l1.image[:, pad:pad + h, pad:pad + w]
            flow = refine(flow, im1, im2, p, sl)
    return flow


def full_flow(finest, p: dict, H: int, W: int):
    """The finest flow upsampled to the padded frame size H x W."""
    fs = p["finest_scale"]
    return finest if fs == 0 else upsample(finest, H, W, float(2 ** fs))


def pair_flow(I0, I1, p: dict, count: Optional[dict] = None):
    """Full-resolution flow [H, W, 2] of one unpadded pair [H, W, C] (any
    dtype): padded, solved, upsampled and cropped back."""
    pin_fp32()
    h, w = I0.shape[0], I0.shape[1]
    pads = pads_for(h, w, p["coarsest_scale"])
    a = pad_replicate(I0[None].float(), pads)
    b = pad_replicate(I1[None].float(), pads)
    fin = flow_from_pyramids(pyramid(a, p), pyramid(b, p), p, None, count)
    full = full_flow(fin, p, a.shape[1], a.shape[2])
    return full[0, pads[0]:pads[0] + h, pads[2]:pads[2] + w]


def init_shape(p: dict, H: int, W: int):
    return H >> (p["coarsest_scale"] + 1), W >> (p["coarsest_scale"] + 1)


def stream_step(prev_pyr, frame, p: dict, init,
                count: Optional[dict] = None):
    """One step of a warm-started stream on a padded frame [H, W, C]:
    (full flow [H, W, 2], finest flow, this frame's pyramid)."""
    pin_fp32()
    pyr = pyramid(frame[None].float(), p)
    fin = flow_from_pyramids(prev_pyr, pyr, p, init, count)
    return full_flow(fin, p, frame.shape[0], frame.shape[1])[0], fin, pyr


def finest_from_full(full, p: dict):
    """The finest-scale flow [1, h, w, 2] whose upsample is ``full`` [H, W,
    2]: the least-squares inverse of the two resize matrices, in float64
    (exact up to the upsample's float32 rounding)."""
    fs = p["finest_scale"]
    if fs == 0:
        return full[None].float()
    H, W = full.shape[0], full.shape[1]
    Lv = _left_inverse(H, H >> fs, full.device)
    Lh = _left_inverse(W, W >> fs, full.device)
    x = full.double().permute(2, 0, 1)                      # [2, H, W]
    f = Lv @ x @ Lh.T
    return (f.permute(1, 2, 0) / 2 ** fs).float()[None]


def _left_inverse(out_len: int, in_len: int, device) -> torch.Tensor:
    """(R^T R)^-1 R^T of the [out, in] resize matrix R, float64."""
    R = interp_matrix(out_len, in_len, device).double()
    return torch.linalg.solve(R.T @ R, R.T)
