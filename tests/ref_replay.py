"""A numpy replay of G6's arithmetic (``csrc/dis_ref.cu``), value by value
and lane by lane, in float32.

The kernel gives a patch one warp: lane l owns values l, l + 32, ...; a
sum is the lane's partials added in value order from +0.0, then five xor
butterfly steps (offsets 16, 8, 4, 2, 1), after which every lane holds
the same bits.  Every other operation is one IEEE float32 operation
(``--fmad=false``: no contraction), as numpy's float32 operations are,
so the replay gives the kernel's bits.  ``order`` says how a trip's sums
are taken:

* ``"fused"`` (the kernel): after the mean's butterfly one pass gives
  the transform, cost_px and the next step's projection partials
  (gx.d, gy.d), whose three sums share one butterfly;
* ``"three butterflies"`` (the first design): the cost's butterfly after
  the transform, then at the top of the next trip a projection pass over
  the stored residual and a butterfly for each of gx.d and gy.d.

No JAX here: the card's tests import this module too.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
ORDERS = ("fused", "three butterflies")
_PARTNERS = [np.arange(32) ^ o for o in (16, 8, 4, 2, 1)]


def warp_sum(v):
    """The butterfly over the last axis (32 lanes): every lane's sum."""
    for partner in _PARTNERS:
        v = v + v[..., partner]
    return v[..., 0]


def lane_partials(x):
    """Each lane's sum of its values [..., slots, 32] in slot order."""
    acc = np.zeros(x.shape[:-2] + (32,), F32)
    for k in range(x.shape[-2]):
        acc = acc + x[..., k, :]
    return acc


def _sign(d):
    return (d > 0).astype(F32) - (d < 0).astype(F32)


def _transform(d, cost_fn, inv_b2, two_b2):
    """(the residual transform of d, cost_px)."""
    if cost_fn == "l1":
        d = _sign(d) * np.sqrt(np.abs(d))
        return d, np.abs(d)
    if cost_fn == "huber":
        t = np.sqrt((d * d) * inv_b2 + F32(1)) - F32(1)
        d = _sign(d) * np.sqrt(two_b2 * t)
        return d, np.abs(d)
    return d, d * d


def _numpy(x):
    """An array of ``x`` (a tensor on any device, or an array)."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _slots(x, N, nv):
    """[P, ps, ps, C] values -> [P, nv, 32] lane slots, 0 where none."""
    flat = np.zeros((x.shape[0], nv * 32), F32)
    flat[:, :N] = x.reshape(x.shape[0], N)
    return flat.reshape(-1, nv, 32)


def replay(state, I1, grid, cfg, one_d=False, cam_lr=0, offset=None,
           order="fused"):
    """G6 on ``state`` (a ``PatchState`` of [B, n_h, n_w, ...] fields,
    tensors or arrays) against the padded level ``I1`` [B, Hp, Wp, C]:
    (p, diff, cost_px) as float32 arrays shaped like the state's."""
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}")
    f = {k: _numpy(v) for k, v in state._asdict().items() if v is not None}
    I1 = np.ascontiguousarray(_numpy(I1), F32)
    B, Hp, Wp, C = I1.shape
    lead = f["p_cur"].shape[:3]
    n = int(np.prod(lead))
    ps = grid.patch_size
    psC, N = ps * C, ps * ps * C
    nv = -(-N // 32)
    rs = Wp * C
    K, off = ps + 1, grid.padding - ps // 2
    frame = np.repeat(np.arange(B), n // B)
    image = I1.reshape(B, -1)

    t = np.arange(nv * 32).reshape(nv, 32)
    live = t < N
    r = np.where(live, t // psC, 0)
    OFF = np.where(live, r * rs + (t - r * psC), 0)
    T = _slots(f["templates"].reshape(n, -1), N, nv)
    GX = _slots(f["tgrad_x"].reshape(n, -1), N, nv)
    GY = (np.zeros_like(GX) if one_d
          else _slots(f["tgrad_y"].reshape(n, -1), N, nv))
    H = f["H"].reshape(n, 3).astype(F32)
    h00, h01, h11 = H[:, 0], H[:, 1], H[:, 2]
    det = h00 * h11 - h01 * h01
    mid = np.broadcast_to(f["mid_org"], lead + (2,)).reshape(n, 2)
    mx0, my0 = mid[:, 0].astype(F32), mid[:, 1].astype(F32)
    p0 = f["p_org"].reshape(n, 2).astype(F32)
    p = f["p_cur"].reshape(n, 2).astype(F32)
    px, py = p[:, 0].copy(), p[:, 1].copy()

    inv_n = F32(1) / F32(N)
    b2 = F32(cfg.norm_outlier * cfg.norm_outlier)
    two_b2 = F32(2.0 * (cfg.norm_outlier * cfg.norm_outlier))
    inv_b2 = F32(1) / b2
    off_x, off_y = (F32(0), F32(0)) if offset is None else map(F32, offset)
    thresh, l_bound = F32(cfg.outlier_thresh), F32(grid.l_bound)
    ub_w, ub_h = F32(grid.u_bound_w), F32(grid.u_bound_h)
    res_thresh = F32(cfg.res_thresh)
    dp_thresh, dr_thresh = F32(cfg.dp_thresh), F32(cfg.dr_thresh)
    max_iter = cfg.grad_descent_iter
    min_iter = max_iter if cfg.min_iter is None else cfg.min_iter
    fused = order == "fused"

    def sample(qx, qy):
        """(D, mares, the sums of gx.D and gy.D) at displacement (qx,
        qy); the sums only in the fused order."""
        mx, my = (mx0 + qx) + off_x, (my0 + qy) + off_y
        fx, fy = np.floor(mx), np.floor(my)
        rx, ry = mx - fx, my - fy
        sy = fy.astype(np.int64) + off
        sx = fx.astype(np.int64) + off
        sy = np.where(sy < 0, sy + Hp, sy).clip(0, Hp - K)
        sx = np.where(sx < 0, sx + Wp, sx).clip(0, Wp - K)
        idx = (sy * rs + sx * C)[:, None, None] + OFF
        q = [image[frame[:, None, None], idx + o]
             for o in (0, C, rs, rs + C)]
        w = [((F32(1) - rx) * (F32(1) - ry)), rx * (F32(1) - ry),
             (F32(1) - rx) * ry, rx * ry]
        w = [x[:, None, None] for x in w]
        S = ((w[0] * q[0] + w[1] * q[1]) + w[2] * q[2]) + w[3] * q[3]
        D = np.where(live, S, F32(0))
        if cfg.use_mean_normalization:
            m = warp_sum(lane_partials(D)) * inv_n
        else:
            m = np.zeros(n, F32)
        d, c = _transform((D - m[:, None, None]) - T, cfg.cost_fn, inv_b2,
                          two_b2)
        D = np.where(live, d, F32(0))
        cost = lane_partials(np.where(live, c, F32(0)))
        if not fused:
            return D, warp_sum(cost) * inv_n, None, None
        sums = [warp_sum(x) for x in
                (cost, lane_partials(GX * D), lane_partials(GY * D))]
        return D, sums[0] * inv_n, sums[1], sums[2]

    def projection(D):
        return (warp_sum(lane_partials(GX * D)),
                warp_sum(lane_partials(GY * D)))

    started = ~f["converged"].reshape(n).astype(bool)
    with np.errstate(all="ignore"):
        D, mares, dpx, dpy = sample(px, py)
        done = ~started | (mares <= res_thresh)
        mares_prev, dp_init = mares, np.full(n, F32(1e-10))
        for cnt in range(1, max_iter + 1):
            act = ~done
            if not act.any():
                break
            if not fused:
                dpx, dpy = projection(D)
            if one_d:
                d_new = px - dpx / h00
                d_new = (np.where(d_new > 0, F32(0), d_new) if cam_lr == 0
                         else np.where(d_new < 0, F32(0), d_new))
                mxn = mx0 + d_new
                outlier = ((np.abs(mxn - mx0) > thresh) | (mxn < l_bound)
                           | (mxn > ub_w))
                nx, ny = np.where(outlier, p0[:, 0], d_new), np.zeros(n, F32)
                D2, m2, sx2, sy2 = sample(nx, ny)
                stop = outlier | (m2 <= res_thresh)
            else:
                delta_px = (h11 * dpx - h01 * dpy) / det
                delta_py = (h00 * dpy - h01 * dpx) / det
                nx, ny = px - delta_px, py - delta_py
                mxn, myn = mx0 + nx, my0 + ny
                ddx, ddy = mxn - mx0, myn - my0
                norm = np.sqrt(ddx * ddx + ddy * ddy)
                outlier = ((norm > thresh) | (mxn < l_bound)
                           | (myn < l_bound) | (mxn > ub_w) | (myn > ub_h))
                nx = np.where(outlier, p0[:, 0], nx)
                ny = np.where(outlier, p0[:, 1], ny)
                dp_sq = delta_px * delta_px + delta_py * delta_py
                if cnt == 1:
                    dp_init = np.where(act, dp_sq, dp_init)
                D2, m2, sx2, sy2 = sample(nx, ny)
                keep = (m2 > res_thresh) & (cnt < max_iter)
                if cnt >= min_iter:
                    keep = (keep & (dp_sq / dp_init >= dp_thresh)
                            & (m2 / mares_prev <= dr_thresh))
                stop = outlier | ~keep
            px, py = np.where(act, nx, px), np.where(act, ny, py)
            D = np.where(act[:, None, None], D2, D)
            mares = np.where(act, m2, mares)
            mares_prev = np.where(act, m2, mares_prev)
            if fused:
                dpx, dpy = np.where(act, sx2, dpx), np.where(act, sy2, dpy)
            done = done | (act & stop)
    if one_d and max_iter > 0:
        py = np.zeros(n, F32)

    diff = D.reshape(n, -1)[:, :N]
    cost = diff * diff if cfg.cost_fn == "l2" else np.abs(diff)
    shape = lead + tuple(f["templates"].shape[3:])
    diff_in = f["diff"].reshape(n, N)
    cost_in = f["cost_px"].reshape(n, N)
    diff = np.where(started[:, None], diff, diff_in).astype(F32)
    cost = np.where(started[:, None], cost, cost_in).astype(F32)
    p = np.stack([np.where(started, px, p[:, 0]),
                  np.where(started, py,
                           F32(0) if one_d and max_iter > 0 else p[:, 1])],
                 -1)
    return p.reshape(lead + (2,)), diff.reshape(shape), cost.reshape(shape)
