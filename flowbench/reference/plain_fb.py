"""Dense Inverse Search with forward-backward consistency in plain
PyTorch: the reference of the configurations that state
``use_fb_consistency`` (``configs/*.json``, key ``dis``).

It is :mod:`.plain_dis`'s pipeline with a second, complementary patch
grid per scale, as OF_DIS's ``usefbcons`` switch runs it (Kroeger et al.,
github.com/tikroeger/OF_DIS: ``oflow.cpp``, the merge in
``patchgrid.cpp``, lines 277-375 of FlowOnTheGo's copy):

    per scale, coarse to fine: the forward grid (templates of I0, searched
    in I1) as in plain_dis, warm-started from the coarser forward flow
    or the stream's warm start; the backward grid (templates of I1,
    searched in I0) warm-started only from its own coarser flow, cold at
    the coarsest scale; densify each direction with the other
    direction's patches merged in (:func:`merge`); variational
    refinement of each; the finest scale solves the backward grid for the
    merge into the forward flow and neither densifies nor refines it.

It imports nothing of the program, runs float32 throughout with TF32 off,
and uses plain_dis's functions for every step the two pipelines share.
Only the modes plain_dis computes are here, with the merge switched on
(:func:`check_params`).  Frames carry a leading batch axis; the benchmark
runs B = 1.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import plain_dis as dis
from .plain_dis import (finest_from_full, init_shape, pads_for,  # noqa: F401
                        pin_fp32, pyramid, warm_start)

# plain_dis's fixed values, the merge on
FIXED = dict(dis.FIXED, use_fb_consistency=True)
CORNERS = ((0, 0), (1, 0), (0, 1), (1, 1))     # (dx, dy) subtracted


def check_params(p: dict) -> None:
    """Raise unless ``p`` (a configuration's ``dis`` object) states only
    what this reference computes: the merge on, stated, and plain_dis's
    other fixed values."""
    if p.get("use_fb_consistency") is not True:
        raise ValueError("the reference computes use_fb_consistency=True, "
                         "the configuration states "
                         f"{p.get('use_fb_consistency')!r}")
    for key, want in FIXED.items():
        if p.get(key, want) != want:
            raise ValueError(f"the reference computes {key}={want!r}, the "
                             f"configuration states {p[key]!r}")


def merge(pos, cost_px, g: dis.Grid, p: dict,
          tally: Optional[list] = None):
    """The complementary grid's patches merged into this grid's frame:
    [B, h, w, 3] of (weight, -weight u, -weight v) sums.

    Each complementary patch lands at its optimised position midpoint +
    (u, v), in the coordinates of the frame it was searched in, which is
    this grid's.  Its pixel (x, y), x and y in [-ps/2, ps/2), goes to
    (ceil(mx + u + 1e-5) + x, ceil(my + v + 1e-5) + y) and only where that
    lies in [1, w - 1) x [1, h - 1); its weight 1 / sum_c max(min_errval,
    cost) is spread bilinearly by the landing point's fraction over that
    cell and the three cells to its left and above, and its flow is
    taken with the sign reversed.  Contributions are added in the loop's
    order (patch, row, column, corner), one deterministic scatter.  With
    ``tally`` (a list [merges, patches, landed]) the merge, its patches
    and the (pixel, corner) contributions that land are added to it."""
    B, n_h, n_w = pos.shape[:3]
    h, w, ps = g.height, g.width, g.ps
    land = dis.midpoints(g, pos.device) + pos          # [B, n_h, n_w, 2]
    lx, ly = land[..., 0], land[..., 1]
    cx = torch.ceil(lx + 1e-5).long()
    cy = torch.ceil(ly + 1e-5).long()
    r0 = (lx - torch.floor(lx))[..., None, None]
    r1 = (ly - torch.floor(ly))[..., None, None]
    wb = (r0 * r1, (1 - r0) * r1, r0 * (1 - r1), (1 - r0) * (1 - r1))
    absw = 1.0 / torch.clamp(cost_px, min=p["min_errval"]).sum(dim=-1)
    lb = -(ps // 2)                    # C++ -ps/2: rounded toward zero
    ar = torch.arange(lb, lb + ps, device=pos.device)
    xt = cx[..., None, None] + ar[None, :]           # [B, n_h, n_w, ps, ps]
    yt = cy[..., None, None] + ar[:, None]
    valid = (xt >= 1) & (xt < w - 1) & (yt >= 1) & (yt < h - 1)
    u = pos[..., 0][..., None, None]
    v = pos[..., 1][..., None, None]
    frame = (torch.arange(B, device=pos.device) * (h * w)).reshape(
        B, 1, 1, 1, 1)
    idx = torch.stack([frame + (yt - dy) * w + (xt - dx)
                       for dx, dy in CORNERS], dim=-1)      # [.., ps, ps, 4]
    wt = torch.stack([k * absw for k in wb], dim=-1)         # [.., ps, ps, 4]
    vals = torch.stack([wt, -(wt * u[..., None]), -(wt * v[..., None])],
                       dim=-1)                               # [.., 4, 3]
    keep = valid[..., None].expand_as(idx)
    idx, vals = idx[keep], vals[keep]
    acc = torch.zeros(B * h * w, 3, device=pos.device)
    if acc.is_cuda:     # sorts stably, then adds each cell's run in order
        acc.index_put_((idx,), vals, accumulate=True)
    else:               # adds serially, in order
        acc.index_add_(0, idx, vals)
    if tally is not None:
        tally[0] += 1
        tally[1] += B * n_h * n_w
        tally[2] += int(idx.numel())
    return acc.reshape(B, h, w, 3)


def canvas(pos, cost_px, g: dis.Grid, p: dict):
    """plain_dis's densify before its normalisation: [B, h, w, 3] of
    (weight, weight u, weight v) sums of a grid's own patches."""
    B = pos.shape[0]
    wt = 1.0 / torch.clamp(cost_px, min=p["min_errval"]).sum(dim=-1)
    contrib = torch.stack([wt, wt * pos[..., 0][..., None, None],
                           wt * pos[..., 1][..., None, None]], dim=-1)
    ps, st = g.ps, g.steps
    top, left, m = g.off_h - ps // 2, g.off_w - ps // 2, ps
    acc = torch.zeros(B, g.height + 2 * m, g.width + 2 * m, 3,
                      device=pos.device)
    for r in range(ps):
        for c in range(ps):
            y0, x0 = m + top + r, m + left + c
            acc[:, y0:y0 + (g.n_h - 1) * st + 1:st,
                x0:x0 + (g.n_w - 1) * st + 1:st] += contrib[:, :, :, r, c]
    return acc[:, m:m + g.height, m:m + g.width]


def normalise(acc):
    weight = acc[..., 0:1]
    return torch.where(weight > 0, acc[..., 1:3] / weight, 0.0)


def start(warm, mid, g: dis.Grid, B: int):
    """(p, started) of a grid's patches: warm-started from ``warm`` [B,
    ch, cw, 2] (nearest lookup at floor(mid / 2), x2; a patch whose start
    leaves the box is not started) or, where it is None, cold."""
    if warm is None:
        return (torch.zeros(B, g.n_h, g.n_w, 2, device=mid.device),
                torch.ones(B, g.n_h, g.n_w, dtype=torch.bool,
                           device=mid.device))
    ch, cw = warm.shape[1], warm.shape[2]
    iy = torch.clamp(mid[0, :, 0, 1].long() // 2, max=ch - 1)
    ix = torch.clamp(mid[0, 0, :, 0].long() // 2, max=cw - 1)
    pos = warm[:, iy][:, :, ix] * 2.0
    m = mid + pos
    return pos, ~((m[..., 0] < g.l_bound) | (m[..., 1] < g.l_bound)
                  | (m[..., 0] > g.ub_w) | (m[..., 1] > g.ub_h))


def solve(l0, l1, g: dis.Grid, p: dict, warm_fw, warm_bw, count=None,
          sl=None):
    """Both directions' patch grids at one scale, as one batch of 2B
    frames: templates of ``l0`` searched in ``l1`` (forward) and of ``l1``
    searched in ``l0`` (backward), each warm-started from its own coarser
    flow (:func:`start`).  Returns ((p, cost_px) forward, the same
    backward); with ``count`` both directions' patches, started patches
    and steps are added under ``sl``."""
    B = l0.image.shape[0]
    both = dis.Level(*(torch.cat([a, b]) for a, b in zip(l0, l1)))
    T, gx, gy, Hs = dis.templates_and_hessians(both, g, p)
    mid = dis.midpoints(g, T.device)
    (pf, sf), (pb, sb) = (start(w, mid, g, B) for w in (warm_fw, warm_bw))
    pos, started = torch.cat([pf, pb]), torch.cat([sf, sb])
    res = dis.inverse_search(torch.cat([l1.image, l0.image]), T, gx, gy, Hs,
                             mid, pos, started, g, p,
                             count=count is not None)
    if count is not None:
        c = count.setdefault(sl, [0, 0, 0])
        c[0] += started.numel()
        c[1] += int(started.sum())
        c[2] += int(res[2].sum())
    return (res[0][:B], res[1][:B]), (res[0][B:], res[1][B:])


def flow_from_pyramids(pyr0, pyr1, p: dict, init: Optional[torch.Tensor],
                       count: Optional[dict] = None,
                       merges: Optional[dict] = None):
    """The finest-scale forward flow [B, H/2^fs, W/2^fs, 2] from two
    pyramids; ``init`` is the forward warm start at 1/2^(coarsest + 1) or
    None.  With ``count`` (a dict) each scale's patches, started patches
    and steps of both directions are added under the scale's number; with
    ``merges`` (a dict) each scale's [merges, patches merged, landed
    contributions]."""
    cs, fs = p["coarsest_scale"], p["finest_scale"]
    pad = p["patch_size"]
    H = pyr0[cs].image.shape[1] - 2 * pad << cs
    W = pyr0[cs].image.shape[2] - 2 * pad << cs
    flow, flow_bw = init, None
    for sl in range(cs, fs - 1, -1):
        w, h = W >> sl, H >> sl
        g = dis.make_grid(p, w, h)
        l0, l1 = pyr0[sl], pyr1[sl]
        tally = None if merges is None else merges.setdefault(sl, [0, 0, 0])
        fw, bw = solve(l0, l1, g, p, flow, flow_bw, count, sl)
        flow = normalise(canvas(*fw, g, p) + merge(*bw, g, p, tally))
        if sl > fs:
            flow_bw = normalise(canvas(*bw, g, p) + merge(*fw, g, p, tally))
        if p["use_var_ref"]:
            im0 = l0.image[:, pad:pad + h, pad:pad + w]
            im1 = l1.image[:, pad:pad + h, pad:pad + w]
            flow = dis.refine(flow, im0, im1, p, sl)
            if sl > fs:
                flow_bw = dis.refine(flow_bw, im1, im0, p, sl)
    return flow


def pair_flow(I0, I1, p: dict, count: Optional[dict] = None,
              merges: Optional[dict] = None):
    """Full-resolution forward flow [H, W, 2] of one unpadded pair [H, W,
    C] (any dtype): padded, solved, upsampled and cropped back."""
    pin_fp32()
    h, w = I0.shape[0], I0.shape[1]
    pads = pads_for(h, w, p["coarsest_scale"])
    a = dis.pad_replicate(I0[None].float(), pads)
    b = dis.pad_replicate(I1[None].float(), pads)
    fin = flow_from_pyramids(pyramid(a, p), pyramid(b, p), p, None, count,
                             merges)
    full = dis.full_flow(fin, p, a.shape[1], a.shape[2])
    return full[0, pads[0]:pads[0] + h, pads[2]:pads[2] + w]


def stream_step(prev_pyr, frame, p: dict, init,
                count: Optional[dict] = None, merges: Optional[dict] = None):
    """One step of a warm-started stream on a padded frame [H, W, C]:
    (full forward flow [H, W, 2], finest forward flow, this frame's
    pyramid).  The backward chain starts cold at every step."""
    pin_fp32()
    pyr = pyramid(frame[None].float(), p)
    fin = flow_from_pyramids(prev_pyr, pyr, p, init, count, merges)
    return dis.full_flow(fin, p, frame.shape[0], frame.shape[1])[0], fin, pyr
