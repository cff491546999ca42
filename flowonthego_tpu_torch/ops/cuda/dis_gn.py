"""K2: one scale's whole Gauss-Newton patch solve (inverse search), for a
batch of frames.

Replaces ``flowonthego_tpu/ops/pallas/dis_gn.py`` (``gn_scale_loop``,
kernel ``_kernel``) with ``csrc/dis_gn.cu``.  The solve needs little of
the card (op 4's largest call ~8.7 GFLOP and ~91 MB, ``bounds.gn_bound``);
what it pays for is the SMs' issue rate, barriers and the L1 wavefronts
of its tap loads.  So the kernel runs one warp per patch (a CTA is one
warp): lane l owns values l, l + 32, ... of the patch and keeps their
template value, gradients and the four taps of their window in registers
(the kernel is instantiated for ps 8 and 12 at C = 1 and 3; any other
patch of up to 1024 values takes a generic form with that state in
shared memory); the window origin and the four bilinear weights are
computed once per warp and iteration (a trip), and the taps are loaded
again only on a trip whose origin differs from the one they came from:
op 4's sub-pixel steps keep the window on 90-92% of its trips, and a trip
that loads four taps a value pays ~150 L1 wavefronts (the kernel's
header has the arithmetic).  The three sums of a trip are per-lane
partials and one shuffle butterfly each, after which every lane holds the
same totals, so the 2x2 step, the outlier test and the early stop are
uniform per warp with no shared memory and no block barrier in the loop.
The blend and the sums are those of loading every trip, in the same
order: the results are bit for bit the same.  The TPU kernel's
envelopes, band pairs and radix shift selects worked around the lack of
a gather on the TPU and are not carried over.

Counting: given ``counts``, each patch adds its trips and its window loads
to its own row; a traced launch counts into tracing's buffer
(``utils/profiling.kernel_counts``, read as ``gn_trips`` and
``gn_window_loads``), any other launch counts nothing.

A batch of B frames is one launch over B*P patches (P a frame); patch k
solves patch k % P of frame k / P against that frame's level image, as a
``vmap`` of the Pallas call adds one grid axis.  A patch's arithmetic
does not depend on where in the launch it runs, so a frame of a batch
equals its own launch bit for bit.

bf16 operand mode (``bf16=True``, ``cfg.dtype="bfloat16"``), the Pallas
kernel's form (``dis_gn.py:90-94``): the wrapper rounds the level image,
the templates and their gradients to bf16 once, on the device, and the
kernel upcasts them on load; every blend, reduction and carry is
float32.  The per-patch sums of gx, gy, gx*T and gy*T come from the
float32 state, as the JAX package computes them outside its kernel
(``ops/dis.py:439-444``), so they enter the kernel as float32 inputs.

:func:`gn_scale_loop` launches the kernel for CUDA tensors and runs
:func:`gn_scale_loop_plain` (the JAX package's XLA reduction form,
``flowonthego_tpu/ops/dis.py:429-466, 559-622``, with the Pallas form's
bf16 rounding of its operands in bf16 mode) for CPU tensors.

Strip offset (``offset=(off_x, off_y)``): the spatial forms solve a
shard's patches against the shard's strip (or tile) of the level image
with its halo; sampling reads at ``(mid_org + p) + offset`` and the
outlier and box tests stay global.  The JAX package runs that solve in
XLA's general gather loop (``ops/dis.py`` with ``sample_offset``), not in
its Pallas kernel; here it is K2's second entry,
``dis_gn_strip_kernel``, over the same body, so the unsharded path's
kernel is unchanged.

Edge rules (as the TPU kernel): a patch that was never started (frozen at
warm start) keeps p_cur and has cost 0; a patch that trips the outlier or
bounds reset goes back to p_org, stops, and its final cost is sampled
there, which is where iteration 1 sampled — the same cost.
"""

from __future__ import annotations

import torch

from . import _build
from ...utils import profiling
from ..interp import (blend_windows, clamp_starts, gather_windows,
                      sample_patches_bilinear)

# Kernel launches since the last reset (read and reset by chip_smoke.py);
# launches_bf16 counts those of them that ran the bf16 operand kernel,
# launches_offset those that ran the strip-offset entry.
launches = 0
launches_bf16 = 0
launches_offset = 0

_PATCH = (-3, -2, -1)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def patch_sums(templates, tgrad_x, tgrad_y) -> torch.Tensor:
    """[..., 4] float32 per-patch sums (gx, gy, gx*T, gy*T) of the float32
    state: the projection's constant terms."""
    return torch.stack([tgrad_x.sum(dim=_PATCH), tgrad_y.sum(dim=_PATCH),
                        (tgrad_x * templates).sum(dim=_PATCH),
                        (tgrad_y * templates).sum(dim=_PATCH)], dim=-1)


def gn_scale_loop_plain(I1_pad, templates, tgrad_x, tgrad_y, H, mid_org,
                        p_cur, p_org, started, *, n_iters: int, padding: int,
                        thresh: float, l_bound: float, ub_w: float,
                        ub_h: float, mean_on: float, bf16: bool = False,
                        offset=None, count_iters: bool = False):
    """Plain PyTorch version of the scale solve.

    I1_pad [B, Hp, Wp, C]; templates, tgrad_x, tgrad_y [B, n_h, n_w, ps,
    ps, C]; H [B, n_h, n_w, 3]; mid_org, p_cur, p_org [B, n_h, n_w, 2];
    started [B, n_h, n_w] bool.  Runs ``n_iters`` Gauss-Newton steps from
    p_cur (projection from the linear reductions sum S, sum gx.S, sum
    gy.S, outlier/bounds reset to p_org), then the per-pixel squared
    residual at the final position.  With ``bf16`` the image, templates
    and gradients are rounded to bf16 (the sums of the projection's
    constant terms are not).  Returns (p [B, n_h, n_w, 2], cost_px like
    templates), and with ``count_iters`` two more values [B, n_h, n_w]:
    the iterations each patch ran (0 if never started, k if it reset at
    iteration k), the work a bound on these inputs counts, and its window
    loads: the trips, the final cost pass among them, whose window origin
    differs from the previous trip's (the first always does), the loads
    of a kernel that keeps its taps while the window stays (module
    docstring).  ``offset`` (off_x, off_y): sample at ``(mid_org + p) +
    offset`` (module docstring).
    """
    ps = templates.shape[-3]
    N = templates[0, 0, 0].numel()
    lead = templates.shape[:-3]
    gx_sum, gy_sum, gxT, gyT = patch_sums(templates, tgrad_x,
                                          tgrad_y).unbind(-1)
    if bf16:
        I1_pad, templates, tgrad_x, tgrad_y = map(
            _round_bf16, (I1_pad, templates, tgrad_x, tgrad_y))
    h00, h01, h11 = H[..., 0], H[..., 1], H[..., 2]
    det = h00 * h11 - h01 * h01
    gxf = tgrad_x.reshape(*lead, N)
    gyf = tgrad_y.reshape(*lead, N)

    def sample_at(p):
        """Where the samples of displacement p are read (x, y)."""
        mid = mid_org + p
        if offset is None:
            return mid[..., 0], mid[..., 1]
        return mid[..., 0] + offset[0], mid[..., 1] + offset[1]

    def gn_step(p, active):
        win, rx, ry = gather_windows(I1_pad, *sample_at(p), ps, padding)
        S = blend_windows(win, rx, ry).reshape(*lead, N)
        m = S.sum(-1) / N * mean_on
        dpx = (S * gxf).sum(-1) - m * gx_sum - gxT
        dpy = (S * gyf).sum(-1) - m * gy_sum - gyT
        delta_px = (h11 * dpx - h01 * dpy) / det
        delta_py = (h00 * dpy - h01 * dpx) / det
        p_new = p - torch.stack([delta_px, delta_py], dim=-1)
        mid_new = mid_org + p_new
        disp = mid_new - mid_org
        norm = torch.sqrt(disp[..., 0] ** 2 + disp[..., 1] ** 2)
        outlier = ((norm > thresh)
                   | (mid_new[..., 0] < l_bound) | (mid_new[..., 1] < l_bound)
                   | (mid_new[..., 0] > ub_w) | (mid_new[..., 1] > ub_h))
        p_new = torch.where(outlier[..., None], p_org, p_new)
        p = torch.where(active[..., None], p_new, p)
        return p, active & ~outlier

    def origin(p):
        """The window's origin at displacement p, one integer a patch."""
        x, y = sample_at(p)
        sy = clamp_starts(torch.floor(y).to(torch.int64) + (padding - ps // 2),
                          I1_pad.shape[1], ps + 1)
        sx = clamp_starts(torch.floor(x).to(torch.int64) + (padding - ps // 2),
                          I1_pad.shape[2], ps + 1)
        return sy * I1_pad.shape[2] + sx

    p, active = p_cur, started
    iters = torch.zeros(started.shape, dtype=torch.int64,
                        device=started.device)
    loads = torch.zeros_like(iters)
    held = torch.full_like(iters, -1)   # the origin of a patch's held taps

    def load(live):
        nonlocal held
        o = origin(p)
        loads.add_(live & (o != held))
        held = torch.where(live, o, held)

    for _ in range(n_iters):
        if count_iters:
            iters += active
            load(active)
        p, active = gn_step(p, active)
    if count_iters:
        load(started)

    raw = sample_patches_bilinear(I1_pad, *sample_at(p), ps, padding)
    if mean_on:
        raw = raw - raw.mean(dim=_PATCH, keepdim=True)
    diff = raw - templates
    cost_px = torch.where(started[..., None, None, None], diff * diff, 0.0)
    return (p, cost_px, iters, loads) if count_iters else (p, cost_px)


def _check(name, x, shape, dtype=torch.float32):
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"gn_scale_loop: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if x.dtype != dtype:
        raise TypeError(f"gn_scale_loop: {name} is {x.dtype}, expected {dtype}")


def gn_scale_loop(I1_pad, templates, tgrad_x, tgrad_y, H, mid_org, p_cur,
                  p_org, started, *, n_iters: int, padding: int,
                  thresh: float, l_bound: float, ub_w: float, ub_h: float,
                  mean_on: float, bf16: bool = False, offset=None,
                  counts=None):
    """The scale solve of :func:`gn_scale_loop_plain` — launches the
    kernel (the bf16 one with ``bf16``, the strip entry with ``offset``)
    once for the whole batch for CUDA tensors, runs the plain version for
    CPU tensors.

    ``counts`` (int32 [B, n_h, n_w, 2]): each patch adds its trips, the
    final cost pass among them, and its window loads to its own row (on
    the CPU: the plain version's ``count_iters`` counts, the same rule).
    Without it a traced launch adds them to tracing's buffer
    (``profiling.kernel_counts``) and any other launch counts nothing."""
    global launches, launches_bf16, launches_offset
    kw = dict(n_iters=n_iters, padding=padding, thresh=thresh,
              l_bound=l_bound, ub_w=ub_w, ub_h=ub_h, mean_on=mean_on,
              bf16=bf16, offset=offset)
    B, n_h, n_w, ps, _, C = templates.shape
    if counts is not None:
        _check("counts", counts, (B, n_h, n_w, 2), torch.int32)
    if not I1_pad.is_cuda:
        if counts is None:
            return gn_scale_loop_plain(I1_pad, templates, tgrad_x, tgrad_y,
                                       H, mid_org, p_cur, p_org, started,
                                       **kw)
        p, cost, iters, loads = gn_scale_loop_plain(
            I1_pad, templates, tgrad_x, tgrad_y, H, mid_org, p_cur, p_org,
            started, **kw, count_iters=True)
        counts += torch.stack([iters + started, loads], -1).to(torch.int32)
        return p, cost
    Hp, Wp = I1_pad.shape[1], I1_pad.shape[2]
    P, N = n_h * n_w, ps * ps * C
    _check("I1_pad", I1_pad, (B, Hp, Wp, C))
    for name, x in (("templates", templates), ("tgrad_x", tgrad_x),
                    ("tgrad_y", tgrad_y)):
        _check(name, x, (B, n_h, n_w, ps, ps, C))
    _check("H", H, (B, n_h, n_w, 3))
    for name, x in (("mid_org", mid_org), ("p_cur", p_cur), ("p_org", p_org)):
        _check(name, x, (B, n_h, n_w, 2))
    _check("started", started, (B, n_h, n_w), torch.bool)
    if N > 1024:
        raise ValueError(f"gn_scale_loop: {N} values per patch exceed the "
                         "kernel's 1024 (32 a lane)")
    if Hp < ps + 1 or Wp < ps + 1:
        raise ValueError("gn_scale_loop: level image smaller than a window")
    dev = I1_pad.device
    for x in (templates, tgrad_x, tgrad_y, H, mid_org, p_cur, p_org, started):
        if x.device != dev:
            raise ValueError("gn_scale_loop: all tensors must be on "
                             f"{dev}, got {x.device}")
    if bf16:
        # the projection's constant terms from the float32 state; the
        # operands rounded once for the whole scale
        sums = patch_sums(templates, tgrad_x, tgrad_y).contiguous()
        I1_pad, templates, tgrad_x, tgrad_y = (
            x.to(torch.bfloat16) for x in (I1_pad, templates, tgrad_x,
                                           tgrad_y))
        sums_ptr = sums.data_ptr()
    else:
        sums_ptr = None
    args = [x.contiguous() for x in (I1_pad, templates, tgrad_x, tgrad_y, H,
                                     mid_org, p_cur, p_org)]
    st = started.to(torch.uint8).contiguous()
    fresh = False
    if counts is None:
        counts, fresh = profiling.kernel_counts(dev, B * P)
    elif not counts.is_contiguous() or counts.device != dev:
        raise ValueError("gn_scale_loop: counts must be contiguous on "
                         f"{dev}")
    p_out = torch.empty((B, n_h, n_w, 2), dtype=torch.float32, device=dev)
    cost = torch.empty((B, n_h, n_w, ps, ps, C), dtype=torch.float32,
                       device=dev)
    lib = _build.load_library()
    I1c, tc, gxc, gyc, Hc, midc, pcc, poc = args
    with torch.cuda.device(dev):
        err = lib.fot_dis_gn(
            I1c.data_ptr(), int(bf16), B, Hp, Wp, C, tc.data_ptr(),
            gxc.data_ptr(), gyc.data_ptr(), sums_ptr, Hc.data_ptr(),
            midc.data_ptr(), pcc.data_ptr(), poc.data_ptr(), st.data_ptr(),
            P, ps, padding, n_iters, float(thresh), float(l_bound),
            float(ub_w), float(ub_h), float(mean_on), int(offset is not None),
            *(0.0, 0.0) if offset is None else map(float, offset),
            p_out.data_ptr(), cost.data_ptr(),
            None if counts is None else counts.data_ptr(), int(fresh),
            _build.stream_handle(I1c))
    _build.check(err, "gn_scale_loop")
    launches += 1
    launches_bf16 += int(bf16)
    launches_offset += int(offset is not None)
    return p_out, cost
