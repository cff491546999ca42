"""G6: one scale's reference-form patch solve, and stereo's 1-D form
(``csrc/dis_ref.cu``).

The JAX package runs both in XLA (``flowonthego_tpu/ops/dis.py``
``optimize_reference``, ``flowonthego_tpu/models/stereo.py``
``_optimize_1d``), not in its Pallas kernel: they are the solves of the
l1 and pseudo-Huber costs, of ``min_iter`` early exits and ``res_thresh
> 0``, with a sample offset on the spatial forms' sharded scales, and of
stereo depth.  Plain PyTorch (``ops/dis.optimize_reference_plain``,
``models/stereo.optimize_1d_plain``) materialises the residual every
trip: ~100 small kernels a trip over every patch.  The kernel is one
launch a scale: one warp a patch, the lane's share of the template,
gradients, window offsets and current residual in registers (ps 8 and 12
at C = 1 and 3; other sizes in shared memory: :func:`ref_plan`), so the
step, the tests and the exit are uniform per warp and a warp stops when
its patch does; CTAs take a frame's grid rows from both edges inward,
where the patches that run longest lie.  It returns the state the plain version returns field by
field: ``p_cur``, ``diff`` (the last sample's transformed residual),
``cost_px`` and every patch converged.

What bounds it on the card is the chain of dependent steps a trip takes,
not bytes or operations.  A trip is one pass for the sample and one for
the transform, ``cost_px`` and the next step's projection partials,
whose three sums share one butterfly; the cost is compiled in and the
square roots carry no slow-path branch, so a lane's values interleave.
Each sum adds in the order a butterfly of its own would, so fusing them
moves no bit.  The sums run in another order than the plain reduction's,
so a ratio test or an outlier reset can flip on an ulp
(``chip_smoke.check_ref``'s flip-share rule).

:func:`optimize_reference` and :func:`optimize_1d` only check and launch:
their callers (``ops/dis.optimize_reference``, ``models/stereo._optimize_1d``)
pick them or the plain versions with ``config.use_kernel``, and a CPU
tensor here raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from ..dis import PatchState
from ..patches import PatchGrid

# Kernel launches since the last reset (read and reset by chip_smoke.py);
# launches_1d counts those of them that ran the 1-D form.
launches = 0
launches_1d = 0

COST_FNS = {"l2": 0, "l1": 1, "huber": 2}
# the compiled forms: (ps, C) -> the form's number in csrc/dis_ref.cu
FORMS = {(8, 1): 1, (8, 3): 2, (12, 1): 3, (12, 3): 4}
MAX_VALUES = 1024        # a patch's values: 32 a lane


class RefPlan(NamedTuple):
    """How a patch of ps x ps x C values is launched, one warp a patch:
    ``form`` the compiled (ps, C) or 0 for the generic form,
    ``values_per_lane`` the value slots of each of the warp's 32 lanes,
    ``shared_bytes`` the generic form's dynamic shared memory (the
    template, both gradients, the residual and the window offset of every
    slot)."""
    form: int
    values_per_lane: int
    shared_bytes: int


def ref_plan(ps: int, C: int) -> RefPlan:
    """The kernel's form for patches of ps x ps x C values; raises
    ``ValueError`` for a patch it cannot take."""
    n = ps * ps * C
    if ps < 1 or C < 1 or n > MAX_VALUES:
        raise ValueError(f"dis_ref: {n} values per patch exceed the "
                         f"kernel's {MAX_VALUES} (32 a lane)")
    slots = -(-n // 32)
    form = FORMS.get((ps, C), 0)
    return RefPlan(form, slots, 0 if form else 5 * slots * 32 * 4)


def check_args(state: PatchState, I1_pad, grid: PatchGrid) -> None:
    """Raise unless the kernel can take these tensors.  The state may be
    a block of the grid's rows or columns (the spatial forms' shards):
    its patches are ``p_cur``'s [B, n_h, n_w]."""
    ps = grid.patch_size
    if not I1_pad.is_cuda:
        raise ValueError(f"dis_ref: the kernel takes CUDA tensors, got "
                         f"I1_pad on {I1_pad.device}")
    if I1_pad.dim() != 4 or state.p_cur.dim() != 4:
        raise ValueError(f"dis_ref: I1_pad must be [B, Hp, Wp, C] and p_cur "
                         f"[B, n_h, n_w, 2], got {tuple(I1_pad.shape)} and "
                         f"{tuple(state.p_cur.shape)}")
    lead = tuple(state.p_cur.shape[:3])
    B, (Hp, Wp, C) = lead[0], I1_pad.shape[1:]
    patch = lead + (ps, ps, C)
    dev = I1_pad.device
    for name, x, shape in (
            ("I1_pad", I1_pad, (B, Hp, Wp, C)),
            ("templates", state.templates, patch),
            ("tgrad_x", state.tgrad_x, patch),
            ("tgrad_y", state.tgrad_y, patch),
            ("diff", state.diff, patch), ("cost_px", state.cost_px, patch),
            ("H", state.H, lead + (3,)), ("p_cur", state.p_cur, lead + (2,)),
            ("p_org", state.p_org, lead + (2,)),
            ("mid_org", state.mid_org, lead + (2,)),
            ("converged", state.converged, lead)):
        dtype = torch.bool if name == "converged" else torch.float32
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != dev:
            raise ValueError(f"dis_ref: {name} must be {dtype} {shape} on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
        if name != "mid_org" and not x.is_contiguous():
            raise ValueError(f"dis_ref: {name} must be contiguous")
    mid = state.mid_org
    if not (mid[0].is_contiguous()
            and (B == 1 or mid.stride(0) in (0, mid[0].numel()))):
        raise ValueError("dis_ref: mid_org must be contiguous a frame")
    ref_plan(ps, C)
    if Hp < ps + 1 or Wp < ps + 1:
        raise ValueError("dis_ref: level image smaller than a window")
    if Hp * Wp * C >= 2 ** 31:
        raise ValueError(f"dis_ref: a frame of {Hp * Wp * C} values exceeds "
                         "the kernel's 32-bit offsets")


def launch(lib, state: PatchState, I1_pad, grid: PatchGrid, cfg, one_d: bool,
           cam_lr: int, offset, p_out, diff_out, cost_out, converged_out,
           stream) -> None:
    """Launch the kernel on checked tensors (``lib``: the kernel library)."""
    B, Hp, Wp, C = I1_pad.shape
    b2 = cfg.norm_outlier * cfg.norm_outlier
    max_iter = cfg.grad_descent_iter
    min_iter = max_iter if cfg.min_iter is None else cfg.min_iter
    off_x, off_y = (0.0, 0.0) if offset is None else map(float, offset)
    plan = ref_plan(grid.patch_size, C)
    err = lib.fot_dis_ref(
        I1_pad.data_ptr(), B, Hp, Wp, C, state.templates.data_ptr(),
        state.tgrad_x.data_ptr(), state.tgrad_y.data_ptr(),
        state.H.data_ptr(), state.mid_org.data_ptr(),
        0 if B == 1 else state.mid_org.stride(0), state.p_cur.data_ptr(),
        state.p_org.data_ptr(), state.converged.view(torch.uint8).data_ptr(),
        state.diff.data_ptr(), state.cost_px.data_ptr(),
        state.p_cur.shape[1] * state.p_cur.shape[2], state.p_cur.shape[2],
        grid.patch_size,
        grid.padding, max_iter, min_iter, COST_FNS[cfg.cost_fn], int(one_d),
        int(cam_lr),
        float(cfg.outlier_thresh), float(grid.l_bound),
        float(grid.u_bound_w), float(grid.u_bound_h),
        1.0 if cfg.use_mean_normalization else 0.0, float(cfg.res_thresh),
        float(cfg.dp_thresh), float(cfg.dr_thresh), float(b2),
        float(2.0 * b2), off_x, off_y, plan.form, plan.shared_bytes,
        p_out.data_ptr(), diff_out.data_ptr(), cost_out.data_ptr(),
        converged_out.view(torch.uint8).data_ptr(), stream)
    _build.check(err, "dis_ref")


def _solve(state: PatchState, I1_pad, grid: PatchGrid, cfg, one_d: bool,
           cam_lr: int, offset) -> PatchState:
    global launches, launches_1d
    if cfg.cost_fn not in COST_FNS:
        raise ValueError(f"dis_ref: unknown cost {cfg.cost_fn!r}")
    check_args(state, I1_pad, grid)
    dev = I1_pad.device
    p_out = torch.empty_like(state.p_cur)
    diff = torch.empty_like(state.templates)
    cost = torch.empty_like(state.templates)
    converged = torch.empty_like(state.converged)   # the kernel sets all
    with torch.cuda.device(dev):
        launch(_build.load_library(), state, I1_pad, grid, cfg, one_d,
               cam_lr, offset, p_out, diff, cost, converged,
               _build.stream_handle(I1_pad))
    launches += 1
    launches_1d += int(one_d)
    return state._replace(p_cur=p_out, diff=diff, cost_px=cost,
                          converged=converged)


def optimize_reference(state: PatchState, I1_pad, grid: PatchGrid, cfg,
                       sample_offset=None) -> PatchState:
    """The reference-form solve of ``ops/dis.optimize_reference_plain``
    for B frames (``I1_pad`` [B, Hp, Wp, C]), sampling at ``(mid_org +
    p) + sample_offset`` where given: one launch."""
    return _solve(state, I1_pad, grid, cfg, False, 0, sample_offset)


def optimize_1d(state: PatchState, I1_pad, grid: PatchGrid, cfg,
                cam_lr: int) -> PatchState:
    """Stereo's 1-D solve of ``models/stereo.optimize_1d_plain``: one
    launch."""
    return _solve(state, I1_pad, grid, cfg, True, cam_lr, None)
