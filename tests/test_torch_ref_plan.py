"""G6 (the reference-form solve and its 1-D stereo form) on the CPU: a
numpy replay of the kernel's arithmetic order against the plain versions
and the JAX package, the first design's order against the kernel's, and
the wrapper's launch plan and refusals.

The kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).  ``ref_replay.replay`` gives its bits (float32
operations one by one, each sum as the lanes' partials in value order
and an xor butterfly), so here it stands in for the kernel: on one
16x32 scale of op 2's geometry (8x8 patches, 4 px apart, 21 patches),
C = 3 and 1, it is held to ``ops/dis.optimize_reference_plain`` /
``models/stereo.optimize_1d_plain`` and to JAX's ``optimize_reference``
/ ``_optimize_1d`` on the same seeded numpy inputs under the flip-share
rule (``chip_smoke.check_ref``): at most 1% of the patches (here: none)
outside the tolerances, p within 1e-4 (l2) or 1e-3 px (the robust costs,
whose residual has an infinite slope at 0: l1's p ends up to 4e-4 px
apart, ``tests/test_torch_modes.py``), cost_px and diff within rtol 1e-3
and atol 1e-3 (l2) or, compared as x|x|, 2e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowonthego_tpu.config import DISConfig as JaxConfig
from flowonthego_tpu.models import stereo as jstereo
from flowonthego_tpu.ops import dis as jdis
from flowonthego_tpu.ops import pyramid as jpyramid

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch.convert import config_from_jax
from flowonthego_tpu_torch.models import stereo as pstereo
from flowonthego_tpu_torch.ops import dis as pdis
from flowonthego_tpu_torch.ops import patches as ppatches
from flowonthego_tpu_torch.ops.cuda import _build, dis_ref

from ref_replay import ORDERS, replay
from test_torch_kernels import _jax_state, _scene, _t
from test_torch_merge_solve import _card
from test_torch_modes import _numpy_state

torch.set_num_threads(1)

F32 = np.float32
H, W = 16, 32
FLIP_SHARE = 0.01

MODES_2D = {"l2 res_thresh": dict(res_thresh=5.0),
            "l1": dict(cost_fn="l1"),
            "huber": dict(cost_fn="huber"),
            "l1 min_iter": dict(cost_fn="l1", min_iter=4)}


def _case(rng, fields, C, one_d=False, cam_lr=0):
    """(JAX config, JAX grid and state, the padded target, port config,
    port grid, port state) on a seeded 16x32 scene, warm-started from a
    seeded coarser flow (horizontal in 1-D)."""
    jc = JaxConfig(coarsest_scale=1, finest_scale=1, grad_descent_iter=12,
                   **fields)
    shift = ((-2 if cam_lr == 0 else 2), 0) if one_d else (2, -1)
    i0, i1 = _scene(rng, H, W, shift=shift, c=C)
    coarse = rng.standard_normal((H // 2, W // 2, 2)).astype(F32) * 1.5
    if one_d:
        coarse[..., 1] = 0.0
    jgrid, jstate = _jax_state(jc, i0, coarse)
    I1p = jpyramid.pad_replicate(jnp.asarray(i1), jc.padding)
    pc = config_from_jax(dataclasses.asdict(jc))
    return (jc, jgrid, jstate, I1p, pc, ppatches.PatchGrid.create(pc, W, H),
            _numpy_state(jstate))


def _off_share(got, ref, robust):
    """The share of patches whose p, cost_px or diff lies outside the
    tolerances (cost_px and diff as x|x| under the robust costs)."""
    def sq(x):
        return x * np.abs(x) if robust else x

    p_tol = 1e-3 if robust else 1e-4
    c_tol = 2e-3 if robust else 1e-3
    bad = np.abs(got[0] - ref[0]) > p_tol + 1e-4 * np.abs(ref[0])
    bad = bad.any(-1)
    for a, b in zip(got[1:], ref[1:]):
        a, b = sq(a.astype(np.float64)), sq(b.astype(np.float64))
        far = np.abs(a - b) > c_tol + 1e-3 * np.abs(b)
        bad |= far.reshape(far.shape[:3] + (-1,)).any(-1)
    return float(bad.mean())


def _fields(state):
    return tuple(np.asarray(x) for x in (state.p_cur, state.diff,
                                         state.cost_px))


def _jax_fields(state):
    return tuple(np.asarray(x)[None] for x in (state.p_cur, state.diff,
                                               state.cost_px))


def _bits(a):
    return np.ascontiguousarray(a, F32).view(np.uint32)


# ------------------------------------------- the replay against the solves

@pytest.mark.parametrize("C", [3, 1])
@pytest.mark.parametrize("mode", list(MODES_2D))
def test_replay_matches_plain_and_jax(rng, mode, C):
    """The kernel's arithmetic (the fused order) against the plain solve
    and JAX's ``optimize_reference`` on the same state, under the
    flip-share rule; some patches stop early, some reset, and the trips
    changed p."""
    jc, jgrid, jstate, I1p, pc, grid, state = _case(rng, MODES_2D[mode], C)
    I1 = _t(I1p)[None]
    got = replay(state, I1, grid, pc)
    plain = _fields(pdis.optimize_reference_plain(state, I1, grid, pc))
    ref = _jax_fields(jdis.optimize_reference(jstate, I1p, jgrid, jc))
    robust = pc.cost_fn != "l2"
    assert _off_share(got, plain, robust) <= FLIP_SHARE
    assert _off_share(got, ref, robust) <= FLIP_SHARE
    assert np.abs(got[0] - np.asarray(state.p_cur)).max() > 1e-2


def test_replay_with_a_sample_offset(rng):
    """The spatial forms' sample offset: the target cut by (2, 3) rows and
    columns and the offset (-3, -2), against the plain solve and JAX's
    (a window that reaches past the cut's edge is clamped there, as a
    shard's is)."""
    jc, jgrid, jstate, I1p, pc, grid, state = _case(rng, MODES_2D["huber"],
                                                    3)
    cut = I1p[2:, 3:]
    off = (-3.0, -2.0)
    got = replay(state, _t(cut)[None], grid, pc, offset=off)
    plain = _fields(pdis.optimize_reference_plain(state, _t(cut)[None], grid,
                                                  pc, off))
    ref = _jax_fields(jdis.optimize_reference(jstate, cut, jgrid, jc,
                                              jnp.asarray(off, jnp.float32)))
    assert _off_share(got, plain, True) <= FLIP_SHARE
    assert _off_share(got, ref, True) <= FLIP_SHARE


@pytest.mark.parametrize("C", [3, 1])
@pytest.mark.parametrize("cam_lr", [0, 1])
def test_replay_1d_matches_plain_and_jax(rng, cam_lr, C):
    """The 1-D form's arithmetic against stereo's plain solve and JAX's
    ``_optimize_1d``: v zero, the flip-share rule."""
    jc, jgrid, jstate, I1p, pc, grid, state = _case(
        rng, dict(use_var_ref=False), C, one_d=True, cam_lr=cam_lr)
    I1 = _t(I1p)[None]
    got = replay(state, I1, grid, pc, one_d=True, cam_lr=cam_lr)
    plain = _fields(pstereo.optimize_1d_plain(state, I1, grid, pc, cam_lr))
    ref = _jax_fields(jstereo._optimize_1d(jstate, I1p, jgrid, jc, cam_lr))
    assert (got[0][..., 1] == 0).all()
    assert _off_share(got, plain, False) <= FLIP_SHARE
    assert _off_share(got, ref, False) <= FLIP_SHARE


@pytest.mark.parametrize("C", [3, 1])
@pytest.mark.parametrize("mode", list(MODES_2D) + ["1-D cam_lr 0",
                                                   "1-D cam_lr 1"])
def test_first_design_order_gives_the_same_bits(rng, mode, C):
    """The first design's order (the cost's butterfly, then a projection
    pass and a butterfly each for gx.d and gy.d at the next trip's top)
    and the kernel's (one pass and one butterfly for the three sums) give
    the same bits: each sum adds the same values in the same order."""
    one_d = mode.startswith("1-D")
    cam_lr = int(mode[-1]) if one_d else 0
    fields = dict(use_var_ref=False) if one_d else MODES_2D[mode]
    _, _, _, I1p, pc, grid, state = _case(rng, fields, C, one_d, cam_lr)
    I1 = _t(I1p)[None]
    got = [replay(state, I1, grid, pc, one_d, cam_lr, order=o)
           for o in ORDERS]
    for a, b in zip(*got):
        assert np.array_equal(_bits(a), _bits(b))


# ------------------------------------------------------ the launch plan

@pytest.mark.parametrize("op", [1, 2, 3, 4])
@pytest.mark.parametrize("C", [3, 1])
def test_plan_for_the_paths(op, C):
    """Every operating point's patch takes a compiled form (ps 8 or 12)
    with its state in registers: no shared memory, the value slots a lane
    holds."""
    ps = port.operating_point(op).patch_size
    plan = dis_ref.ref_plan(ps, C)
    assert plan.form == dis_ref.FORMS[(ps, C)] and plan.form > 0
    assert plan.shared_bytes == 0
    assert plan.values_per_lane == -(-ps * ps * C // 32)


@pytest.mark.parametrize("ps,C,slots", [(6, 3, 4), (6, 1, 2), (10, 3, 10),
                                        (10, 1, 4), (18, 3, 31),
                                        (32, 1, 32)])
def test_plan_generic_form(ps, C, slots):
    """Other patch sizes take the generic form: the template, both
    gradients, the residual and the window offset of each value slot in
    shared memory (5 words a slot a lane; at most 20 KB, under the 48 KB
    a launch takes without opting in)."""
    plan = dis_ref.ref_plan(ps, C)
    assert plan.form == 0 and plan.values_per_lane == slots
    assert plan.shared_bytes == 5 * slots * 32 * 4 <= 48 * 1024


@pytest.mark.parametrize("ps,C", [(20, 3), (34, 1), (0, 3), (8, 0)])
def test_plan_refuses(ps, C):
    """More than 1024 values a patch (32 a lane), or none: ValueError."""
    with pytest.raises(ValueError):
        dis_ref.ref_plan(ps, C)


class _Lib:
    """Stands in for the kernel library: records fot_dis_ref's
    arguments."""

    def __init__(self):
        self.calls = []

    def fot_dis_ref(self, *args):
        assert len(args) == len(_build.SIGNATURES["fot_dis_ref"])
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("ps,C,one_d,cost", [(8, 3, False, "huber"),
                                             (8, 1, True, "l2"),
                                             (12, 3, False, "l1"),
                                             (6, 3, False, "huber"),
                                             (10, 1, True, "l1")])
def test_launch_passes_the_plan(ps, C, one_d, cost):
    """``launch`` hands the C entry the plan's form and shared bytes, the
    grid's patches and row width (the kernel's row order), the cost's
    number, the 1-D flag and the converged flags' output, which the
    kernel fills (the argument count matches ``_build``'s)."""
    cfg = dataclasses.replace(port.operating_point(2), patch_size=ps,
                              cost_fn=cost)
    grid = ppatches.PatchGrid.create(cfg, 32, 24)
    lead = (1, grid.n_h, grid.n_w)
    patch = torch.zeros(lead + (ps, ps, C))
    two = torch.zeros(lead + (2,))
    st = pdis.PatchState(p_cur=two, p_org=two, mid_org=two,
                         H=torch.ones(lead + (3,)), templates=patch,
                         tgrad_x=patch, tgrad_y=patch,
                         converged=torch.zeros(lead, dtype=torch.bool),
                         cost_px=patch, diff=patch)
    I1 = torch.zeros((1, 24 + 2 * grid.padding, 32 + 2 * grid.padding, C))
    lib = _Lib()
    converged = torch.empty(lead, dtype=torch.bool)
    dis_ref.launch(lib, st, I1, grid, cfg, one_d, 1, None, two, patch, patch,
                   converged, 0)
    args = lib.calls[0]
    plan = dis_ref.ref_plan(ps, C)
    assert args[37:39] == (plan.form, plan.shared_bytes)
    assert args[22:25] == (dis_ref.COST_FNS[cost], int(one_d), 1)
    assert args[16:19] == (grid.n_patches, grid.n_w, ps) and args[4] == C
    assert args[42] == converged.data_ptr()


def test_refuses_a_frame_beyond_32_bit_offsets():
    """The kernel addresses a frame's taps with 32-bit offsets: a level of
    2^31 values or more raises before anything is built."""
    cfg = port.operating_point(2)
    grid = ppatches.PatchGrid.create(cfg, 32, 24)
    lead = (1, grid.n_h, grid.n_w)
    meta = dict(device="meta")
    patch = torch.empty(lead + (8, 8, 3), **meta)
    two = torch.empty(lead + (2,), **meta)
    st = pdis.PatchState(p_cur=two, p_org=two, mid_org=two,
                         H=torch.empty(lead + (3,), **meta), templates=patch,
                         tgrad_x=patch, tgrad_y=patch,
                         converged=torch.empty(lead, dtype=torch.bool, **meta),
                         cost_px=patch, diff=patch)
    big = _card(torch.empty((1, 2 ** 12, 2 ** 16, 3), **meta))
    dis_ref.check_args(st, big, grid)        # 2^29.6 values: taken
    huge = _card(torch.empty((1, 2 ** 14, 2 ** 16, 3), **meta))
    with pytest.raises(ValueError, match="32-bit"):
        dis_ref.check_args(st, huge, grid)
