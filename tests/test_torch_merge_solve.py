"""The fb merge (G5) and the reference-form solve with its 1-D stereo form
(G6) on the CPU: their plain versions against an independent fold and
against the JAX package, the callers kept off the kernels for CPU
tensors, and the wrappers' checks before anything is built.

The kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here ``ops/densify.fb_merge_plain`` is held to the
merge's contract, bit for bit: each cell's sum is the left fold from
+0.0 of its contributions in the JAX package's order (frame, corner,
patch in grid order; at most one pixel a cell, corner and patch).  The
reference-form solve's plain version: ``tests/test_torch_modes.py``
``test_optimize_reference_matches_jax``.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowonthego_tpu.config import DISConfig as JaxConfig
from flowonthego_tpu.models import stereo as jstereo
from flowonthego_tpu.ops import pyramid as jpyramid

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch.convert import config_from_jax
from flowonthego_tpu_torch.models import stereo as pstereo
from flowonthego_tpu_torch.ops import densify as pdensify
from flowonthego_tpu_torch.ops import dis as pdis
from flowonthego_tpu_torch.ops import patches as ppatches
from flowonthego_tpu_torch.ops.cuda import _build, dis_ref, fb_merge
from flowonthego_tpu_torch.utils.synth import synthetic_frames

from test_torch_kernels import _jax_state, _scene, _t
from test_torch_modes import _numpy_state

torch.set_num_threads(1)

F32 = np.float32


# ---------------------------------------------------------------- G5

def _merge_state(rng, case, B, C, h, w):
    """(cfg, grid, state) with seeded flows and costs for one case (op 2's
    8x8 patches, 4 px apart)."""
    cfg = dataclasses.replace(port.operating_point(2, width=w),
                              densify_weight="abs" if case == "abs"
                              else "squared")
    grid = ppatches.PatchGrid.create(cfg, w, h)
    ps = grid.patch_size
    lead = (B, grid.n_h, grid.n_w)
    mid = torch.as_tensor(np.stack(grid.midpoints(), -1), dtype=torch.float32)
    mid = mid[None].expand(lead + (2,))
    p = rng.standard_normal(lead + (2,)).astype(F32) * 3
    if case == "outside":
        # half the patches far outside, the rest landing across the edges
        p[..., : grid.n_w // 2, 0] += 1000.0
        p[..., grid.n_w // 2:, :] *= 4.0
    elif case == "pile-up":
        # every patch of every frame lands on cell (w // 2, h // 3), each
        # with its own fraction
        target = np.array([w // 2, h // 3], F32)
        p = (target - mid.numpy() + rng.random(lead + (2,)).astype(F32)
             - F32(0.5))
    cost = (rng.random(lead + (ps, ps, C)) ** 2 * 50).astype(F32)
    state = pdis.PatchState(torch.as_tensor(p), None, mid, None, None, None,
                            None, None, torch.as_tensor(cost), None)
    return cfg, grid, state


def _numpy_fold(state, grid, cfg, h, w):
    """The merge's contract as a loop: each cell from +0.0, adding in the
    order frame, corner (0,0), (1,0), (0,1), (1,1), patch in grid order,
    pixel; every value in float32 as the plain version computes it on the
    CPU (a channel sum left to right, 1 / x, the products in their
    order; the abs weights' square roots are torch's, whose CPU kernel
    rounds some values otherwise than numpy)."""
    p = state.p_cur.numpy()
    mid = state.mid_org.numpy()
    cost = state.cost_px.numpy()
    B, n_h, n_w = p.shape[:3]
    ps, C = grid.patch_size, cost.shape[-1]
    lb = -ps // 2
    acc = np.zeros((B, h, w, 3), F32)
    err = cost
    if cfg.densify_weight == "abs" and cfg.cost_fn == "l2":
        err = torch.sqrt(state.cost_px).numpy()
    err = np.maximum(err, F32(cfg.min_errval))
    wsum = err[..., 0]
    for c in range(1, C):
        wsum = wsum + err[..., c]
    absw = F32(1.0) / wsum
    for b in range(B):
        for ox, oy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            for j_ in range(n_h):
                for i_ in range(n_w):
                    px = mid[b, j_, i_, 0] + p[b, j_, i_, 0]
                    py = mid[b, j_, i_, 1] + p[b, j_, i_, 1]
                    cx = int(np.ceil(px + F32(1e-5)))
                    cy = int(np.ceil(py + F32(1e-5)))
                    rx, ry = px - np.floor(px), py - np.floor(py)
                    wb = {(0, 0): rx * ry, (1, 0): (F32(1) - rx) * ry,
                          (0, 1): rx * (F32(1) - ry),
                          (1, 1): (F32(1) - rx) * (F32(1) - ry)}[(ox, oy)]
                    u, v = p[b, j_, i_]
                    for r in range(ps):
                        for q in range(ps):
                            xt, yt = cx + lb + q, cy + lb + r
                            if not (1 <= xt < w - 1 and 1 <= yt < h - 1):
                                continue
                            a = absw[b, j_, i_, r, q]
                            acc[b, yt - oy, xt - ox] += np.array(
                                [wb * a, wb * (-u * a), wb * (-v * a)], F32)
    return acc


@pytest.mark.parametrize("case,B,C", [("scattered", 2, 3), ("scattered", 1, 1),
                                      ("outside", 2, 3), ("pile-up", 2, 3),
                                      ("abs", 1, 3)])
def test_fb_merge_plain_is_the_left_fold(rng, case, B, C):
    """``fb_merge_plain`` (and the public merge on CPU tensors) equals the
    contract's fold bit for bit: two frames, patches landing outside the
    frame and across its edges, every patch piled on one cell, the abs
    weights, C = 1 and 3."""
    h, w = 20, 28
    cfg, grid, state = _merge_state(rng, case, B, C, h, w)
    got = pdensify.fb_merge_plain(state, grid, cfg, h, w)
    want = _numpy_fold(state, grid, cfg, h, w)
    assert got.dtype == torch.float32 and got.shape == (B, h, w, 3)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(pdensify._fb_merge_scatter(state, grid, cfg, h, w),
                       got)
    if case == "pile-up":   # the landings span two cells a side
        hit = (got[..., 0] > 0).sum(dim=(1, 2))
        assert (hit <= (grid.patch_size + 2) ** 2).all() and (hit > 0).all()
    if case == "outside":
        assert (got[:, :, : w // 4, 0] == 0).any()


# ---------------------------------------------------------------- G6

@pytest.mark.parametrize("entry", ["_optimize_1d", "optimize_1d_plain"])
@pytest.mark.parametrize("cam_lr,C,warm", [(0, 3, False), (1, 1, False),
                                           (0, 3, True)])
def test_optimize_1d_matches_jax(rng, cam_lr, C, warm, entry):
    """Stereo's 1-D solve on CPU tensors (the public name, which sends
    them on to the plain version, and the plain version itself) against
    JAX's on the same state: p within 1e-4 px (the same sums in another
    order), v zero, the sign clamp kept, cost_px and diff within 1e-3."""
    jc = JaxConfig(coarsest_scale=1, finest_scale=1, grad_descent_iter=12,
                   use_var_ref=False)
    sx = -2 if cam_lr == 0 else 2
    i0, i1 = _scene(rng, 48, 64, shift=(sx, 0), c=C)
    coarse = None
    if warm:
        coarse = np.zeros((24, 32, 2), F32)
        coarse[..., 0] = (rng.standard_normal((24, 32)) * 1.5).astype(F32)
    grid, jstate = _jax_state(jc, i0, coarse)
    I1p = jpyramid.pad_replicate(jnp.asarray(i1), jc.padding)
    ref = jstereo._optimize_1d(jstate, I1p, grid, jc, cam_lr)
    pc = config_from_jax(dataclasses.asdict(jc))
    got = getattr(pstereo, entry)(_numpy_state(jstate), _t(I1p)[None],
                                  ppatches.PatchGrid.create(pc, 64, 48), pc,
                                  cam_lr)
    np.testing.assert_allclose(got.p_cur[0].numpy(), np.asarray(ref.p_cur),
                               rtol=1e-4, atol=1e-4)
    assert (got.p_cur[..., 1] == 0).all()
    d = got.p_cur[..., 0]
    if not warm:    # a warm start's p_org, where a patch resets, is free
        assert (d <= 0).all() if cam_lr == 0 else (d >= 0).all()
    for name in ("cost_px", "diff"):
        np.testing.assert_allclose(getattr(got, name)[0].numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-3, atol=1e-3, err_msg=name)
    assert got.converged.all()


@pytest.mark.parametrize("one_d", [False, True])
def test_plain_solves_count_their_trips(rng, one_d):
    """``count_iters`` (what a bound counts) leaves the state as it was;
    a patch converged on entry runs no trip, and none runs more than
    ``grad_descent_iter``."""
    jc = JaxConfig(coarsest_scale=1, finest_scale=1, grad_descent_iter=6,
                   cost_fn="huber", min_iter=2)
    i0, i1 = _scene(rng, 48, 64, shift=(3, -2))
    coarse = rng.standard_normal((24, 32, 2)).astype(F32) * 2.0
    grid, jstate = _jax_state(jc, i0, coarse)
    I1p = _t(jpyramid.pad_replicate(jnp.asarray(i1), jc.padding))[None]
    pc = config_from_jax(dataclasses.asdict(jc))
    pgrid = ppatches.PatchGrid.create(pc, 64, 48)
    state = _numpy_state(jstate)
    if one_d:
        run = lambda **kw: pstereo.optimize_1d_plain(  # noqa: E731
            state, I1p, pgrid, pc, 0, **kw)
    else:
        run = lambda **kw: pdis.optimize_reference_plain(  # noqa: E731
            state, I1p, pgrid, pc, **kw)
    plain = run()
    counted, trips = run(count_iters=True)
    for a, b in zip(plain, counted):
        assert torch.equal(a, b)
    assert trips.shape == state.converged.shape
    assert (trips[state.converged] == 0).all()
    assert int(trips.max()) <= 6 and int(trips.sum()) > 0


# ------------------------------------------------ dispatch on the CPU

@pytest.mark.parametrize("mode", ["fb", "huber", "l1 min_iter", "depth"])
def test_cpu_callers_stay_off_the_kernels(monkeypatch, mode):
    """Under "auto" CPU tensors never reach G5's or G6's launch on the
    paths that run them: forward-backward consistency, the robust costs,
    ``min_iter`` and stereo depth."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel was reached for a CPU tensor")
    for mod in (fb_merge, dis_ref):
        monkeypatch.setattr(mod, "launch", refuse)
    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    frames = synthetic_frames(5, 2, 32, 64, (-2, 0), factor=4)
    cfg = port.operating_point(2, width=64)
    fields = {"fb": dict(use_fb_consistency=True),
              "huber": dict(cost_fn="huber"),
              "l1 min_iter": dict(cost_fn="l1", min_iter=4)}.get(mode, {})
    cfg = dataclasses.replace(cfg, **fields)
    if mode == "depth":
        out = port.compute_disparity(frames[0], frames[1], cfg, device="cpu")
    else:
        out = port.compute_flow(frames[0], frames[1], cfg, device="cpu")
    assert np.isfinite(np.asarray(out)).all()
    assert fb_merge.launches == 0 and dis_ref.launches == 0


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so a wrapper takes its
    kernel branch (and here reaches the refused build)."""

    @property
    def is_cuda(self):
        return True


def _card(x):
    return x.as_subclass(_OnCard)


def _solve_state():
    cfg = dataclasses.replace(port.operating_point(2), cost_fn="huber")
    h, w, C = 24, 32, 3
    img = torch.rand((1, h + 16, w + 16, C)) * 255
    grid = ppatches.PatchGrid.create(cfg, w, h)
    lvl = port.ops.pyramid.pyramid_level_plain(img[:, 8:-8, 8:-8],
                                               cfg.padding)
    tmpl = ppatches.extract_templates_and_hessians_plain(*lvl, grid, cfg)
    return cfg, grid, img, port.ops.dis.init_state(*tmpl, grid)


def _wrapper_calls():
    """For each wrapper: (call on good arguments, [calls on bad ones]):
    a wrong dtype, a wrong layout, a wrong shape, mixed devices, tensors
    that all lie on the CPU, a geometry the launch plan refuses."""
    cfg, grid, img, st = _solve_state()
    h, w = grid.height, grid.width
    meta = torch.empty(st.templates.shape, device="meta")
    cost = torch.rand(st.cost_px.shape)

    def mg(state, out_h=h, out_w=w, grid=grid):
        s = state._replace(p_cur=_card(state.p_cur))
        return lambda: fb_merge.fb_merge(s, grid, cfg, out_h, out_w)

    def ref(state, I1=img, one_d=False):
        if one_d:
            return lambda: dis_ref.optimize_1d(state, _card(I1), grid, cfg,
                                               0)
        return lambda: dis_ref.optimize_reference(state, _card(I1), grid,
                                                  cfg)

    good = st._replace(cost_px=cost)
    return {
        "fb_merge": (mg(good), [
            mg(good._replace(p_cur=good.p_cur.double())),
            mg(good._replace(cost_px=cost.transpose(3, 4))),
            mg(good._replace(cost_px=cost[..., :2, :, :])),
            mg(good._replace(cost_px=cost.to("meta"))),
            # patches wider than a cell tile (32 px): the plan refuses
            mg(good._replace(cost_px=torch.rand(cost.shape[:3]
                                                + (40, 40, 3))),
               grid=dataclasses.replace(grid, patch_size=40)),
            lambda: fb_merge.fb_merge(good, grid, cfg, h, w)]),
        "dis_ref": (ref(st), [
            ref(st._replace(templates=st.templates.double())),
            ref(st._replace(tgrad_x=st.tgrad_x.transpose(3, 4))),
            ref(st, torch.cat([img, img])),
            ref(st._replace(diff=meta)),
            lambda: dis_ref.optimize_reference(st, img, grid, cfg)]),
        "dis_ref 1-D": (ref(st, one_d=True), [
            ref(st._replace(H=st.H.double()), one_d=True),
            ref(st._replace(cost_px=st.cost_px.transpose(3, 4)), one_d=True),
            ref(st._replace(p_org=st.p_org[..., :1]), one_d=True),
            ref(st._replace(converged=st.converged.to("meta")),
                one_d=True),
            lambda: dis_ref.optimize_1d(st, img, grid, cfg, 0)]),
    }


@pytest.mark.parametrize("name", ["fb_merge", "dis_ref", "dis_ref 1-D"])
def test_wrapper_checks_come_before_the_build(monkeypatch, name):
    """A wrong dtype, a layout the kernel cannot take, a wrong shape,
    mixed devices and CPU tensors (the wrappers run no plain version)
    raise ValueError from the wrapper's checks before the kernel library
    is built or loaded; good arguments pass the checks and reach the
    build (refused here: there is no card)."""
    def refuse():
        raise RuntimeError("the build was reached")
    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    good, bad = _wrapper_calls()[name]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    with pytest.raises(RuntimeError, match="the build was reached"):
        good()
    assert fb_merge.launches == 0 and dis_ref.launches == 0
