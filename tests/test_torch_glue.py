"""The per-scale glue (G1-G4: a pyramid level, template extraction,
densify, the var-ref derivatives) against the JAX package on the CPU
(extraction's plain version: tests/test_torch_kernels.py).

The JAX package runs these as XLA fusions (no Pallas kernel); the port
runs them as four CUDA kernels on the card and as their plain PyTorch
versions on CPU tensors.  Here the plain versions are held against the
JAX functions on the same seeded numpy inputs, frame by frame, over the
channel counts, batch sizes, op 2's and op 4's patch geometry, mean
normalisation and the densify weights; the callers are shown to stay off
the kernels for CPU tensors, and the wrappers to check their arguments
before anything is built.  Tolerances are stated per test.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowonthego_tpu.config import operating_point as jax_operating_point
from flowonthego_tpu.ops import densify as jdensify
from flowonthego_tpu.ops import dis as jdis
from flowonthego_tpu.ops import patches as jpatches
from flowonthego_tpu.ops import pyramid as jpyramid
from flowonthego_tpu.ops import variational as jvariational

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch.convert import (config_from_jax,
                                           patch_state_from_numpy)
from flowonthego_tpu_torch.ops import densify as pdensify
from flowonthego_tpu_torch.ops import patches as ppatches
from flowonthego_tpu_torch.ops import pyramid as ppyramid
from flowonthego_tpu_torch.ops import variational as pvariational
from flowonthego_tpu_torch.ops.cuda import (_build, densify, derivs,
                                            extract, level, varref_fused)
from flowonthego_tpu_torch.utils.synth import (plant_stripes, smooth_texture,
                                              synthetic_frames)

torch.set_num_threads(1)

GLUE = {"level": level, "extract": extract, "densify": densify,
        "derivs": derivs}


def _frames(rng, n, h, w, C):
    """n seeded smooth textures [n, h, w, C] float32, each with a flat
    block (flat patches: det == 0) and a block of vertical stripes
    (det == 0 where H00 > 0)."""
    seeds = rng.integers(0, 2**31, n)
    f = np.stack([smooth_texture(int(s), h, w, C, factor=4) for s in seeds])
    f[:, :h // 3, :w // 4] = 128.0
    return plant_stripes(f)


def _configs(op, **fields):
    jc = dataclasses.replace(jax_operating_point(op), **fields)
    return jc, config_from_jax(dataclasses.asdict(jc))


# ---------------------------------------------------------------- G1

@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("op", [2, 4])
def test_level_plain_matches_jax(rng, op, C, n):
    """A level's padded image and zero-bordered central differences,
    frame by frame: exact (copies and one subtraction); the fixed-tensor
    form (``out=``) writes the same values."""
    jc, pc = _configs(op)
    img = _frames(rng, n, 20, 28, C)
    got = ppyramid.pyramid_level_plain(torch.as_tensor(img), pc.padding)
    buf = ppyramid.pyramid_buffers(n, 20, 28, C, 1, pc.padding, 0, "cpu")[0]
    ppyramid.pyramid_level_plain(torch.as_tensor(img), pc.padding, out=buf)
    for b in range(n):
        ref = jpyramid.build_pyramid(jnp.asarray(img[b]), 1, jc.padding)[0]
        for x, y, r in zip(got, buf, ref):
            np.testing.assert_array_equal(x[b].numpy(), np.asarray(r))
            np.testing.assert_array_equal(y[b].numpy(), np.asarray(r))


# ---------------------------------------------------------------- G2

# G2's plain version against JAX: tests/test_torch_kernels.py
# test_extract_matches_jax (op 1, 2, 4; C = 1, 3; one and two frames; mean
# normalisation on and off; flat patches).


# ---------------------------------------------------------------- G3

def _jax_patch_state(jc, img, rng):
    """A JAX PatchState of frame ``img`` with seeded patch flows and
    per-pixel costs (the clamp at min_errval and large costs both taken)."""
    h, w = img.shape[:2]
    grid = jpatches.PatchGrid.create(jc, w, h)
    lvl = jpyramid.build_pyramid(jnp.asarray(img), 1, jc.padding)[0]
    st = jdis.init_state(*jpatches.extract_templates_and_hessians(
        *lvl, grid, jc), grid)
    p = rng.standard_normal((grid.n_h, grid.n_w, 2)).astype(np.float32) * 3
    cost = (rng.random(st.cost_px.shape) ** 2 * 50).astype(np.float32)
    return grid, st._replace(p_cur=jnp.asarray(p), cost_px=jnp.asarray(cost))


@pytest.mark.parametrize("fb", [False, True])
@pytest.mark.parametrize("weight", ["squared", "abs"])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("op", [2, 4])
def test_densify_plain_matches_jax(rng, op, C, n, weight, fb):
    """The plain canvas, clip and normalisation (with the fb merge's
    accumulator where ``fb``), frame by frame: <= 1e-5 abs, the weights'
    channel sum and the canvas adds associating differently in XLA."""
    jc, pc = _configs(op, densify_weight=weight)
    h, w = 30, 40
    frames = _frames(rng, n, h, w, C)
    jstates, cstates = [], []
    for b in range(n):
        grid, st = _jax_patch_state(jc, frames[b], rng)
        jstates.append(st)
        cstates.append(st._replace(p_cur=-st.p_cur[::-1]))
    stack = [patch_state_from_numpy({k: np.stack([np.asarray(getattr(s, k))
                                                  for s in states])
                                     for k in jdis.PatchState._fields})
             for states in (jstates, cstates)]
    pgrid = ppatches.PatchGrid.create(pc, w, h)
    got = pdensify.densify(stack[0], pgrid, pc,
                           compl_state=stack[1] if fb else None)
    for b in range(n):
        ref = jdensify.densify(jstates[b], grid, jc,
                               compl_state=cstates[b] if fb else None)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5)


# ---------------------------------------------------------------- G4

@pytest.mark.parametrize("hw", [(24, 36), (4, 8)])
@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("C", [1, 3])
def test_derivatives_plain_matches_jax(rng, C, n, hw):
    """The eight derivative planes of a strided crop (as the var-ref gets
    its image) and a warped frame, frame by frame, down to a field of 4
    rows, where every second derivative reaches the first derivatives'
    replicated edge: <= 1e-6 relative to the largest value (XLA may divide
    by 12 where PyTorch's CUDA code multiplies by 1/12: an ulp)."""
    h, w = hw
    big = _frames(rng, n, h + 6, w + 6, C)
    im1 = torch.as_tensor(big)[:, 3:3 + h, 3:3 + w]
    w_im2 = _frames(rng, n, h, w, C)
    got = derivs.derivatives_plain(im1, torch.as_tensor(w_im2))
    assert got.shape == (n, 8, C, h, w) and got.is_contiguous()
    for b in range(n):
        ref = jvariational.get_derivatives(jnp.asarray(im1[b].numpy()),
                                           jnp.asarray(w_im2[b]))
        for k, r in enumerate(ref):
            r = np.asarray(r)
            np.testing.assert_allclose(
                got[b, k].permute(1, 2, 0).numpy(), r, rtol=0,
                atol=1e-6 * max(1.0, np.abs(r).max()))


def test_derivatives_layout_is_warp_and_derivs():
    """``derivatives_plain`` gives ``warp_and_derivs``'s planes: dIs[:, k,
    c] is the k-th ``Derivatives`` field's channel c, in field order,
    exactly; and ``warp_and_derivs`` on CPU tensors returns them."""
    n, h, w, C = 2, 12, 20, 3
    frames = [synthetic_frames(s, 2, h, w, (1, 0), factor=4) for s in (3, 4)]
    im1, im2 = (torch.as_tensor(np.stack([f[k] for f in frames]))
                for k in (0, 1))
    flow = torch.full((n, h, w, 2), 0.25)
    wx, wy, mask, dIs = varref_fused.warp_and_derivs(
        flow, im1, im2, port.operating_point(2))
    w_im2, wmask = pvariational.warp_image(im2, flow[..., 0], flow[..., 1])
    d = pvariational.get_derivatives(im1, w_im2)
    assert torch.equal(mask, wmask)
    assert torch.equal(dIs, derivs.derivatives_plain(im1, w_im2))
    assert pvariational.Derivatives._fields == (
        "Ix", "Iy", "Iz", "Ixx", "Ixy", "Iyy", "Ixz", "Iyz")
    for k, field in enumerate(d):
        for c in range(C):
            assert torch.equal(dIs[:, k, c], field[..., c])


# ---------------------------------------------------- dispatch on the CPU

def _no_kernels(monkeypatch):
    """Every G wrapper's launch, and the kernel library's build, raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("a glue kernel was reached for a CPU tensor")
    for mod in GLUE.values():
        monkeypatch.setattr(mod, "launch", refuse)
    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(_build, "build", refuse)


@pytest.mark.parametrize("mode", ["op 2", "op 2 fb", "op 1", "stream",
                                  "depth"])
def test_cpu_callers_stay_off_the_glue_kernels(monkeypatch, mode):
    """Under "auto" (every backend field's default), CPU tensors never
    reach a G kernel's launch on any path that runs the glue: a pair with
    var-ref, with forward-backward consistency, op 1 (no var-ref), a
    stream (the pyramid written into fixed tensors) and stereo depth."""
    _no_kernels(monkeypatch)
    frames = synthetic_frames(5, 3, 32, 64, (2, 1), factor=4)
    cfg = port.operating_point(1 if mode == "op 1" else 2, width=64)
    if mode == "op 2 fb":
        cfg = dataclasses.replace(cfg, use_fb_consistency=True)
    if mode == "stream":
        flows = list(port.stream_flow(frames, cfg, device="cpu"))
        assert len(flows) == 2
    elif mode == "depth":
        d = port.compute_disparity(frames[0], frames[1], cfg, device="cpu")
        assert np.isfinite(np.asarray(d)).all()
    else:
        flow = port.compute_flow(frames[0], frames[1], cfg, device="cpu")
        assert np.isfinite(np.asarray(flow)).all()


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so a wrapper takes its
    kernel branch (and here reaches the refused build)."""

    @property
    def is_cuda(self):
        return True


def _card(x):
    return x.as_subclass(_OnCard)


def _wrapper_calls():
    """For each wrapper: (call on good arguments, [calls on bad ones])."""
    cfg = port.operating_point(2)
    h, w, C = 12, 16, 3
    img = torch.rand((1, h, w, C)) * 255
    lvl = ppyramid.pyramid_level_plain(img, cfg.padding)
    grid = ppatches.PatchGrid.create(cfg, w, h)
    tmpl = extract.extract_templates_and_hessians(*lvl, grid, cfg)
    st = port.ops.dis.init_state(*tmpl, grid)
    p, cost = st.p_cur.contiguous(), torch.rand(st.cost_px.shape)
    meta = torch.empty((1, h + 16, w + 16, C), device="meta")
    crop = lvl.image[:, 8:8 + h, 8:8 + w]

    def lv(x, out=None):
        return lambda: level.pyramid_level(_card(x), cfg.padding, out)

    def ex(a, b, c):
        return lambda: extract.extract_templates_and_hessians(
            _card(a), b, c, grid, cfg)

    def de(pc, c, merge=None, grid=grid):
        return lambda: densify.densify(st._replace(p_cur=_card(pc),
                                                   cost_px=c), grid, cfg,
                                       merge)

    # 40 px patches every px: one column's CTA would need more shared
    # memory than a CTA has, so the plan refuses it
    wide = dataclasses.replace(grid, patch_size=40, steps=1, n_h=h, n_w=w)

    def dv(a, b):
        return lambda: derivs.derivatives(_card(a), b)

    return {
        "level": (lv(img), [
            lv(img.double()), lv(img.transpose(1, 2)),
            lv(img, ppyramid.PyramidLevel(meta, meta, meta))]),
        "extract": (ex(*lvl), [
            ex(lvl.image.double(), lvl.grad_x, lvl.grad_y),
            ex(lvl.image, lvl.grad_x.transpose(1, 2).contiguous()
               .transpose(1, 2), lvl.grad_y),
            ex(lvl.image, meta, lvl.grad_y)]),
        "densify": (de(p, cost), [
            de(p.double(), cost), de(p, cost.transpose(1, 2)),
            de(p, cost.to("meta")),
            de(p, cost, torch.zeros((1, h, w, 3), device="meta")),
            de(torch.zeros((1, h, w, 2)), torch.rand((1, h, w, 40, 40, 3)),
               grid=wide)]),
        "derivs": (dv(crop, img), [
            dv(crop.double(), img), dv(crop, img[..., :1].expand_as(img)),
            dv(crop, img.to("meta"))]),
    }


@pytest.mark.parametrize("name", sorted(GLUE))
def test_wrapper_checks_come_before_the_build(monkeypatch, name):
    """A wrong dtype, a layout the kernel cannot take, mixed devices or
    (G3) a geometry its launch plan refuses raise ValueError from the
    wrapper's checks before the kernel library
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
    assert GLUE[name].launches == 0
