"""The modes behind the CLI flags, the port against the JAX package.

The reference-form solve (l1/huber costs, ``min_iter``, ``res_thresh``),
the forward-backward merge, the channel modes, stereo depth and the
numpy I/O run on CPU tensors and are held against the JAX package's own
functions (jitted where the JAX package jits them) on the same numpy
inputs.  Tolerances are stated per test, with their reason.
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowonthego_tpu as fot
from flowonthego_tpu.config import DISConfig as JaxConfig
from flowonthego_tpu.io import color as jcolor
from flowonthego_tpu.io import images as jimages
from flowonthego_tpu.io import pfm as jpfm
from flowonthego_tpu.models.stereo import compute_disparity as jax_disparity
from flowonthego_tpu.ops import channels as jchannels
from flowonthego_tpu.ops import densify as jdensify
from flowonthego_tpu.ops import dis as jdis
from flowonthego_tpu.ops import pyramid as jpyramid

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch.convert import config_from_jax, \
    patch_state_from_numpy
from flowonthego_tpu_torch.io import images as pimages
from flowonthego_tpu_torch.ops import densify as pdensify
from flowonthego_tpu_torch.ops import dis as pdis
from flowonthego_tpu_torch.ops import patches as ppatches
from flowonthego_tpu_torch.utils.synth import synthetic_frames

from test_torch_kernels import _jax_state, _scene, _t
from test_torch_slice import assert_flow_band

torch.set_num_threads(1)


def _numpy_state(state):
    return patch_state_from_numpy({k: np.asarray(v)
                                   for k, v in state._asdict().items()})


# ------------------------------------------------ reference-form solve

@pytest.mark.parametrize("entry", ["optimize", "optimize_reference_plain"])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("mode", [dict(cost_fn="l1"), dict(cost_fn="huber"),
                                  dict(min_iter=2), dict(res_thresh=20.0)])
def test_optimize_reference_matches_jax(rng, mode, warm, entry):
    """p atol 1e-4, cost_px rtol/atol 1e-3, as the K2 test: the same
    values summed in another order.  The warm start freezes some patches
    at once and sends others through the outlier reset.  ``entry``: the
    public solve (which sends these modes to ``optimize_reference``, and
    CPU tensors on to its plain version) or the plain version itself.

    The robust costs store a transformed residual whose slope is infinite
    at 0 (l1: sign(d) sqrt|d|) or which cancels to 0 below |d| ~ 1e-3
    (pseudo-Huber: sqrt(1 + d^2/b^2) - 1 in float32), so an ulp of d
    moves it by up to ~5e-3.  Each step sums those residuals, and l1's
    solve does not contract them: its p ends up to 4e-4 px apart.  So for
    the robust costs p is held at 1e-3, and diff and cost_px are compared
    as x|x|, which undoes the slope, at rtol 1e-3 / atol 2e-3 (the residual
    at a position 1e-3 px apart)."""
    jc = JaxConfig(coarsest_scale=1, finest_scale=1, grad_descent_iter=12,
                   **mode)
    i0, i1 = _scene(rng, 48, 64, shift=(3, -2) if warm else (2, 1))
    coarse = (rng.standard_normal((24, 32, 2)).astype(np.float32) * 2.0
              if warm else None)
    grid, jstate = _jax_state(jc, i0, coarse)
    I1p = jpyramid.pad_replicate(jnp.asarray(i1), jc.padding)
    ref = jdis.optimize(jstate, I1p, grid, jc)

    pc = config_from_jax(dataclasses.asdict(jc))
    got = getattr(pdis, entry)(_numpy_state(jstate), _t(I1p)[None],
                               ppatches.PatchGrid.create(pc, 64, 48), pc)
    robust = jc.cost_fn != "l2"
    np.testing.assert_allclose(got.p_cur[0].numpy(), np.asarray(ref.p_cur),
                               rtol=1e-4, atol=1e-3 if robust else 1e-4)
    for name in ("cost_px", "diff"):
        a = getattr(got, name)[0].numpy().astype(np.float64)
        b = np.asarray(getattr(ref, name), np.float64)
        if robust:
            a, b = a * np.abs(a), b * np.abs(b)
        np.testing.assert_allclose(a, b, rtol=1e-3,
                                   atol=2e-3 if robust else 1e-3,
                                   err_msg=name)
    assert got.converged.all()
    # the mode changed the solve: the fixed-trip L2 solve lands elsewhere
    fixed = pdis.optimize(_numpy_state(jstate), _t(I1p)[None],
                          ppatches.PatchGrid.create(pc, 64, 48),
                          config_from_jax(dataclasses.asdict(
                              JaxConfig(coarsest_scale=1, finest_scale=1))))
    assert (fixed.p_cur - got.p_cur).abs().max() > 1e-3


# ------------------------------------------------ forward-backward merge

@pytest.mark.parametrize("channels", [3, 1])
def test_densify_fb_merge_matches_jax(rng, channels):
    """densify with a complementary state: <= 1e-5 abs.  Weights are
    1/max(2, cost) and the merge adds the same terms in the same order
    (corners outer, patches inner)."""
    jc = JaxConfig(coarsest_scale=1, finest_scale=1)
    i0, i1 = _scene(rng, 48, 64, shift=(2, 1), c=channels)
    grid, jf = _jax_state(jc, i0, None)
    _, jb = _jax_state(jc, i1, None)
    jf = jdis.optimize(jf, jpyramid.pad_replicate(jnp.asarray(i1), 8),
                       grid, jc)
    jb = jdis.optimize(jb, jpyramid.pad_replicate(jnp.asarray(i0), 8),
                       grid, jc)
    pc = config_from_jax(dataclasses.asdict(jc))
    pgrid = ppatches.PatchGrid.create(pc, 64, 48)
    pf, pb = _numpy_state(jf), _numpy_state(jb)
    for a, b, sa, sb in ((jf, jb, pf, pb), (jb, jf, pb, pf)):
        ref = np.asarray(jdensify.densify(a, grid, jc, compl_state=b))
        got = pdensify.densify(sa, pgrid, pc, compl_state=sb)[0].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        plain = pdensify.densify(sa, pgrid, pc)[0].numpy()
        assert np.abs(got - plain).max() > 1e-4     # the merge did merge


@pytest.mark.parametrize("use_var_ref", [False, True])
def test_compute_flow_fb_matches_jax(use_var_ref):
    """compute_flow with forward-backward consistency at 3 scales, the
    backward chain warm-started and refined: the whole-flow band."""
    i0, i1 = synthetic_frames(6, 2, 64, 96, (2, 1), factor=4)
    kw = dict(coarsest_scale=3, finest_scale=1, use_var_ref=use_var_ref,
              use_fb_consistency=True)
    ref = np.asarray(fot.compute_flow(i0, i1, JaxConfig(**kw)))
    got = port.compute_flow(i0, i1, port.DISConfig(**kw),
                            device="cpu").numpy()
    assert_flow_band(got, ref)
    no_fb = port.compute_flow(i0, i1, port.DISConfig(
        **dict(kw, use_fb_consistency=False)), device="cpu").numpy()
    assert np.abs(got - no_fb).max() > 1e-4


def test_config_from_jax_carries_mode_fields():
    """A JAX config with every CLI mode field set, carried as a dict,
    gives the port the same config and the same flow (band)."""
    jc = JaxConfig(coarsest_scale=2, finest_scale=1, grad_descent_iter=6,
                   use_var_ref=False, cost_fn="huber", min_iter=3,
                   res_thresh=0.5, use_fb_consistency=True,
                   densify_weight="abs")
    pc = config_from_jax(dataclasses.asdict(jc))
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    i0, i1 = synthetic_frames(7, 2, 48, 64, (1, 1), factor=4)
    assert_flow_band(port.compute_flow(i0, i1, pc, device="cpu").numpy(),
                     np.asarray(fot.compute_flow(i0, i1, jc)))


# ------------------------------------------------ channels and stereo

@pytest.mark.parametrize("mode", ["rgb", "gray", "gradmag", "1", "2"])
def test_prepare_input_matches_jax(rng, mode):
    """Elementwise float32 arithmetic in the same order: <= 1e-5 abs on
    0..255 values (exact for rgb), or 1e-6 relative for gradmag, whose
    squares XLA may fuse into one FMA (an ulp of values up to ~360)."""
    img = (rng.random((20, 28, 3)) * 255).astype(np.float32)
    ref = np.asarray(jchannels.prepare_input(jnp.asarray(img), mode))
    got = port.prepare_input(img, mode).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError, match="channel mode"):
        port.prepare_input(img, "hsv")


@pytest.mark.parametrize("cam_lr,channels", [(0, 3), (1, 1)])
def test_compute_disparity_matches_jax(cam_lr, channels):
    """1-D stereo against JAX (band), sign-clamped: <= 0 for the left
    reference, >= 0 for the mirrored pair."""
    sx = -2 if cam_lr == 0 else 2
    i0, i1 = synthetic_frames(8, 2, 64, 96, (sx, 0), channels=channels,
                              factor=4)
    kw = dict(coarsest_scale=3, finest_scale=1, use_var_ref=False)
    ref = np.asarray(jax_disparity(i0, i1, JaxConfig(**kw), cam_lr=cam_lr))
    got = port.compute_disparity(i0, i1, port.DISConfig(**kw),
                                 cam_lr=cam_lr, device="cpu").numpy()
    assert got.shape == (64, 96)
    assert_flow_band(np.stack([got, np.zeros_like(got)], -1),
                     np.stack([ref, np.zeros_like(ref)], -1))
    assert (got <= 0).all() if cam_lr == 0 else (got >= 0).all()
    np.testing.assert_allclose(np.median(got[8:-8, 8:-8]), sx, atol=0.1)


def test_compute_disparity_default_config(rng):
    """Without a config: operating point 2 at the image width, no
    variational refinement, as JAX."""
    i0, i1 = synthetic_frames(9, 2, 48, 64, (-1, 0), factor=4)
    ref = np.asarray(jax_disparity(i0, i1))
    got = port.compute_disparity(i0, i1, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


# ------------------------------------------------ I/O

@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3)])
def test_pfm_matches_jax(tmp_path, rng, shape):
    data = rng.standard_normal(shape).astype(np.float32)
    a, b = tmp_path / "a.pfm", tmp_path / "b.pfm"
    port.write_pfm(a, data)
    jpfm.write_pfm(b, data)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(port.read_pfm(b), jpfm.read_pfm(a))
    np.testing.assert_array_equal(port.read_pfm(a), data)
    with pytest.raises(ValueError):
        port.write_pfm(a, np.zeros((2, 2, 2), np.float32))


def test_flow_to_color_matches_jax(rng):
    flow = rng.standard_normal((9, 11, 2)).astype(np.float32) * 3
    flow[0, 0] = (2e9, 0.0)                         # unknown: black
    flow[1, 1] = (np.nan, 0.0)
    for mm in (None, 2.5):
        got = port.flow_to_color(flow, mm)
        np.testing.assert_array_equal(got, jcolor.flow_to_color(flow, mm))
    assert (got[0, 0] == 0).all()


@pytest.mark.parametrize("suffix,channels", [(".ppm", 3), (".pgm", 1),
                                             (".png", 3)])
def test_images_match_jax(tmp_path, rng, suffix, channels):
    """The port writes PPM/PGM byte for byte as Pillow does, and loads
    each format to JAX's exact float32 BGR array."""
    img = (rng.random((13, 17, channels)) * 300 - 20).astype(np.float32)
    a, b = tmp_path / f"a{suffix}", tmp_path / f"b{suffix}"
    pimages.save_image(a, img)
    jimages.save_image(b, img if channels == 3 else img[..., 0])
    if suffix != ".png":
        assert a.read_bytes() == b.read_bytes()
    ref = jimages.load_image(b)
    got = pimages.load_image(b)
    assert got.dtype == np.float32 and got.shape == (13, 17, 3)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(pimages.load_image(a), ref)


def test_images_without_pillow(tmp_path, rng, monkeypatch):
    """PPM needs no Pillow; PNG without it raises naming the format."""
    img = (rng.random((6, 8, 3)) * 255).astype(np.uint8)
    pimages.save_image(tmp_path / "a.png", img)
    monkeypatch.setitem(sys.modules, "PIL", None)
    pimages.save_image(tmp_path / "a.ppm", img)
    np.testing.assert_array_equal(pimages.load_image(tmp_path / "a.ppm"),
                                  img.astype(np.float32))
    with pytest.raises(RuntimeError, match="'png'.*Pillow"):
        pimages.load_image(tmp_path / "a.png")
    with pytest.raises(RuntimeError, match="'jpg'.*Pillow"):
        pimages.save_image(tmp_path / "a.jpg", img)


def test_pnm_header_with_comment(tmp_path):
    """A comment line in the header and a maxval other than 255 (left to
    Pillow) read as Pillow reads them."""
    px = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    path = tmp_path / "c.ppm"
    path.write_bytes(b"P6\n# made by hand\n3 2\n255\n" + px.tobytes())
    np.testing.assert_array_equal(pimages.load_image(path),
                                  jimages.load_image(path))
    path.write_bytes(b"P5 3 2 100\n" + px[..., 0].tobytes())
    np.testing.assert_array_equal(pimages.load_image(path),
                                  jimages.load_image(path))
