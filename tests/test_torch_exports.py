"""The port's remaining exports against the JAX package, and the synthetic
pair with a non-uniform known flow.

``angular_error`` and ``unknown_flow_mask`` are numpy functions and are
held bit for bit against the JAX package's on seeded flows with NaN and
unknown-flow sentinels.  ``flow_full_padded`` (padded frames in,
full-resolution flow out) is held against JAX's within the band of
tests/test_torch_slice.py (mean endpoint difference <= 1e-3 px, 99th
percentile <= 1e-2 px: an ulp can flip a patch's outlier reset), and bit
for bit against the port's ``compute_flow`` on frames that need no
padding.  ``synthetic_split_pair`` moves the two halves of a frame
differently; its field is checked by warping and the whole slice runs on
it against JAX.
"""

import numpy as np
import pytest
import torch

import flowonthego_tpu as fot
import flowonthego_tpu.io as jio
import flowonthego_tpu.utils as jutils
from flowonthego_tpu.config import DISConfig as JaxConfig
from flowonthego_tpu.models.dis_flow import \
    flow_full_padded as jax_flow_full_padded

import flowonthego_tpu_torch as port
import flowonthego_tpu_torch.io as pio
import flowonthego_tpu_torch.utils as putils
from flowonthego_tpu_torch.io.flo import UNKNOWN_FLOW_THRESH
from flowonthego_tpu_torch.ops.variational import warp_image
from flowonthego_tpu_torch.utils.synth import (synthetic_frames,
                                               synthetic_split_pair)
from test_torch_slice import assert_flow_band

torch.set_num_threads(1)


def _flows(seed, h=23, w=31):
    """A flow and a ground truth with every kind of unknown pixel: NaN in
    u, in v, in both, values at, just over and far over the threshold, of
    either sign."""
    rng = np.random.default_rng(seed)
    flow = (rng.standard_normal((h, w, 2)) * 3).astype(np.float32)
    gt = (flow + rng.standard_normal((h, w, 2)) * 0.5).astype(np.float32)
    gt[1, 2, 0] = np.nan
    gt[2, 3, 1] = np.nan
    gt[3, 4] = np.nan
    gt[4, 5, 0] = UNKNOWN_FLOW_THRESH          # at the threshold: known
    gt[5, 6, 1] = np.float32(UNKNOWN_FLOW_THRESH) * np.float32(1.001)
    gt[6, 7] = 1.666666752e9                   # the .flo sentinel
    gt[7, 8, 0] = -2e9
    gt[8, 9] = 0.0                             # zero flow: angle of (0, 0, 1)
    flow[9, 10] = 0.0
    return flow, gt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_angular_error_matches_jax(seed):
    flow, gt = _flows(seed)
    ref = jutils.angular_error(flow, gt)
    got = putils.angular_error(flow, gt)
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)        # NaN == NaN here
    assert np.isnan(got[3, 4]) and np.isfinite(got[8, 9])
    # tensors go through the same function
    np.testing.assert_array_equal(
        putils.angular_error(torch.as_tensor(flow), torch.as_tensor(gt)), ref)
    # identical flows: zero angle up to arccos's rounding near 1
    assert np.nanmax(putils.angular_error(flow, flow)) < 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_unknown_flow_mask_matches_jax(seed):
    _, gt = _flows(seed)
    ref = jio.unknown_flow_mask(gt)
    got = pio.unknown_flow_mask(gt)
    assert got.dtype == np.bool_ and got.shape == gt.shape[:2]
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == 6 and not got[4, 5] and got[5, 6] and got[7, 8]
    np.testing.assert_array_equal(
        pio.unknown_flow_mask(torch.as_tensor(gt)), ref)
    # the mask is where the endpoint error is undefined
    epe = putils.endpoint_error(np.zeros_like(gt), gt)
    np.testing.assert_array_equal(np.isnan(epe), got)


def test_exports_present():
    """Every name the JAX package exports from ``io`` and ``utils.metrics``
    is exported by the port, and the top-level package has the new ones."""
    assert set(jio.__all__) <= set(pio.__all__)
    for name in ("average_epe", "endpoint_error", "angular_error"):
        assert name in putils.__all__ and callable(getattr(putils, name))
    for name in ("angular_error", "unknown_flow_mask", "flow_full_padded"):
        assert name in port.__all__ and callable(getattr(port, name))


@pytest.mark.parametrize("h,w,cfg_kw", [
    (64, 96, dict(coarsest_scale=2, finest_scale=0)),
    (64, 128, dict(coarsest_scale=3, finest_scale=1)),   # upsampled x2
])
def test_flow_full_padded_matches_jax(h, w, cfg_kw):
    i0, i1 = synthetic_frames(6, 2, h, w, (2, 1), factor=4)
    ref = np.asarray(jax_flow_full_padded(i0, i1, JaxConfig(**cfg_kw)))
    got = port.flow_full_padded(torch.as_tensor(i0), torch.as_tensor(i1),
                                port.DISConfig(**cfg_kw))
    assert got.shape == (h, w, 2)
    assert_flow_band(got.numpy(), ref)


def test_flow_full_padded_is_compute_flow_without_padding():
    """On frames already divisible by 2^coarsest ``compute_flow`` pads
    nothing and crops nothing: the two are one computation, bit for bit;
    a batch gives each pair's flow."""
    cfg = port.DISConfig(coarsest_scale=3, finest_scale=1)
    pairs = [synthetic_frames(7 + b, 2, 64, 128, (1 + b, -1), factor=4)
             for b in range(2)]
    full = [port.flow_full_padded(torch.as_tensor(p[0]),
                                  torch.as_tensor(p[1]), cfg) for p in pairs]
    for p, f in zip(pairs, full):
        assert torch.equal(f, port.compute_flow(*p, cfg, device="cpu"))
    I0, I1 = (torch.as_tensor(np.stack([p[k] for p in pairs]))
              for k in (0, 1))
    batch = port.flow_full_padded(I0, I1, cfg)
    assert batch.shape == (2, 64, 128, 2)
    assert torch.equal(batch, port.batched_flow(I0, I1, cfg, device="cpu"))
    for b in range(2):
        np.testing.assert_allclose(batch[b].numpy(), full[b].numpy(),
                                   rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        port.flow_full_padded(I0[0, :60], I1[0, :60], cfg)


@pytest.mark.parametrize("seed,h,w,left,right", [
    (0, 40, 64, (2, 2), (16, 8)), (1, 33, 50, (-3, 1), (5, -4)),
    (2, 24, 36, (4, 0), (-4, 0))])
def test_split_pair_field_is_exact(seed, h, w, left, right):
    """Warping I1 back by the known field reproduces I0 bit for bit where
    the field is marked known (whole-pixel motions: one tap has weight 1);
    both halves are there, the unknown band lies at the seam or at the
    border, and the same seed gives the same frames."""
    i0, i1, flow, known = synthetic_split_pair(seed, h, w, left, right,
                                               factor=4)
    assert i0.shape == i1.shape == (h, w, 3) and flow.shape == (h, w, 2)
    assert i1.flags.c_contiguous and known.dtype == np.bool_
    warped, mask = warp_image(torch.as_tensor(i1)[None],
                              torch.as_tensor(flow[..., 0])[None],
                              torch.as_tensor(flow[..., 1])[None])
    np.testing.assert_array_equal(warped[0].numpy()[known], i0[known])
    assert (mask[0].numpy()[known] == 1).all()
    assert {tuple(v) for v in flow[known].astype(int)} == {left, right}
    jj, ii = np.nonzero(~known)
    reach = max(abs(v) for s in (left, right) for v in s)
    at_seam = np.abs(ii - w // 2) <= reach
    at_border = ((ii < reach) | (ii >= w - reach) | (jj < reach)
                 | (jj >= h - reach))
    assert (at_seam | at_border).all()
    again = synthetic_split_pair(seed, h, w, left, right, factor=4)
    for a, b in zip((i0, i1, flow, known), again):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("op_point,h,w", [(2, 124, 256), (4, 64, 128)])
def test_split_pair_flow_matches_jax(op_point, h, w):
    """The whole slice on a non-uniform motion, against JAX within the
    band, and each half's median flow against its motion (0.25 px: the
    frame is small, and at op 2 the flow is computed at 1/8 resolution
    beside a seam)."""
    left, right = (1, 1), (4, 2)
    i0, i1, flow, known = synthetic_split_pair(8, h, w, left, right, factor=4)
    ref = np.asarray(fot.compute_flow(i0, i1, op_point=op_point))
    got = port.compute_flow(i0, i1, op_point=op_point, device="cpu").numpy()
    assert_flow_band(got, ref)
    seam = w // 2
    for cols, motion in ((slice(8, seam - 16), left),
                         (slice(seam + 12, w - 8), right)):
        med = np.median(got[8:-8, cols].reshape(-1, 2), axis=0)
        np.testing.assert_allclose(med, motion, atol=0.25)
