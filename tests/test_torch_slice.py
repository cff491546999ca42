"""The PyTorch port's whole op-2 slice against the JAX package.

``compute_flow`` (pad, pyramid, per-scale extract / solve / densify /
refine, upsample, crop) and ``stream_flow`` (pyramid reuse, warm start)
run on CPU tensors through the kernels' plain versions and are held
against the JAX package's jitted pipeline on the same numpy frames.

Tolerance: mean endpoint difference <= 1e-3 px and 99th percentile
<= 1e-2 px.  Per-op differences are ulp-level, but an ulp can flip a
patch's outlier reset, which moves a few pixels far more than the rest,
so the bound is a band over the field rather than a per-pixel one.
"""

import numpy as np
import pytest
import torch

import flowonthego_tpu as fot
from flowonthego_tpu.config import DISConfig as JaxConfig
from flowonthego_tpu.parallel.frame_parallel import \
    stream_flow as jax_stream_flow

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch.utils.synth import synthetic_frames

torch.set_num_threads(1)


def assert_flow_band(got, ref, mean_tol=1e-3, p99_tol=1e-2):
    got = np.asarray(got)
    assert got.shape == ref.shape and np.isfinite(got).all()
    epe = np.sqrt(((got.astype(np.float64) - ref) ** 2).sum(-1))
    assert epe.mean() <= mean_tol and np.quantile(epe, 0.99) <= p99_tol, \
        f"mean {epe.mean():.3g} p99 {np.quantile(epe, 0.99):.3g}"


@pytest.mark.parametrize("h,w,cfg_kw", [
    (64, 96, dict(coarsest_scale=2, finest_scale=0)),
    (124, 256, None),                         # op 2 auto scales, padded
])
def test_compute_flow_matches_jax(h, w, cfg_kw):
    i0, i1 = synthetic_frames(3, 2, h, w, (2, 1), factor=4)
    jcfg = None if cfg_kw is None else JaxConfig(**cfg_kw)
    pcfg = None if cfg_kw is None else port.DISConfig(**cfg_kw)
    ref = np.asarray(fot.compute_flow(i0, i1, jcfg))
    got = port.compute_flow(i0, i1, pcfg, device="cpu").numpy()
    assert_flow_band(got, ref)
    inner = got[8:-8, 8:-8].reshape(-1, 2)
    np.testing.assert_allclose(np.median(inner, axis=0), [2.0, 1.0],
                               atol=0.1)


def test_stream_flow_matches_jax():
    frames = synthetic_frames(4, 3, 128, 256, (2, -1), factor=4)
    cfg = port.operating_point(2, width=256)
    jcfg = fot.operating_point(2, width=256)
    ref = list(jax_stream_flow(iter(frames), jcfg))
    got = list(port.stream_flow(iter(frames), cfg, device="cpu"))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert_flow_band(g, r)
    # the second pair ran from the first pair's warm start
    for g in got:
        np.testing.assert_allclose(
            np.median(g[8:-8, 8:-8].reshape(-1, 2), axis=0), [2.0, -1.0],
            atol=0.1)


def test_warm_start_level_offset_and_disflow(rng):
    """``init_flow`` and ``level_offset`` of dis_flow_padded, and the
    object API, against JAX."""
    import jax
    from flowonthego_tpu.models.dis_flow import dis_flow_padded
    i0, i1 = synthetic_frames(5, 2, 64, 96, (1, 2), factor=4)
    jcfg = JaxConfig(coarsest_scale=2, finest_scale=1)
    pcfg = port.DISConfig(coarsest_scale=2, finest_scale=1)
    init = rng.standard_normal((8, 12, 2)).astype(np.float32) * 0.5
    ref = np.asarray(jax.jit(dis_flow_padded,
                             static_argnames=("cfg", "level_offset"))(
        i0, i1, jcfg, init_flow=init, level_offset=2))
    got = port.dis_flow_padded(torch.as_tensor(i0)[None],
                               torch.as_tensor(i1)[None], pcfg,
                               init_flow=torch.as_tensor(init)[None],
                               level_offset=2)
    assert_flow_band(got[0].numpy(), ref)
    assert_flow_band(port.DISFlow(pcfg, device="cpu").calc(i0, i1),
                     fot.DISFlow(jcfg).calc(i0, i1))
