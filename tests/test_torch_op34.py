"""Operating points 1, 3 and 4 of the PyTorch port against the JAX package.

The slice adds K4 (the var-ref loop over the whole card) and K5 (the
var-ref warp), the resolver that sends each field to K3, K4 or the plain
stencils, and ``compute_flow_timed``.  On the CPU the port runs each
kernel's plain version; the JAX side runs its Pallas kernels in interpret
mode, as the JAX package's own tests do.  Tolerances are stated per test.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

import flowonthego_tpu as fot
from flowonthego_tpu.config import DISConfig as JaxConfig
from flowonthego_tpu.ops.patches import PatchGrid as JaxPatchGrid
from flowonthego_tpu.ops.pallas.varref_fused import \
    variational_refine_tiled as jax_varref_tiled
from flowonthego_tpu.ops.pallas.warp import warp_image_banded
from flowonthego_tpu.ops.variational import warp_image as jax_warp_image
from flowonthego_tpu.parallel.frame_parallel import \
    stream_flow as jax_stream_flow
from flowonthego_tpu.utils.timing import PhaseTimer as JaxPhaseTimer

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch.convert import config_from_jax
from flowonthego_tpu_torch.ops import variational as pvar
from flowonthego_tpu_torch.ops.cuda import varref_tiled, warp
from flowonthego_tpu_torch.ops.cuda.varref_fused import (
    CTA_SHARED_BYTES, FUSED_MAX_PIXELS_PER_CTA, fused_plan)
from flowonthego_tpu_torch.utils import timing
from flowonthego_tpu_torch.utils.synth import synthetic_frames
from test_torch_slice import assert_flow_band

torch.set_num_threads(1)


# ---------------------------------------------------------------- K5 warp

@pytest.mark.parametrize("h,w,bound", [(60, 96, 6.0), (37, 64, 4.0)])
def test_warp_matches_banded_and_gather(rng, h, w, bound):
    """The port's warp (its plain version on CPU tensors) against JAX's
    banded Pallas warp and its gather warp, as
    tests/test_variational.py::test_warp_banded_matches_gather holds the
    two JAX forms together.  Mask: equal.  Warped image: within atol 1e-3
    of the banded form, which sums rows then columns (1-2 ulp of 0..255);
    exact against the gather, which sums the four corners in the same
    order.  Integer flows: exact against both (single-tap selects)."""
    src = (rng.random((h, w, 3)) * 255).astype(np.float32)
    wx = ((rng.random((h, w)) * 2 - 1) * bound).astype(np.float32)
    wy = ((rng.random((h, w)) * 2 - 1) * bound).astype(np.float32)
    got_w, got_m = (x[0] for x in warp.warp_image(
        *(torch.as_tensor(x)[None] for x in (src, wx, wy))))
    band_w, band_m = warp_image_banded(jnp.asarray(src), jnp.asarray(wx),
                                       jnp.asarray(wy), bound, tile_rows=32,
                                       interpret=True)
    gat_w, gat_m = jax_warp_image(jnp.asarray(src), jnp.asarray(wx),
                                  jnp.asarray(wy), force_onehot=False)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(band_m))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(gat_m))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(band_w), rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(gat_w))

    wxi, wyi = np.round(wx), np.round(wy)
    got_i = warp.warp_image(
        *(torch.as_tensor(x)[None] for x in (src, wxi, wyi)))[0][0]
    band_i, _ = warp_image_banded(jnp.asarray(src), jnp.asarray(wxi),
                                  jnp.asarray(wyi), bound, tile_rows=32,
                                  interpret=True)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(band_i))


@pytest.mark.parametrize("h,w,channels,strided", [
    (40, 64, 3, False), (37, 61, 3, True), (23, 50, 1, True),
    (18, 30, 3, False)])
def test_warp_nonuniform_flow_matches_jax(h, w, channels, strided):
    """The port's warp on the flow the pipeline gives it, the split pair's
    field (two motions, a seam, samples that leave the image at the right
    and lower border) plus a smooth sub-pixel part: widths that are and
    are not multiples of 4, a dense source and a strided crop of a larger
    frame.  Mask: equal to both JAX forms.  Warped image: exact against
    JAX's gather warp (the same four corners in the same order), within
    atol 1e-3 of its banded Pallas warp in interpret mode (rows, then
    columns: 1-2 ulp of 0..255)."""
    from flowonthego_tpu_torch.utils.synth import (smooth_texture,
                                                   synthetic_split_pair)
    left, right = (2, 2), (7, 4)
    _, i1, field, _ = synthetic_split_pair(11, h, w, left, right, channels,
                                           factor=4)
    flow = (field + (smooth_texture(12, h, w, 2, factor=4) - 128.0)
            / 100.0).astype(np.float32)
    wx, wy = np.ascontiguousarray(flow[..., 0]), np.ascontiguousarray(
        flow[..., 1])
    bound = float(np.abs(flow).max()) + 1.0
    src = torch.as_tensor(i1)
    if strided:
        big = torch.zeros((h + 6, w + 10, channels))
        big[3:3 + h, 5:5 + w] = src
        src = big[3:3 + h, 5:5 + w]
        assert not src.is_contiguous()
    got_w, got_m = (x[0] for x in warp.warp_image(
        src[None], torch.as_tensor(wx)[None], torch.as_tensor(wy)[None]))
    gat_w, gat_m = jax_warp_image(jnp.asarray(i1), jnp.asarray(wx),
                                  jnp.asarray(wy), force_onehot=False)
    band_w, band_m = warp_image_banded(jnp.asarray(i1), jnp.asarray(wx),
                                       jnp.asarray(wy), bound, tile_rows=16,
                                       interpret=True)
    assert 0 < float(got_m.mean()) < 1          # some samples leave the image
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(gat_m))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(band_m))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(gat_w))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(band_w), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("reach", [30.0, 1e4])
def test_warp_flows_far_outside_match_jax(rng, reach):
    """Flows that leave the image by far (every tap clamped): mask and
    image exact against JAX's gather warp."""
    h, w = 19, 27
    src = (rng.random((h, w, 3)) * 255).astype(np.float32)
    wx = ((rng.random((h, w)) * 2 - 1) * reach).astype(np.float32)
    wy = ((rng.random((h, w)) * 2 - 1) * reach).astype(np.float32)
    got_w, got_m = (x[0] for x in warp.warp_image(
        *(torch.as_tensor(x)[None] for x in (src, wx, wy))))
    gat_w, gat_m = jax_warp_image(jnp.asarray(src), jnp.asarray(wx),
                                  jnp.asarray(wy), force_onehot=False)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(gat_m))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(gat_w))
    assert float(got_m.mean()) < 0.5


# ---------------------------------------------------------------- K4 var-ref

@pytest.mark.parametrize("level,channels", [(0, 3), (1, 3), (0, 1), (1, 1)])
def test_varref_tiled_matches_pallas_oracle(rng, level, channels):
    """rtol 1e-4 / atol 1e-5, as tests/test_pallas_kernels.py holds JAX's
    tiled form against its stencils: the TPU kernel uses rsqrt and sums
    channels in another order.  Small tiles make JAX's grid real (row and
    column tiles, image edges inside and outside tiles)."""
    h, w = 61, 83
    base = gaussian_filter(
        rng.standard_normal((h + 8, w + 8, channels)).astype(np.float32),
        sigma=(3, 3, 0)) * 120 + 128
    im1, im2 = base[4:4 + h, 4:4 + w], base[4:4 + h, 3:3 + w]
    flow = (0.3 * rng.standard_normal((h, w, 2)).astype(np.float32)
            + np.array([1.0, 0.0], np.float32))
    jc = JaxConfig()
    ref = np.asarray(jax_varref_tiled(
        jnp.asarray(flow), jnp.asarray(im1), jnp.asarray(im2), jc, level,
        interpret=True, tile_rows=24, tile_cols=32))
    got = varref_tiled.variational_refine_tiled(
        *(torch.as_tensor(x)[None] for x in (flow, im1, im2)),
        config_from_jax(dataclasses.asdict(jc)), level)
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- resolver

def test_varref_resolver():
    cfg = port.operating_point(3)
    n = pvar.FUSED_MAX_PIXELS
    small, large = (2, n // 2), (2, n // 2 + 1)
    huge = (2, pvar.CLUSTER_MAX_PIXELS)
    for shape in (small, large, huge):
        assert pvar.varref_backend_for(cfg, *shape, "cpu") == "xla"
        plain = dataclasses.replace(cfg, varref_backend="xla")
        assert pvar.varref_backend_for(plain, *shape, "cuda") == "xla"
    for channels in (1, 3):
        assert pvar.varref_backend_for(cfg, *small, "cuda",
                                       channels) == "fused"
        assert pvar.varref_backend_for(cfg, *large, "cuda",
                                       channels) == "cluster"
        assert pvar.varref_backend_for(cfg, *huge, "cuda",
                                       channels) == "tiled"
    forced = dataclasses.replace(cfg, varref_backend="pallas")
    assert pvar.varref_backend_for(forced, *large, "cuda") == "cluster"
    assert pvar.varref_backend_for(forced, *huge, "cuda") == "tiled"
    with pytest.raises(ValueError, match="CUDA kernel"):
        pvar.varref_backend_for(forced, *small, "cpu")
    # at 1024x448 the coarsest field (scale 5) goes to K3, as does the 4K
    # stream's (17x30), scale 4 to K4's cluster route, the finer ones to
    # its grid route
    assert 14 * 32 < 17 * 30 <= n < 28 * 64 <= pvar.CLUSTER_MAX_PIXELS \
        < 56 * 128
    # K3 never gets a field it cannot take
    assert n <= FUSED_MAX_PIXELS_PER_CTA


# The fields of the main paths (1024x448 scales 5-0, the 4K stream's
# scales 7-5) at C = 3 and C = 1, and the fields on either side of both
# thresholds.
@pytest.mark.parametrize("h,w,channels,want", [
    (14, 32, 3, "fused"), (17, 30, 3, "fused"),
    (14, 32, 1, "fused"), (17, 30, 1, "fused"),
    (28, 64, 3, "cluster"), (34, 60, 3, "cluster"), (28, 64, 1, "cluster"),
    (56, 128, 3, "tiled"), (68, 120, 3, "tiled"), (112, 256, 3, "tiled"),
    (224, 512, 3, "tiled"), (448, 1024, 3, "tiled"), (448, 1024, 1, "tiled"),
    (2, pvar.FUSED_MAX_PIXELS // 2, 3, "fused"),
    (2, pvar.FUSED_MAX_PIXELS // 2 + 1, 3, "cluster"),
    (1, pvar.FUSED_MAX_PIXELS, 1, "fused"),
    (64, pvar.CLUSTER_MAX_PIXELS // 64, 3, "cluster"),
    (64, pvar.CLUSTER_MAX_PIXELS // 64 + 1, 3, "tiled"),
    # within K3's pixel threshold, but so many channels that its planes do
    # not fit a CTA's shared memory: the next route takes the field
    (2, pvar.FUSED_MAX_PIXELS // 2, 10, "cluster"),
    # few, very long rows: within the pixel threshold, but two rows a CTA
    # do not fit its shared memory
    (2, pvar.CLUSTER_MAX_PIXELS // 2, 3, "tiled"),
])
def test_varref_resolver_routes(h, w, channels, want):
    cfg = port.operating_point(2)
    assert pvar.varref_backend_for(cfg, h, w, "cuda", channels) == want
    assert pvar.varref_backend_for(cfg, h, w, "cpu", channels) == "xla"


def test_variational_refine_auto_passes_channels(monkeypatch):
    """The resolver is asked with the images' channel count."""
    seen = []

    def fake(cfg, h, w, device_type, channels=3):
        seen.append((h, w, device_type, channels))
        return "xla"

    monkeypatch.setattr(pvar, "varref_backend_for", fake)
    cfg = port.operating_point(2)
    for channels in (1, 3):
        flow = torch.zeros((2, 12, 16, 2))
        im = torch.rand((2, 12, 16, channels)) * 255
        out = pvar.variational_refine_auto(flow, im, im, cfg, 1)
        assert out.shape == flow.shape
    assert seen == [(12, 16, "cpu", 1), (12, 16, "cpu", 3)]


@pytest.mark.parametrize("h,w,channels,threads,fits", [
    (14, 32, 3, 448, True), (14, 32, 1, 448, True), (17, 30, 3, 512, True),
    (17, 30, 1, 512, True), (3, 5, 3, 32, True), (1, 1, 1, 32, True),
    (31, 33, 3, 1024, True), (32, 32, 3, 1024, True),
    (32, 32, 1, 1024, True),
    # a thread a pixel: more than 1,024 pixels never fit
    (25, 41, 3, 1056, False), (25, 41, 1, 1056, False),
    (28, 64, 3, 1792, False), (56, 128, 1, 7168, False),
    # the 227 KB edge, which C = 1 and C = 3 never reach within 1,024
    # pixels (29 planes * 4 B * 1,024 px = 116 KB): seven channels do
    (1, 952, 7, 960, True), (1, 953, 7, 960, False),
    (32, 32, 6, 1024, True), (32, 32, 7, 1024, False)])
def test_fused_plan(h, w, channels, threads, fits):
    """K3's plan: a thread a pixel in whole warps, 5 + 8 C planes of 4-byte
    pixels in shared memory, fitting if there are at most 1,024 pixels and
    at most 227 KB."""
    plan = fused_plan(h, w, channels)
    assert plan.threads == threads and plan.threads % 32 == 0
    assert plan.threads >= h * w
    assert plan.shared_bytes == (5 + 8 * channels) * h * w * 4
    assert plan.fits == fits
    assert plan.fits == (h * w <= FUSED_MAX_PIXELS_PER_CTA
                         and plan.shared_bytes <= CTA_SHARED_BYTES)
    assert CTA_SHARED_BYTES == 227 * 1024


def test_cluster_plan():
    """The cluster route's split: up to 8 CTAs, at least two rows and 64
    pixels a CTA, every row held, a thread a pixel in whole warps (128 to
    1024), 36 bytes of shared memory a pixel with three halo rows."""
    from flowonthego_tpu_torch.ops.cuda.varref_tiled import (
        CTA_SHARED_BYTES, cluster_plan)
    assert cluster_plan(14, 32)[:4] == (4, 4, 128, 9 * 7 * 32 * 4)
    assert cluster_plan(28, 64)[:4] == (8, 4, 256, 9 * 7 * 64 * 4)
    assert cluster_plan(34, 60)[:4] == (8, 5, 320, 9 * 8 * 60 * 4)
    assert cluster_plan(56, 128)[:4] == (8, 7, 896, 9 * 10 * 128 * 4)
    assert cluster_plan(112, 256)[:4] == (8, 14, 1024, 9 * 17 * 256 * 4)
    assert cluster_plan(5, 2000)[:2] == (4, 2)      # not 8 CTAs of 1 row
    assert cluster_plan(3, 100)[:2] == (2, 2)
    assert cluster_plan(2, 100)[:2] == (1, 2)
    for h, w in ((28, 64), (68, 120), (112, 256), (7, 900), (224, 512)):
        plan = cluster_plan(h, w)
        assert plan.n_ctas in (1, 2, 4, 8) and plan.n_ctas * plan.rows_per >= h
        assert plan.n_ctas == 1 or plan.rows_per >= 2
        assert plan.threads % 32 == 0 and 128 <= plan.threads <= 1024
        assert plan.fits == (plan.shared_bytes <= CTA_SHARED_BYTES)
    assert not cluster_plan(224, 512).fits


# ---------------------------------------------------------------- the slice

@pytest.mark.parametrize("op_point,h,w", [(1, 96, 192), (3, 96, 192),
                                          (4, 64, 128)])
def test_compute_flow_op_matches_jax(op_point, h, w):
    """The band of tests/test_torch_slice.py (mean EPE <= 1e-3 px, p99 <=
    1e-2 px), and the median within 0.1 px of the known shift."""
    i0, i1 = synthetic_frames(11, 2, h, w, (2, 1), factor=4)
    ref = np.asarray(fot.compute_flow(i0, i1, op_point=op_point))
    got = port.compute_flow(i0, i1, op_point=op_point,
                            device="cpu").numpy()
    assert_flow_band(got, ref)
    np.testing.assert_allclose(
        np.median(got[8:-8, 8:-8].reshape(-1, 2), axis=0), [2.0, 1.0],
        atol=0.1)


def test_stream_flow_op3_matches_jax():
    frames = synthetic_frames(12, 3, 96, 192, (2, -1), factor=4)
    cfg = port.operating_point(3, width=192)
    ref = list(jax_stream_flow(iter(frames), fot.operating_point(3, width=192)))
    got = list(port.stream_flow(iter(frames), cfg, device="cpu"))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert_flow_band(g, r)
        np.testing.assert_allclose(
            np.median(g[8:-8, 8:-8].reshape(-1, 2), axis=0), [2.0, -1.0],
            atol=0.1)


_SC = re.compile(r"^TIME \(Sc: (\d+), #p:\s*(\d+), pconst, pinit, poptim, "
                 r"cflow, tvopt, total\):(\s+[-\d.]+){5} -> \s*[\d.]+ ms\.$")


def test_compute_flow_timed_lines_and_flow():
    """One ``TIME (Sc:`` line per scale in JAX's format, with the scale and
    the patch count of JAX's grid; the pyramid, run-time and phase-report
    lines; and compute_flow's flow (the same calls in the same order:
    equal).  (JAX's own compute_flow_timed runs op by op, which costs
    ~30 s on the CPU for these few lines, so its grid stands in.)"""
    i0, i1 = synthetic_frames(13, 2, 48, 64, (2, 0), factor=4)
    kw = dict(coarsest_scale=2, finest_scale=1, grad_descent_iter=4)
    lines = []
    got = port.compute_flow_timed(i0, i1, cfg=port.DISConfig(**kw),
                                  device="cpu", printer=lines.append)
    np.testing.assert_array_equal(
        got.numpy(),
        port.compute_flow(i0, i1, port.DISConfig(**kw), device="cpu").numpy())

    jc = JaxConfig(**kw)
    want = [(sl, JaxPatchGrid.create(jc, 64 >> sl, 48 >> sl).n_patches)
            for sl in (2, 1)]
    text = "\n".join(lines)
    assert [tuple(map(int, m.groups()[:2]))
            for m in map(_SC.match, text.splitlines()) if m] == want
    for key in ("TIME (Pyramide+Gradients) (ms):",
                "TIME (O.Flow Run-Time   ) (ms):", "Timings (ms)", "[opti",
                "[aggregate", "[var_ref"):
        assert key in text
    # forward-backward consistency runs both grids inside the same phases:
    # the same lines per scale, and compute_flow's fb flow
    fb = port.DISConfig(**kw, use_fb_consistency=True)
    fb_lines = []
    got = port.compute_flow_timed(i0, i1, cfg=fb, device="cpu",
                                  printer=fb_lines.append)
    np.testing.assert_array_equal(
        got.numpy(), port.compute_flow(i0, i1, fb, device="cpu").numpy())
    assert [tuple(map(int, m.groups()[:2])) for m in
            map(_SC.match, "\n".join(fb_lines).splitlines()) if m] == want


def test_profile_categories():
    """profile_paths files each device kernel under its own row (K3's
    kernel, ``varref_kernel``, must not catch K4's)."""
    from flowonthego_tpu_torch.profile_paths import category
    names = {"void (anonymous namespace)::dis_gn_kernel<float, 8, 3>(GnArgs)":
                 "K2 gn",
             "void (anonymous namespace)::varref_tiled_kernel<3>(float const*)":
                 "K4 grid",
             "void (anonymous namespace)::varref_cluster_kernel<1>(float*)":
                 "K4 cluster",
             "void (anonymous namespace)::varref_kernel<3>(float const*)": "K3",
             "(anonymous namespace)::warp_kernel(float const*)": "K5 warp",
             "void (anonymous namespace)::pool2x2_kernel<float>()": "K1 pool",
             "Memcpy HtoD (Pageable -> Device)": "copies",
             "void at::native::indexing_backward_kernel<float>()":
                 "index_put sort+sum",
             "void cub::DeviceRadixSortOnesweepKernel<int>()":
                 "index_put sort+sum",
             "void at::native::elementwise_kernel<128, 2>()":
                 "small torch kernels"}
    assert {n: category(n) for n in names} == names


def test_timing_helpers():
    """PhaseTimer counts and reports as JAX's does; warmup and time_fn run
    on the CPU, where the sync is a no-op."""
    timers = JaxPhaseTimer(), timing.PhaseTimer(torch.device("cpu"))
    for t in timers:
        for name in ("pyramid", "opti", "opti"):
            with t.phase(name):
                pass
        assert dict(t.counts) == {"pyramid": 1, "opti": 2}
        t.totals.update(pyramid=1.5, opti=12.25)
    assert timers[1].report() == timers[0].report()
    timing.warmup("cpu")
    calls = []
    assert timing.time_fn(calls.append, 1, iters=3, warmup_iters=1) >= 0.0
    assert calls == [1] * 4
