"""Each module of the PyTorch port that holds or feeds a kernel, against
the JAX package on the same numpy inputs.

The JAX side runs as the JAX package's own tests run it on the CPU: the
Pallas kernels in interpret mode (``pool2x2_flat``,
``variational_refine_fused``, ``optimize`` with ``gn_backend="pallas"``).
The port runs on CPU tensors, i.e. through each kernel's plain PyTorch
version.  Tolerances are stated per test, with their reason.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from flowonthego_tpu.config import DISConfig as JaxConfig
from flowonthego_tpu.ops import densify as jdensify
from flowonthego_tpu.ops import dis as jdis
from flowonthego_tpu.ops import patches as jpatches
from flowonthego_tpu.ops import pyramid as jpyramid
from flowonthego_tpu.ops import resize as jresize
from flowonthego_tpu.ops.pallas.pool import _BW, pool2x2_flat as jax_pool
from flowonthego_tpu.ops.pallas.varref_fused import \
    variational_refine_fused as jax_varref_fused

from flowonthego_tpu_torch.convert import (config_from_jax,
                                           patch_state_from_numpy,
                                           pyramid_from_numpy)
from flowonthego_tpu_torch.ops import densify as pdensify
from flowonthego_tpu_torch.ops import dis as pdis
from flowonthego_tpu_torch.ops import patches as ppatches
from flowonthego_tpu_torch.ops import pyramid as ppyramid
from flowonthego_tpu_torch.ops import resize as presize
from flowonthego_tpu_torch.ops.cuda.pool import pool2x2_flat as port_pool
from flowonthego_tpu_torch.ops.cuda.varref_fused import \
    variational_refine_fused as port_varref_fused
from flowonthego_tpu_torch.utils.synth import plant_stripes

torch.set_num_threads(1)


def _smooth(rng, h, w, c, sigma=4.0, margin=8):
    """Smoothed seeded noise around 128, as tests/test_dis_gn_pallas.py."""
    return gaussian_filter(
        rng.standard_normal((h + 2 * margin, w + 2 * margin, c))
        .astype(np.float32), sigma=(sigma, sigma, 0)) * 120 + 128


def _scene(rng, h, w, shift=(2, 1), c=3):
    base = _smooth(rng, h, w, c)
    sx, sy = shift
    return base[8:8 + h, 8:8 + w], base[8 - sy:8 - sy + h, 8 - sx:8 - sx + w]


def _t(x):
    return torch.as_tensor(np.array(x))


# ---------------------------------------------------------------- K1 pool

_RAGGED_W = 2 * ((_BW + _BW // 2) // 6)     # one full + one ragged TPU block


@pytest.mark.parametrize("case,h,w,C,dtype,bias", [
    ("f32", 64, 96, 3, np.float32, None),
    ("gray", 128, 128, 1, np.float32, None),
    ("uint8", 40, 322, 3, np.uint8, None),
    ("uint8_bias", 40, 322, 3, np.uint8, 1.5),
    ("ragged_bias", 40, _RAGGED_W, 3, np.float32, 3.25),
])
def test_pool_matches_pallas_oracle(rng, case, h, w, C, dtype, bias):
    """rtol 1e-6 / atol 1e-4, as tests/test_pallas_kernels.py: the TPU
    kernel's bf16x3 split sums in another order (1-2 ulp of 0..255)."""
    x = (rng.random((h, w * C)) * 255).astype(dtype)
    ref = np.asarray(jax_pool(jnp.asarray(x), C,
                              bias=None if bias is None else jnp.float32(bias),
                              interpret=True))
    got = port_pool(torch.as_tensor(x), C, bias=bias).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)


# ---------------------------------------------------------------- pyramid

@pytest.mark.parametrize("dtype,start,bias", [
    (np.float32, 0, None), (np.uint8, 1, None), (np.float32, 1, 0.125)])
def test_build_pyramid_matches_jax(rng, dtype, start, bias):
    """<= 1e-5 abs: both pool the same taps in reduce_window's order."""
    img = (rng.random((32, 48, 3)) * 255).astype(dtype)
    ref = jpyramid.build_pyramid(jnp.asarray(img), 4, 4, start_level=start,
                                 ingest_bias=None if bias is None
                                 else jnp.float32(bias))
    got = ppyramid.build_pyramid(torch.as_tensor(img)[None], 4, 4,
                                 start_level=start, ingest_bias=bias)
    for lr, lg in zip(ref, got):
        for a, b in zip(lr, lg):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(b[0].numpy(), np.asarray(a,
                                           np.float32), rtol=0, atol=1e-5)
    f32 = img.astype(np.float32)
    np.testing.assert_allclose(
        ppyramid.downsample_half(torch.as_tensor(f32)).numpy(),
        np.asarray(jpyramid.downsample_half(jnp.asarray(f32))),
        rtol=0, atol=1e-5)


# ---------------------------------------------------------------- patches

# (operating point, channels, frames, mean normalisation): the grouped
# window form (op 2, op 4) and the strided one (op 1)
EXTRACT_CASES = {"2": (2, 3, 1, True), "1": (1, 3, 1, True),
                 "4": (4, 3, 1, True), "2-gray-2frames": (2, 1, 2, True),
                 "2-nomean-2frames": (2, 3, 2, False),
                 "4-gray-2frames": (4, 1, 2, True),
                 "4-nomean-2frames": (4, 3, 2, False),
                 "4-gray-nomean": (4, 1, 1, False),
                 "1-gray-nomean-2frames": (1, 1, 2, False)}


@pytest.mark.parametrize("op_point,C,n,mean", list(EXTRACT_CASES.values()),
                         ids=list(EXTRACT_CASES))
def test_extract_matches_jax(rng, op_point, C, n, mean):
    """Extraction of ``n`` frames at once, frame by frame against JAX
    (the plain form of the G2 kernel).  Windows and gradients are copies
    (exact).  Templates subtract a mean of ps*ps*C fp32 values near 128,
    summed in another order: one ulp of op 2's ~2.5e4 sum is 2e-3, 1e-5
    of the mean, so <= 1e-4 abs; op 4's 432 values (a sum near 5.5e4,
    ulp 3.9e-3) are summed sequentially here and pairwise by XLA, whose
    roundings drift apart: the largest template error read on this data
    is 2.37e-4 (op 4, C = 3), 0.10 absolute on the sum or ~26 ulps of it,
    so <= 4e-4 (0.17 on the sum, ~44 ulps).  Hessians are such sums too:
    within 1e-5 of the largest entry (h01 is a signed sum that cancels,
    so a relative bound per entry is too strict).  A flat block gives
    patches with det == 0 and H00 == 0, a block of vertical stripes
    patches with det == 0 and H00 > 0: both bumped alike."""
    from flowonthego_tpu.config import operating_point
    jc = dataclasses.replace(operating_point(op_point),
                             use_mean_normalization=mean)
    pc = config_from_jax(dataclasses.asdict(jc))
    h, w = 40, 56
    imgs = [_smooth(rng, h, w, C)[8:8 + h, 8:8 + w] for _ in range(n)]
    for img in imgs:
        img[:h // 2, :w // 3] = 128.0
        plant_stripes(img)
    jpyrs = [jpyramid.build_pyramid(jnp.asarray(img), 1, jc.padding)[0]
             for img in imgs]
    ppyr = pyramid_from_numpy([tuple(
        np.stack([np.asarray(jp[k]) for jp in jpyrs]) for k in range(3))])[0]
    jg = jpatches.PatchGrid.create(jc, w, h)
    pg = ppatches.PatchGrid.create(pc, w, h)
    assert dataclasses.asdict(jg) == dataclasses.asdict(pg)
    assert (pc.patch_size % pc.steps == 0) == (op_point != 1)
    got = ppatches.extract_templates_and_hessians(*ppyr, pg, pc)
    windows = ppatches.extract_windows(ppyr.image, pg)
    for b, jpyr in enumerate(jpyrs):
        ref = jpatches.extract_templates_and_hessians(*jpyr, jg, jc)
        np.testing.assert_array_equal(
            windows[b].numpy(),
            np.asarray(jpatches.extract_windows(jpyr.image, jg)))
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(ref[1]))
        np.testing.assert_array_equal(got[2][b].numpy(), np.asarray(ref[2]))
        np.testing.assert_allclose(got[0][b].numpy(), np.asarray(ref[0]),
                                   rtol=0,
                                   atol=4e-4 if pc.patch_size == 12 else 1e-4)
        H = np.asarray(ref[3])
        np.testing.assert_allclose(got[3][b].numpy(), H, rtol=0,
                                   atol=1e-5 * np.abs(H).max())
        flat = H[..., 0] == np.float32(1e-10)
        assert flat.any()
        np.testing.assert_array_equal(got[3][b].numpy()[flat][:, :2],
                                      H[flat][:, :2])
        striped = (H[..., 1] == 0) & (H[..., 2] == np.float32(1e-10)) & (
            H[..., 0] > 1e-10)
        assert striped.any()
        np.testing.assert_array_equal(got[3][b].numpy()[striped][:, 1:],
                                      H[striped][:, 1:])


# ---------------------------------------------------------------- K2 GN solve

def _jax_state(cfg, i0, coarse):
    h, w = i0.shape[:2]
    grid = jpatches.PatchGrid.create(cfg, w, h)
    lvl = jpyramid.build_pyramid(jnp.asarray(i0), 1, cfg.padding)[0]
    tmpl, gx, gy, H = jpatches.extract_templates_and_hessians(*lvl, grid, cfg)
    state = jdis.init_state(tmpl, gx, gy, H, grid)
    if coarse is not None:
        state = jdis.init_from_coarser(state, jnp.asarray(coarse), grid)
    return grid, state


@pytest.mark.parametrize("warm,gd_iter", [
    (False, 1), (False, 2), (False, 12), (True, 12)])
def test_gn_solve_matches_pallas_oracle(rng, warm, gd_iter):
    """p atol 1e-4, cost_px rtol/atol 1e-3, as tests/test_dis_gn_pallas.py:
    the reductions sum the same values in another order.  The warm start
    exercises frozen-at-init patches and the outlier reset."""
    jc = JaxConfig(coarsest_scale=1, finest_scale=1, grad_descent_iter=gd_iter,
                   gn_backend="pallas")
    i0, i1 = _scene(rng, 48, 64, shift=(3, -2) if warm else (2, 1))
    coarse = (rng.standard_normal((24, 32, 2)).astype(np.float32) * 2.0
              if warm else None)
    grid, jstate = _jax_state(jc, i0, coarse)
    I1p = jpyramid.pad_replicate(jnp.asarray(i1), jc.padding)
    ref = jdis.optimize(jstate, I1p, grid, jc)

    pc = config_from_jax(dataclasses.asdict(jc))
    pstate = patch_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()})
    pgrid = ppatches.PatchGrid.create(pc, 64, 48)
    got = pdis.optimize(pstate, _t(I1p)[None], pgrid,
                        dataclasses.replace(pc, gn_backend="auto"))
    np.testing.assert_allclose(got.p_cur[0].numpy(), np.asarray(ref.p_cur),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.cost_px[0].numpy(),
                               np.asarray(ref.cost_px), rtol=1e-3, atol=1e-3)
    if warm:
        frozen = np.asarray(jstate.converged)
        assert frozen.any()
        assert not got.cost_px[0].numpy()[frozen].any()

    # densify of the same state: <= 1e-5 abs (weights are 1/max(2, cost),
    # the flow a weighted mean of patch flows; reorder-only differences).
    # gn_backend "pallas" selects the card's kernels for densify too (G3),
    # so the CPU run takes "auto", as for the solve above.
    jd = np.asarray(jdensify.densify(ref, grid, jc))
    pd = pdensify.densify(patch_state_from_numpy(
        {k: np.asarray(v) for k, v in ref._asdict().items()}), pgrid,
        dataclasses.replace(pc, gn_backend="auto"))
    np.testing.assert_allclose(pd[0].numpy(), jd, rtol=0, atol=1e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("ps,C", [(6, 1), (6, 3), (10, 1), (10, 3)])
def test_gn_solve_patch_sizes_match_jax(rng, ps, C, backend):
    """The plain solve at the patch sizes that take the CUDA kernel's
    generic form (even sizes other than 8 and 12), one and three channels,
    warm-started, against JAX's XLA loop and its Pallas kernel in
    interpret mode: p rtol/atol 1e-4, cost_px rtol/atol 1e-3 (the sums run
    over the same values in another order).  The scene is smoothed less
    than the other K2 tests' (sigma 1.5, not 4): a 36-value one-channel
    patch of the smoother scene has a Hessian close to singular, which
    turns an ulp of the sums into ~1e-3 px."""
    jc = JaxConfig(coarsest_scale=1, finest_scale=1, patch_size=ps,
                   grad_descent_iter=8, gn_backend=backend)
    base = _smooth(rng, 48, 64, C, sigma=1.5)
    i0, i1 = base[8:56, 8:72], base[9:57, 6:70]        # moved by (2, -1)
    coarse = rng.standard_normal((24, 32, 2)).astype(np.float32) * 1.5
    grid, jstate = _jax_state(jc, i0, coarse)
    I1p = jpyramid.pad_replicate(jnp.asarray(i1), jc.padding)
    ref = jdis.optimize(jstate, I1p, grid, jc)

    pc = config_from_jax(dataclasses.asdict(jc))
    pstate = patch_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()})
    pgrid = ppatches.PatchGrid.create(pc, 64, 48)
    assert pstate.templates.shape[-3:] == (ps, ps, C)
    got = pdis.optimize(pstate, _t(I1p)[None], pgrid,
                        dataclasses.replace(pc, gn_backend="auto"))
    np.testing.assert_allclose(got.p_cur[0].numpy(), np.asarray(ref.p_cur),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.cost_px[0].numpy(),
                               np.asarray(ref.cost_px), rtol=1e-3, atol=1e-3)
    # some patches moved, some were frozen at the warm start
    assert (np.abs(got.p_cur[0].numpy() - np.asarray(jstate.p_cur)).max()
            > 1e-2)


def test_gn_plain_counts_iterations(rng):
    """``count_iters`` changes nothing and counts what ran: 0 for a patch
    frozen at the warm start, at most ``n_iters``, fewer for a patch the
    outlier test stopped."""
    from flowonthego_tpu_torch.ops.cuda.dis_gn import gn_scale_loop_plain
    jc = JaxConfig(coarsest_scale=1, finest_scale=1, grad_descent_iter=12)
    i0, i1 = _scene(rng, 48, 64, shift=(3, -2))
    coarse = rng.standard_normal((24, 32, 2)).astype(np.float32) * 2.0
    grid, jstate = _jax_state(jc, i0, coarse)
    st = patch_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()})
    I1p = _t(jpyramid.pad_replicate(jnp.asarray(i1), jc.padding))[None]
    args = (I1p, st.templates, st.tgrad_x, st.tgrad_y, st.H, st.mid_org,
            st.p_cur, st.p_org, ~st.converged)
    kw = dict(n_iters=12, padding=grid.padding, thresh=jc.outlier_thresh,
              l_bound=grid.l_bound, ub_w=grid.u_bound_w, ub_h=grid.u_bound_h,
              mean_on=1.0)
    p, cost = gn_scale_loop_plain(*args, **kw)
    p2, cost2, iters, loads = gn_scale_loop_plain(*args, **kw,
                                                  count_iters=True)
    assert torch.equal(p, p2) and torch.equal(cost, cost2)
    assert iters.shape == loads.shape == st.converged.shape
    assert not iters[st.converged].any() and (iters[~st.converged] >= 1).all()
    assert int(iters.max()) == 12 and 0 < int(iters.sum()) < 12 * iters.numel()
    # a started patch loads its window at its first trip, and at most at
    # every trip and the final cost pass; a frozen one never
    started = ~st.converged
    assert not loads[st.converged].any()
    assert (loads[started] >= 1).all()
    assert (loads[started] <= iters[started] + 1).all()
    # one iteration fewer allowed: every patch that ran all 12 now runs 11
    iters11 = gn_scale_loop_plain(*args, **dict(kw, n_iters=11),
                                  count_iters=True)[2]
    assert torch.equal(iters11, iters.clamp(max=11))


def test_init_from_coarser_matches_jax(rng):
    """The warm-start lookup, exact.  A 1/2^(cs+1) warm start of a 4K
    frame padded to 2176 rows has 8 rows where the 17-row coarsest grid
    reads row 8: both packages clamp to the last row."""
    jc = JaxConfig(coarsest_scale=7, finest_scale=5)
    pc = config_from_jax(dataclasses.asdict(jc))
    h, w = 17, 30
    i0 = _smooth(rng, h, w, 3)[8:8 + h, 8:8 + w]
    grid, jstate = _jax_state(jc, i0, None)
    coarse = rng.standard_normal((8, 15, 2)).astype(np.float32) * 3.0
    ref = jdis.init_from_coarser(jstate, jnp.asarray(coarse), grid)
    assert int(grid.midpoints()[1].max()) // 2 == 8
    pstate = patch_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()})
    got = pdis.init_from_coarser(pstate, _t(coarse)[None],
                                 ppatches.PatchGrid.create(pc, w, h))
    for name in ("p_cur", "p_org", "converged"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(ref, name)))


# ---------------------------------------------------------------- K3 var-ref

@pytest.mark.parametrize("level,C", [(0, 3), (3, 3), (0, 1), (3, 1)])
def test_varref_matches_pallas_oracle(rng, level, C):
    """rtol 1e-4 / atol 1e-5, as tests/test_pallas_kernels.py: the TPU
    kernel uses rsqrt and sums channels in another order."""
    h, w = 32, 48
    base = _smooth(rng, h, w, C, sigma=3.0, margin=4)
    im1, im2 = base[4:4 + h, 4:4 + w], base[4:4 + h, 3:3 + w]
    flow = (0.3 * rng.standard_normal((h, w, 2)).astype(np.float32)
            + np.array([1.0, 0.0], np.float32))
    jc = JaxConfig()
    ref = np.asarray(jax_varref_fused(jnp.asarray(flow), jnp.asarray(im1),
                                      jnp.asarray(im2), jc, level,
                                      interpret=True))
    got = port_varref_fused(_t(flow)[None], _t(im1)[None], _t(im2)[None],
                            config_from_jax(dataclasses.asdict(jc)), level)
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- resize

@pytest.mark.parametrize("src,dst", [
    ((56, 128), (7, 16)), ((68, 120), (8, 15)), ((14, 32), (2, 4))])
def test_warm_start_resize_matches_jax(rng, src, dst):
    """The stream warm start: jax.image.resize 'linear' antialiases on
    downsampling; <= 1e-6 abs on flow-sized values."""
    import jax
    flow = (rng.standard_normal(src + (2,)) * 2).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(flow), dst + (2,),
                                      method="linear"))
    got = presize.resize_linear_antialias(_t(flow), *dst).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_resize_matmul_matches_jax(rng):
    """The final flow upsample (x8 here): <= 1e-5 abs (two fp32 matmuls)."""
    flow = (rng.standard_normal((14, 32, 2)) * 2).astype(np.float32)
    ref = np.asarray(jresize.resize_matmul(jnp.asarray(flow), 112, 256))
    got = presize.resize_matmul(_t(flow), 112, 256).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def _gn_ramp_case(n_iters=12):
    """A hand-built scale whose steps are exact: a flat target image, the
    template 0.25 above it, gx = 1/64 and gy = 0 on 8x8x1 patches, H the
    identity and no mean normalisation, so every trip moves p by exactly
    +0.25 px in x and not in y.  Patch 0 starts at x = 10.1 and its window
    origin moves at trips 5 and 9 and at the final pass (x = 13.1); patch
    1 starts at x = 20.1, steps past the box's right edge (21) at its 4th
    trip and resets to p_org (x = 18.1), where the final pass loads anew;
    patch 2 is frozen."""
    ps, pad = 8, 4
    I1 = torch.zeros((1, 24, 40, 1))
    tmpl = torch.full((1, 1, 3, ps, ps, 1), 0.25)
    gx = torch.full_like(tmpl, 1 / 64)
    gy = torch.zeros_like(tmpl)
    H = torch.tensor([1.0, 0.0, 1.0]).expand(1, 1, 3, 3).contiguous()
    mid = torch.tensor([[[[10.0, 9.0], [20.0, 9.0], [30.0, 9.0]]]])
    p_cur = torch.full((1, 1, 3, 2), 0.1)
    p_cur[..., 1] = 0.0
    p_org = torch.tensor([[[[0.0, 0.0], [-1.9, 0.0], [0.0, 0.0]]]])
    started = torch.tensor([[[True, True, False]]])
    args = (I1, tmpl, gx, gy, H, mid, p_cur, p_org, started)
    kw = dict(n_iters=n_iters, padding=pad, thresh=100.0, l_bound=-100.0,
              ub_w=21.0, ub_h=100.0, mean_on=0.0)
    return args, kw


def test_gn_plain_counts_window_loads():
    """``count_iters``'s window loads on steps whose every pixel crossing
    is known: 4 for patch 0 (its first trip, x 11.1 and 12.1, the final
    pass at 13.1), 2 for patch 1 (its first trip, the final pass at
    p_org), 0 for the frozen patch; the CPU path of ``gn_scale_loop`` adds
    the same counts, the final pass as a trip, to ``counts``."""
    from flowonthego_tpu_torch.ops.cuda.dis_gn import (gn_scale_loop,
                                                       gn_scale_loop_plain)
    args, kw = _gn_ramp_case()
    p, cost, iters, loads = gn_scale_loop_plain(*args, **kw,
                                                count_iters=True)
    torch.testing.assert_close(p[0, 0, :, 0], torch.tensor([3.1, -1.9, 0.1]))
    assert (p[0, 0, :, 1] == 0).all()
    assert iters.tolist() == [[[12, 4, 0]]]
    assert loads.tolist() == [[[4, 2, 0]]]
    counts = torch.ones((1, 1, 3, 2), dtype=torch.int32)
    p2, cost2 = gn_scale_loop(*args, **kw, counts=counts)
    assert torch.equal(p2, p) and torch.equal(cost2, cost)
    assert counts.tolist() == [[[[14, 5], [6, 3], [1, 1]]]]
    # one trip fewer: patch 0's final pass (x = 12.85) stays in the window
    # of its last trip (x = 12.6) and loads nothing
    loads11 = gn_scale_loop_plain(*args, **dict(kw, n_iters=11),
                                  count_iters=True)[3]
    assert loads11.tolist() == [[[3, 2, 0]]]
