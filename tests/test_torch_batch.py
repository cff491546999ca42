"""The port's batched execution against the JAX package: ``batched_flow``,
``MultiStream``, ``stream_video_chunks``, each batched module against its
single-frame self, and K2's bf16 operand mode.

Tiny sizes: 48x64 frames, coarsest_scale 3, finest_scale 1, 4
Gauss-Newton iterations, variational refinement on, B = 3 (4 streams for
the multi-stream cases, on the conftest's virtual devices for JAX).
Inputs come from numpy seeds.  The port runs on CPU tensors, i.e.
through each kernel's plain version.  Each case states its tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowonthego_tpu.config import DISConfig as JaxConfig
from flowonthego_tpu.ops import dis as jdis
from flowonthego_tpu.ops import patches as jpatches
from flowonthego_tpu.ops import pyramid as jpyramid
from flowonthego_tpu.parallel import make_mesh
from flowonthego_tpu.parallel import frame_parallel as jfp
from flowonthego_tpu.parallel import multistream as jms

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch.convert import (config_from_jax,
                                           patch_state_from_numpy,
                                           pyramid_from_numpy)
from flowonthego_tpu_torch.ops import densify as pdensify
from flowonthego_tpu_torch.ops import dis as pdis
from flowonthego_tpu_torch.ops import patches as ppatches
from flowonthego_tpu_torch.ops import pyramid as ppyramid
from flowonthego_tpu_torch.ops import variational as pvar
from flowonthego_tpu_torch.ops.cuda import dis_gn, varref_fused, warp
from flowonthego_tpu_torch.ops.resize import resize_matmul
from flowonthego_tpu_torch.utils.synth import synthetic_frames
from test_torch_kernels import _jax_state, _scene, _t
from test_torch_slice import assert_flow_band

H, W, B = 48, 64, 3
JCFG = JaxConfig(coarsest_scale=3, finest_scale=1, grad_descent_iter=4,
                 use_var_ref=True)
# one motion per frame, each a multiple of 2^finest_scale
SHIFTS = ((2, 1), (-2, 2), (4, -2))
MODES = {"l2": {}, "fb": dict(use_fb_consistency=True),
         "l1 min_iter": dict(cost_fn="l1", min_iter=2)}


def _pcfg(jc):
    return config_from_jax(dataclasses.asdict(jc))


def _pairs():
    """[B, H, W, 3] I0 and I1, frame b moving SHIFTS[b]."""
    pairs = [synthetic_frames(11 + b, 2, H, W, s, factor=4)
             for b, s in enumerate(SHIFTS)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))


def _video(seed, n, shift):
    return np.stack(synthetic_frames(seed, n, H, W, shift, factor=4))


# ---------------------------------------------------------------- entry points

@pytest.mark.parametrize("mode", sorted(MODES))
def test_batched_flow_matches_jax(mode):
    """The full-resolution flows of B pairs: the EPE band of the
    single-pair slice (mean <= 1e-3, p99 <= 1e-2 px; an ulp can flip one
    patch's outlier reset), frame by frame."""
    jc = dataclasses.replace(JCFG, **MODES[mode])
    I0, I1 = _pairs()
    ref = np.asarray(jfp.batched_flow(jnp.asarray(I0), jnp.asarray(I1), jc))
    got = port.batched_flow(I0, I1, _pcfg(jc), device="cpu")
    assert got.shape == (B, H, W, 2)
    for b in range(B):
        assert_flow_band(got[b].numpy(), ref[b])


@pytest.mark.parametrize("full_res", [True, False])
def test_batched_frame_matches_single_pair(full_res):
    """Frame b of the batch against the port's own single-pair path on
    that pair: <= 1e-5 px.  Every op is per frame; only the reductions
    and the upsample's matmuls see other shapes, which may associate
    differently (ulps of values < 100)."""
    cfg = _pcfg(JCFG)
    I0, I1 = _pairs()
    got = port.batched_flow(I0, I1, cfg, full_res=full_res, device="cpu")
    for b in range(B):
        single = port.dis_flow_padded(torch.as_tensor(I0[b])[None],
                                      torch.as_tensor(I1[b])[None], cfg)[0]
        if full_res:
            single = port.compute_flow(I0[b], I1[b], cfg, device="cpu")
        np.testing.assert_allclose(got[b].numpy(), single.numpy(), rtol=0,
                                   atol=1e-5)
        # and it found its own frame's motion, not a neighbour's
        med = np.median(got[b, 8:-8, 8:-8].numpy().reshape(-1, 2), axis=0)
        scale = 1 if full_res else 2 ** cfg.finest_scale
        np.testing.assert_allclose(med * scale, SHIFTS[b], atol=0.1)


def test_batched_flow_rejects_mismatched_batches():
    I0, I1 = _pairs()
    with pytest.raises(ValueError):
        port.batched_flow(I0, I1[:2], _pcfg(JCFG), device="cpu")
    with pytest.raises(ValueError):
        port.batched_flow(I0[0], I1[0], _pcfg(JCFG), device="cpu")


def test_multistream_matches_jax():
    """4 streams x 3 frames against JAX's MultiStream on a 4-device mesh
    (one stream per virtual device): the EPE band, stream by stream, each
    tick on the previous tick's warm start."""
    videos = np.stack([_video(21 + k, 3, s) for k, s in
                       enumerate(SHIFTS + ((0, 2),))])        # [4, T, ...]
    mesh = make_mesh(n_data=4, devices=jax.devices()[:4])
    jm = jms.MultiStream(mesh, JCFG, H, W)
    pm = port.MultiStream(_pcfg(JCFG), H, W, n_streams=4, device="cpu")
    jm.start(videos[:, 0])
    pm.start(torch.as_tensor(videos[:, 0]))
    for t in range(1, videos.shape[1]):
        ref = np.asarray(jm.push(videos[:, t]))
        got = pm.push(videos[:, t].reshape(4, H, W * 3))      # packed form
        assert got.shape == (4, H, W, 2)
        for k in range(4):
            assert_flow_band(got[k].numpy(), ref[k])


def test_multistream_matches_stream_flow():
    """Each stream against the port's own ``stream_flow`` on that
    stream's frames (finest-scale flows, <= 1e-5 px: the same ops on
    other shapes)."""
    cfg = _pcfg(JCFG)
    videos = [_video(31 + k, 4, s) for k, s in enumerate(SHIFTS)]
    ms = port.MultiStream(cfg, H, W, full_res=False, n_streams=B,
                          device="cpu")
    ms.start(np.stack([v[0] for v in videos]))
    got = [ms.push(np.stack([v[t] for v in videos])) for t in range(1, 4)]
    for k, v in enumerate(videos):
        want = list(port.stream_flow(v, cfg, full_res=False,
                                     device="cpu"))
        for t, w in enumerate(want):
            np.testing.assert_allclose(got[t][k].numpy(), w, rtol=0,
                                       atol=1e-5)


def test_multistream_input_validation():
    """The errors of JAX's MultiStream (tests/test_multistream.py)."""
    cfg = _pcfg(JCFG)
    ms = port.MultiStream(cfg, H, W, n_streams=4, device="cpu")
    with pytest.raises(RuntimeError):
        ms.push(np.zeros((4, H, W, 3), np.float32))
    with pytest.raises(ValueError):
        ms.start(np.zeros((3, H, W, 3), np.float32))    # wrong batch size
    with pytest.raises(ValueError):
        ms.start(np.zeros((4, H, W + 2, 3), np.float32))
    with pytest.raises(ValueError):
        ms.start(np.zeros((4, H, W * 3 + 1), np.float32))   # bad packed
    with pytest.raises(ValueError):
        port.MultiStream(cfg, H + 1, W, n_streams=4, device="cpu")
    with pytest.raises(ValueError):
        port.stream_video_chunks(np.zeros((4, H, W, 3), np.float32), cfg,
                                 4, "cpu")                 # too few frames


def test_stream_video_chunks_matches_jax():
    """A 9-frame video as 4 chunks (2 pairs each): JAX's chunking, its
    one-frame overlap and its re-fed tail; the EPE band per pair, and
    each chunk equal to the port's stream_flow over that chunk."""
    video = _video(41, 9, (2, 1))
    mesh = make_mesh(n_data=4, devices=jax.devices()[:4])
    ref = jms.stream_video_chunks(video, mesh, JCFG)
    cfg = _pcfg(JCFG)
    got = port.stream_video_chunks(video, cfg, 4, "cpu")
    assert got.shape == ref.shape == (8, H, W, 2)
    for p in range(8):
        assert_flow_band(got[p], ref[p])
    starts = [k * 8 // 4 for k in range(5)]
    for k in range(4):
        lo, hi = starts[k], starts[k + 1]
        want = list(port.stream_flow(video[lo:hi + 1], cfg, device="cpu"))
        np.testing.assert_allclose(got[lo:hi], np.stack(want), rtol=0,
                                   atol=1e-5)


def test_vmapped_jax_pyramid_into_port():
    """A JAX ``vmap``ped pyramid (leading batch axis) through
    ``pyramid_from_numpy`` into the port's batched
    ``dis_flow_from_pyramids``, against JAX's on the same pyramids: the
    finest flows within the EPE band."""
    I0, I1 = _pairs()
    jc = JCFG
    build = jax.vmap(lambda x: jpyramid.build_pyramid(
        x, jc.coarsest_scale + 1, jc.padding, start_level=jc.finest_scale))
    jp0, jp1 = build(jnp.asarray(I0)), build(jnp.asarray(I1))
    from flowonthego_tpu.models.dis_flow import dis_flow_from_pyramids
    ref = np.asarray(jax.jit(jax.vmap(lambda a, b: dis_flow_from_pyramids(
        a, b, jc)))(jp0, jp1))

    def conv(pyr):
        return pyramid_from_numpy([tuple(None if x is None else np.asarray(x)
                                         for x in lvl) for lvl in pyr])
    p0, p1 = conv(jp0), conv(jp1)
    assert p0[jc.coarsest_scale].image.shape[0] == B
    got = port.models.dis_flow.dis_flow_from_pyramids(p0, p1, _pcfg(jc))
    for b in range(B):
        assert_flow_band(got[b].numpy(), ref[b])


# ---------------------------------------------------------------- modules

def test_pyramid_and_windows_per_frame(rng):
    """A batched pyramid, its template windows and Hessians equal each
    frame's own, exactly (the pool stacks frames as rows; the rest is
    copies and per-patch sums of the same values)."""
    imgs = (rng.random((B, 32, 48, 3)) * 255).astype(np.float32)
    cfg = port.operating_point(2)
    pyr = ppyramid.build_pyramid(torch.as_tensor(imgs), 4, cfg.padding,
                                 start_level=1)
    for b in range(B):
        one = ppyramid.build_pyramid(torch.as_tensor(imgs[b])[None], 4,
                                     cfg.padding, start_level=1)
        for lb, l1 in zip(pyr, one):
            for x, y in zip(lb, l1):
                assert (x is None) == (y is None)
                if x is not None:
                    assert torch.equal(x[b], y[0])
    lvl = pyr[1]
    grid = ppatches.PatchGrid.create(cfg, 24, 16)
    got = ppatches.extract_templates_and_hessians(*lvl, grid, cfg)
    for b in range(B):
        one = ppatches.extract_templates_and_hessians(
            *(x[b:b + 1] for x in lvl), grid, cfg)
        for x, y in zip(got, one):
            assert torch.equal(x[b], y[0])
    with pytest.raises(ValueError):
        ppyramid.build_pyramid(torch.zeros((2, 10, 16, 3)), 3, 4)  # 10/2 odd


def _batched_state(jc, frames, coarse=None):
    """The port's state of several JAX states, stacked on the batch axis."""
    states = [_jax_state(jc, f, None if coarse is None else coarse[b])[1]
              for b, f in enumerate(frames)]
    return patch_state_from_numpy(
        {k: np.stack([np.asarray(getattr(s, k)) for s in states])
         for k in jdis.PatchState._fields}), states


def test_optimize_batched_matches_per_frame(rng):
    """The batched K2 solve (plain version) and the warm start, frame by
    frame, against B = 1 solves: exact (every op is per patch), and the
    warm-start lookup clamps within each frame's own coarse field."""
    jc = JaxConfig(coarsest_scale=1, finest_scale=1)
    scenes = [_scene(rng, 48, 64, shift=s) for s in SHIFTS]
    coarse = rng.standard_normal((B, 24, 32, 2)).astype(np.float32) * 2.0
    state, _ = _batched_state(jc, [s[0] for s in scenes])
    pc, grid = _pcfg(jc), ppatches.PatchGrid.create(_pcfg(jc), 64, 48)
    state = pdis.init_from_coarser(state, torch.as_tensor(coarse), grid)
    I1 = torch.stack([ppyramid.pad_replicate(torch.as_tensor(s[1]), 8)
                      for s in scenes])
    got = pdis.optimize(state, I1, grid, pc)
    for b in range(B):
        one = pdis.init_from_coarser(
            pdis.init_state(*(t[b:b + 1] for t in (state.templates,
                                                   state.tgrad_x,
                                                   state.tgrad_y, state.H)),
                            grid),
            torch.as_tensor(coarse[b])[None], grid)
        assert torch.equal(one.converged, state.converged[b:b + 1])
        ref = pdis.optimize(one, I1[b:b + 1], grid, pc)
        assert torch.equal(got.p_cur[b], ref.p_cur[0])
        assert torch.equal(got.cost_px[b], ref.cost_px[0])


@pytest.mark.parametrize("fb", [False, True])
def test_densify_batched_matches_per_frame(rng, fb):
    """Densify with and without the fb merge, batched against each frame
    alone: exact.  The overlap-add canvases and the clipped margin are
    per frame and the merge's one scatter offsets each frame's cells, so
    no contribution crosses into another frame and each cell adds the
    same terms in the same order."""
    jc = JaxConfig(coarsest_scale=1, finest_scale=1)
    frames = [_scene(rng, 48, 64, shift=s)[0] for s in SHIFTS]
    state, _ = _batched_state(jc, frames)
    p = torch.as_tensor(rng.standard_normal((B, 12, 16, 2)) * 3,
                        dtype=torch.float32)
    cost = torch.as_tensor(rng.random(state.cost_px.shape) * 10,
                           dtype=torch.float32)
    state = state._replace(p_cur=p, cost_px=cost)
    compl = state._replace(p_cur=-p.flip(0)) if fb else None
    pc, grid = _pcfg(jc), ppatches.PatchGrid.create(_pcfg(jc), 64, 48)
    got = pdensify.densify(state, grid, pc, compl_state=compl)
    for b in range(B):
        one = pdis.PatchState(*(x[b:b + 1] for x in state))
        oc = None if compl is None else pdis.PatchState(
            *(x[b:b + 1] for x in compl))
        assert torch.equal(got[b], pdensify.densify(one, grid, pc,
                                                    compl_state=oc)[0])


def test_fb_merge_serial_on_cpu(rng):
    """The fb merge on the CPU adds in JAX's order whatever torch's thread
    count (``index_put_(accumulate=True)`` adds in parallel there with
    several threads): the scatter equals a serial Python loop over the
    contributions bit for bit, and the fb flow of two runs is identical."""
    jc = JaxConfig(coarsest_scale=1, finest_scale=1)
    pc, grid = _pcfg(jc), ppatches.PatchGrid.create(_pcfg(jc), 64, 48)
    state, _ = _batched_state(jc, [_scene(rng, 48, 64)[0]])
    p = torch.as_tensor(rng.standard_normal((1, 12, 16, 2)) * 3,
                        dtype=torch.float32)
    state = state._replace(p_cur=p, cost_px=torch.as_tensor(
        rng.random(state.cost_px.shape) * 10, dtype=torch.float32))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        got = pdensify._fb_merge_scatter(state, grid, pc, 48, 64)
        vals, idx = [], []
        real_add = torch.Tensor.index_add_

        def spy(acc, dim, index, source):
            idx.append(index)
            vals.append(source)
            return real_add(acc, dim, index, source)

        torch.Tensor.index_add_ = spy
        try:
            pdensify._fb_merge_scatter(state, grid, pc, 48, 64)
        finally:
            torch.Tensor.index_add_ = real_add
        serial = torch.zeros((48 * 64 + 1, 3))
        for i, v in zip(idx[0].tolist(), vals[0]):
            serial[i] += v
        assert torch.equal(got.reshape(-1, 3), serial[:-1])
        frames = _pairs()
        cfg = _pcfg(dataclasses.replace(JCFG, use_fb_consistency=True))
        first = port.batched_flow(*frames, cfg, device="cpu")
        assert torch.equal(port.batched_flow(*frames, cfg, device="cpu"),
                           first)
    finally:
        torch.set_num_threads(threads)


def test_varref_batched_matches_per_frame(rng):
    """Warp (K5's plain version), derivatives and the var-ref loop on a
    batch against each field alone: exact (every stencil is per field;
    the border rules and the red-black parity are the frame's own)."""
    h, w = 14, 20
    im1 = torch.as_tensor(rng.random((B, h, w, 3)) * 255, dtype=torch.float32)
    im2 = torch.as_tensor(rng.random((B, h, w, 3)) * 255, dtype=torch.float32)
    flow = torch.as_tensor(rng.standard_normal((B, h, w, 2)) * 2,
                           dtype=torch.float32)
    cfg = port.operating_point(2)
    wim, mask = warp.warp_image(im2, flow[..., 0].contiguous(),
                                flow[..., 1].contiguous())
    got = pvar.variational_refine(flow, im1, im2, cfg, 2)
    fused = varref_fused.variational_refine_fused(flow, im1, im2, cfg, 2)
    assert torch.equal(got, fused)
    for b in range(B):
        sl = slice(b, b + 1)
        one_w, one_m = warp.warp_image(im2[sl], flow[sl, ..., 0].contiguous(),
                                       flow[sl, ..., 1].contiguous())
        assert torch.equal(wim[b], one_w[0]) and torch.equal(mask[b],
                                                             one_m[0])
        one = pvar.variational_refine(flow[sl], im1[sl], im2[sl], cfg, 2)
        assert torch.equal(got[b], one[0])
    assert pvar.varref_backend_for(cfg, h, w, "cuda") == "fused"


def test_resize_batched(rng):
    """The upsample's two matmuls on a batch against each frame alone:
    <= 1e-5 px (the batched product may associate differently)."""
    flow = torch.as_tensor(rng.standard_normal((B, 6, 8, 2)) * 2,
                           dtype=torch.float32)
    got = resize_matmul(flow, 48, 64)
    for b in range(B):
        np.testing.assert_allclose(got[b].numpy(),
                                   resize_matmul(flow[b], 48, 64).numpy(),
                                   rtol=0, atol=1e-5)


# ---------------------------------------------------------------- K2 bf16

def _bf16_solve(rng, warm):
    jc = JaxConfig(coarsest_scale=1, finest_scale=1, grad_descent_iter=12,
                   dtype="bfloat16")
    i0, i1 = _scene(rng, 48, 64, shift=(3, -2) if warm else (2, 1))
    coarse = (rng.standard_normal((24, 32, 2)).astype(np.float32) * 2.0
              if warm else None)
    grid, jstate = _jax_state(jc, i0, coarse)
    I1p = jpyramid.pad_replicate(jnp.asarray(i1), jc.padding)
    pstate = patch_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()})
    pgrid = ppatches.PatchGrid.create(_pcfg(jc), 64, 48)
    got = pdis.optimize(pstate, _t(I1p)[None],
                        pgrid, _pcfg(jc))
    return jc, grid, jstate, I1p, pstate, got


@pytest.mark.parametrize("warm", [False, True])
def test_bf16_matches_pallas_form(rng, warm):
    """``dtype="bfloat16"`` against JAX's Pallas kernel in interpret mode
    (``gn_backend="pallas"``), which takes the same bf16 operands, upcasts
    them and carries float32: p rtol 1e-4 atol 3e-4, cost_px rtol/atol
    1e-3.  Reorder-only differences, which 12 iterations amplify: on this
    warm state the float32 solve and the float32 Pallas form also end up
    to 2.0e-4 px apart (bf16: 2.2e-4)."""
    jc, grid, jstate, I1p, pstate, got = _bf16_solve(rng, warm)
    ref = jdis.optimize(jstate, I1p, grid,
                        dataclasses.replace(jc, gn_backend="pallas"))
    np.testing.assert_allclose(got.p_cur[0].numpy(), np.asarray(ref.p_cur),
                               rtol=1e-4, atol=3e-4)
    np.testing.assert_allclose(got.cost_px[0].numpy(),
                               np.asarray(ref.cost_px), rtol=1e-3, atol=1e-3)
    # bf16 did change the solve: the float32 one lands elsewhere
    f32 = pdis.optimize(pstate, _t(I1p)[None],
                        ppatches.PatchGrid.create(_pcfg(jc), 64, 48),
                        dataclasses.replace(_pcfg(jc), dtype="float32"))
    assert (f32.p_cur - got.p_cur).abs().max() > 1e-4


def test_bf16_quantization_vs_xla_form(rng):
    """Against JAX's default XLA bf16 path, which also blends in bf16:
    quantization-level agreement, the bound of JAX's own test
    (tests/test_dis_gn_pallas.py): q95 < 0.05 px, max < 0.5 px."""
    jc, grid, jstate, I1p, _, got = _bf16_solve(rng, False)
    ref = jdis.optimize(jstate, I1p, grid,
                        dataclasses.replace(jc, gn_backend="xla"))
    d = np.abs(got.p_cur[0].numpy() - np.asarray(ref.p_cur))
    assert float(np.quantile(d, 0.95)) < 0.05 and float(d.max()) < 0.5, \
        f"q95={np.quantile(d, 0.95):.3g} max={d.max():.3g}"


def test_bf16_plain_rounds_operands_once(rng):
    """The plain bf16 solve equals the float32 solve on operands rounded
    to bf16 with the projection's constant sums from the float32 state:
    exact, which is what the kernel computes on the card."""
    jc, grid, jstate, I1p, st, got = _bf16_solve(rng, True)
    rnd = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    I1 = _t(I1p)[None]
    kw = dict(n_iters=12, padding=grid.padding, thresh=jc.outlier_thresh,
              l_bound=grid.l_bound, ub_w=grid.u_bound_w,
              ub_h=grid.u_bound_h, mean_on=1.0)
    p, cost = dis_gn.gn_scale_loop(I1, st.templates, st.tgrad_x, st.tgrad_y,
                                   st.H, st.mid_org, st.p_cur, st.p_org,
                                   ~st.converged, bf16=True, **kw)
    assert torch.equal(p, got.p_cur) and torch.equal(cost, got.cost_px)
    sums = dis_gn.patch_sums(st.templates, st.tgrad_x, st.tgrad_y)
    rsums = dis_gn.patch_sums(*map(rnd, (st.templates, st.tgrad_x,
                                         st.tgrad_y)))
    assert (sums - rsums).abs().max() > 0     # the two forms differ here
    with pytest.raises(ValueError):
        pdis.optimize(st, I1, ppatches.PatchGrid.create(_pcfg(jc), 64, 48),
                      dataclasses.replace(_pcfg(jc), dtype="float16"))
