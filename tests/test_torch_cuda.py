"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips without one.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances are those of the CPU tests against the JAX package
(tests/test_torch_kernels.py), each with its reason there.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch.ops import dis as dis_mod
from flowonthego_tpu_torch.ops import densify as densify_mod
from flowonthego_tpu_torch.ops import patches as patches_mod
from flowonthego_tpu_torch.ops import pyramid as pyramid_mod
from flowonthego_tpu_torch.models import stereo as stereo_mod
from flowonthego_tpu_torch.ops.cuda import (densify, derivs, dis_gn, dis_ref,
                                            extract, fb_merge, level, pool,
                                            varref_fused, varref_tiled, warp)
from flowonthego_tpu_torch.ops.patches import (PatchGrid,
                                               extract_templates_and_hessians)
from flowonthego_tpu_torch.ops.pyramid import build_pyramid
from flowonthego_tpu_torch.utils import graphs, profiling
from flowonthego_tpu_torch.utils.synth import plant_stripes, synthetic_frames

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run this file on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,bias", [(torch.float32, None),
                                        (torch.uint8, 1.5)])
def test_pool_kernel(cuda, dtype, bias):
    g = torch.Generator().manual_seed(0)
    x = (torch.rand((68, 3 * 122), generator=g) * 255).to(dtype).to(cuda)
    n0 = pool.launches
    got = pool.pool2x2_flat(x, 3, bias)
    assert pool.launches == n0 + 1
    ref = pool.pool2x2_flat_plain(x, 3, bias)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-4)


def _level_state(device, h, w, warm, channels=3, n_frames=1, patch_size=8,
                 op=2):
    """A level's patch state of ``n_frames`` frames (frame b from seed
    1 + b) and the padded target levels [B, Hp, Wp, C], at operating
    point ``op`` (its patch size where it is not 2)."""
    pairs = [synthetic_frames(1 + b, 2, h, w, (1, 1), channels=channels,
                              factor=4) for b in range(n_frames)]
    cfg = port.operating_point(op)
    if op == 2:
        cfg = dataclasses.replace(cfg, patch_size=patch_size)
    lvl0, lvl1 = (build_pyramid(torch.as_tensor(np.stack([p[k] for p in pairs]),
                                                device=device), 1,
                                cfg.padding)[0]
                  for k in (0, 1))
    grid = PatchGrid.create(cfg, w, h)
    state = dis_mod.init_state(*extract_templates_and_hessians(
        lvl0.image, lvl0.grad_x, lvl0.grad_y, grid, cfg), grid)
    if warm:
        g = torch.Generator().manual_seed(1)
        coarse = torch.randn((n_frames, h // 2, w // 2, 2), generator=g) * 2.0
        state = dis_mod.init_from_coarser(state, coarse.to(device), grid)
    return cfg, grid, state, lvl1.image


@pytest.mark.parametrize("warm", [False, True])
def test_gn_kernel(cuda, warm):
    cfg, grid, state, I1p = _level_state(cuda, 56, 128, warm)
    n0 = dis_gn.launches
    got = dis_mod.optimize(state, I1p, grid,
                           dataclasses.replace(cfg, gn_backend="pallas"))
    assert dis_gn.launches == n0 + 1
    ref = dis_mod.optimize(state, I1p, grid,
                           dataclasses.replace(cfg, gn_backend="xla"))
    torch.testing.assert_close(got.p_cur, ref.p_cur, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.cost_px, ref.cost_px, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("level", [0, 3])
def test_varref_kernel(cuda, level):
    # 16x64: 1,024 px, the most K3 takes (a thread a pixel)
    i0, i1 = synthetic_frames(2, 2, 16, 64, (1, 0), factor=4)
    g = torch.Generator().manual_seed(2)
    flow = (torch.randn((1, 16, 64, 2), generator=g) * 0.3
            + torch.tensor([1.0, 0.0])).to(cuda)
    im1 = torch.as_tensor(i0, device=cuda)[None]
    im2 = torch.as_tensor(i1, device=cuda)[None]
    cfg = port.operating_point(2)
    wx, wy, mask, dIs = varref_fused.warp_and_derivs(flow, im1, im2, cfg)
    n0 = varref_fused.launches
    uu, vv = varref_fused.refine_inner(wx, wy, mask, dIs, cfg, level + 1)
    assert varref_fused.launches == n0 + 1
    ru, rv = varref_fused.refine_inner_plain(wx, wy, mask, dIs, cfg,
                                             level + 1)
    torch.testing.assert_close(uu, ru, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(vv, rv, rtol=1e-4, atol=1e-5)


def _gn_call(cfg, grid, state, I1p):
    """K2's positional and keyword arguments for a level's state."""
    args = (I1p, state.templates, state.tgrad_x, state.tgrad_y, state.H,
            state.mid_org, state.p_cur, state.p_org, ~state.converged)
    kw = dict(n_iters=cfg.grad_descent_iter, padding=grid.padding,
              thresh=cfg.outlier_thresh, l_bound=grid.l_bound,
              ub_w=grid.u_bound_w, ub_h=grid.u_bound_h, mean_on=1.0)
    return args, kw


# the four compiled (ps, C) with their per-value state in registers, and
# sizes that take the generic form (18x18x3 = 972 of its 1024 values)
@pytest.mark.parametrize("start", ["random", "converged"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("ps,channels", [(8, 1), (8, 3), (12, 1), (12, 3),
                                         (10, 1), (6, 3), (10, 3), (18, 3)])
def test_gn_kernel_forms(cuda, ps, channels, bf16, start):
    """Every form of K2 (one warp a patch) against the plain version on a
    batch of two frames, float32 and bf16 operands, warm-started from a
    random coarse flow of +-2 px (window origins move) or from the plain
    solve's own result (converged: most trips keep their window's taps);
    two runs give the same bits; a frame of the batch equals its own
    launch bit for bit (a patch's arithmetic does not depend on its place
    in the launch).  The kernel's counts: a patch's trips are the plain
    version's iterations and its final pass, but on at most 1% of the
    patches (an ulp can flip an outlier reset); its window loads are within
    1% of the plain count in all and never above its trips; a second run
    adds the same counts again."""
    cfg, grid, state, I1p = _level_state(cuda, 56, 128, True, channels, 2,
                                         patch_size=ps)
    args, kw = _gn_call(cfg, grid, state, I1p)
    kw = dict(kw, bf16=bf16)
    if start == "converged":
        p0 = dis_gn.gn_scale_loop_plain(*args, **kw)[0]
        args = args[:6] + (p0,) + args[7:]
    assert state.templates.shape[-3:] == (ps, ps, channels)
    counts = torch.zeros(args[8].shape + (2,), dtype=torch.int32,
                         device=cuda)
    n0 = dis_gn.launches
    p, cost = dis_gn.gn_scale_loop(*args, **kw, counts=counts)
    assert dis_gn.launches == n0 + 1
    rp, rcost, iters, loads = dis_gn.gn_scale_loop_plain(*args, **kw,
                                                         count_iters=True)
    torch.testing.assert_close(p, rp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cost, rcost, rtol=1e-3, atol=1e-3)
    trips, kloads = counts.long().unbind(-1)
    assert (trips != iters + args[8]).float().mean() < 0.01
    assert abs(int(kloads.sum()) - int(loads.sum())) <= 0.01 * int(
        loads.sum())
    assert (kloads <= trips).all() and (kloads[args[8]] >= 1).all()
    if start == "converged":        # the mechanism engages
        assert int(kloads.sum()) < 0.5 * int(trips.sum())
    first = counts.clone()
    p2, cost2 = dis_gn.gn_scale_loop(*args, **kw, counts=counts)
    assert torch.equal(p2, p) and torch.equal(cost2, cost)
    assert torch.equal(counts, 2 * first)
    for b in range(2):
        pb, cb = dis_gn.gn_scale_loop(*(x[b:b + 1] for x in args), **kw)
        assert torch.equal(pb[0], p[b]) and torch.equal(cb[0], cost[b])


def _varref_planes(device, h, w, cfg, channels=3, n_frames=1):
    """The var-ref loop's planes for ``n_frames`` fields (frame b from
    seed 2 + b) with flows near (1, 0)."""
    pairs = [synthetic_frames(2 + b, 2, h, w, (1, 0), channels=channels,
                              factor=4) for b in range(n_frames)]
    g = torch.Generator().manual_seed(3)
    flow = (torch.randn((n_frames, h, w, 2), generator=g) * 0.3
            + torch.tensor([1.0, 0.0])).to(device)
    im1, im2 = (torch.as_tensor(np.stack([p[k] for p in pairs]),
                                device=device) for k in (0, 1))
    return varref_fused.warp_and_derivs(flow, im1, im2, cfg)


@pytest.mark.parametrize("warm", [False, True])
def test_gn_kernel_one_channel(cuda, warm):
    """K2 at C = 1 (the gray and gradmag modes): 64 threads, two warps,
    per patch."""
    cfg, grid, state, I1p = _level_state(cuda, 56, 128, warm, channels=1)
    n0 = dis_gn.launches
    got = dis_mod.optimize(state, I1p, grid,
                           dataclasses.replace(cfg, gn_backend="pallas"))
    assert dis_gn.launches == n0 + 1
    ref = dis_mod.optimize(state, I1p, grid,
                           dataclasses.replace(cfg, gn_backend="xla"))
    torch.testing.assert_close(got.p_cur, ref.p_cur, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.cost_px, ref.cost_px, rtol=1e-3, atol=1e-3)


def test_varref_kernels_one_channel(cuda):
    """K3 and K4 against their plain loops on one-channel planes."""
    cfg = port.operating_point(3)
    P = _varref_planes(cuda, 14, 32, cfg, channels=1)
    uu, vv = varref_fused.refine_inner(*P, cfg, 6)
    ru, rv = varref_fused.refine_inner_plain(*P, cfg, 6)
    torch.testing.assert_close(uu, ru, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(vv, rv, rtol=1e-4, atol=1e-5)
    P = _varref_planes(cuda, 224, 512, cfg, channels=1)
    uu, vv = varref_tiled.refine_inner_tiled(*P, cfg, 2)
    ru, rv = varref_tiled.refine_inner_plain(*P, cfg, 2)
    torch.testing.assert_close(uu, ru, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(vv, rv, rtol=1e-4, atol=1e-5)


def test_varref_tiled_kernel(cuda):
    """K4 against the plain loop at op-3 scale 1 of 1024x448, and against
    K3 on a field that K3 takes (the same function, the same
    arithmetic)."""
    cfg = port.operating_point(3)
    P = _varref_planes(cuda, 224, 512, cfg)
    n0 = varref_tiled.launches
    uu, vv = varref_tiled.refine_inner_tiled(*P, cfg, 2)
    assert varref_tiled.launches == n0 + 1
    ru, rv = varref_tiled.refine_inner_plain(*P, cfg, 2)
    torch.testing.assert_close(uu, ru, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(vv, rv, rtol=1e-4, atol=1e-5)
    P = _varref_planes(cuda, 28, 32, cfg)
    u4, v4 = varref_tiled.refine_inner_tiled(*P, cfg, 3)
    u3, v3 = varref_fused.refine_inner(*P, cfg, 3)
    torch.testing.assert_close(u4, u3, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v4, v3, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("h,w,level,channels", [
    (28, 64, 4, 3), (34, 60, 6, 3), (56, 128, 3, 1), (112, 256, 2, 3),
    (9, 200, 2, 3), (28, 48, 4, 3), (28, 64, 4, 1), (17, 30, 7, 3)])
def test_varref_cluster_route(cuda, h, w, level, channels):
    """K4's cluster route (work planes in the CTAs' shared memory, halo
    rows through distributed shared memory), its grid route and K3 run
    one loop: bit-identical on a field all three take (K3 takes those of
    at most 1,024 pixels, a thread each), within tolerance of the
    plain loop; a batch of four (one cluster a frame) matches each frame
    alone.  9x200 splits into 8 CTAs: four of 2 rows, one of 1 and three
    with none."""
    cfg = port.operating_point(3)
    P = _varref_planes(cuda, h, w, cfg, channels, n_frames=B)
    assert varref_tiled.cluster_plan(h, w).fits
    n0, c0 = varref_tiled.launches, varref_tiled.launches_cluster
    uu, vv = varref_tiled.refine_inner_tiled(*P, cfg, level + 1,
                                             route="cluster")
    assert (varref_tiled.launches, varref_tiled.launches_cluster) == (
        n0 + 1, c0 + 1)
    ru, rv = varref_tiled.refine_inner_plain(*P, cfg, level + 1)
    torch.testing.assert_close(uu, ru, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(vv, rv, rtol=1e-4, atol=1e-5)
    ug, vg = varref_tiled.refine_inner_tiled(*P, cfg, level + 1,
                                             route="grid")
    assert varref_tiled.launches_cluster == c0 + 1
    assert torch.equal(uu, ug) and torch.equal(vv, vg)
    if varref_fused.fused_plan(h, w, channels).fits:
        u3, v3 = varref_fused.refine_inner(*P, cfg, level + 1)
        assert torch.equal(uu, u3) and torch.equal(vv, v3)
    for b in range(B):
        ub, vb = varref_tiled.refine_inner_tiled(
            *(x[b:b + 1] for x in P), cfg, level + 1, route="cluster")
        assert torch.equal(ub[0], uu[b]) and torch.equal(vb[0], vv[b])


def test_varref_cluster_refused_launch_raises(cuda):
    """A field whose rows do not fit the cluster's shared memory: the card
    refuses the launch and the wrapper raises; nothing is counted, nothing
    is sent to the grid route, and the next launch works."""
    cfg = port.operating_point(3)
    P = _varref_planes(cuda, 224, 512, cfg)
    assert not varref_tiled.cluster_plan(224, 512).fits
    n0 = varref_tiled.launches
    with pytest.raises(RuntimeError, match="fot_varref_cluster"):
        varref_tiled.refine_inner_tiled(*P, cfg, 2, route="cluster")
    with pytest.raises(ValueError, match="route"):
        varref_tiled.refine_inner_tiled(*P, cfg, 2, route="auto")
    assert varref_tiled.launches == n0
    uu, _ = varref_tiled.refine_inner_tiled(*P, cfg, 2, route="grid")
    assert torch.isfinite(uu).all()


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("h,w,level", [
    (14, 32, 5), (17, 30, 7), (18, 32, 5), (22, 32, 5), (28, 32, 4),
    (31, 33, 4), (32, 32, 4), (3, 5, 2), (1, 40, 1), (40, 1, 1)])
def test_varref_fused_matches_k4(cuda, h, w, level, channels):
    """K3 (one CTA a field, a thread a pixel, everything in registers and
    shared memory) at every size up to the resolver's threshold and on to
    the 1,024 pixels it can take: bit-identical to both routes of K4,
    within tolerance of the plain loop, a batch of four (one CTA a frame)
    equal to each frame alone; 31x33 and 17x30 leave the last warp
    ragged, 1x40 and 40x1 have no neighbour in one direction."""
    cfg = port.operating_point(2)
    P = _varref_planes(cuda, h, w, cfg, channels, n_frames=B)
    assert varref_fused.fused_plan(h, w, channels).fits
    n0 = varref_fused.launches
    uu, vv = varref_fused.refine_inner(*P, cfg, level + 1)
    assert varref_fused.launches == n0 + 1
    ru, rv = varref_fused.refine_inner_plain(*P, cfg, level + 1)
    torch.testing.assert_close(uu, ru, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(vv, rv, rtol=1e-4, atol=1e-5)
    for route in varref_tiled.ROUTES:
        u4, v4 = varref_tiled.refine_inner_tiled(*P, cfg, level + 1,
                                                 route=route)
        assert torch.equal(uu, u4) and torch.equal(vv, v4), route
    for b in range(B):
        ub, vb = varref_fused.refine_inner(*(x[b:b + 1] for x in P), cfg,
                                           level + 1)
        assert torch.equal(ub[0], uu[b]) and torch.equal(vb[0], vv[b])


@pytest.mark.parametrize("h,w,channels", [(56, 128, 3), (28, 64, 3),
                                          (40, 96, 1), (33, 32, 1)])
def test_varref_fused_refused_launch_raises(cuda, h, w, channels):
    """A field of more than 1,024 pixels (K3 has a thread a pixel): the
    launch is refused and the wrapper raises; nothing is counted, nothing
    is sent to K4, and the next launch works."""
    cfg = port.operating_point(3)
    P = _varref_planes(cuda, h, w, cfg, channels)
    assert not varref_fused.fused_plan(h, w, channels).fits
    n0, n4 = varref_fused.launches, varref_tiled.launches
    with pytest.raises(RuntimeError, match="fot_varref_fused"):
        varref_fused.refine_inner(*P, cfg, 2)
    assert (varref_fused.launches, varref_tiled.launches) == (n0, n4)
    uu, _ = varref_fused.refine_inner(*_varref_planes(cuda, 14, 32, cfg), cfg,
                                      2)
    assert torch.isfinite(uu).all()


def test_compute_flow_takes_both_k4_routes(cuda):
    """Op 3 on a 1024x436 pair: scale 5 goes to K3, scale 4 to K4's cluster
    route, the finer scales to its grid route, as the resolver says."""
    from flowonthego_tpu_torch.ops.variational import varref_backend_for
    cfg = port.operating_point(3, width=1024)
    want = [varref_backend_for(cfg, 448 >> s, 1024 >> s, "cuda")
            for s in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1)]
    assert want[:2] == ["fused", "cluster"] and want[-1] == "tiled"
    i0, i1 = synthetic_frames(5, 2, 436, 1024, (4, 2), factor=8)
    n3, n4, nc = (varref_fused.launches, varref_tiled.launches,
                  varref_tiled.launches_cluster)
    with graphs.eager():    # the wrappers count what a call launches itself
        flow = port.compute_flow(i0, i1, cfg)   # numpy, no device: the card
    assert flow.is_cuda
    assert varref_fused.launches - n3 == want.count("fused")
    assert varref_tiled.launches_cluster - nc == want.count("cluster")
    assert varref_tiled.launches - n4 == (want.count("cluster")
                                          + want.count("tiled"))
    med = flow[16:-16, 16:-16].reshape(-1, 2).median(dim=0).values.cpu()
    np.testing.assert_allclose(med.numpy(), [4.0, 2.0], atol=0.1)


def test_warp_kernel(cuda):
    """K5 is bit-exact with the plain warp, border clamps, a batch of two
    frames and a frame- and row-strided source included."""
    g = torch.Generator().manual_seed(4)
    big = (torch.rand((2, 53, 77, 3), generator=g) * 255).to(cuda)
    gray = big[..., :1].contiguous()
    for src in (big[:, 4:41, 8:69].contiguous(), big[:, 4:41, 8:69],
                gray[:, 4:41, 8:69], big[1:, 4:41, 8:69]):
        wx, wy = ((torch.rand((src.shape[0], 37, 61), generator=g) * 16
                   - 8).to(cuda) for _ in range(2))
        n0 = warp.launches
        got, gm = warp.warp_image(src, wx, wy)
        assert warp.launches == n0 + 1
        ref, rm = warp.warp_image_plain(src, wx, wy)
        assert torch.equal(got, ref) and torch.equal(gm, rm)


@pytest.mark.parametrize("channels", [1, 3, 5])
@pytest.mark.parametrize("n_frames", [1, 4])
@pytest.mark.parametrize("h,w", [(37, 61), (16, 64), (3, 130), (9, 7)])
def test_warp_kernel_forms(cuda, h, w, channels, n_frames):
    """K5 is bit-exact with the plain warp at C = 1 and 3 (compiled) and 5
    (the generic form), for one frame and four, with widths and heights
    that are and are not multiples of 4 (a thread owns four rows), on a
    dense source and on a strided crop, on flows within the image, flows
    that leave it and flows far outside it."""
    g = torch.Generator().manual_seed(6)
    big = (torch.rand((n_frames, h + 9, w + 6, channels), generator=g)
           * 255).to(cuda)
    crop = big[:, 4:4 + h, 3:3 + w]
    for src in (crop.contiguous(), crop):
        for reach in (0.75, 8.0, 1e4):
            wx, wy = (((torch.rand((n_frames, h, w), generator=g) * 2 - 1)
                       * reach).to(cuda) for _ in range(2))
            n0 = warp.launches
            got, gm = warp.warp_image(src, wx, wy)
            assert warp.launches == n0 + 1
            ref, rm = warp.warp_image_plain(src, wx, wy)
            assert torch.equal(got, ref) and torch.equal(gm, rm)


def test_warp_kernel_smooth_split_flow(cuda):
    """K5 on the flow the pipeline gives it: the split pair's known field
    (two motions and a seam) with a smooth sub-pixel part."""
    from flowonthego_tpu_torch.utils.synth import (smooth_texture,
                                                   synthetic_split_pair)
    h, w = 56, 128
    _, i1, field, _ = synthetic_split_pair(3, h, w, (2, 2), (16, 8),
                                           factor=4)
    flow = field + (smooth_texture(4, h, w, 2, factor=4) - 128.0) / 100.0
    flow = torch.as_tensor(flow, dtype=torch.float32, device=cuda)
    src = torch.as_tensor(i1, device=cuda)[None]
    wx, wy = flow[None, ..., 0].contiguous(), flow[None, ..., 1].contiguous()
    got, gm = warp.warp_image(src, wx, wy)
    ref, rm = warp.warp_image_plain(src, wx, wy)
    assert torch.equal(got, ref) and torch.equal(gm, rm)


def test_compute_flow_op4_runs_k4_k5(cuda):
    """Op 4 at 128x256 (scales 3..0, fields of 512 to 32,768 px) goes
    through K1, K2, K4 and K5, within the band of the all-plain path."""
    i0, i1 = synthetic_frames(5, 2, 128, 256, (2, 1), factor=4)
    mods = (pool, dis_gn, varref_tiled, warp)
    counts = [m.launches for m in mods]
    got = port.compute_flow(i0, i1, op_point=4, device=cuda)
    assert all(m.launches > n for m, n in zip(mods, counts))
    plain = dataclasses.replace(port.operating_point(4, width=256),
                                gn_backend="xla", varref_backend="xla")
    counts = [m.launches for m in mods]
    ref = port.compute_flow(i0, i1, plain, device=cuda)
    assert [m.launches for m in mods] == counts
    epe = torch.linalg.vector_norm(got - ref, dim=-1).double().cpu().numpy()
    assert epe.mean() <= 1e-3 and np.quantile(epe, 0.99) <= 1e-2


def test_compute_flow_runs_all_kernels(cuda):
    """Op 2 on 124x256 from scale 4 (fields of 128 to 8,192 px): K1, K2,
    K3, both routes of K4 and K5, and the glue kernels G1-G4."""
    i0, i1 = synthetic_frames(3, 2, 124, 256, (2, 1), factor=4)
    cfg = dataclasses.replace(port.operating_point(2, width=256),
                              coarsest_scale=4)
    mods = (pool, dis_gn, varref_fused, varref_tiled, warp, level, extract,
            densify, derivs)
    counts = [m.launches for m in mods]
    n_cluster = varref_tiled.launches_cluster
    got = port.compute_flow(i0, i1, cfg, device=cuda)
    assert all(m.launches > n for m, n in zip(mods, counts))
    assert 0 < (varref_tiled.launches_cluster - n_cluster) < (
        varref_tiled.launches - counts[3])
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    plain = dataclasses.replace(cfg, gn_backend="xla", varref_backend="xla")
    ref = port.compute_flow(i0, i1, plain, device=cuda)
    epe = torch.linalg.vector_norm(got - ref, dim=-1).double().cpu().numpy()
    assert epe.mean() <= 1e-3 and np.quantile(epe, 0.99) <= 1e-2


def test_fb_flow_deterministic(cuda):
    """Forward-backward consistency runs K1-K5 on both grids, and
    its merge (a scatter at data-dependent positions) adds in a fixed
    order: two runs agree bit for bit, and the flow is within the band of
    the all-plain path."""
    i0, i1 = synthetic_frames(3, 2, 124, 256, (2, 1), factor=4)
    cfg = dataclasses.replace(port.operating_point(2, width=256),
                              coarsest_scale=4, use_fb_consistency=True)
    mods = (pool, dis_gn, varref_fused, warp)
    counts = [m.launches for m in mods]
    first = port.compute_flow(i0, i1, cfg, device=cuda)
    assert all(m.launches > n for m, n in zip(mods, counts))
    assert torch.equal(port.compute_flow(i0, i1, cfg, device=cuda), first)
    ref = port.compute_flow(i0, i1, dataclasses.replace(
        cfg, gn_backend="xla", varref_backend="xla"), device=cuda)
    epe = torch.linalg.vector_norm(first - ref, dim=-1).double().cpu().numpy()
    assert epe.mean() <= 1e-3 and np.quantile(epe, 0.99) <= 1e-2


@pytest.mark.parametrize("args", [["--channels", "gray", "--fb"],
                                  ["--cost", "l1", "--min-iter", "4"],
                                  ["--mode", "depth"]])
def test_cli_on_card_matches_cpu(cuda, tmp_path, args):
    """The command line on the card (its default device) against the same
    command with ``--device cpu``: the band."""
    from flowonthego_tpu_torch import cli, read_flo, read_pfm
    from flowonthego_tpu_torch.io.images import save_image
    shift = (-2, 0) if "depth" in args else (2, 1)
    paths = [str(tmp_path / f"{k}.ppm") for k in "ab"]
    for path, img in zip(paths, synthetic_frames(3, 2, 124, 256, shift,
                                                 factor=4)):
        save_image(path, img)
    suffix = ".pfm" if "depth" in args else ".flo"
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = str(tmp_path / (device + suffix))
        assert cli.main(paths + [out[device], "2", "--device", device]
                        + args) == 0
    read = read_pfm if suffix == ".pfm" else read_flo
    got, ref = (read(out[k]).reshape(124, 256, -1) for k in ("cuda", "cpu"))
    epe = np.sqrt(((got.astype(np.float64) - ref) ** 2).sum(-1))
    assert epe.mean() <= 1e-3 and np.quantile(epe, 0.99) <= 1e-2


# ---------------------------------------------------------------- batch, bf16

B = 4


def test_batched_gn_kernel(cuda):
    """K2 on a batch of four frames: one launch, within tolerance of the
    plain version, and each frame bit-identical to its own launch (a CTA
    computes its patch alone)."""
    cfg, grid, state, I1p = _level_state(cuda, 56, 128, True, n_frames=B)
    args = (I1p, state.templates, state.tgrad_x, state.tgrad_y, state.H,
            state.mid_org, state.p_cur, state.p_org, ~state.converged)
    kw = dict(n_iters=cfg.grad_descent_iter, padding=grid.padding,
              thresh=cfg.outlier_thresh, l_bound=grid.l_bound,
              ub_w=grid.u_bound_w, ub_h=grid.u_bound_h, mean_on=1.0)
    n0 = dis_gn.launches
    p, cost = dis_gn.gn_scale_loop(*args, **kw)
    assert dis_gn.launches == n0 + 1
    rp, rcost = dis_gn.gn_scale_loop_plain(*args, **kw)
    torch.testing.assert_close(p, rp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cost, rcost, rtol=1e-3, atol=1e-3)
    for b in range(B):
        pb, cb = dis_gn.gn_scale_loop(*(x[b:b + 1] for x in args), **kw)
        assert torch.equal(pb[0], p[b]) and torch.equal(cb[0], cost[b])


@pytest.mark.parametrize("warm", [False, True])
def test_gn_kernel_bf16(cuda, warm):
    """K2's bf16 operand kernel on a batch against the plain version on
    the same bf16-rounded operands (float32 blends, reductions and
    carries on both): the float32 kernel's tolerances.  It counts as a
    bf16 launch, and it is not the float32 kernel."""
    cfg, grid, state, I1p = _level_state(cuda, 56, 128, warm, n_frames=2)
    bf = dataclasses.replace(cfg, dtype="bfloat16", gn_backend="pallas")
    n0, nb0 = dis_gn.launches, dis_gn.launches_bf16
    got = dis_mod.optimize(state, I1p, grid, bf)
    assert (dis_gn.launches, dis_gn.launches_bf16) == (n0 + 1, nb0 + 1)
    ref = dis_mod.optimize(state, I1p, grid,
                           dataclasses.replace(bf, gn_backend="xla"))
    torch.testing.assert_close(got.p_cur, ref.p_cur, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.cost_px, ref.cost_px, rtol=1e-3, atol=1e-3)
    f32 = dis_mod.optimize(state, I1p, grid,
                           dataclasses.replace(bf, dtype="float32"))
    assert dis_gn.launches_bf16 == nb0 + 1
    assert (f32.p_cur - got.p_cur).abs().max() > 1e-4


def test_batched_varref_and_warp_kernels(cuda):
    """K3 (one CTA per field), K4 (one launch over the batch) and K5 on
    four frames: one launch each, within tolerance of the plain loop (K5
    bit-exact), and every frame bit-identical to its own launch: no
    border or red-black neighbour crosses into the next frame."""
    cfg = port.operating_point(3)
    for mod, run, h, w, level in (
            (varref_fused, varref_fused.refine_inner, 14, 32, 5),
            (varref_tiled, varref_tiled.refine_inner_tiled, 56, 128, 3)):
        P = _varref_planes(cuda, h, w, cfg, n_frames=B)
        n0 = mod.launches
        uu, vv = run(*P, cfg, level + 1)
        assert mod.launches == n0 + 1
        ru, rv = varref_fused.refine_inner_plain(*P, cfg, level + 1)
        torch.testing.assert_close(uu, ru, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(vv, rv, rtol=1e-4, atol=1e-5)
        for b in range(B):
            ub, vb = run(*(x[b:b + 1] for x in P), cfg, level + 1)
            assert torch.equal(ub[0], uu[b]) and torch.equal(vb[0], vv[b])
    g = torch.Generator().manual_seed(5)
    src = (torch.rand((B, 37, 61, 3), generator=g) * 255).to(cuda)
    wx, wy = ((torch.rand((B, 37, 61), generator=g) * 16 - 8).to(cuda)
              for _ in range(2))
    n0 = warp.launches
    got, gm = warp.warp_image(src, wx, wy)
    assert warp.launches == n0 + 1
    ref, rm = warp.warp_image_plain(src, wx, wy)
    assert torch.equal(got, ref) and torch.equal(gm, rm)


def test_batched_fb_flow_deterministic(cuda):
    """``batched_flow`` with forward-backward consistency on three pairs:
    each kernel launches as often as for one pair (once per scale and
    direction for the batch), two runs agree bit for bit (the merge's
    one scatter adds in a fixed order), and each frame is within the band
    of its single-pair flow."""
    shifts = ((2, 1), (-2, 2), (4, -2))
    pairs = [synthetic_frames(3 + b, 2, 128, 256, s, factor=4)
             for b, s in enumerate(shifts)]
    I0, I1 = (torch.as_tensor(np.stack([p[k] for p in pairs]), device=cuda)
              for k in (0, 1))
    cfg = dataclasses.replace(port.operating_point(2, width=256),
                              use_fb_consistency=True)
    mods = (pool, dis_gn, varref_fused, varref_tiled, warp)

    def eager(a, b):
        """(flows, the wrappers' launches) of one launch-by-launch call."""
        counts = [m.launches for m in mods]
        with graphs.eager():
            out = port.batched_flow(a, b, cfg)
        return out, [m.launches - n for m, n in zip(mods, counts)]

    first, batch_n = eager(I0, I1)
    assert batch_n[1] > 0
    assert torch.equal(eager(I0, I1)[0], first)
    for _ in range(2):      # the captured path: recorded, then replayed
        assert torch.equal(port.batched_flow(I0, I1, cfg), first)
    for b in range(len(shifts)):
        single, single_n = eager(I0[b:b + 1], I1[b:b + 1])
        assert single_n == batch_n
        epe = torch.linalg.vector_norm(first[b] - single[0], dim=-1)
        assert epe.mean() <= 1e-3 and torch.quantile(epe, 0.99) <= 1e-2


# ------------------------------------------------------- CUDA-graph captures

def _eager_then_captured(fn, calls=3):
    """``fn()`` eagerly, then ``calls`` times through its captured path
    (the first of them runs eagerly and records, the others replay)."""
    graphs.clear()
    with graphs.eager():
        ref = fn()
    got = [fn() for _ in range(calls)]
    torch.cuda.synchronize()
    return ref, got, graphs.cached_paths()


GRAPH_MODES = {
    "op 1": (1, {}), "op 2": (2, {}), "op 3": (3, {}), "op 4": (4, {}),
    "fb": (2, dict(use_fb_consistency=True)),
    "huber": (2, dict(cost_fn="huber")),
    "bf16": (2, dict(dtype="bfloat16")),
    "plain": (2, dict(gn_backend="xla", varref_backend="xla")),
}


@pytest.mark.parametrize("mode", sorted(GRAPH_MODES))
def test_captured_compute_flow_equals_eager(cuda, mode):
    """A replayed graph returns the eager call's flow bit for bit (it
    replays the same kernels on the same arguments), on 124x256 from
    scale 4, so that K3 and both routes of K4 are in the graph."""
    op, fields = GRAPH_MODES[mode]
    cfg = dataclasses.replace(port.operating_point(op, width=256),
                              coarsest_scale=4, **fields)
    i0, i1 = (torch.as_tensor(x, device=cuda) for x in
              synthetic_frames(3, 2, 124, 256, (2, 1), factor=4))
    ref, got, paths = _eager_then_captured(
        lambda: port.compute_flow(i0, i1, cfg))
    assert paths == [("flow_full_padded", 2)]
    assert all(torch.equal(g, ref) for g in got)
    assert len({g.data_ptr() for g in got}) == 3


def test_captured_gray_and_depth_equal_eager(cuda):
    cfg = dataclasses.replace(port.operating_point(2, width=256),
                              coarsest_scale=4)
    i0, i1 = (torch.as_tensor(x, device=cuda) for x in
              synthetic_frames(3, 2, 124, 256, (-2, 0), factor=4))
    g0, g1 = (port.prepare_input(x, "gray") for x in (i0, i1))
    ref, got, _ = _eager_then_captured(lambda: port.compute_flow(g0, g1, cfg))
    assert all(torch.equal(g, ref) for g in got)
    depth = dataclasses.replace(cfg, use_var_ref=False)
    ref, got, paths = _eager_then_captured(
        lambda: port.compute_disparity(i0, i1, depth))
    assert paths == [("compute_disparity", 2)]
    assert all(torch.equal(g, ref) for g in got)


@pytest.mark.parametrize("full_res", [True, False])
def test_captured_batched_flow_equals_eager(cuda, full_res):
    cfg = dataclasses.replace(port.operating_point(2, width=256),
                              coarsest_scale=4)
    pairs = [synthetic_frames(5 + b, 2, 128, 256, s, factor=4)
             for b, s in enumerate(((2, 1), (-2, 2), (4, -2), (0, 2)))]
    I0, I1 = (torch.as_tensor(np.stack([p[k] for p in pairs]), device=cuda)
              for k in (0, 1))
    ref, got, _ = _eager_then_captured(
        lambda: port.batched_flow(I0, I1, cfg, full_res=full_res))
    assert all(torch.equal(g, ref) for g in got)


def test_captured_streams_equal_eager_and_do_not_alias(cuda):
    """``stream_flow`` and a 4-stream ``MultiStream`` through the two
    alternating graphs against the eager stream bit for bit; flows held
    at once stay as they were."""
    cfg = dataclasses.replace(port.operating_point(2, width=256),
                              coarsest_scale=4)
    frames = [torch.as_tensor(f, device=cuda) for f in
              synthetic_frames(7, 7, 128, 256, (2, 1), factor=4)]
    graphs.clear()
    with graphs.eager():
        ref = list(port.stream_flow(frames, cfg, fetch=False))
    runs = [list(port.stream_flow(frames, cfg, fetch=False))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert graphs.cached_paths() == [("stream_step", 11)]
    for got in runs:
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    videos = torch.stack([torch.stack(frames), torch.stack(frames[::-1]),
                          torch.stack(frames), torch.stack(frames[::-1])])
    with graphs.eager():
        em = port.MultiStream(cfg, 128, 256, n_streams=4, device=cuda)
        em.start(videos[:, 0])
        want = [em.push(videos[:, t]) for t in range(1, 7)]
    pm = port.MultiStream(cfg, 128, 256, n_streams=4, device=cuda)
    pm.start(videos[:, 0])
    got = [pm.push(videos[:, t]) for t in range(1, 7)]
    pm.close()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # stream 0 is the stream above.  At the finest scale a batch of 4
    # gives it the single stream's flow bit for bit; the full-resolution
    # flows differ by <= 1e-5 px, so that gap is the upsample's (its
    # matmuls see another shape in a batch)
    fine = list(port.stream_flow(frames, cfg, full_res=False, fetch=False))
    fm = port.MultiStream(cfg, 128, 256, n_streams=4, full_res=False,
                          device=cuda)
    fm.start(videos[:, 0])
    for t in range(1, 7):
        assert torch.equal(fm.push(videos[:, t])[0], fine[t - 1])
    fm.close()
    assert float((got[0][0] - ref[0]).abs().max()) <= 1e-5


def test_failed_capture_raises_and_leaves_no_path(cuda):
    """A function that cannot be captured (it synchronises) raises out of
    the call that records it, the path's first; nothing is cached and
    nothing falls back."""

    def fn(a):
        return a * float(a.sum())        # a device-to-host copy

    graphs.clear()
    x = torch.ones(8, device=cuda)
    with graphs.eager():
        assert torch.equal(fn(x), x * 8)      # the eager call is fine
    for _ in range(2):                        # and no later call gets by
        with pytest.raises(Exception):
            graphs.run("flow_full_padded", fn, (x,), static=("bad",))
        torch.cuda.synchronize()
        assert graphs.cached_paths() == []
    # the card is usable afterwards
    for _ in range(3):
        ok = graphs.run("flow_full_padded", lambda a: a + 1, (x,),
                        static=("good",))
        assert torch.equal(ok, x + 1)
    assert graphs.cached_paths() == [("flow_full_padded", 2)]
    graphs.clear()


def test_cache_frees_its_memory(cuda):
    """Evicted and cleared paths give their pools back."""
    graphs.clear()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()

    def fn(a):
        return (a @ a).relu()

    for n in range(graphs.MAX_ENTRIES + 3):
        x = torch.ones((256 + n, 256 + n), device=cuda)
        for _ in range(2):
            graphs.run("dis_flow_padded", fn, (x,))
    assert len(graphs.cached_paths()) == graphs.MAX_ENTRIES
    del x
    graphs.clear()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= base + (1 << 20)


def test_device_list_forms_on_one_card(cuda):
    """A one-device mesh and ``devices=[cuda:0]``: the one-device forms
    bit for bit."""
    cfg = dataclasses.replace(port.operating_point(2, width=256),
                              coarsest_scale=4)
    pairs = [synthetic_frames(5 + b, 3, 128, 256, s, factor=4)
             for b, s in enumerate(((2, 1), (-2, 2)))]
    I0, I1, I2 = (torch.as_tensor(np.stack([p[k] for p in pairs]),
                                  device=cuda) for k in (0, 1, 2))
    fn = port.make_data_parallel_flow(port.make_mesh(devices=[cuda]), cfg)
    assert torch.equal(fn(I0, I1), port.batched_flow(I0, I1, cfg))
    a = port.MultiStream(cfg, 128, 256, n_streams=2, devices=[cuda])
    b = port.MultiStream(cfg, 128, 256, n_streams=2, device=cuda)
    for m in (a, b):
        m.start(I0)
    for frames in (I1, I2):
        assert torch.equal(a.push(frames), b.push(frames))
    assert set(port.device_memory_stats()["cuda:0"]) == {
        "bytes_in_use", "peak_bytes_in_use", "bytes_limit"}


# ---------------------------------------------------------- spatial forms

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("ps,channels", [(8, 3), (12, 3), (8, 1), (10, 3)])
def test_gn_kernel_strip_offset(cuda, ps, channels, bf16):
    """K2's strip entry on a cut of the target: against its plain version
    on the same cut (tolerances of test_gn_kernel), counted apart; where
    the cut holds every window the patches read, the same as the kernel
    without an offset on the whole target."""
    cfg, grid, state, I1p = _level_state(cuda, 56, 128, True, channels,
                                         patch_size=ps)
    kw = dict(n_iters=cfg.grad_descent_iter, padding=grid.padding,
              thresh=cfg.outlier_thresh, l_bound=grid.l_bound,
              ub_w=grid.u_bound_w, ub_h=grid.u_bound_h, mean_on=1.0,
              bf16=bf16)
    block = (slice(None), slice(4, 9), slice(4, 24))   # patch rows, columns
    args = [x[block].contiguous() for x in (
        state.templates, state.tgrad_x, state.tgrad_y, state.H,
        state.mid_org, state.p_cur, state.p_org, ~state.converged)]
    r0, c0 = 2, 2
    cut = I1p[:, r0:, c0:].contiguous()
    n0, o0 = dis_gn.launches, dis_gn.launches_offset
    got = dis_gn.gn_scale_loop(cut, *args, **kw, offset=(-c0, -r0))
    assert (dis_gn.launches, dis_gn.launches_offset) == (n0 + 1, o0 + 1)
    ref = dis_gn.gn_scale_loop_plain(cut, *args, **kw, offset=(-c0, -r0))
    torch.testing.assert_close(got[0], ref[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-3, atol=1e-3)
    whole = dis_gn.gn_scale_loop(I1p, *args, **kw)
    assert dis_gn.launches_offset == o0 + 1
    assert torch.equal(whole[0], got[0]) and torch.equal(whole[1], got[1])


def test_captured_spatial_forms_equal_eager(cuda):
    """The strip, tile and replicate-coarse forms on a one-card mesh (the
    JAX package's test geometries): the captured call equals the eager
    call bit for bit, K2's strip entry ran where a scale is sharded, and
    the strips agree with the unsharded flow at the JAX package's bar."""
    cfg = port.DISConfig(patch_size=8, patch_stride=0.4, coarsest_scale=2,
                         finest_scale=1, grad_descent_iter=8,
                         use_var_ref=True)
    par = port.parallel
    strips = par.make_mesh(n_space=4, devices=[cuda] * 4)
    tiles = par.make_tile_mesh(2, 2, devices=[cuda] * 4)
    assert par.sharded_scale_levels(cfg, 512, 4)
    assert par.tiled2d_scale_levels(cfg, 160, 160, 2, 2)
    forms = {"strips": (par.make_fine_spatial_flow(strips, cfg, 512, 64),
                        (512, 64)),
             "tiles": (par.make_tile2d_flow(tiles, cfg, 160, 160),
                       (160, 160)),
             "replicate": (par.make_spatial_flow(strips, cfg, 512, 64),
                           (512, 64))}
    for name, (fn, (H, W)) in forms.items():
        frames = synthetic_frames(5, 2, H, W, (2, 1), factor=4)
        I0, I1 = (torch.as_tensor(f, device=cuda) for f in frames)
        graphs.clear()
        o0 = dis_gn.launches_offset
        with graphs.eager():
            ref = fn(I0, I1)
        assert (dis_gn.launches_offset > o0) == (name != "replicate"), name
        got = [fn(I0, I1) for _ in range(3)]
        assert [e for e, _ in graphs.cached_paths()] == ["spatial_flow"]
        for out in got:
            out, want = ((out, ref) if name == "replicate"
                         else (out[0], ref[0]))
            assert torch.equal(out, want), name
            assert out.device.type == "cuda"
        if name != "replicate":
            assert all(int(v) == 0 for _, v in got), name
        if name == "strips":
            torch.testing.assert_close(
                got[0][0], port.flow_full_padded(I0, I1, cfg), rtol=1e-3,
                atol=1e-3)
    graphs.clear()


# ------------------------------------------------- the glue kernels G1-G4

def _glue_level(cuda, n, h, w, C, op=2):
    """(cfg, frames [n, h, w, C] on the card, their plain padded level)."""
    frames = np.stack([synthetic_frames(7 + b, 1, h, w, (0, 0), channels=C,
                                        factor=4)[0] for b in range(n)])
    frames[:, :h // 3, :w // 4] = 128.0          # flat patches: det == 0
    plant_stripes(frames)            # det == 0 where H00 > 0 (gy == 0)
    cfg = port.operating_point(op)
    img = torch.as_tensor(frames, device=cuda)
    return cfg, img, pyramid_mod.pyramid_level_plain(img, cfg.padding)


@pytest.mark.parametrize("n,C", [(1, 3), (2, 1), (4, 3)])
def test_glue_level_kernel(cuda, n, C):
    """G1 against its plain version, bit for bit, and into a stream's
    fixed tensors."""
    cfg, img, ref = _glue_level(cuda, n, 30, 44, C)
    n0 = level.launches
    got = level.pyramid_level(img, cfg.padding)
    buf = pyramid_mod.PyramidLevel(*(torch.zeros_like(x) for x in ref))
    level.pyramid_level(img, cfg.padding, out=buf)
    assert level.launches == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all(torch.equal(a, b) for a, b in zip(buf, ref))


@pytest.mark.parametrize("mean", [True, False])
@pytest.mark.parametrize("op,n,C", [(2, 1, 3), (4, 2, 3), (1, 2, 1)])
def test_glue_extract_kernel(cuda, op, n, C, mean):
    """G2 against its plain version: windows bit for bit, templates within
    1e-4 and Hessians within 1e-5 of the largest entry (sums in another
    order, as chip_smoke.py's bars), flat and striped patches (det == 0,
    H00 == 0 and H00 > 0) bumped alike."""
    cfg, img, lvl = _glue_level(cuda, n, 40, 56, C, op)
    cfg = dataclasses.replace(cfg, use_mean_normalization=mean)
    grid = PatchGrid.create(cfg, 56, 40)
    n0 = extract.launches
    got = extract.extract_templates_and_hessians(*lvl, grid, cfg)
    assert extract.launches == n0 + 1
    ref = patches_mod.extract_templates_and_hessians_plain(*lvl, grid, cfg)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    H = ref[3]
    torch.testing.assert_close(got[3], H, rtol=1e-5,
                               atol=1e-5 * float(H.abs().max()))
    flat = H[..., 0] <= 1e-10
    assert flat.any() and torch.equal(got[3][flat][:, :2], H[flat][:, :2])
    striped = (H[..., 1] == 0) & (H[..., 2] <= 1e-10) & (H[..., 0] > 1e-10)
    assert striped.any()
    assert torch.equal(got[3][striped][:, 1:], H[striped][:, 1:])


@pytest.mark.parametrize("weight,merge", [("squared", False), ("abs", False),
                                          ("squared", True)])
@pytest.mark.parametrize("op,n,C,h,w", [
    (2, 1, 3, 30, 44), (4, 2, 1, 30, 44), (1, 1, 3, 30, 44),
    (4, 1, 3, 448, 1024),     # op 4's scale 0
    (4, 2, 3, 448, 1030),     # the last chunk ends inside a patch's reach
    (1, 1, 1, 56, 128)])      # op 1's scale 3: ps % steps != 0
def test_glue_densify_kernel(cuda, op, n, C, h, w, weight, merge):
    """G3 against its plain version, bit for bit: the canvas's order of
    adds, PyTorch's order for the weights' channel sum, the fb merge's
    accumulator added before the normalisation; bands and chunks at op
    4's scale 0, a width whose chunks do not divide the patch columns and
    op 1's strided geometry."""
    cfg = dataclasses.replace(port.operating_point(op), densify_weight=weight)
    grid = PatchGrid.create(cfg, w, h)
    g = torch.Generator().manual_seed(5)
    P = (n, grid.n_h, grid.n_w)
    ps = grid.patch_size
    p = (torch.randn(P + (2,), generator=g) * 3).to(cuda)
    cost = (torch.rand(P + (ps, ps, C), generator=g) ** 2 * 50).to(cuda)
    state = dis_mod.PatchState(p, p, None, None, None, None, None, None,
                               cost, None)
    m = (torch.cat([torch.rand((n, h, w, 1), generator=g),
                    torch.randn((n, h, w, 2), generator=g)], dim=-1).to(cuda)
         if merge else None)
    n0 = densify.launches
    got = densify.densify(state, grid, cfg, m)
    assert densify.launches == n0 + 1
    assert torch.equal(got, densify_mod.densify_plain(state, grid, cfg, m))


@pytest.mark.parametrize("ps,stride,C", [(10, 0.6, 3), (6, 0.5, 1)])
def test_glue_densify_kernel_generic_form(cuda, ps, stride, C):
    """G3's generic instantiation (a geometry no operating point has, ps
    and steps read at run time; 10 px every 4 leaves ps % steps != 0)
    against its plain version, bit for bit, with an fb merge's
    accumulator, two frames, at a width whose chunks end inside the
    patches' reach."""
    cfg = dataclasses.replace(port.operating_point(2), patch_size=ps,
                              patch_stride=stride)
    h, w = 64, 200
    grid = PatchGrid.create(cfg, w, h)
    assert (grid.patch_size, grid.steps) not in ((8, 4), (8, 5), (12, 3))
    assert densify.densify_plan(grid, 2).n_chunks > 1
    g = torch.Generator().manual_seed(6)
    P = (2, grid.n_h, grid.n_w)
    p = (torch.randn(P + (2,), generator=g) * 3).to(cuda)
    cost = (torch.rand(P + (ps, ps, C), generator=g) ** 2 * 50).to(cuda)
    state = dis_mod.PatchState(p, p, None, None, None, None, None, None,
                               cost, None)
    m = torch.cat([torch.rand((2, h, w, 1), generator=g),
                   torch.randn((2, h, w, 2), generator=g)], dim=-1).to(cuda)
    for merge in (None, m):
        assert torch.equal(densify.densify(state, grid, cfg, merge),
                           densify_mod.densify_plain(state, grid, cfg, merge))


@pytest.mark.parametrize("h,w", [(30, 44), (4, 8), (14, 32), (37, 5)])
@pytest.mark.parametrize("n,C", [(1, 3), (2, 1)])
def test_glue_derivs_kernel(cuda, n, C, h, w):
    """G4 on a strided crop (as the var-ref takes its image) against its
    plain version, bit for bit, down to fields of 4 and 5 pixels, where
    the second derivatives reach the first derivatives' replicated edge."""
    cfg, img, lvl = _glue_level(cuda, n, h, w, C)
    p = cfg.padding
    im1 = lvl.image[:, p:p + h, p:p + w, :]
    assert not im1.is_contiguous()
    w_im2 = _glue_level(cuda, n, h, w, C)[1].flip(1).contiguous()
    n0 = derivs.launches
    got = derivs.derivatives(im1, w_im2)
    assert derivs.launches == n0 + 1
    assert torch.equal(got, derivs.derivatives_plain(im1, w_im2))


# ------------------------------------------- G5 (fb merge), G6 (dis_ref)

def _merge_state(device, case, n, C, h=56, w=128, op=2):
    """A complementary state of ``n`` frames at op ``op``'s geometry with
    seeded flows and costs: scattered, every patch outside the frame, or
    every patch piled on one cell."""
    cfg = port.operating_point(op)
    grid = PatchGrid.create(cfg, w, h)
    g = torch.Generator().manual_seed(7)
    lead = (n, grid.n_h, grid.n_w)
    ps = grid.patch_size
    mid = torch.as_tensor(np.stack(grid.midpoints(), -1),
                          dtype=torch.float32)[None].expand(lead + (2,))
    p = torch.randn(lead + (2,), generator=g) * 3
    if case == "outside":
        p = p + 1e4
    elif case == "pile-up":
        p = (torch.tensor([w / 2, h / 3]) - mid
             + torch.rand(lead + (2,), generator=g) - 0.5)
    cost = torch.rand(lead + (ps, ps, C), generator=g) ** 2 * 50
    state = dis_mod.PatchState(p.to(device), None, mid.to(device), None,
                               None, None, None, None, cost.to(device), None)
    return cfg, grid, state


MERGE_SHAPES = {"op 2 scale 3": (2, 56, 128), "op 4 scale 0": (4, 448, 1024),
                "op 4 scale 2": (4, 112, 256), "op 4 scale 4": (4, 28, 64)}


@pytest.mark.parametrize("case,n,C,weight,shape", [
    ("scattered", 1, 3, "squared", "op 2 scale 3"),
    ("scattered", 4, 1, "squared", "op 2 scale 3"),
    ("scattered", 2, 3, "abs", "op 2 scale 3"),
    ("outside", 2, 3, "squared", "op 2 scale 3"),
    ("pile-up", 2, 3, "squared", "op 2 scale 3"),
    ("scattered", 1, 3, "squared", "op 4 scale 0"),   # 51 sort chunks
    ("scattered", 2, 1, "abs", "op 4 scale 0"),
    ("pile-up", 1, 3, "squared", "op 4 scale 2"),     # windows of patches
    ("scattered", 2, 3, "squared", "op 4 scale 4"),   # a warp a cell
    ("pile-up", 1, 3, "squared", "op 4 scale 4")])    # its lists' walk
def test_fb_merge_kernel(cuda, case, n, C, weight, shape):
    """G5 against the plain merge (a stably sorted index_put_ that folds
    each cell in order), bit for bit; one call counted.  Op 2's frames
    sort in one CTA; op 4's scale 0 in chunks over two radix passes; op
    4's scale-2 pile-up gives a tile 3,268 candidates, taken in
    windows; op 4's scale 4 (28x64) takes a warp a cell, its pile-up
    more hits a corner than a warp sorts."""
    op, h, w = MERGE_SHAPES[shape]
    cfg, grid, state = _merge_state(cuda, case, n, C, h, w, op)
    cfg = dataclasses.replace(cfg, densify_weight=weight)
    n0 = fb_merge.launches
    got = fb_merge.fb_merge(state, grid, cfg, grid.height, grid.width)
    assert fb_merge.launches == n0 + 1
    ref = densify_mod.fb_merge_plain(state, grid, cfg, grid.height,
                                     grid.width)
    assert torch.equal(got, ref)
    if case == "outside":
        assert not got.any()


def _ref_close(got, ref, cost_fn):
    """G6 against its plain version: p within 1e-4, cost and diff within
    1e-3 (as x|x| under the robust costs) on all but 1% of the patches
    (an ulp of a reduction can flip a ratio test or an outlier reset)."""
    def off(a, b, tol):
        bad = (a - b).abs() > tol * (1 + b.abs())
        return float(bad.reshape(*bad.shape[:3], -1).any(-1).float().mean())

    def sq(x):
        return x if cost_fn == "l2" else x * x.abs()

    assert got.converged.all()
    assert off(got.p_cur, ref.p_cur, 1e-4) <= 0.01
    assert off(sq(got.cost_px), sq(ref.cost_px), 1e-3) <= 0.01
    assert off(sq(got.diff), sq(ref.diff), 1e-3) <= 0.01


@pytest.mark.parametrize("fields", [dict(cost_fn="l1"),
                                    dict(cost_fn="huber"),
                                    dict(cost_fn="l1", min_iter=4),
                                    dict(res_thresh=5.0)])
@pytest.mark.parametrize("warm,channels,n_frames,offset", [
    (False, 3, 1, None), (True, 1, 2, None), (True, 3, 1, (-3.0, -2.0))])
def test_dis_ref_kernel(cuda, fields, warm, channels, n_frames, offset):
    """G6 through ``optimize`` (the modes that take the reference-form
    solve) against the plain version, with a strip offset (the target cut
    by (2, 3)); one launch, no K2."""
    cfg, grid, state, I1p = _level_state(cuda, 56, 128, warm, channels,
                                         n_frames)
    cfg = dataclasses.replace(cfg, **fields)
    if offset is not None:
        I1p = I1p[:, 2:, 3:].contiguous()
    n0, k0 = dis_ref.launches, dis_gn.launches
    got = dis_mod.optimize(state, I1p, grid, cfg, offset)
    assert dis_ref.launches == n0 + 1 and dis_gn.launches == k0
    ref = dis_mod.optimize_reference_plain(state, I1p, grid, cfg, offset)
    _ref_close(got, ref, cfg.cost_fn)
    again = dis_ref.optimize_reference(state, I1p, grid, cfg, offset)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_dis_ref_kernel_on_a_block(cuda):
    """G6 on a block of the grid's rows, as a spatial form's shard solves
    it (its patches, the global grid's box, a strip of the target and
    the offset into it), against the plain version."""
    cfg, grid, state, I1p = _level_state(cuda, 56, 128, True)
    cfg = dataclasses.replace(cfg, cost_fn="l1")
    block = dis_mod.PatchState(*(x[:, 3:7] for x in state))
    strip = I1p[:, 10:40].contiguous()
    n0 = dis_ref.launches
    got = dis_mod.optimize(block, strip, grid, cfg, (0.0, -10.0))
    assert dis_ref.launches == n0 + 1 and got.p_cur.shape[1] == 4
    _ref_close(got, dis_mod.optimize_reference_plain(
        block, strip, grid, cfg, (0.0, -10.0)), cfg.cost_fn)


@pytest.mark.parametrize("cam_lr,channels,n_frames", [(0, 3, 1), (1, 1, 2)])
def test_dis_ref_1d_kernel(cuda, cam_lr, channels, n_frames):
    """G6's 1-D form (stereo) against its plain version: v zero, the
    sign clamp where p_org is 0."""
    cfg, grid, state, I1p = _level_state(cuda, 56, 128, False, channels,
                                         n_frames)
    n0 = dis_ref.launches_1d
    got = stereo_mod._optimize_1d(state, I1p, grid, cfg, cam_lr)
    assert dis_ref.launches_1d == n0 + 1
    ref = stereo_mod.optimize_1d_plain(state, I1p, grid, cfg, cam_lr)
    _ref_close(got, ref, "l2")
    assert (got.p_cur[..., 1] == 0).all()
    d = got.p_cur[..., 0]
    assert (d <= 0).all() if cam_lr == 0 else (d >= 0).all()


@pytest.mark.parametrize("ps", [6, 10])
@pytest.mark.parametrize("cost_fn", ["l1", "huber"])
@pytest.mark.parametrize("channels", [3, 1])
def test_dis_ref_generic_form(cuda, ps, cost_fn, channels):
    """G6's generic form (a patch size other than 8 and 12: the state in
    shared memory), 2-D from a warm start and 1-D from a cold one,
    against the plain versions."""
    cfg, grid, state, I1p = _level_state(cuda, 56, 128, True, channels,
                                         patch_size=ps)
    cfg = dataclasses.replace(cfg, cost_fn=cost_fn)
    n0, k0 = dis_ref.launches, dis_ref.launches_1d
    got = dis_ref.optimize_reference(state, I1p, grid, cfg)
    _ref_close(got, dis_mod.optimize_reference_plain(state, I1p, grid, cfg),
               cost_fn)
    cfg, grid, state, I1p = _level_state(cuda, 56, 128, False, channels,
                                         patch_size=ps)
    cfg = dataclasses.replace(cfg, cost_fn=cost_fn)
    got = dis_ref.optimize_1d(state, I1p, grid, cfg, 0)
    _ref_close(got, stereo_mod.optimize_1d_plain(state, I1p, grid, cfg, 0),
               cost_fn)
    assert (dis_ref.launches, dis_ref.launches_1d) == (n0 + 2, k0 + 1)


@pytest.mark.parametrize("shape,cost_fn", [("op 2 scale 3", "huber"),
                                           ("op 2 scale 3", "l1"),
                                           ("op 4 scale 1", "huber")])
def test_dis_ref_one_pass_trip(cuda, shape, cost_fn):
    """G6's one-pass trip at the paths' shapes from a warm start: op 2's
    scale 3 (448 patches, 12 trips) and op 4's scale 1 (12,825 patches,
    up to 128 trips), against the plain version under the flip-share
    rule; one launch, two runs bit-identical."""
    op, h, w = {"op 2 scale 3": (2, 56, 128), "op 4 scale 1": (4, 224, 512)}[
        shape]
    cfg, grid, state, I1p = _level_state(cuda, h, w, True, op=op)
    cfg = dataclasses.replace(cfg, cost_fn=cost_fn)
    n0 = dis_ref.launches
    got = dis_ref.optimize_reference(state, I1p, grid, cfg)
    assert dis_ref.launches == n0 + 1
    again = dis_ref.optimize_reference(state, I1p, grid, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _ref_close(got, dis_mod.optimize_reference_plain(state, I1p, grid, cfg),
               cost_fn)


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("mode", ["huber", "l1", "l1 min_iter 4",
                                  "l2 res_thresh 5", "1-D cam_lr 0",
                                  "1-D cam_lr 1"])
def test_dis_ref_is_its_numpy_replay(cuda, mode, channels):
    """G6 gives the bits of ``tests/ref_replay.py``'s numpy replay of its
    arithmetic (the CPU tests' stand-in for the kernel) at op 2's scale 3:
    2-D from a warm start, 1-D from a cold one."""
    from ref_replay import replay
    one_d = mode.startswith("1-D")
    cfg, grid, state, I1p = _level_state(cuda, 56, 128, not one_d, channels)
    fields = {"huber": dict(cost_fn="huber"), "l1": dict(cost_fn="l1"),
              "l1 min_iter 4": dict(cost_fn="l1", min_iter=4),
              "l2 res_thresh 5": dict(res_thresh=5.0)}.get(mode, {})
    cfg = dataclasses.replace(cfg, **fields)
    cam_lr = int(mode[-1]) if one_d else 0
    if one_d:
        got = dis_ref.optimize_1d(state, I1p, grid, cfg, cam_lr)
    else:
        got = dis_ref.optimize_reference(state, I1p, grid, cfg)
    want = replay(state, I1p, grid, cfg, one_d, cam_lr)
    for name, a, b in zip(("p", "diff", "cost_px"),
                          (got.p_cur, got.diff, got.cost_px), want):
        assert np.array_equal(a.cpu().numpy().view(np.uint32),
                              np.ascontiguousarray(b).view(np.uint32)), name


@pytest.mark.parametrize("mode", ["fb", "huber", "depth", "op 4 fb"])
def test_captured_paths_through_g5_g6(cuda, mode):
    """The fb, huber and depth paths launch G5 / G6 eagerly, and their
    replayed graphs equal the eager call bit for bit; op 4's fb pair at
    1024x436 (G5's chunked sort at scales 0-1) too."""
    cfg = dataclasses.replace(port.operating_point(2, width=256),
                              coarsest_scale=4)
    shift = (-2, 0) if mode == "depth" else (2, 1)
    i0, i1 = (torch.as_tensor(x, device=cuda) for x in
              synthetic_frames(3, 2, 124, 256, shift, factor=4))
    if mode == "op 4 fb":
        cfg = port.operating_point(4, width=1024)
        i0, i1 = (torch.as_tensor(x, device=cuda) for x in
                  synthetic_frames(3, 2, 436, 1024, (16, 8), factor=4))
    if mode == "depth":
        cfg = dataclasses.replace(cfg, use_var_ref=False)
        fn = lambda: port.compute_disparity(i0, i1, cfg)  # noqa: E731
        mod = dis_ref
    else:
        cfg = dataclasses.replace(cfg, **(
            dict(use_fb_consistency=True) if "fb" in mode
            else dict(cost_fn="huber")))
        fn = lambda: port.compute_flow(i0, i1, cfg)  # noqa: E731
        mod = fb_merge if "fb" in mode else dis_ref
    n0 = mod.launches
    ref, got, _ = _eager_then_captured(fn)
    assert mod.launches > n0
    assert all(torch.equal(g, ref) for g in got)


def test_g5_g6_raise_on_what_they_cannot_take(cuda):
    """No quiet plain version on the card: a wrong dtype, mixed devices,
    tensors on the CPU and a patch beyond the kernel's 1024 values
    raise."""
    cfg, grid, state = _merge_state(cuda, "scattered", 1, 3)
    with pytest.raises(ValueError):
        fb_merge.fb_merge(state._replace(cost_px=state.cost_px.double()),
                          grid, cfg, grid.height, grid.width)
    with pytest.raises(ValueError):
        fb_merge.fb_merge(state._replace(mid_org=state.mid_org.cpu()),
                          grid, cfg, grid.height, grid.width)
    with pytest.raises(ValueError):
        fb_merge.fb_merge(dis_mod.PatchState(*(
            None if x is None else x.cpu() for x in state)),
            grid, cfg, grid.height, grid.width)
    cfg, grid, st, I1p = _level_state(cuda, 56, 128, False)
    cfg = dataclasses.replace(cfg, cost_fn="huber")
    with pytest.raises(ValueError):
        dis_ref.optimize_reference(st._replace(H=st.H.cpu()), I1p, grid, cfg)
    with pytest.raises(ValueError):
        dis_ref.optimize_reference(dis_mod.PatchState(*(
            x.cpu() for x in st)), I1p.cpu(), grid, cfg)
    with pytest.raises(ValueError):
        stereo_mod._optimize_1d(st._replace(p_cur=st.p_cur.double()), I1p,
                                grid, cfg, 0)
    cfg, grid, st, I1p = _level_state(cuda, 56, 128, False, patch_size=20)
    with pytest.raises(ValueError, match="1024"):
        dis_ref.optimize_reference(st, I1p, grid,
                                   dataclasses.replace(cfg, cost_fn="l1"))


# --------------------------------------------------- traced twins (tracing)

LEAVES = profiling.LEAVES


def _tracing(on: bool):
    (profiling.enable if on else profiling.disable)()


def test_twin_replay_equals_plain_replay(cuda):
    """A traced call replays the twin: the same flow bit for bit as the
    plain graph's, one replay a call, its device spans read without a
    wait by the next call of a caller that reads each flow (synchronises),
    none dropped; on 124x256 frames (the in-graph pad and crop run)."""
    cfg = dataclasses.replace(port.operating_point(2, width=256),
                              coarsest_scale=4)
    i0, i1 = (torch.as_tensor(x, device=cuda) for x in
              synthetic_frames(3, 2, 124, 256, (2, 1), factor=4))
    graphs.clear()
    try:
        plain = [port.compute_flow(i0, i1, cfg) for _ in range(3)]
        _tracing(True)
        twin = []
        for _ in range(3):
            twin.append(port.compute_flow(i0, i1, cfg))
            torch.cuda.synchronize()
        _tracing(False)
        again = port.compute_flow(i0, i1, cfg)
        torch.cuda.synchronize()
        r = profiling.report()
    finally:
        _tracing(False)
        graphs.clear()
    assert all(torch.equal(t, plain[1]) for t in twin + [again, plain[2]])
    assert r["calls"] == 3 and r["modes"] == {"replay": 3}
    assert r["device_calls"] == 3 and r["dropped"] == r["pending"] == 0
    assert {"pad", "pyramid", "upsample", "scale 4", "opti"} <= set(
        r["device_ms"])
    assert all(v > 0 for k, v in r["device_ms"].items() if k != "pad")


def test_stream_switching_tracing_equals_untraced(cuda):
    """A stream that turns tracing on and off between steps yields the
    same flows as one that never traces; with ``fetch=True`` no reading
    is dropped."""
    cfg = dataclasses.replace(port.operating_point(2, width=256),
                              coarsest_scale=4)
    frames = [torch.as_tensor(f, device=cuda) for f in
              synthetic_frames(7, 9, 128, 256, (2, 1), factor=4)]
    graphs.clear()
    reports = []       # enable() starts the totals afresh: one a stretch
    try:
        ref = list(port.stream_flow(frames, cfg))
        got = []
        for k, flow in enumerate(port.stream_flow(iter(frames), cfg)):
            got.append(flow)
            if k % 3 == 1:
                _tracing(False)
                reports.append(profiling.report())
            elif not profiling.is_on():
                _tracing(True)
    finally:
        _tracing(False)
        graphs.clear()
    assert len(got) == len(ref) == 8
    assert all(np.array_equal(g, f) for g, f in zip(got, ref))
    assert sum(r["calls"] for r in reports) == 5      # frames 1, 3-4, 6-7
    for r in reports:
        assert r["dropped"] == 0 and r["pending"] == 0
        assert r["calls"] == r["device_calls"]
        assert r["modes"] == {"replay": r["calls"]}
        assert r["dtoh_bytes"] == r["calls"] * 128 * 256 * 2 * 4


def test_twin_leaves_add_up_to_first_to_last(cuda):
    """The leaves of a replayed twin share their boundary events, so
    their device ms add up to its first-to-last event time; each scale's
    span holds its five phases."""
    cfg = dataclasses.replace(port.operating_point(2, width=256),
                              coarsest_scale=4)
    i0, i1 = (torch.as_tensor(x, device=cuda) for x in
              synthetic_frames(3, 2, 124, 256, (2, 1), factor=4))
    graphs.clear()
    try:
        port.compute_flow(i0, i1, cfg)
        _tracing(True)
        port.compute_flow(i0, i1, cfg)
        torch.cuda.synchronize()
        r = profiling.report()
        (path,) = graphs._cache.values()
        ev = path.recording.twins[0][1].events
        total = ev[0].elapsed_time(ev[-1])
    finally:
        _tracing(False)
        graphs.clear()
    ms = r["device_ms"]
    leaves = sum(v for k, v in ms.items() if k in LEAVES)
    assert leaves == pytest.approx(total, rel=1e-5, abs=1e-4)
    for sl in range(cfg.coarsest_scale, cfg.finest_scale - 1, -1):
        assert ms[f"scale {sl}"] > 0
    scales = sum(v for k, v in ms.items() if k.startswith("scale "))
    phases = sum(ms[k] for k in ("extract", "coarse", "opti", "aggregate",
                                 "var_ref"))
    assert scales == pytest.approx(phases, rel=1e-5, abs=1e-4)


def test_captured_fb_stream_equals_eager(cuda):
    """An fb stream of uint8 host frames at op 4 (the backward chain starts
    cold on every frame) replays one graph a frame, bit for bit with the
    eager step; traced, its scales hold both directions' leaves and the
    merges, and each direction counts its patches on every replay."""
    cfg = dataclasses.replace(port.operating_point(4, width=256),
                              coarsest_scale=4, use_fb_consistency=True)
    u8 = _u8_frames(8, 7)
    graphs.clear()
    try:
        with graphs.eager():
            want = list(port.stream_flow(u8, cfg))
        stream = port.stream_flow(iter(u8), cfg)
        got = [next(stream) for _ in range(3)]
        _tracing(True)
        got += [next(stream) for _ in range(3)]
        torch.cuda.synchronize()
        _tracing(False)
        r = profiling.report()
        stream.close()
    finally:
        _tracing(False)
        graphs.clear()
    assert len(got) == len(want) == 6
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert r["modes"] == {"replay": 3}
    assert r["device_calls"] == 3 and r["dropped"] == 0
    n = sum(PatchGrid.create(cfg, 256 >> sl, 128 >> sl).n_patches
            for sl in range(cfg.finest_scale, cfg.coarsest_scale + 1))
    counters = r["counters"]
    assert {k: counters[k] for k in ("patches_fw", "patches_bw")} == {
        "patches_fw": 3 * n, "patches_bw": 3 * n}
    assert 0 < counters["gn_window_loads"] <= counters["gn_trips"]
    ms = r["device_ms"]
    assert {"extract_bw", "opti_bw", "fb_merge", "aggregate_bw",
            "var_ref_bw"} <= set(ms)
    scales = sum(v for k, v in ms.items() if k.startswith("scale "))
    inner = sum(v for k, v in ms.items() if k in LEAVES and k not in (
        "pyramid", "pad", "warm_start", "upsample"))
    assert scales == pytest.approx(inner, rel=1e-5, abs=1e-4)


# ------------------------------------------------- host frames and flows

def _u8_frames(seed, n, h=128, w=256):
    return [np.clip(np.round(f), 0, 255).astype(np.uint8)
            for f in synthetic_frames(seed, n, h, w, (2, 1), factor=4)]


@pytest.mark.parametrize("op", [2, 4])
def test_uint8_host_stream_equals_float32_host_stream(cuda, op):
    """uint8 numpy frames cross as uint8 and are converted on the card
    (op 4: in the graph at finest scale 0; op 2: K1 reads them): the
    flows of the same frames as float32, bit for bit."""
    cfg = dataclasses.replace(port.operating_point(op, width=256),
                              coarsest_scale=4)
    u8 = _u8_frames(5, 6)
    graphs.clear()
    try:
        got = list(port.stream_flow(u8, cfg))
        want = list(port.stream_flow([f.astype(np.float32) for f in u8],
                                     cfg))
        dtypes = sorted(str(p.frames.dtype) for p in graphs._cache.values())
    finally:
        graphs.clear()
    assert dtypes == ["torch.float32", "torch.uint8"]
    assert len(got) == 5
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_fetched_flow_is_pinned_and_the_callers_own(cuda):
    """A flow yielded with ``fetch=True`` lies in pinned memory and stays
    as it was while three later steps run."""
    cfg = dataclasses.replace(port.operating_point(2, width=256),
                              coarsest_scale=4)
    graphs.clear()
    try:
        stream = port.stream_flow(_u8_frames(6, 7), cfg)
        flows = [next(stream) for _ in range(2)]
        first = flows[-1]
        kept = first.copy()
        later = [next(stream) for _ in range(3)]
        stream.close()
    finally:
        graphs.clear()
    assert torch.from_numpy(first).is_pinned()
    assert all(torch.from_numpy(f).is_pinned() for f in later)
    assert np.array_equal(first, kept)
    assert first.ctypes.data not in {f.ctypes.data for f in later}


def test_pinned_bytes_count_the_pinned_crossings(cuda):
    """Traced small host frames and fetched flows: the frames go up
    pageable (a uint8 frame; a cold pair's two), the flows come down
    pinned, and the steady stream reuses its pinned blocks."""
    cfg = dataclasses.replace(port.operating_point(2, width=256),
                              coarsest_scale=4)
    frames = _u8_frames(7, 12)
    graphs.clear()
    try:
        stream = port.stream_flow(iter(frames), cfg)
        for _ in range(3):
            next(stream)
        _tracing(True)
        for _ in range(8):
            next(stream)
        _tracing(False)
        r = profiling.report()
        stream.close()
        port.compute_flow(*frames[:2], cfg)
        _tracing(True)
        for _ in range(3):
            port.compute_flow(*frames[:2], cfg)
        _tracing(False)
        pairs = profiling.report()
    finally:
        _tracing(False)
        graphs.clear()
    assert r["calls"] == 8
    assert r["htod_bytes"] == 8 * 128 * 256 * 3
    assert r["dtoh_bytes"] == 8 * 128 * 256 * 2 * 4
    assert r["pinned_bytes"] == r["dtoh_bytes"]
    assert r["pinned_blocks"] <= 2
    assert pairs["calls"] == 3 and pairs["dtoh_bytes"] == 0
    assert pairs["pinned_bytes"] == 0
    assert pairs["htod_bytes"] == 3 * 2 * 128 * 256 * 3


@pytest.mark.parametrize("case", ["small", "small strided", "small to float",
                                  "large", "large strided", "large to float"])
def test_copy_in_stages_every_form_exactly(cuda, case):
    """A host tensor reaches the card unchanged on both sides of
    ``PINNED_UPLOAD_BYTES`` (the plain copy below it, pinned staging by
    copy_ above it, a strided or converting copy too), and the counter
    sees the staged bytes alone cross pinned."""
    from flowonthego_tpu_torch.utils import device as device_mod
    n = device_mod.PINNED_UPLOAD_BYTES
    g = torch.Generator().manual_seed(3)
    large = case.startswith("large")
    rows = n // 3072 + (64 if large else -64)
    src = torch.randint(0, 256, (rows, 1024, 3), generator=g,
                        dtype=torch.uint8)
    dtype = torch.float32 if case.endswith("to float") else torch.uint8
    if case.endswith("strided"):
        src = src.transpose(0, 1)
    dst = torch.empty(src.shape, dtype=dtype, device=cuda)
    if dtype == torch.float32 and not large:
        rows = n // 12288 - 16                   # under the bound as float
        src, dst = src[:rows], dst[:rows]
    _tracing(True)
    try:
        with profiling.call():
            profiling._local.call.modes["eager"] += 1     # a call that launched
            device_mod.copy_in(dst, src)
        r = profiling.report()
    finally:
        _tracing(False)
    assert torch.equal(dst.cpu(), src.to(dtype))
    assert r["htod_bytes"] == dst.nbytes
    assert r["pinned_bytes"] == (dst.nbytes if large else 0)


def test_kept_flows_hold_at_most_the_pinned_bound(cuda, monkeypatch):
    """Fetched flows that the caller keeps stay pinned up to
    ``PINNED_FLOW_BYTES``; the next lands in pageable memory, and a
    dropped flow's bytes count no more."""
    from flowonthego_tpu_torch.utils import device as device_mod
    flow = torch.rand(64, 128, 2, device=cuda)
    held = device_mod._held
    monkeypatch.setattr(device_mod, "PINNED_FLOW_BYTES",
                        held + 2 * flow.nbytes)
    kept = [device_mod.to_host(flow) for _ in range(3)]
    assert [torch.from_numpy(f).is_pinned() for f in kept] == [
        True, True, False]
    assert all(np.array_equal(f, flow.cpu().numpy()) for f in kept)
    view = kept[0][..., 0]
    del kept[0]
    assert not torch.from_numpy(device_mod.to_host(flow)).is_pinned()
    del view
    again = device_mod.to_host(flow)
    assert torch.from_numpy(again).is_pinned()
    del kept, again
    assert device_mod._held == held
