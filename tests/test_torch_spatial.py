"""The port's spatial multi-device forms (``parallel/halo.py``,
``spatial.py``, ``spatial_fine.py``, ``spatial_tile2d.py``,
``varref_sharded.py``, ``varref_tiled2d.py``), K2's strip sample offset
and ``ops/resize.resize_rows_strip``, against the JAX package on the
conftest's virtual CPU devices.

The JAX functions run in ``shard_map`` over 4 or 8 virtual devices as the
JAX package's own tests run them; the port runs the same mesh shape over
``"cpu"`` repeated (its shards are a list on one device).  Each JAX
spatial program costs seconds to compile on the CPU, so each is called
once, in a module-scoped fixture.  Tolerances, with their reasons:

* halo primitives: bit for bit (pure copies and the same adds in the
  same order);
* ``resize_rows_strip``: <= 1e-6 (the same gather blend);
* the offset solve: p rtol = atol = 1e-4, cost_px rtol = atol = 1e-3, as
  tests/test_torch_kernels.py (the sums run in another order);
* the sharded var-ref: rtol 1e-4, atol 1e-5, the var-ref tolerance;
* end to end: the JAX package's own bars against its unsharded pipeline
  (strips rtol = atol = 1e-3, tiles q50 < 5e-4, q95 < 5e-3, max < 0.05,
  replicate-coarse rtol = atol = 1e-4), and the violation counts equal.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P
from scipy.ndimage import gaussian_filter

from flowonthego_tpu.config import DISConfig as JaxConfig
from flowonthego_tpu.ops import dis as jdis
from flowonthego_tpu.ops import patches as jpatches
from flowonthego_tpu.ops import pyramid as jpyramid
from flowonthego_tpu.ops import resize as jresize
from flowonthego_tpu.parallel import halo as jhalo
from flowonthego_tpu.parallel import make_mesh as jax_make_mesh
from flowonthego_tpu.parallel import spatial as jspatial
from flowonthego_tpu.parallel import spatial_fine as jsf
from flowonthego_tpu.parallel import spatial_tile2d as jst
from flowonthego_tpu.parallel import varref_sharded as jvs
from flowonthego_tpu.parallel import varref_tiled2d as jvt

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch import parallel as pp
from flowonthego_tpu_torch.convert import config_from_jax, patch_state_from_numpy
from flowonthego_tpu_torch.ops import dis as pdis
from flowonthego_tpu_torch.ops import patches as ppatches
from flowonthego_tpu_torch.ops import resize as presize
from flowonthego_tpu_torch.ops.cuda import dis_gn
from flowonthego_tpu_torch.parallel import mesh as pmesh
from flowonthego_tpu_torch.parallel import spatial as pspatial
from flowonthego_tpu_torch.parallel import spatial_fine as psf
from flowonthego_tpu_torch.utils import graphs
from test_torch_graphs import fixed_tensors

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")


def _t(x):
    return torch.as_tensor(np.array(x))


def _pcfg(jc, **fields):
    return dataclasses.replace(config_from_jax(dataclasses.asdict(jc)),
                               **fields)


def _smooth(seed, h, w, c=3, sigma=3.0):
    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.standard_normal((h, w, c)).astype(np.float32),
                           sigma=(sigma, sigma, 0)) * 120 + 128


def _cpu(n):
    return ["cpu"] * n


# ------------------------------------------------------------------ meshes

def test_tile_mesh_shape_and_errors():
    """make_tile_mesh: the JAX package's axes, arrangement and error; the
    same device may stand at several positions; Mesh.shape follows the
    mesh's own axis names."""
    jm = jvt.make_tile_mesh(2, 4, devices=jax.devices()[:8])
    pm = pp.make_tile_mesh(2, 4, devices=_cpu(8))
    assert dict(jm.shape) == pm.shape == {"rows": 2, "cols": 4}
    assert tuple(jm.axis_names) == pm.axis_names == (pp.ROW_AXIS, pp.COL_AXIS)
    assert pm.one_device and len(pm.flat_devices) == 8
    with pytest.raises(ValueError, match="tile mesh != 8 devices"):
        pp.make_tile_mesh(3, 3, devices=_cpu(8))
    with pytest.raises(ValueError, match="tile mesh != 8 devices"):
        jvt.make_tile_mesh(3, 3, devices=jax.devices()[:8])
    two = pmesh.Mesh(((torch.device("cuda", 0), torch.device("cuda", 1)),))
    assert not two.one_device


def test_spatial_entry_is_chosen_by_the_mesh():
    """One device at every position: the captured entry; several cards:
    the eager one, with its reason in the table."""
    one = pp.make_mesh(n_space=2, devices=["cuda:0", "cuda:0"])
    two = pp.make_mesh(n_space=2, devices=["cuda:0", "cuda:1"])
    assert pspatial.spatial_entry(one) == "spatial_flow"
    assert pspatial.spatial_entry(two) == "spatial_flow_devices"
    assert graphs.ENTRIES["spatial_flow"] is None
    assert "several" in graphs.ENTRIES["spatial_flow_devices"]
    assert graphs.enabled("spatial_flow", "cuda")
    assert not graphs.enabled("spatial_flow_devices", "cuda")


@pytest.mark.parametrize("op,H,W,n", [
    (1, 2304, 3840, 2), (3, 2304, 3840, 2), (4, 2304, 3840, 2),
    (4, 2304, 3840, 4), (4, 1152, 1920, 2), (2, 2176, 3840, 2)])
def test_scale_levels_match_jax(op, H, W, n):
    """Which scales shard, on strips and on 2x2 tiles (the 4K table of
    the port's notes), and the displacement bound at every scale."""
    from flowonthego_tpu.config import operating_point as jop
    jc = jop(op, width=W)
    pc = port.operating_point(op, width=W)
    assert pp.sharded_scale_levels(pc, H, n) == jsf.sharded_scale_levels(
        jc, H, n)
    assert pp.tiled2d_scale_levels(pc, H, W, n, n) == \
        jst.tiled2d_scale_levels(jc, H, W, n, n)
    for sl in range(jc.finest_scale, jc.coarsest_scale + 1):
        assert pp.displacement_bound(pc, sl) == jsf.displacement_bound(jc, sl)


# ------------------------------------------------------------------ halo

def _jax_line(fn, x, n, axis):
    """``fn`` in shard_map over n virtual devices, x split along ``axis``."""
    mesh = JaxMesh(np.asarray(jax.devices()[:n]).reshape(1, n), ("r", "c"))
    spec = P(*([None] * axis + ["c"]))
    run = jax.jit(shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec))
    return np.asarray(run(jnp.asarray(x)))


@pytest.mark.parametrize("n", [4, 1])
@pytest.mark.parametrize("kind,mode", [
    ("rows", "edge"), ("rows", "zero"), ("cols", "edge"), ("cols", "zero"),
    ("acc_rows", None), ("acc_cols", None)])
def test_halo_matches_jax_bit_for_bit(n, kind, mode):
    rng = np.random.default_rng(7)
    halo = 2
    axis = 0 if kind.endswith("rows") else 1
    per = 8 + (2 * halo if kind.startswith("acc") else 0)
    shape = [3, 5, 2]
    shape[axis] = n * per
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "rows":
        jfn = partial(jhalo.exchange_rows, halo=halo, axis_name="c",
                      mode=mode)
        pfn = partial(pp.exchange_rows, halo=halo, mode=mode)
    elif kind == "cols":
        jfn = partial(jhalo.exchange_cols, halo=halo, axis_name="c",
                      mode=mode)
        pfn = partial(pp.exchange_cols, halo=halo, mode=mode)
    elif kind == "acc_rows":
        jfn = partial(jhalo.exchange_accumulate_rows, halo=halo,
                      axis_name="c")
        pfn = partial(pp.exchange_accumulate_rows, halo=halo)
    else:
        jfn = partial(jhalo.exchange_accumulate_cols, halo=halo,
                      axis_name="c")
        pfn = partial(pp.exchange_accumulate_cols, halo=halo)
    ref = _jax_line(jfn, x, n, axis)
    got = torch.cat(pfn(list(_t(x).chunk(n, dim=axis))), dim=axis).numpy()
    np.testing.assert_array_equal(got, ref)


def test_all_gather_and_total():
    xs = [torch.full((2, 3), float(k)) for k in range(4)]
    out = pp.all_gather(xs, dim=0)
    assert len(out) == 4 and all(o is out[0] for o in out)
    assert torch.equal(out[0], torch.cat(xs))
    from flowonthego_tpu_torch.parallel.halo import total
    assert int(total([torch.tensor(k, dtype=torch.int32)
                      for k in range(4)])) == 6


# ------------------------------------------------------------------ resize

@pytest.mark.parametrize("scale,row_start", [(2.0, 0), (4.0, 24), (8.0, 40)])
def test_resize_rows_strip_matches_jax(scale, row_start):
    rng = np.random.default_rng(3)
    img = (rng.standard_normal((12, 10, 2)) * 3).astype(np.float32)
    rows, out_w = 16, int(10 * scale)
    ref = np.asarray(jresize.resize_rows_strip(jnp.asarray(img), scale, scale,
                                               row_start, rows, out_w))
    got = presize.resize_rows_strip(_t(img)[None], scale, scale, row_start,
                                    rows, out_w)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ------------------------------------------------------------ K2's offset

def _block_case(cost_fn, gd_iter=12):
    """A warm-started 64x80 scale; the patch block of grid rows 4-9 and
    columns 3-11 with a target cut to the rows and columns it can reach:
    (jax config, grid, block state, full padded target, the cut (r0, r1,
    c0, c1))."""
    jc = JaxConfig(coarsest_scale=1, finest_scale=1,
                   grad_descent_iter=gd_iter, cost_fn=cost_fn)
    rng = np.random.default_rng(11)
    base = _smooth(11, 80, 96, sigma=4.0)
    i0, i1 = base[8:72, 8:88], base[10:74, 5:85]           # moved (3, -2)
    h, w = i0.shape[:2]
    grid = jpatches.PatchGrid.create(jc, w, h)
    lvl = jpyramid.build_pyramid(jnp.asarray(i0), 1, jc.padding)[0]
    state = jdis.init_state(*jpatches.extract_templates_and_hessians(
        *lvl, grid, jc), grid)
    coarse = rng.standard_normal((h // 2, w // 2, 2)).astype(np.float32) * 1.5
    state = jdis.init_from_coarser(state, jnp.asarray(coarse), grid)
    block = jdis.PatchState(*(x[4:10, 3:12] for x in state))
    I1p = np.asarray(jpyramid.pad_replicate(jnp.asarray(i1), jc.padding))
    return jc, grid, block, I1p, (14, 70, 6, 82)


@pytest.mark.parametrize("cost_fn", ["l2", "l1"])
def test_offset_solve_matches_jax(cost_fn):
    """``optimize(..., sample_offset)`` on a cut of the padded target, the
    midpoints global: against the JAX package's XLA loop on the same cut
    (l2: the fixed-trip solve, K2's plain version; l1: the reference-form
    solve), and against the port's own solve on the whole target, where
    the cut holds every window the patches read (bit for bit).

    l1 as tests/test_torch_modes.py holds the reference-form solve: its
    residual sign(d) sqrt|d| has an infinite slope at 0 and its solve does
    not contract an ulp of it, so p is held at atol 1e-3 and cost_px as
    x|x| at rtol 1e-3 / atol 2e-3, over 8 iterations (at 12 the unsharded
    solves of the two packages already drift 1.3e-3 px apart on this
    scene, with or without the offset)."""
    robust = cost_fn != "l2"
    jc, grid, block, I1p, (r0, r1, c0, c1) = _block_case(
        cost_fn, 8 if robust else 12)
    cut = I1p[r0:r1, c0:c1]
    off = (float(-c0), float(-r0))
    ref = jdis.optimize(block, jnp.asarray(cut), grid, jc,
                        sample_offset=jnp.asarray(off, jnp.float32))
    pc = _pcfg(jc)
    pgrid = ppatches.PatchGrid.create(pc, grid.width, grid.height)
    pstate = patch_state_from_numpy(
        {k: np.asarray(v) for k, v in block._asdict().items()})
    got = pdis.optimize(pstate, _t(cut)[None], pgrid, pc, sample_offset=off)
    np.testing.assert_allclose(got.p_cur[0].numpy(), np.asarray(ref.p_cur),
                               rtol=1e-4, atol=1e-3 if robust else 1e-4)
    a = got.cost_px[0].numpy().astype(np.float64)
    b = np.asarray(ref.cost_px, np.float64)
    if robust:
        a, b = a * np.abs(a), b * np.abs(b)
    np.testing.assert_allclose(a, b, rtol=1e-3,
                               atol=2e-3 if robust else 1e-3)
    whole = pdis.optimize(pstate, _t(I1p)[None], pgrid, pc)
    assert torch.equal(whole.p_cur, got.p_cur)
    assert torch.equal(whole.cost_px, got.cost_px)
    # some patches moved, some were frozen or reset
    assert (got.p_cur - pstate.p_cur).abs().max() > 1e-2


def test_gn_plain_offset_is_a_shift_of_the_image():
    """K2's wrapper on CPU tensors (its plain version) with an offset
    reads at (mid + p) + offset: on the image with its first 5 rows and 7
    columns cut off, offset (-7, -5) gives the solve without the offset on
    the whole image, bit for bit (subtracting a whole number that keeps a
    positive coordinate positive is exact in float32)."""
    jc, grid, block, I1p, _ = _block_case("l2")
    st = patch_state_from_numpy(
        {k: np.asarray(v) for k, v in block._asdict().items()})
    kw = dict(n_iters=12, padding=grid.padding, thresh=jc.outlier_thresh,
              l_bound=grid.l_bound, ub_w=grid.u_bound_w, ub_h=grid.u_bound_h,
              mean_on=1.0)
    args = (st.templates, st.tgrad_x, st.tgrad_y, st.H, st.mid_org, st.p_cur,
            st.p_org, ~st.converged)
    img = _t(I1p)[None]
    p, cost = dis_gn.gn_scale_loop_plain(img, *args, **kw)
    p2, cost2 = dis_gn.gn_scale_loop(img[:, 5:, 7:].contiguous(), *args,
                                     **kw, offset=(-7.0, -5.0))
    assert torch.equal(p, p2) and torch.equal(cost, cost2)


# ------------------------------------------------------------ sharded var-ref

def _varref_problem(H=64, W=96, C=3, seed=0):
    rng = np.random.default_rng(seed)
    im1 = rng.uniform(0, 255, (H, W, C)).astype(np.float32)
    im2 = (np.roll(im1, (2, -3), axis=(0, 1))
           + rng.normal(0, 2.0, (H, W, C))).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    u = 3.0 * np.sin(yy / 17.0) + 1.5 * np.cos(xx / 23.0)
    v = -2.0 * np.cos(yy / 13.0) + 1.0 * np.sin(xx / 29.0)
    return np.stack([u, v], -1).astype(np.float32), im1, im2


def test_varref_sharded_matches_jax():
    """4 strips, level 2, a halo covering the flow."""
    flow, im1, im2 = _varref_problem()
    H = flow.shape[0]
    jc = JaxConfig(varref_backend="xla")
    level, n = 2, 4
    hl = H // n
    halo = int(np.ceil(np.abs(flow).max())) + 2
    mesh = jax_make_mesh(n_data=1, n_space=n, devices=jax.devices()[:n])

    def worker(f, a, b):
        return jvs.variational_refine_sharded(
            f, a, b, jc, level, "space", jax.lax.axis_index("space"), hl, H,
            halo)

    ref = np.asarray(jax.jit(shard_map(
        worker, mesh=mesh, in_specs=(P("space"),) * 3,
        out_specs=P("space")))(*map(jnp.asarray, (flow, im1, im2))))
    strips = [[x[None] for x in _t(a).chunk(n, dim=0)]
              for a in (flow, im1, im2)]
    got = pp.variational_refine_sharded(*strips, _pcfg(jc), level, H, halo)
    got = torch.cat(got, dim=1)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_varref_tile_matches_jax():
    """A 2x4 tile mesh, level 2, through make_tiled_varref on both sides;
    the port's tile warp at the tile (1, 2) against JAX's."""
    flow, im1, im2 = _varref_problem()
    H, W = flow.shape[:2]
    jc = JaxConfig(varref_backend="xla")
    halo = int(np.ceil(np.abs(flow).max())) + 2
    jm = jvt.make_tile_mesh(2, 4, devices=jax.devices()[:8])
    ref = np.asarray(jax.jit(jvt.make_tiled_varref(jm, jc, 2, H, W, halo))(
        *map(jnp.asarray, (flow, im1, im2))))
    fn = pp.make_tiled_varref(pp.make_tile_mesh(2, 4, devices=_cpu(8)),
                              _pcfg(jc), 2, H, W, halo)
    np.testing.assert_allclose(fn(flow, im1, im2).numpy(), ref, rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        pp.make_tiled_varref(pp.make_tile_mesh(2, 4, devices=_cpu(8)),
                             _pcfg(jc), 1, 63, 96, 4)
    # the warp alone, tile (1, 2) of 32x24 with its halo
    from flowonthego_tpu_torch.parallel.varref_tiled2d import warp_tile
    hl, wl = H // 2, W // 4
    pad = np.pad(im2, ((halo, halo), (halo, halo), (0, 0)), mode="edge")
    tile = pad[hl:hl + hl + 2 * halo, 2 * wl:2 * wl + wl + 2 * halo]
    f = flow[hl:2 * hl, 2 * wl:3 * wl]
    jw, jmask = jvt.warp_tile(jnp.asarray(tile), jnp.asarray(f[..., 0]),
                              jnp.asarray(f[..., 1]), halo, 1, 2, hl, wl, H,
                              W)
    pw, pmask = warp_tile(_t(tile)[None], _t(f[..., 0])[None],
                          _t(f[..., 1])[None], halo, 1, 2, hl, wl, H, W)
    np.testing.assert_array_equal(pw[0].numpy(), np.asarray(jw))
    np.testing.assert_array_equal(pmask[0].numpy(), np.asarray(jmask))


# ------------------------------------------------------------ end to end

FINE_CFG = dict(patch_size=8, patch_stride=0.4, coarsest_scale=2,
                finest_scale=1, grad_descent_iter=8)
# (JAX config fields, H, W, vertical roll, horizontal roll, halo_slack)
FINE_CASES = {
    "var-ref": (dict(FINE_CFG, use_var_ref=True), 512, 64, 1, 2, None),
    "fb": (dict(FINE_CFG, use_var_ref=False, use_fb_consistency=True), 256,
           64, 1, 2, None),
    "starved": (dict(FINE_CFG, use_var_ref=False), 256, 64, 6, 0, -6),
    "fb-starved": (dict(FINE_CFG, use_var_ref=False, use_fb_consistency=True),
                   256, 64, 6, 0, -6),
}


def _fine_pair(name):
    _, H, W, dy, dx, _ = FINE_CASES[name]
    I0 = _smooth(21, H, W)
    return I0, np.roll(np.roll(I0, dx, axis=1), dy, axis=0)


@pytest.fixture(scope="module")
def jax_fine():
    """The JAX package's make_fine_spatial_flow on 4 virtual devices, once
    per case: {case: (flow, violations)}."""
    mesh = jax_make_mesh(n_data=1, n_space=4, devices=jax.devices()[:4])
    out = {}
    for name, (fields, H, W, _, _, slack) in FINE_CASES.items():
        fn = jsf.make_fine_spatial_flow(mesh, JaxConfig(**fields), H, W,
                                        halo_slack=slack)
        flow, viol = fn(*map(jnp.asarray, _fine_pair(name)))
        out[name] = (np.asarray(flow), int(viol))
    return out


@pytest.mark.parametrize("name", ["var-ref", "fb", "starved", "fb-starved"])
def test_fine_spatial_flow_matches_jax(jax_fine, name):
    """4 strips at the JAX package's test geometry; the count equals
    JAX's (0 where the halo holds, > 0 where halo_slack starves it)."""
    fields, H, W, _, _, slack = FINE_CASES[name]
    pc = _pcfg(JaxConfig(**fields))
    mesh = pp.make_mesh(n_data=1, n_space=4, devices=_cpu(4))
    if slack is None:
        assert 1 in pp.sharded_scale_levels(pc, H, 4)
    flow, viol = pp.make_fine_spatial_flow(mesh, pc, H, W, halo_slack=slack)(
        *_fine_pair(name))
    ref, ref_viol = jax_fine[name]
    assert viol.dtype == torch.int32 and int(viol) == ref_viol
    if slack is None:
        assert ref_viol == 0
        np.testing.assert_allclose(flow.numpy(), ref, rtol=1e-3, atol=1e-3)
    else:
        assert ref_viol > 0


@pytest.mark.parametrize("name", ["starved", "fb-starved"])
def test_fine_recovering_returns_the_unsharded_flow(name):
    """A starved halo (with fb: patches whose merge scatter reaches beyond
    the strip's accumulator, test above, are counted too): the recovering
    form returns the port's unsharded flow bit for bit (and the count); a
    healthy one (without fb) the sharded flow."""
    fields, H, W, _, _, slack = FINE_CASES[name]
    pc = _pcfg(JaxConfig(**fields))
    mesh = pp.make_mesh(n_data=1, n_space=4, devices=_cpu(4))
    I0, I1 = _fine_pair(name)
    flow, viol = pp.make_fine_spatial_flow_recovering(
        mesh, pc, H, W, halo_slack=slack)(I0, I1)
    assert int(viol) > 0
    full = port.flow_full_padded(_t(I0), _t(I1), pc)
    assert torch.equal(flow, full)
    ok, viol_ok = pp.make_fine_spatial_flow_recovering(mesh, pc, H, W)(I0, I1)
    if pc.use_fb_consistency:
        # the fb count takes every patch's merge position, converged or
        # not: at this motion the default halo is short too, and recovers
        assert int(viol_ok) > 0 and torch.equal(ok, full)
        return
    assert int(viol_ok) == 0
    sharded, _ = pp.make_fine_spatial_flow(mesh, pc, H, W)(I0, I1)
    assert torch.equal(ok, sharded)
    np.testing.assert_allclose(ok.numpy(), full.numpy(), rtol=1e-3, atol=1e-3)


def test_fb_merge_cell_above_the_accumulator():
    """The one place the strip fb merge knowingly differs from the JAX
    package: a scatter cell one row above a strip's accumulator.  JAX's
    linear index goes negative there and wraps to the accumulator's last
    row, whose margin folds into the next strip; the port drops the cell.

    3 strips of 32 rows, margin 6; one patch of strip 1 lies with its top
    scatter row on the accumulator's first row, so its lower corners'
    cells reach the row above.  Every other patch lies left of the image
    (dropped by the validity box on both sides).  The two merges agree
    everywhere but on global row 2*32 + 6 - 1, where only JAX holds the
    wrapped cells; and the patch's rows reach beyond the rows the
    violation count provisions (those lie ``pad`` rows inside the
    accumulator's), so both packages count it and the recovering forms
    recompute the frame unsharded (test below)."""
    n, hl, margin, n_loc, n_w = 3, 32, 6, 2, 3
    jc = JaxConfig(patch_size=8, coarsest_scale=1, finest_scale=1,
                   use_fb_consistency=True)
    grid = jpatches.PatchGrid.create(jc, 32, n * hl)
    ps = grid.patch_size
    rng = np.random.default_rng(13)
    p = np.full((n * n_loc, n_w, 2), -1000.0, np.float32)
    py = 29.5                     # strip 1, top scatter row 26 = 32 - 6
    p[n_loc, 1] = (15.25, py)
    assert np.ceil(py + 1e-5) - ps // 2 == 1 * hl - margin
    assert py - ps // 2 - 1 < 1 * hl - margin    # the count's window edge
    zeros = np.zeros((n * n_loc, n_w, 2), np.float32)
    cost = rng.uniform(0.5, 2.0, (n * n_loc, n_w, ps, ps, 3)).astype(
        np.float32)
    fields = dict(p_cur=p, p_org=zeros, mid_org=zeros,
                  H=np.ones((n * n_loc, n_w, 3), np.float32),
                  templates=cost, tgrad_x=cost, tgrad_y=cost,
                  converged=np.ones((n * n_loc, n_w), bool), cost_px=cost,
                  diff=cost)
    jstate = jdis.PatchState(**{k: jnp.asarray(v) for k, v in fields.items()})
    mesh = JaxMesh(np.asarray(jax.devices()[:n]), ("c",))

    def worker(st):
        return jsf._fb_merge_strip(st, grid, jc, hl, margin,
                                   jax.lax.axis_index("c"), "c")

    ref = np.asarray(jax.jit(shard_map(worker, mesh=mesh, in_specs=(P("c"),),
                                       out_specs=P("c")))(jstate))
    pc = _pcfg(jc)
    pgrid = ppatches.PatchGrid.create(pc, 32, n * hl)
    pstate = patch_state_from_numpy(fields)
    valid = torch.ones((1, n_loc, 1), dtype=torch.bool)
    accs = [psf.merge_block(
        pdis.PatchState(*(x[:, i * n_loc:(i + 1) * n_loc] for x in pstate)),
        pgrid, pc, hl + 2 * margin, 32, i * hl - margin, 0, valid)
        for i in range(n)]
    got = torch.cat(pp.exchange_accumulate_rows(accs, margin, dim=1),
                    dim=1)[0].numpy()
    wrapped = 2 * hl + margin - 1
    others = np.arange(n * hl) != wrapped
    np.testing.assert_allclose(got[others], ref[others], rtol=1e-6,
                               atol=1e-6)
    assert got[others][..., 0].sum() > 0        # the patch merged, both sides
    assert not got[wrapped].any()                # the port dropped the cells
    # JAX wrapped the patch's top row of the two lower corners: ps + 1 cells
    assert (ref[wrapped][..., 0] > 0).sum() == ps + 1


TILE_H, TILE_W = 160, 320


def _tile_pair():
    base = _smooth(23, TILE_H + 16, TILE_W + 16)
    return base[:TILE_H, :TILE_W], base[3:3 + TILE_H, 2:2 + TILE_W]


@pytest.fixture(scope="module")
def jax_tile():
    jc = JaxConfig(coarsest_scale=2, finest_scale=1, grad_descent_iter=8,
                   use_var_ref=True)
    mesh = jvt.make_tile_mesh(2, 4, devices=jax.devices()[:8])
    flow, viol = jst.make_tile2d_flow(mesh, jc, TILE_H, TILE_W)(
        *map(jnp.asarray, _tile_pair()))
    return jc, np.asarray(flow), int(viol)


def test_tile2d_flow_matches_jax(jax_tile):
    """2x4 tiles at the JAX package's test geometry: its bar (q50 < 5e-4,
    q95 < 5e-3, max < 0.05: an ulp can flip a marginal outlier reset,
    which var-ref then diffuses), count 0 on both sides; the recovering
    form passes the tiled flow through, and a starved halo recovers to
    the unsharded flow."""
    jc, ref, ref_viol = jax_tile
    pc = _pcfg(jc)
    mesh = pp.make_tile_mesh(2, 4, devices=_cpu(8))
    assert 1 in pp.tiled2d_scale_levels(pc, TILE_H, TILE_W, 2, 4)
    A, B = _tile_pair()
    flow, viol = pp.make_tile2d_flow(mesh, pc, TILE_H, TILE_W)(A, B)
    assert int(viol) == ref_viol == 0
    d = np.abs(flow.numpy() - ref)
    q50, q95 = float(np.quantile(d, 0.5)), float(np.quantile(d, 0.95))
    assert q50 < 5e-4 and q95 < 5e-3 and float(d.max()) < 0.05, \
        (q50, q95, float(d.max()))
    rec, viol = pp.make_tile2d_flow_recovering(mesh, pc, TILE_H, TILE_W)(A, B)
    assert int(viol) == 0 and torch.equal(rec, flow)
    rec, viol = pp.make_tile2d_flow_recovering(
        mesh, pc, TILE_H, TILE_W, halo_slack=-9)(A, np.roll(A, 9, axis=0))
    assert int(viol) > 0
    assert torch.equal(rec, port.flow_full_padded(
        _t(A), _t(np.roll(A, 9, axis=0)), pc))


def test_spatial_flow_matches_jax():
    """Replicate-coarse on 8 strips (tests/test_sharding.py's geometry)
    against JAX's make_spatial_flow at its bar, rtol = atol = 1e-4; the
    batch form on a 2x2 (data x space) mesh against batched_flow."""
    jc = JaxConfig(coarsest_scale=4, finest_scale=2, use_var_ref=True,
                   grad_descent_iter=8)
    h, w = 128, 64
    I0 = _smooth(25, h, w)
    I1 = np.roll(I0, 2, axis=1)
    ref = np.asarray(jspatial.make_spatial_flow(
        jax_make_mesh(n_data=1, n_space=8), jc, h, w)(jnp.asarray(I0),
                                                      jnp.asarray(I1)))
    pc = _pcfg(jc)
    got = pp.make_spatial_flow(pp.make_mesh(n_space=8, devices=_cpu(8)), pc,
                               h, w)(I0, I1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    batch = (np.stack([I0, I1]), np.stack([I1, I0]))
    got = pp.make_batch_spatial_flow(
        pp.make_mesh(n_data=2, n_space=2, devices=_cpu(4)), pc, h, w)(*batch)
    want = port.batched_flow(*batch, pc, device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="must satisfy"):
        pp.make_spatial_flow(pp.make_mesh(n_space=8, devices=_cpu(8)), pc,
                             100, w)


def test_captured_protocol_equals_eager():
    """Through the fixed-tensor protocol of the captured path (a stand-in
    for the CUDA graph, tests/test_torch_graphs.py): the strip, tile and
    replicate-coarse forms equal their eager calls bit for bit, and a
    returned flow is the caller's own."""
    pc = port.DISConfig(**dict(FINE_CFG, use_var_ref=True))
    H, W = 512, 64
    I0, I1 = (_t(x) for x in _fine_pair("var-ref"))
    assert pp.tiled2d_scale_levels(pc, H, W, 4, 1)
    forms = [
        pp.make_fine_spatial_flow(pp.make_mesh(n_space=4, devices=_cpu(4)),
                                  pc, H, W),
        pp.make_tile2d_flow(pp.make_tile_mesh(4, 1, devices=_cpu(4)), pc,
                            H, W, with_diagnostics=False),
        pp.make_spatial_flow(pp.make_mesh(n_space=4, devices=_cpu(4)), pc,
                             H, W)]
    for fn in forms:
        with graphs.eager():
            ref = fn(I0, I1)
        with fixed_tensors():
            graphs.clear()
            got = [fn(I0, I1) for _ in range(3)]
            assert [e for e, _ in graphs.cached_paths()] == ["spatial_flow"]
        graphs.clear()
        for out in got:
            for a, b in zip(*((out, ref) if isinstance(ref, tuple)
                              else ((out,), (ref,)))):
                assert torch.equal(a, b)
        first = got[0][0] if isinstance(ref, tuple) else got[0]
        second = got[1][0] if isinstance(ref, tuple) else got[1]
        assert first.data_ptr() != second.data_ptr()
