"""The port's data-parallel forms over a list of devices
(``parallel/mesh.py``, ``make_data_parallel_flow``, ``MultiStream`` and
``stream_video_chunks`` with ``devices=[...]``) against the JAX package on
the conftest's virtual CPU mesh.

Here every device of the list is the CPU, so the port's shards run one
after the other; what is checked is the splitting, the order and that
nothing crosses a shard: each shard's flows must equal the one-device
result on that shard's frames bit for bit (the same ops on the same
shapes), and the whole must lie within the band of JAX's sharded program
(mean endpoint difference <= 1e-3 px, 99th percentile <= 1e-2 px, as
tests/test_torch_slice.py).  Tiny sizes: 48x64 frames, coarsest_scale 3,
finest_scale 1, 4 Gauss-Newton iterations, inputs from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowonthego_tpu.config import DISConfig as JaxConfig
from flowonthego_tpu.parallel import make_mesh as jax_make_mesh
from flowonthego_tpu.parallel import frame_parallel as jfp
from flowonthego_tpu.parallel import mesh as jmesh
from flowonthego_tpu.parallel import multistream as jms

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch.convert import config_from_jax
from flowonthego_tpu_torch.parallel import mesh as pmesh
from flowonthego_tpu_torch.utils import graphs
from flowonthego_tpu_torch.utils.synth import synthetic_frames
from test_torch_graphs import fixed_tensors
from test_torch_slice import assert_flow_band

torch.set_num_threads(1)

H, W = 48, 64
JCFG = JaxConfig(coarsest_scale=3, finest_scale=1, grad_descent_iter=4,
                 use_var_ref=True)
SHIFTS = ((2, 1), (-2, 2), (4, -2), (0, 2))
CPU = torch.device("cpu")


def _pcfg():
    return config_from_jax(dataclasses.asdict(JCFG))


def _video(seed, n, shift):
    return np.stack(synthetic_frames(seed, n, H, W, shift, factor=4))


def _pairs():
    pairs = [_video(11 + b, 2, s) for b, s in enumerate(SHIFTS)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


# ----------------------------------------------------------------------- mesh

def test_make_mesh_shapes_and_errors():
    """The JAX package's arrangement, axis names and ValueError."""
    jm = jax_make_mesh(n_data=2, n_space=2, devices=jax.devices()[:4])
    pm = port.make_mesh(n_data=2, n_space=2, devices=["cpu"] * 4)
    assert dict(jm.shape) == pm.shape == {"data": 2, "space": 2}
    assert tuple(jm.axis_names) == pm.axis_names == (pmesh.DATA_AXIS,
                                                     pmesh.SPACE_AXIS)
    assert (pmesh.DATA_AXIS, pmesh.SPACE_AXIS) == (jmesh.DATA_AXIS,
                                                   jmesh.SPACE_AXIS)
    assert port.make_mesh(devices=["cpu"] * 3).shape == {"data": 3,
                                                         "space": 1}
    assert port.make_mesh(n_space=2, devices=["cpu"] * 4).shape["data"] == 2
    assert pm.devices[1][0] == CPU
    for kw in (dict(n_data=3, devices=["cpu"] * 4),
               dict(n_data=2, n_space=3, devices=["cpu"] * 4)):
        with pytest.raises(ValueError, match="mesh != 4 devices"):
            port.make_mesh(**kw)
        with pytest.raises(ValueError, match="mesh != 4 devices"):
            jax_make_mesh(**dict(kw, devices=jax.devices()[:4]))
    # no visible GPU here: the default device list is empty and refused
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            port.make_mesh()


def test_shardings_split_like_jax():
    """Each description cuts an array as JAX's NamedSharding places it:
    the pieces, in device order, are the addressable shards' data."""
    jm = jax_make_mesh(n_data=2, n_space=2, devices=jax.devices()[:4])
    pm = port.make_mesh(n_data=2, n_space=2, devices=["cpu"] * 4)
    x = np.arange(4 * 6 * 5, dtype=np.float32).reshape(4, 6, 5)
    for jsh, psh in ((jmesh.batch_sharding(jm), pmesh.batch_sharding(pm)),
                     (jmesh.batch_space_sharding(jm),
                      pmesh.batch_space_sharding(pm)),
                     (jmesh.replicated(jm), pmesh.replicated(pm))):
        placed = jax.device_put(jnp.asarray(x), jsh)
        by_device = {s.device: np.asarray(s.data)
                     for s in placed.addressable_shards}
        pieces = psh.shards(torch.as_tensor(x))
        devices = ([row[0] for row in jm.devices]
                   if psh.spec == (pmesh.DATA_AXIS,)
                   else list(jm.devices.flat))
        assert len(pieces) == len(psh.devices) == len(devices)
        for piece, d in zip(pieces, devices):
            np.testing.assert_array_equal(piece.numpy(), by_device[d])
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.batch_sharding(pm).shards(torch.zeros(3, 2))


# ------------------------------------------------------- data-parallel flow

@pytest.mark.parametrize("full_res", [True, False])
def test_data_parallel_flow_matches_jax(full_res):
    """4 pairs over 2 'data' devices: every shard equals ``batched_flow``
    on its own two pairs bit for bit, and the whole lies within the band
    of JAX's sharded program on a 2-device virtual mesh."""
    cfg = _pcfg()
    I0, I1 = _pairs()
    fn = port.make_data_parallel_flow(
        port.make_mesh(n_data=2, devices=["cpu", "cpu"]), cfg, full_res)
    got = fn(I0, I1)
    assert got.device == CPU
    assert got.shape == ((4, H, W, 2) if full_res else (4, H // 2, W // 2, 2))
    for k in range(2):
        part = slice(2 * k, 2 * k + 2)
        want = port.batched_flow(I0[part], I1[part], cfg, full_res,
                                 device="cpu")
        assert torch.equal(got[part], want)
    jfn = jfp.make_data_parallel_flow(
        jax_make_mesh(n_data=2, devices=jax.devices()[:2]), JCFG, full_res)
    ref = np.asarray(jfn(jnp.asarray(I0), jnp.asarray(I1)))
    for b in range(4):
        assert_flow_band(got[b].numpy(), ref[b])


def test_data_parallel_flow_one_device_is_batched_flow():
    cfg = _pcfg()
    I0, I1 = _pairs()
    fn = port.make_data_parallel_flow(port.make_mesh(devices=["cpu"]), cfg)
    assert torch.equal(fn(torch.as_tensor(I0), torch.as_tensor(I1)),
                       port.batched_flow(I0, I1, cfg, device="cpu"))


def test_data_parallel_flow_rejects_indivisible_batch():
    """A batch of 3 over 2 devices raises, as JAX's sharding does."""
    cfg = _pcfg()
    I0, I1 = _pairs()
    fn = port.make_data_parallel_flow(
        port.make_mesh(n_data=2, devices=["cpu", "cpu"]), cfg)
    with pytest.raises(ValueError, match="does not divide"):
        fn(I0[:3], I1[:3])
    jfn = jfp.make_data_parallel_flow(
        jax_make_mesh(n_data=2, devices=jax.devices()[:2]), JCFG)
    with pytest.raises(ValueError):
        jfn(jnp.asarray(I0[:3]), jnp.asarray(I1[:3]))


def test_data_parallel_flow_through_the_fixed_tensor_path():
    """Both shards share one captured path (same shape, cfg and device):
    the second shard's replay must not change the first shard's flows."""
    cfg = _pcfg()
    I0, I1 = _pairs()
    fn = port.make_data_parallel_flow(
        port.make_mesh(n_data=2, devices=["cpu", "cpu"]), cfg)
    want = fn(I0, I1)
    graphs.clear()
    with fixed_tensors():
        got = [fn(I0, I1) for _ in range(2)]
        assert graphs.cached_paths() == [("flow_full_padded", 3)]
    graphs.clear()
    assert all(torch.equal(g, want) for g in got)


# ---------------------------------------------------------------- MultiStream

def test_multistream_over_devices_matches_jax():
    """4 streams over devices=[cpu, cpu] (two streams each): every tick
    equals the one-device ``MultiStream`` bit for bit stream by stream
    (sub-batches of 2 against a batch of 4: <= 1e-5 px, the upsample's
    matmuls see another shape) and each sub-batch equals a 2-stream
    ``MultiStream`` on its own streams bit for bit; within the band of
    JAX's ``MultiStream`` on a 4-device mesh."""
    cfg = _pcfg()
    videos = np.stack([_video(21 + k, 4, s) for k, s in enumerate(SHIFTS)])
    multi = port.MultiStream(cfg, H, W, n_streams=4, devices=["cpu", "cpu"])
    one = port.MultiStream(cfg, H, W, n_streams=4, device="cpu")
    halves = [port.MultiStream(cfg, H, W, n_streams=2, device="cpu")
              for _ in range(2)]
    jm = jms.MultiStream(jax_make_mesh(n_data=4, devices=jax.devices()[:4]),
                         JCFG, H, W)
    assert multi.device == CPU and len(multi.devices) == 2
    for m in (multi, one, jm):
        m.start(videos[:, 0])
    for k, half in enumerate(halves):
        half.start(videos[2 * k:2 * k + 2, 0])
    for t in range(1, 4):
        got = multi.push(videos[:, t])
        assert got.shape == (4, H, W, 2)
        np.testing.assert_allclose(got.numpy(), one.push(videos[:, t]).numpy(),
                                   rtol=0, atol=1e-5)
        for k, half in enumerate(halves):
            assert torch.equal(got[2 * k:2 * k + 2],
                               half.push(videos[2 * k:2 * k + 2, t]))
        ref = np.asarray(jm.push(videos[:, t]))
        for k in range(4):
            assert_flow_band(got[k].numpy(), ref[k])
    multi.close()


def test_multistream_device_arguments():
    cfg = _pcfg()
    with pytest.raises(ValueError, match="either device= or devices="):
        port.MultiStream(cfg, H, W, n_streams=2)
    with pytest.raises(ValueError, match="either device= or devices="):
        port.MultiStream(cfg, H, W, n_streams=2, device="cpu",
                         devices=["cpu"])
    with pytest.raises(ValueError, match="do not divide"):
        port.MultiStream(cfg, H, W, n_streams=3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="do not divide"):
        port.MultiStream(cfg, H, W, n_streams=2, devices=[])


@pytest.mark.parametrize("overlap_warmup", [True, False])
def test_stream_video_chunks_over_devices(overlap_warmup):
    """A 9-frame video as 4 chunks over two devices equals the one-device
    run (<= 1e-5 px) and JAX's within the band; ``overlap_warmup`` is
    accepted and changes nothing, as in JAX."""
    cfg = _pcfg()
    video = _video(41, 9, (2, 1))
    got = port.stream_video_chunks(video, cfg, 4, ["cpu", "cpu"],
                                   overlap_warmup=overlap_warmup)
    one = port.stream_video_chunks(video, cfg, 4, "cpu")
    np.testing.assert_allclose(got, one, rtol=0, atol=1e-5)
    ref = jms.stream_video_chunks(
        video, jax_make_mesh(n_data=4, devices=jax.devices()[:4]), JCFG,
        overlap_warmup=overlap_warmup)
    for p in range(8):
        assert_flow_band(got[p], ref[p])
