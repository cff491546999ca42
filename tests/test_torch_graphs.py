"""The captured entry points of the port (``utils/graphs.py``) on the CPU,
``utils/profiling.py``, ``ops/resize.resize_full`` and the tensors the
paths no longer build on the host every call.

A CUDA graph exists only on the card (tests/test_torch_cuda.py holds
captured == eager there).  On the CPU the entry points run eagerly;
``fixed_tensors()`` here puts a stand-in for the graph into
``utils/graphs.py`` (a recording that runs the function again where a
graph would replay) and switches the captured paths on for CPU tensors.
That drives the same fixed-tensor protocol the captures use (inputs
copied into fixed tensors, the function run again into fixed outputs,
results copied out, two alternating state sets for a stream), so the
wrapper is covered here: every captured-form result must
equal the eager result bit for bit, stay untouched by later calls, and
lie within the band of the JAX package's jitted function (mean endpoint
difference <= 1e-3 px, 99th percentile <= 1e-2 px, as
tests/test_torch_slice.py: an ulp can flip a patch's outlier reset).

Tiny sizes: 48x64 frames, coarsest_scale 3, finest_scale 1, 4
Gauss-Newton iterations, variational refinement on; inputs from numpy
seeds.
"""

import contextlib
import dataclasses
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowonthego_tpu.config import DISConfig as JaxConfig
from flowonthego_tpu.models.dis_flow import \
    flow_full_padded as jax_flow_full_padded
from flowonthego_tpu.ops import resize as jresize
from flowonthego_tpu.parallel import make_mesh as jax_make_mesh
from flowonthego_tpu.parallel import frame_parallel as jfp
from flowonthego_tpu.parallel import multistream as jms

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch.convert import config_from_jax
from flowonthego_tpu_torch.ops import dis as pdis
from flowonthego_tpu_torch.ops import patches as ppatches
from flowonthego_tpu_torch.ops import resize as presize
from flowonthego_tpu_torch.parallel.frame_parallel import StreamCore
from flowonthego_tpu_torch.utils import graphs, profiling
from flowonthego_tpu_torch.utils.device import device_constant
from flowonthego_tpu_torch.utils.synth import synthetic_frames
from test_torch_slice import assert_flow_band

torch.set_num_threads(1)

H, W = 48, 64
JCFG = JaxConfig(coarsest_scale=3, finest_scale=1, grad_descent_iter=4,
                 use_var_ref=True)
MODES = {"l2": {}, "fb": dict(use_fb_consistency=True),
         "huber": dict(cost_fn="huber"), "bf16": dict(dtype="bfloat16")}


def _pcfg(jc=JCFG, **fields):
    return dataclasses.replace(config_from_jax(dataclasses.asdict(jc)),
                               **fields)


def _video(seed, n, shift=(2, 1), channels=3):
    return np.stack(synthetic_frames(seed, n, H, W, shift, channels=channels,
                                     factor=4))


@pytest.fixture(autouse=True)
def fresh_cache():
    graphs.clear()
    yield
    graphs.clear()


class Rerun:
    """Stands in for ``graphs._Recording`` on the CPU: recording runs
    nothing, the first replay's results become the output tensors, and
    later replays copy theirs into them."""

    def __init__(self, fn, device, pool=None):
        self.fn = fn
        self.out = None

    def pool(self):
        return None

    def free(self):
        self.out = None

    def replay(self):
        out = self.fn()
        if self.out is None:
            self.out = out
            return out
        single = isinstance(out, torch.Tensor)
        for dst, src in zip((self.out,) if single else self.out,
                            (out,) if single else out):
            dst.copy_(src)
        return self.out


@contextlib.contextmanager
def fixed_tensors():
    """Inside the block CPU tensors take the captured paths, with
    :class:`Rerun` for the graph."""
    on_card = graphs.enabled
    with mock.patch.object(graphs, "_Recording", Rerun), \
            mock.patch.object(graphs, "enabled",
                              lambda entry, device: on_card(entry, "cuda")):
        yield


# ------------------------------------------------------------ the protocol

def test_table_names_every_entry_and_its_reason():
    for entry, reason in graphs.ENTRIES.items():
        assert reason is None or len(reason) > 10
    text = graphs.table()
    assert text.count("captured") >= 4 and "eager: " in text
    # on the CPU nothing is captured; on a card what the table says, and
    # eager() wins over all
    assert not graphs.enabled("flow_full_padded", "cpu")
    assert not graphs.enabled("stream_step", torch.device("cpu"))
    for device in ("cuda", "cpu"):
        with contextlib.ExitStack() as stack:
            if device == "cpu":
                stack.enter_context(fixed_tensors())
            assert graphs.enabled("flow_full_padded", device)
            assert not graphs.enabled("compute_flow_timed", device)
            with graphs.eager():
                assert not graphs.enabled("flow_full_padded", device)
            assert graphs.enabled("stream_step", torch.device(device))


def test_run_copies_in_and_out():
    """The first call is the function itself and records the path, later
    calls go through the fixed tensors: same numbers, results never alias,
    inputs may change between calls, another shape or static argument is
    another path."""
    calls = []

    def fn(a, b):
        calls.append(a.data_ptr())
        return a * 2 + b, a - b

    x, y = torch.arange(6.0).reshape(2, 3), torch.ones(2, 3)
    with fixed_tensors():
        first = graphs.run("flow_full_padded", fn, (x, y), static=("k",))
        second = graphs.run("flow_full_padded", fn, (x, y), static=("k",))
        third = graphs.run("flow_full_padded", fn, (x + 1, y), static=("k",))
        assert calls[0] == x.data_ptr() and calls[1] == calls[2] != calls[0]
        for out in (first, second):
            assert torch.equal(out[0], x * 2 + y)
            assert torch.equal(out[1], x - y)
        assert torch.equal(third[0], (x + 1) * 2 + y)
        assert torch.equal(second[0], x * 2 + y)      # untouched by call 3
        assert second[0].data_ptr() != third[0].data_ptr()
        assert graphs.cached_paths() == [("flow_full_padded", 2)]
        for _ in range(2):
            graphs.run("flow_full_padded", fn, (x[:1], y[:1]), static=("k",))
            assert len(graphs.cached_paths()) == 2
        for _ in range(2):
            graphs.run("flow_full_padded", fn, (x, y), static=("other",))
        assert len(graphs.cached_paths()) == 3
    # outside the block a CPU call is the function itself
    n = len(calls)
    out = graphs.run("flow_full_padded", fn, (x, y), static=("k",))
    assert calls[n:] == [x.data_ptr()] and torch.equal(out[1], x - y)


def test_cache_is_bounded_and_clear_empties_it():
    fn = lambda a: a + 1        # noqa: E731
    with fixed_tensors():
        for n in range(1, graphs.MAX_ENTRIES + 4):
            for _ in range(2):
                graphs.run("dis_flow_padded", fn, (torch.zeros(n),))
        paths = graphs.cached_paths()
        assert paths == [("dis_flow_padded", 1)] * graphs.MAX_ENTRIES
        graphs.run("dis_flow_padded", fn, (torch.zeros(graphs.MAX_ENTRIES + 3),))
        assert graphs.cached_paths()[-1] == ("dis_flow_padded", 2)
        # the oldest went: the first shape is recorded anew
        graphs.run("dis_flow_padded", fn, (torch.zeros(1),))
        assert graphs.cached_paths()[-1] == ("dis_flow_padded", 0)
    graphs.clear()
    assert graphs.cached_paths() == []


def test_stream_path_alternates_and_serves_one_stream_at_a_time():
    def make(device):
        frames = torch.zeros(2)
        state = [torch.zeros(2), torch.zeros(2)]

        def step(k):
            state[1 - k].copy_(state[k] + frames)
            return state[1 - k] * 10
        return state, frames, step

    with fixed_tensors():
        a = graphs.acquire_stream("stream_step", "key", make, "cpu")
        outs = [a.step(torch.tensor([1.0, 2.0])) for _ in range(4)]
        assert [o.tolist() for o in outs] == [[10, 20], [20, 40], [30, 60],
                                              [40, 80]]
        assert len({o.data_ptr() for o in outs}) == 4
        # a second stream of the same key while the first runs: its own path
        b = graphs.acquire_stream("stream_step", "key", make, "cpu")
        assert b is not a and b.step(torch.ones(2)).tolist() == [10, 10]
        assert a.step(torch.tensor([1.0, 2.0])).tolist() == [50, 100]
        b.release()
        assert b.state is None                  # private: freed at once
        a.release()
        c = graphs.acquire_stream("stream_step", "key", make, "cpu")
        assert c is a and c.k == 0 and c.replays == 4
        c.release()
        assert graphs.cached_paths() == [("stream_step", 4)]


# ------------------------------------------------------------ entry points

@pytest.mark.parametrize("mode", sorted(MODES))
def test_captured_compute_flow_equals_eager_and_jax(mode):
    """``compute_flow`` / ``flow_full_padded`` through the fixed-tensor
    path, three calls on two pairs: bit-equal to the eager call, and
    (float32 modes) within the band of JAX's jitted ``flow_full_padded``."""
    cfg = _pcfg(**MODES[mode])
    v = _video(3, 3)
    eager = [port.compute_flow(v[k], v[k + 1], cfg, device="cpu")
             for k in (0, 1)]
    with fixed_tensors():
        got = [port.compute_flow(v[k], v[k + 1], cfg, device="cpu")
               for k in (0, 1, 0)]
        assert graphs.cached_paths() == [("flow_full_padded", 2)]
    for g, k in zip(got, (0, 1, 0)):
        assert torch.equal(g, eager[k])
    if mode != "bf16":
        jc = dataclasses.replace(JCFG, **MODES[mode])
        ref = np.asarray(jax_flow_full_padded(jnp.asarray(v[0]),
                                              jnp.asarray(v[1]), jc))
        assert_flow_band(got[0].numpy(), ref)


@pytest.mark.parametrize("full_res", [True, False])
def test_captured_batched_flow_equals_eager_and_jax(full_res):
    cfg = _pcfg()
    I0 = np.stack([_video(5 + b, 2, s)[0] for b, s in
                   enumerate(((2, 1), (-2, 2)))])
    I1 = np.stack([_video(5 + b, 2, s)[1] for b, s in
                   enumerate(((2, 1), (-2, 2)))])
    eager = port.batched_flow(I0, I1, cfg, full_res=full_res, device="cpu")
    with fixed_tensors():
        got = [port.batched_flow(I0, I1, cfg, full_res=full_res, device="cpu")
               for _ in range(3)]
        entry = "flow_full_padded" if full_res else "dis_flow_padded"
        assert graphs.cached_paths() == [(entry, 2)]
    assert all(torch.equal(g, eager) for g in got)
    assert got[1].data_ptr() != got[2].data_ptr()
    ref = np.asarray(jfp.batched_flow(jnp.asarray(I0), jnp.asarray(I1), JCFG,
                                      full_res))
    for b in range(2):
        assert_flow_band(got[2][b].numpy(), ref[b])


def test_captured_disparity_equals_eager():
    cfg = _pcfg(use_var_ref=False)
    v = _video(9, 2, (-2, 0))
    eager = port.compute_disparity(v[0], v[1], cfg, device="cpu")
    with fixed_tensors():
        got = [port.compute_disparity(v[0], v[1], cfg, device="cpu")
               for _ in range(3)]
        assert graphs.cached_paths() == [("compute_disparity", 2)]
    assert all(torch.equal(g, eager) for g in got)


@pytest.mark.parametrize("full_res", [True, False])
def test_captured_stream_flow_equals_eager_and_jax(full_res):
    """Six frames through the two alternating state sets, twice (the
    second stream takes the cached path), against the eager stream bit for
    bit and JAX's jitted ``stream_flow`` within the band."""
    cfg = _pcfg()
    v = _video(7, 6)
    eager = list(port.stream_flow(v, cfg, full_res=full_res, fetch=False,
                                  device="cpu"))
    with fixed_tensors():
        runs = [list(port.stream_flow(v, cfg, full_res=full_res, fetch=False,
                                      device="cpu")) for _ in range(2)]
        assert graphs.cached_paths() == [("stream_step", 9)]
    for got in runs:
        assert len(got) == 5
        assert all(torch.equal(g, e) for g, e in zip(got, eager))
    ref = list(jfp.stream_flow(iter(v), JCFG, full_res=full_res))
    for g, r in zip(runs[1], ref):
        assert_flow_band(g.numpy(), np.asarray(r))


def test_stream_flows_do_not_alias():
    """Two consecutive ``fetch=False`` flows held at once: the first is
    unchanged after the second (and third) step replayed."""
    cfg = _pcfg()
    v = _video(8, 5)
    eager = list(port.stream_flow(v, cfg, fetch=False, device="cpu"))
    with fixed_tensors():
        list(port.stream_flow(v[:3], cfg, fetch=False, device="cpu"))
        stream = port.stream_flow(v, cfg, fetch=False, device="cpu")
        first = next(stream)
        kept = first.clone()
        second = next(stream)
        third = next(stream)
        stream.close()
    assert torch.equal(first, kept) and torch.equal(first, eager[0])
    assert torch.equal(second, eager[1]) and torch.equal(third, eager[2])
    assert len({t.data_ptr() for t in (first, second, third)}) == 3


def test_abandoned_stream_gives_its_path_back():
    cfg = _pcfg()
    v = _video(8, 4)
    with fixed_tensors():
        stream = port.stream_flow(v, cfg, fetch=False, device="cpu")
        next(stream)
        other = list(port.stream_flow(v, cfg, fetch=False, device="cpu"))
        rest = list(stream)
        again = list(port.stream_flow(v, cfg, fetch=False, device="cpu"))
    eager = list(port.stream_flow(v, cfg, fetch=False, device="cpu"))
    for got in (other, again):
        assert all(torch.equal(g, e) for g, e in zip(got, eager))
    assert all(torch.equal(g, e) for g, e in zip(rest, eager[1:]))


def test_captured_multistream_equals_eager_and_jax():
    """A 4-stream tick through the fixed-tensor path against the eager
    ``MultiStream`` bit for bit and JAX's jitted ``step_fn`` on a 4-device
    virtual mesh within the band; ticks held at once do not alias."""
    cfg = _pcfg()
    shifts = ((2, 1), (-2, 2), (4, -2), (0, 2))
    videos = np.stack([_video(21 + k, 4, s) for k, s in enumerate(shifts)])
    em = port.MultiStream(cfg, H, W, n_streams=4, device="cpu")
    em.start(videos[:, 0])
    eager = [em.push(videos[:, t]) for t in range(1, 4)]
    with fixed_tensors():
        pm = port.MultiStream(cfg, H, W, n_streams=4, device="cpu")
        pm.start(videos[:, 0])
        got = [pm.push(videos[:, t]) for t in range(1, 4)]
        pm.close()
        assert graphs.cached_paths() == [("stream_step", 2)]
    assert all(torch.equal(g, e) for g, e in zip(got, eager))
    assert len({g.data_ptr() for g in got}) == 3
    mesh = jax_make_mesh(n_data=4, devices=jax.devices()[:4])
    jm = jms.MultiStream(mesh, JCFG, H, W)
    jm.start(videos[:, 0])
    for t in range(1, 4):
        ref = np.asarray(jm.push(videos[:, t]))
        for k in range(4):
            assert_flow_band(got[t - 1][k].numpy(), ref[k])


def test_stream_core_restart_rewrites_its_state():
    """A cached path taken by a new stream starts from the new first
    frame and a zero warm start, whatever the last stream left."""
    cfg = _pcfg()
    a, b = _video(31, 4), _video(32, 3, (-2, 2))
    want = list(port.stream_flow(b, cfg, fetch=False, device="cpu"))
    with fixed_tensors():
        list(port.stream_flow(a, cfg, fetch=False, device="cpu"))
        got = list(port.stream_flow(b, cfg, fetch=False, device="cpu"))
        core = StreamCore(cfg, 1, H, W, 3, True, "cpu")
        assert not core.started
        core.start(b[:1])
        assert core.started and core._path.k == 0
        core.close()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _uint8(video):
    return np.clip(np.round(video), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("path", ["eager", "fixed tensors"])
@pytest.mark.parametrize("finest", [1, 0])
def test_uint8_stream_equals_float32_stream(path, finest):
    """A stream of uint8 numpy frames gives the flows of the same frames
    as float32 bit for bit, run eagerly and through the fixed-tensor path;
    at finest scale 0 the pyramid converts the uint8 frame itself, above
    it the pool reads uint8."""
    cfg = _pcfg(finest_scale=finest)
    u8 = _uint8(_video(9, 5))
    with (graphs.eager() if path == "eager" else fixed_tensors()):
        got = list(port.stream_flow(u8, cfg, device="cpu"))
        want = list(port.stream_flow(u8.astype(np.float32), cfg,
                                     device="cpu"))
    assert len(got) == 4
    assert all(g.dtype == np.float32 and np.array_equal(g, w)
               for g, w in zip(got, want))


def test_uint8_and_float32_streams_take_two_paths():
    """One shape, two frame dtypes: two stream paths, each holding its
    frames in its own dtype; a uint8 stream refuses a float32 frame."""
    cfg = _pcfg()
    u8 = _uint8(_video(10, 3))
    with fixed_tensors():
        list(port.stream_flow(u8, cfg, fetch=False, device="cpu"))
        list(port.stream_flow(u8.astype(np.float32), cfg, fetch=False,
                              device="cpu"))
        assert graphs.cached_paths() == [("stream_step", 1)] * 2
        held = sorted(str(p.frames.dtype) for p in graphs._cache.values())
        assert held == ["torch.float32", "torch.uint8"]
        mixed = [u8[0], u8[1], u8[2].astype(np.float32)]
        with pytest.raises(ValueError, match="uint8"):
            list(port.stream_flow(mixed, cfg, device="cpu"))


def test_host_results_stay_float32_numpy():
    """``DISFlow.calc`` and ``stream_video_chunks`` fetch through the same
    helper as ``stream_flow``: float32 numpy on the CPU, uint8 frames or
    float32 alike."""
    cfg = _pcfg()
    u8 = _uint8(_video(11, 5))
    flow = port.DISFlow(cfg, device="cpu").calc(u8[0], u8[1])
    assert isinstance(flow, np.ndarray) and flow.dtype == np.float32
    assert np.array_equal(flow, port.DISFlow(cfg, device="cpu").calc(
        u8[0].astype(np.float32), u8[1].astype(np.float32)))
    chunks = [port.stream_video_chunks(v, cfg, 2, "cpu")
              for v in (u8, u8.astype(np.float32))]
    assert isinstance(chunks[0], np.ndarray) and chunks[0].dtype == np.float32
    assert chunks[0].shape == (4, H, W, 2)
    assert np.array_equal(*chunks)


# ------------------------------------------------- the hoisted host tensors

def test_hoisted_constants_equal_the_host_values():
    """``mid_org`` and the warm-start lookup indices, once built with
    numpy on every call, now built once per (grid, device): the same
    values bit for bit, and the same tensor on the second call."""
    cfg = _pcfg(JaxConfig(coarsest_scale=7, finest_scale=5))
    grid = ppatches.PatchGrid.create(cfg, 30, 17)
    mx, my = grid.midpoints()
    t = torch.zeros((2, grid.n_h, grid.n_w, cfg.patch_size, cfg.patch_size,
                     3))
    st = pdis.init_state(t, t, t, torch.zeros((2, grid.n_h, grid.n_w, 3)),
                         grid)
    assert st.mid_org.dtype == torch.float32
    for b in range(2):
        np.testing.assert_array_equal(st.mid_org[b, ..., 0].numpy(), mx)
        np.testing.assert_array_equal(st.mid_org[b, ..., 1].numpy(), my)
    again = pdis.init_state(t, t, t, st.H, grid)
    assert again.mid_org.data_ptr() == st.mid_org.data_ptr()
    ix, iy = pdis.coarse_lookup(grid, 8, 15, "cpu")
    np.testing.assert_array_equal(ix.numpy(),
                                  np.minimum(mx.astype(int) // 2, 14))
    np.testing.assert_array_equal(iy.numpy(),
                                  np.minimum(my.astype(int) // 2, 7))
    assert pdis.coarse_lookup(grid, 8, 15, "cpu")[0] is ix
    # another coarse field is another constant
    assert pdis.coarse_lookup(grid, 9, 15, "cpu")[1] is not iy
    R = presize.interp_matrix_on(112, 14, "cpu")
    np.testing.assert_array_equal(R.numpy(), presize._interp_matrix(112, 14))
    np.testing.assert_array_equal(R.numpy(), jresize._interp_matrix(112, 14))
    assert presize.interp_matrix_on(112, 14, "cpu") is R


def test_device_constant_builds_once_per_key_and_device():
    built = []

    def build():
        built.append(1)
        return np.arange(3)
    a = device_constant(("test_graphs", 1), "cpu", build)
    b = device_constant(("test_graphs", 1), torch.device("cpu"), build)
    c = device_constant(("test_graphs", 2), "cpu", build)
    assert a is b and c is not a and len(built) == 2


# ---------------------------------------------------------------- resize_full

@pytest.mark.parametrize("src,dst", [((14, 32), (112, 256)),
                                     ((17, 30), (34, 61)),
                                     ((24, 20), (12, 10))])
def test_resize_full_matches_jax_and_resize_matmul(src, dst):
    """The gather form against JAX's ``resize_full`` (<= 1e-6 abs on
    flow-sized values: the same float32 taps and weights) and against the
    port's ``resize_matmul`` (<= 1e-5: two matmuls sum in another
    order), with and without leading dims."""
    rng = np.random.default_rng(0)
    flow = (rng.standard_normal(src + (2,)) * 2).astype(np.float32)
    ref = np.asarray(jresize.resize_full(jnp.asarray(flow), *dst))
    got = presize.resize_full(torch.as_tensor(flow), *dst)
    assert got.shape == dst + (2,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), presize.resize_matmul(torch.as_tensor(flow),
                                           *dst).numpy(), rtol=0, atol=1e-5)
    batch = torch.as_tensor(np.stack([flow, flow * 2]))
    both = presize.resize_full(batch, *dst)
    assert torch.equal(both[0], got)
    np.testing.assert_allclose(both[1].numpy(), 2 * ref, rtol=0, atol=2e-6)


# ------------------------------------------------------------------ profiling

def test_profiling_on_the_cpu(tmp_path):
    """``trace`` writes a Chrome trace holding the nested ``annotate``
    ranges; ``device_memory_stats`` is {} without a GPU, else the JAX
    package's three keys per device."""
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as where:
        assert where == log_dir
        with profiling.annotate("outer_range"):
            with profiling.annotate("inner_range"):
                torch.ones(8).sum()
    path = os.path.join(log_dir, "trace.json")
    events = json.load(open(path))["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("name") in ("outer_range", "inner_range")}
    assert set(spans) == {"outer_range", "inner_range"}
    outer, inner = spans["outer_range"], spans["inner_range"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1
    stats = profiling.device_memory_stats()
    if not torch.cuda.is_available():
        assert stats == {}
    for per_device in stats.values():
        assert set(per_device) == {"bytes_in_use", "peak_bytes_in_use",
                                   "bytes_limit"}
    assert port.trace is profiling.trace and port.annotate is profiling.annotate
