"""The port's spans and counters (``utils/profiling.py``) on the CPU.

Tracing is on between ``profiling.enable()`` and ``disable()``, or while
a ``torch.profiler`` records.  Here: the span tree of ``compute_flow``
and ``stream_flow`` (host spans, device spans timed by the host clock on
the CPU, one ``scale <sl>`` a scale), an empty report and unchanged flows
with tracing off, the byte counters against shape x dtype, launches by
mode through a stand-in for the CUDA graph (as tests/test_torch_graphs.py
puts one in), the boundary events of a traced twin (:class:`Marks`) with
stand-in events, and a span on the profiler's clock.  With
forward-backward consistency: the backward grid's leaves and the merges'
leaf, the TIME line's phases over both directions, the per-direction
patch counters (eager, and carried by a recording to its replays), and
the fb stream as a chain of fb pairs.  The card's side is in
tests/test_torch_cuda.py.

Tiny sizes: 44x64 frames, scales 2..1, 4 Gauss-Newton iterations,
variational refinement on.
"""

import contextlib
import dataclasses
import time
from unittest import mock

import numpy as np
import pytest
import torch

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch.models import dis_flow as dis_flow_mod
from flowonthego_tpu_torch.models.dis_flow import as_image
from flowonthego_tpu_torch.parallel import frame_parallel
from flowonthego_tpu_torch.utils import graphs, profiling
from flowonthego_tpu_torch.utils.synth import synthetic_frames

torch.set_num_threads(1)

H, W = 44, 64
CFG = port.DISConfig(coarsest_scale=2, finest_scale=1, grad_descent_iter=4,
                     use_var_ref=True)
PHASES = ("extract", "coarse", "opti", "aggregate", "var_ref")


@pytest.fixture(autouse=True)
def quiet():
    """Each test starts with tracing off, an empty cache and empty
    totals, and leaves them so."""
    profiling.disable()
    profiling.enable()
    profiling.disable()
    graphs.clear()
    yield
    profiling.disable()
    graphs.clear()


@contextlib.contextmanager
def traced():
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()


def _frames(n, h=H, w=W):
    return synthetic_frames(3, n, h, w, (2, 1), factor=4)


def _by_call(spans):
    calls = {}
    for s in spans:
        calls.setdefault(s.call, []).append(s)
    return calls


def _check_tree(spans, scales, leaves_top):
    """One call's spans: host spans at the top, a ``scale <sl>`` under the
    launch for each scale with its five phases under it, the other
    device leaves under the launch."""
    dev = [s for s in spans if s.on == "device"]
    assert {s.name for s in spans if s.on == "host"} >= {"launch"}
    assert all(s.parent is None for s in spans if s.on == "host")
    assert [s.name for s in dev if s.name.startswith("scale ")] == [
        f"scale {sl}" for sl in scales]
    for sl in scales:
        inner = [s for s in dev if s.parent == f"scale {sl}"]
        assert [s.name for s in inner] == list(PHASES)
        assert {s.scale for s in inner} == {sl}
    top = [s.name for s in dev if s.parent == "launch"]
    assert sorted(set(top)) == sorted(set(leaves_top) | {
        f"scale {sl}" for sl in scales})
    assert all(s.end_ns >= s.start_ns for s in spans)


# ------------------------------------------------------------ off and on

def test_off_keeps_nothing_and_on_changes_no_flow():
    f0, f1 = _frames(2)
    off = port.compute_flow(f0, f1, CFG, device="cpu")
    stream_off = list(port.stream_flow(_frames(4), CFG, device="cpu"))
    r = profiling.report()
    assert r["calls"] == 0 and r["modes"] == {} and r["host_ms"] == {} \
        and r["device_ms"] == {} and r["htod_bytes"] == r["dtoh_bytes"] == 0
    assert profiling.spans() == []
    with traced():
        on = port.compute_flow(f0, f1, CFG, device="cpu")
        stream_on = list(port.stream_flow(_frames(4), CFG, device="cpu"))
    assert torch.equal(off, on)
    assert all(np.array_equal(a, b) for a, b in zip(stream_off, stream_on))
    assert profiling.report()["calls"] == 4


def test_off_creates_no_call_context():
    """With tracing off every hook is the same do-nothing context."""
    assert profiling.call() is profiling._NOOP
    assert profiling.host_span("ingest") is profiling._NOOP
    assert profiling.launch("eager", "cpu") is profiling._NOOP
    assert profiling.span("pyramid") is profiling._NOOP
    assert profiling.scale(3) is profiling._NOOP
    assert not profiling.active()


# -------------------------------------------------------------- span tree

def test_compute_flow_span_tree():
    """Unpadded 42x62 frames: the in-graph pad and crop are spans too."""
    f0, f1 = (f[:42, :62] for f in _frames(2))
    with traced():
        port.compute_flow(f0, f1, CFG, device="cpu")
        port.compute_flow(f0, f1, CFG, device="cpu")
    calls = _by_call(profiling.spans())
    assert len(calls) == 2
    for spans in calls.values():
        _check_tree(spans, (2, 1), ("pad", "pyramid", "upsample"))
        assert [s.name for s in spans if s.on == "host"].count("ingest") == 2
        assert [s.mode for s in spans if s.name == "launch"] == ["eager"]
    r = profiling.report()
    assert r["calls"] == 2 and r["modes"] == {"eager": 2}
    assert r["device_calls"] == 2 and r["pending"] == r["dropped"] == 0
    assert set(r["device_ms"]) == {"pad", "pyramid", "upsample", "scale 2",
                                   "scale 1", *PHASES}
    last = profiling.report(calls=1)
    assert last["calls"] == 1
    assert last["device_ms"]["scale 1"] < r["device_ms"]["scale 1"]


def test_stream_flow_span_tree():
    frames = _frames(5)
    with traced():
        flows = list(port.stream_flow(frames, CFG, device="cpu"))
    assert len(flows) == 4
    calls = _by_call(profiling.spans())
    assert len(calls) == 4          # the first frame launches nothing
    for spans in calls.values():
        _check_tree(spans, (2, 1), ("pyramid", "warm_start", "upsample"))
        assert [s.name for s in spans if s.on == "host"] == [
            "ingest", "launch", "fetch"]
    r = profiling.report()
    assert r["modes"] == {"eager": 4} and r["device_calls"] == 4


def test_multistream_push_is_one_call():
    videos = np.stack([np.stack(_frames(3)), np.stack(_frames(3)[::-1])])
    ms = port.MultiStream(CFG, H, W, n_streams=2, device="cpu")
    ms.start(videos[:, 0])
    with traced():
        for t in (1, 2):
            ms.push(videos[:, t])
    ms.close()
    calls = _by_call(profiling.spans())
    assert len(calls) == 2
    for spans in calls.values():
        _check_tree(spans, (2, 1), ("pyramid", "warm_start", "upsample"))


def test_phase_timer_is_fed_by_the_leaves():
    """compute_flow_timed's PhaseTimer gets its phases from the same span
    hook: its pyramid, the five phases and the upsample, nothing else."""
    made = []

    class Kept(dis_flow_mod.PhaseTimer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    lines = []
    with mock.patch.object(dis_flow_mod, "PhaseTimer", Kept):
        port.compute_flow_timed(*_frames(2), CFG, device="cpu",
                                printer=lines.append)
    text = "\n".join(lines)
    names = [ln.split("]")[0].strip("[ ") for ln in text.splitlines()
             if ln.startswith("[")]
    assert names == ["pyramid", *PHASES, "upsample"]
    assert text.count("TIME (Sc:") == 2
    assert dict(made[0].counts) == dict(pyramid=1, extract=2, coarse=2,
                                        opti=2, aggregate=2, var_ref=2,
                                        upsample=1)


# ------------------------------------------------------------------ bytes

def test_byte_counters_are_shape_times_dtype():
    """What crosses to a card (the meta device stands in for it): a numpy
    frame as its own dtype, a host tensor copied into a path's float32
    tensor as float32 (the copy converts on the host), a flow fetched."""
    frame = np.zeros((448, 1024, 3), np.uint8)
    fixed = torch.empty((1, 448, 1024, 3), device="meta")
    flow = torch.empty((448, 1024, 2), device="meta")
    with traced(), profiling.call():
        profiling._local.call.modes["eager"] += 1     # a call that launched
        as_image(frame, "meta")
        as_image(torch.as_tensor(frame), "meta")
        as_image(torch.as_tensor(frame), "cpu")        # stays on the host
        graphs._ingest(fixed, torch.as_tensor(frame)[None])
        profiling.moved(flow.nbytes, flow.device, "cpu")
    r = profiling.report()
    assert r["htod_bytes"] == 2 * 448 * 1024 * 3 + 448 * 1024 * 3 * 4
    assert r["dtoh_bytes"] == 448 * 1024 * 2 * 4 == 3_670_016


def test_uint8_stream_counts_uint8_bytes_in():
    """A uint8 stream's path holds its frames as uint8, so a host frame
    crosses in its own dtype: 448·1024·3 bytes a Sintel frame (the meta
    device stands in for the card, which alone stages large frames in
    pinned memory).  On the CPU a uint8 stream crosses nothing and pins
    nothing."""
    frame = np.zeros((448, 1024, 3), np.uint8)
    cfg = port.operating_point(4, width=1024)
    _, fixed, _ = frame_parallel._make_stream_path(
        cfg, (1, 448, 1024, 3), frame_parallel.frame_dtype(frame), True,
        "meta")
    assert fixed.dtype == torch.uint8
    with traced(), profiling.call():
        profiling._local.call.modes["eager"] += 1     # a call that launched
        for _ in range(2):
            graphs._ingest(fixed, torch.as_tensor(frame)[None])
    r = profiling.report()
    assert r["htod_bytes"] == 2 * 448 * 1024 * 3
    assert r["pinned_bytes"] == r["pinned_blocks"] == 0
    u8 = [np.clip(f, 0, 255).astype(np.uint8) for f in _frames(3)]
    with traced():
        list(port.stream_flow(u8, CFG, device="cpu"))
    r = profiling.report()
    assert r["calls"] == 2
    assert r["htod_bytes"] == r["dtoh_bytes"] == r["pinned_bytes"] == 0


def test_host_frames_on_the_cpu_cross_nothing():
    with traced():
        list(port.stream_flow(_frames(3), CFG, device="cpu"))
        port.compute_flow(*_frames(2), CFG, device="cpu")
    r = profiling.report()
    assert r["calls"] == 3 and r["htod_bytes"] == r["dtoh_bytes"] == 0


# ----------------------------------------------------- modes through a graph

class Rerun:
    """Stands in for ``graphs._Recording`` on the CPU (as in
    tests/test_torch_graphs.py): recording runs nothing, a replay runs
    the function again into the first replay's output tensors."""

    replayed = []

    def __init__(self, fn, device, pool=None):
        self.fn = fn
        self.out = None

    def pool(self):
        return None

    def free(self):
        self.out = None

    def replay(self):
        Rerun.replayed.append(self)
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
def fake_graphs():
    on_card = graphs.enabled
    Rerun.replayed = []
    with mock.patch.object(graphs, "_Recording", Rerun), \
            mock.patch.object(graphs, "enabled",
                              lambda entry, device: on_card(entry, "cuda")):
        yield


def test_record_then_replay_counts_modes_and_recordings():
    f0, f1 = (torch.as_tensor(f) for f in _frames(2))
    eager = port.compute_flow(f0, f1, CFG, device="cpu")
    with fake_graphs(), traced():
        got = [port.compute_flow(f0, f1, CFG, device="cpu")
               for _ in range(3)]
    assert all(torch.equal(g, eager) for g in got)
    r = profiling.report()
    assert r["calls"] == 3
    assert r["modes"] == {"record": 1, "replay": 2}
    assert r["recordings"] == 1 and r["device_calls"] == 3
    calls = list(_by_call(profiling.spans()).values())
    for spans in calls:             # the twin's spans, timed on the host
        _check_tree(spans, (2, 1), ("pyramid", "upsample"))
    assert [s.name for s in calls[-1] if s.on == "host"] == [
        "ingest", "ingest", "ingest", "launch", "copy_out"]
    path = graphs._cache[next(iter(graphs._cache))]
    assert Rerun.replayed == [twin for twin, _ in path.recording.twins]


def test_stream_replays_its_twins_only_while_traced():
    frames = [torch.as_tensor(f) for f in _frames(6)]
    eager = list(port.stream_flow(frames, CFG, fetch=False, device="cpu"))
    with fake_graphs():
        with traced():
            head = list(port.stream_flow(frames[:4], CFG, fetch=False,
                                         device="cpu"))
        r = profiling.report()
        assert r["modes"] == {"record": 1, "replay": 2}
        assert r["recordings"] == 2
        path = graphs._cache[next(iter(graphs._cache))]
        twins = [rec.twins[0][0] for rec in path._recordings]
        assert Rerun.replayed == [twins[1], twins[0]]
        Rerun.replayed = []
        untraced = list(port.stream_flow(frames, CFG, fetch=False,
                                         device="cpu"))
        plains = [rec.plain for rec in path._recordings]
        assert Rerun.replayed == [plains[0], plains[1]] * 2 + [plains[0]]
    assert all(torch.equal(a, b) for a, b in zip(head, eager))
    assert all(torch.equal(a, b) for a, b in zip(untraced, eager))
    assert profiling.report()["calls"] == 3      # kept after disable


def test_report_survives_clear():
    with fake_graphs(), traced():
        for _ in range(2):
            port.compute_flow(*_frames(2), CFG, device="cpu")
    before = profiling.report()
    graphs.clear()
    assert profiling.report() == before and before["calls"] == 2


# ------------------------------------------------- a twin's boundary events

class FakeEvent:
    """A timing event: ``t`` ms once recorded; done unless held back."""

    clock = [0.0]
    held = False

    def __init__(self):
        FakeEvent.clock[0] += 1.0
        self.t = FakeEvent.clock[0]

    def query(self):
        return not FakeEvent.held

    def elapsed_time(self, other):
        return other.t - self.t


def test_twin_marks_share_leaf_boundaries_and_drop_unread():
    """Leaves share their boundary events (a pyramid, a scale's two
    phases, an upsample: 5 events for 4 leaves), a parent runs from its
    first leaf's start to its last leaf's end, the leaves add up to the
    first-to-last time; a twin replayed again before its events are done
    drops their times."""
    marks = profiling.Marks()

    def step():
        with profiling.span("pyramid"):
            pass
        with profiling.scale(0):
            with profiling.span("extract"):
                pass
            with profiling.span("opti"):
                pass
        with profiling.span("upsample"):
            pass

    def fake_mark():
        marks.events.append(FakeEvent())
        return len(marks.events) - 1

    with mock.patch.object(profiling, "_capturing", lambda: True), \
            mock.patch.object(marks, "_mark", fake_mark):
        marks.capture(step)
    assert len(marks.events) == 5
    assert [row[0] for row in marks.layout] == [
        "pyramid", "extract", "opti", "scale 0", "upsample"]

    with traced():
        for held in (False, True, False):
            with profiling.call():
                profiling._local.call.modes["replay"] += 1
                marks.before_replay()
                FakeEvent.held = held
                marks.replayed()
        FakeEvent.held = False
        r = profiling.report()
    assert r["calls"] == 3 and r["device_calls"] == 2 and r["dropped"] == 1
    assert r["device_ms"] == {"pyramid": 2.0, "extract": 2.0, "opti": 2.0,
                              "scale 0": 4.0, "upsample": 2.0}
    leaves = sum(v for k, v in r["device_ms"].items() if k != "scale 0")
    assert leaves == 2 * (marks.events[-1].t - marks.events[0].t)
    first = [s for s in profiling.spans() if s.on == "device"][:5]
    assert [s.parent for s in first] == [
        "launch", "scale 0", "scale 0", "launch", "launch"]


# ------------------------------------------------------ the profiler's clock

def test_span_brackets_an_aten_op_on_the_profilers_clock():
    """Inside a CPU-only torch.profiler run tracing is on, and a host span
    stamped around an op holds the op's own event on the profile's clock
    (its times from the trace's start)."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.is_on()
        with profiling.call():
            profiling._local.call.modes["eager"] += 1
            with profiling.host_span("fetch"):
                time.sleep(0.002)
                torch.mm(x, x)
                time.sleep(0.002)
    assert not profiling.is_on()
    span = [s for s in profiling.spans() if s.name == "fetch"][-1]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    mm = [e for e in prof.events() if e.name == "aten::mm"]
    assert len(mm) == 1
    start_us, end_us = (span.start_ns - t0) / 1e3, (span.end_ns - t0) / 1e3
    assert start_us < mm[0].time_range.start < mm[0].time_range.end < end_us


def test_trace_writes_the_spans(tmp_path):
    import json
    with profiling.trace(str(tmp_path)):
        port.compute_flow(*_frames(2), CFG, device="cpu")
    doc = json.loads((tmp_path / "trace.json").read_text())
    mine = [e for e in doc["traceEvents"] if e.get("cat") == "program span"]
    names = {e["name"] for e in mine}
    assert {"ingest", "launch", "pyramid", "scale 1", "opti"} <= names
    aten = [e for e in doc["traceEvents"] if e.get("name") == "aten::mm"
            or str(e.get("name", "")).startswith("aten::")]
    launch = next(e for e in mine if e["name"] == "launch")
    inside = [e for e in aten
              if launch["ts"] <= e["ts"] <= launch["ts"] + launch["dur"]]
    assert inside


# ------------------------------------------- forward-backward consistency

def _fb(cfg=CFG):
    return dataclasses.replace(cfg, use_fb_consistency=True)


def _scale_leaves(fb, finest):
    """A scale's leaves, in order: the forward phases, with fb the
    backward grid's and the merges, whose aggregation and refinement the
    finest scale leaves out."""
    if not fb:
        return list(PHASES)
    bw = ["extract_bw", "coarse_bw", "opti_bw", "fb_merge", "aggregate"]
    if not finest:
        bw.append("aggregate_bw")
    bw.append("var_ref")
    if not finest:
        bw.append("var_ref_bw")
    return ["extract", "coarse", "opti", *bw]


def _run_entry(entry, cfg):
    if entry == "compute_flow":
        port.compute_flow(*_frames(2), cfg, device="cpu")
    else:
        list(port.stream_flow(_frames(3), cfg, device="cpu"))


@pytest.mark.parametrize("entry", ["compute_flow", "stream_flow"])
@pytest.mark.parametrize("fb", [False, True], ids=["fw", "fb"])
def test_scale_leaves_by_direction(entry, fb):
    """An fb call gives the backward grid's work and the merges leaves of
    their own inside each scale; a call without fb keeps the five
    phases, their names and their order."""
    cfg = _fb() if fb else CFG
    with traced():
        _run_entry(entry, cfg)
    calls = _by_call(profiling.spans())
    assert calls
    for spans in calls.values():
        dev = [s for s in spans if s.on == "device"]
        for sl in (2, 1):
            inner = [s.name for s in dev if s.parent == f"scale {sl}"]
            assert inner == _scale_leaves(fb, sl == CFG.finest_scale)
        assert {s.name for s in dev if s.parent != "launch"
                } <= set(dis_flow_mod.LEAVES)
    names = set(profiling.report()["device_ms"])
    bw = {n for n in dis_flow_mod.LEAVES if n.endswith("_bw")} | {"fb_merge"}
    assert bool(names & bw) == fb


def test_fb_leaves_share_boundaries_and_add_up():
    """Captured into a twin's boundary events (stand-in events), the leaves
    of an fb call share their boundaries, so they add up to the call's
    first-to-last time."""
    marks = profiling.Marks()
    a, b = (torch.as_tensor(f)[None] for f in _frames(2))

    def fake_mark():
        marks.events.append(FakeEvent())
        return len(marks.events) - 1

    with mock.patch.object(profiling, "_capturing", lambda: True), \
            mock.patch.object(marks, "_mark", fake_mark):
        marks.capture(lambda: dis_flow_mod.dis_flow_padded(a, b, _fb()))
    with traced():
        with profiling.call():
            profiling._local.call.modes["replay"] += 1
            marks.replayed()
        r = profiling.report()
    ms = r["device_ms"]
    assert r["device_calls"] == 1
    assert {"opti_bw", "fb_merge", "aggregate_bw", "var_ref_bw"} <= set(ms)
    leaves = sum(v for k, v in ms.items() if k in dis_flow_mod.LEAVES)
    assert leaves == marks.events[-1].t - marks.events[0].t
    n_leaves = sum(1 for row in marks.layout if row[0] in dis_flow_mod.LEAVES)
    assert len(marks.events) == n_leaves + 1


def test_fb_phase_timer_sums_both_directions():
    """compute_flow_timed's TIME line keeps five phases, each the work of
    both directions: ``<phase>_bw`` added to its phase, ``fb_merge`` to
    the aggregation (every leaf timed 1 ms here)."""

    class OneMs(dis_flow_mod.PhaseTimer):
        @contextlib.contextmanager
        def phase(self, name):
            yield
            self.last[name] = 1.0
            self.totals[name] += 1.0
            self.counts[name] += 1

    lines = []
    with mock.patch.object(dis_flow_mod, "PhaseTimer", OneMs):
        port.compute_flow_timed(*_frames(2), _fb(), device="cpu",
                                printer=lines.append)
    rows = [ln for ln in lines if ln.startswith("TIME (Sc:")]
    assert len(rows) == 2
    got = [[float(x) for x in ln.split("):")[1].replace("->", "").replace(
        "ms.", "").split()] for ln in rows]
    assert got[0] == [2.0, 2.0, 2.0, 3.0, 2.0, 11.0]     # scale 2
    assert got[1] == [2.0, 2.0, 2.0, 2.0, 1.0, 9.0]      # scale 1, finest


class Captured(Rerun):
    """A stand-in recording that runs the function once where a capture
    would (so what it counts goes to the recording's tally) and whose
    replay runs no Python, as a graph's does."""

    def __init__(self, fn, device, pool=None):
        super().__init__(fn, device, pool)
        self.out = fn()

    def replay(self):
        Rerun.replayed.append(self)
        return self.out


def _patches(cfg, h=H, w=W):
    from flowonthego_tpu_torch.ops.patches import PatchGrid
    return sum(PatchGrid.create(cfg, w >> sl, h >> sl).n_patches
               for sl in range(cfg.finest_scale, cfg.coarsest_scale + 1))


@pytest.mark.parametrize("path", ["eager", "captured"])
@pytest.mark.parametrize("entry", ["compute_flow", "stream_flow"])
@pytest.mark.parametrize("fb", [False, True], ids=["fw", "fb"])
def test_patch_counters_are_grids_times_frames(path, entry, fb):
    """``patches_fw`` and ``patches_bw``: each direction's patches over the
    scales times the frames; a captured path counts what its recording
    counted on every replay."""
    cfg = _fb() if fb else CFG
    fake = mock.patch.object(graphs, "_Recording", Captured)
    on = mock.patch.object(graphs, "enabled",
                           lambda e, d, f=graphs.enabled: f(e, "cuda"))
    with contextlib.ExitStack() as stack:
        if path == "captured":
            stack.enter_context(fake)
            stack.enter_context(on)
        with traced():
            for _ in range(3):
                _run_entry(entry, cfg)
        r = profiling.report()
    frames = r["calls"]
    assert frames == (3 if entry == "compute_flow" else 6)
    if path == "captured":
        assert r["modes"].get("replay", 0) > 0
    n = _patches(cfg) * frames
    assert r["counters"] == ({"patches_fw": n, "patches_bw": n} if fb
                             else {"patches_fw": n})


def test_fb_stream_is_the_chain_of_fb_pairs():
    """On the CPU an fb stream equals fb ``dis_flow_padded`` calls chained
    by the forward warm start (the backward chain starts cold on every
    frame), each upsampled."""
    cfg = _fb()
    frames = _frames(5)
    got = list(port.stream_flow(frames, cfg, device="cpu"))
    init_hw = (H >> (cfg.coarsest_scale + 1), W >> (cfg.coarsest_scale + 1))
    init = torch.zeros((1, *init_hw, 2))
    for i in range(1, len(frames)):
        a, b = (torch.as_tensor(f)[None].float() for f in frames[i - 1:i + 1])
        fin = dis_flow_mod.dis_flow_padded(a, b, cfg, init_flow=init)
        init = frame_parallel.warm_start(fin, cfg, *init_hw)
        full = dis_flow_mod.upsample_flow_to_full(fin, cfg, H, W)[0]
        assert np.array_equal(got[i - 1], full.numpy())


# ------------------------------------------------------- kernel counters

GN = ("gn_trips", "gn_window_loads")
CARD = torch.device("cuda", 0)


@contextlib.contextmanager
def card_buffers(n):
    """Tracing's kernel counters of ``n`` cards, as CPU tensors of three
    rows (none for ``n`` = 0); the process's own are put back after."""
    bufs = [torch.zeros((3, 2), dtype=torch.int32) for _ in range(n)]
    with mock.patch.dict(profiling._rec.counts, clear=True), \
            mock.patch.object(profiling._rec, "names", ()):
        profiling._rec.counts.update(
            (torch.device("cuda", i), t) for i, t in enumerate(bufs))
        yield bufs


def _traced_launch(card):
    """What a K2 launch on ``card`` asks for in a traced call of its own."""
    with profiling.call():
        profiling._local.call.modes["eager"] += 1
        return profiling.kernel_counts(f"cuda:{card}", GN)


def test_kernel_counters_are_read_once_and_zeroed():
    """The kernel counters (``gn_trips``, ``gn_window_loads``), one buffer
    a card: absent until a traced launch takes one; ``report`` folds what
    the buffers hold into the session's sums and zeroes them, so a second
    report adds only what came since; the session's end folds too, and a
    new session starts without the counters.  CPU tensors stand in for
    the cards' buffers."""
    with card_buffers(2) as (a, b):
        with traced():
            assert "gn_trips" not in profiling.report()["counters"]
            assert _traced_launch(0) is a and _traced_launch(1) is b
            a += torch.tensor([[13, 2], [13, 1], [0, 0]], dtype=torch.int32)
            b[0] += 5
            r = profiling.report()
            assert r["counters"] == {"gn_trips": 31, "gn_window_loads": 8}
            assert not a.any() and not b.any()
            _traced_launch(0)[0] += torch.tensor([13, 3], dtype=torch.int32)
            assert profiling.report(calls=1)["counters"] == {
                "gn_trips": 44, "gn_window_loads": 11}
            _traced_launch(0)[0] += 7
        assert not a.any()                   # folded at the session's end
        assert profiling.report()["counters"] == {"gn_trips": 51,
                                                  "gn_window_loads": 18}
        profiling.enable()                   # a new session
        profiling.disable()
        assert "gn_trips" not in profiling.report()["counters"]


class CapturedOnCard(Captured):
    """A stand-in recording on a card: ``profiling`` sees a capture while
    it runs the function."""

    capturing = False

    def __init__(self, fn, device, pool=None):
        CapturedOnCard.capturing = True
        try:
            super().__init__(fn, device, pool)
        finally:
            CapturedOnCard.capturing = False


def test_twin_counters_made_zeroed_counted_when_traced():
    """A recording on a card has the card's kernel counters made zeroed
    before any capture, once a card; a twin's capture takes them and the
    plain capture none; a twin's replay counts in a traced call, and a
    plain replay, outside one, counts nothing."""
    made, asked = [], []
    zeros = torch.zeros

    def on_cpu(shape, dtype, device):
        made.append((profiling._capturing(), shape, device))
        return zeros(shape, dtype=dtype)

    def fn():
        asked.append(profiling.kernel_counts(CARD, GN))
        return torch.ones(1)

    with card_buffers(0), \
            mock.patch.object(torch, "zeros", on_cpu), \
            mock.patch.object(graphs, "_Recording", CapturedOnCard), \
            mock.patch.object(profiling, "_capturing",
                              lambda: CapturedOnCard.capturing):
        rec = graphs._Traced(fn, CARD)
        graphs._Traced(fn, CARD, twins=1)
        assert made == [(False, (profiling._COUNT_ROWS, 2), CARD)]
        buf = profiling._rec.counts[CARD]
        assert not buf.any()
        assert [t is buf for t in asked] == [False, True, True, False, True]
        buf[5] += torch.tensor([4, 1], dtype=torch.int32)   # a replay's
        Rerun.replayed = []
        rec.replay()                         # no traced call: the plain
        assert Rerun.replayed == [rec.plain]
        assert "gn_trips" not in profiling.report()["counters"]
        with traced():
            with profiling.call():
                profiling._local.call.modes["replay"] += 1
                rec.replay()
            r = profiling.report()
        assert Rerun.replayed == [rec.plain, rec.twins[0][0]]
        assert r["counters"] == {"gn_trips": 4, "gn_window_loads": 1}


def test_kernel_counts_only_for_traced_card_launches():
    """No buffer off the card, and none with tracing off (nothing of CUDA
    is touched then)."""
    assert profiling.kernel_counts("cuda", GN) is None
    with traced(), profiling.call():
        assert profiling.kernel_counts("cpu", GN) is None
        assert profiling.kernel_counts(torch.device("cpu"), GN) is None
    f0, f1 = _frames(2)
    with traced():
        port.compute_flow(f0, f1, CFG, device="cpu")
    assert "gn_trips" not in profiling.report()["counters"]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["eager", "captured"])
def test_traced_stream_counts_gn_trips_on_the_card(path):
    """On the card: a traced stream, eager or replaying its twins, reports
    ``gn_trips`` and ``gn_window_loads`` (as many as the eager stream: the
    same work), with fewer loads than trips; an untraced stream leaves
    both absent and gives the traced flows' bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run this on the card")
    frames = [torch.as_tensor(f, device="cuda") for f in _frames(6)]

    def run():
        return [f.clone() for f in port.stream_flow(frames, CFG,
                                                     fetch=False)]

    with graphs.eager():
        with traced():
            eager = run()
        want = profiling.report()["counters"]
    assert 0 < want["gn_window_loads"] < want["gn_trips"]
    with contextlib.ExitStack() as stack:
        if path == "eager":
            stack.enter_context(graphs.eager())
        else:
            run()                            # record the paths untraced
        with traced():
            got = run()
        r = profiling.report()
        if path == "captured":
            assert r["modes"].get("replay", 0) > 0
        assert {k: r["counters"][k] for k in want} == want
        profiling.enable()                   # a new session, then off
        profiling.disable()
        plain = run()
        assert "gn_trips" not in profiling.report()["counters"]
    assert all(torch.equal(a, b) for a, b in zip(got, eager))
    assert all(torch.equal(a, b) for a, b in zip(plain, eager))
