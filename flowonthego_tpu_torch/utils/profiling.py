"""Profiling hooks, and the port's own spans and counters.

The port of ``flowonthego_tpu/utils/profiling.py``:

  * :func:`trace` — a ``torch.profiler`` context that writes a Chrome
    trace (host and, on a GPU, device timeline) into a directory, the
    program's spans (below) with it.
  * :func:`annotate` — named ranges (``torch.profiler.record_function``)
    that show up inside traces, the analogue of the reference's phase
    names (pconst/pinit/poptim/cflow/tvopt).
  * :func:`device_memory_stats` — bytes in use, peak and limit of every
    visible GPU.

Spans and counters
------------------
Tracing is on while a ``torch.profiler`` records, or between
:func:`enable` and :func:`disable`.  An entry call (``compute_flow``,
``batched_flow``, a frame of ``stream_flow``, ``MultiStream.push``, a
call of ``graphs.run``) that starts while it is on is traced whole
(:func:`call`); with it off nothing is recorded or allocated, no event is
made and nothing waits.  A traced call keeps:

* host spans, stamped with ``time.time_ns``, the clock ``torch.profiler``
  stamps host events with (Unix ns): ``ingest`` (a frame staged in pinned
  memory and copied up, or copied into a path's tensors), ``launch`` with its
  mode (``eager``, ``record``: the eager run and the recording, or
  ``replay``), ``copy_out`` (a replay's output cloned), ``fetch``
  (``stream_flow``'s flow copied down into pinned memory) and ``read``
  (tracing's own: earlier launches' device times, read right after a
  launch, while the card runs it);
* device spans: the leaves ``pyramid``, ``pad``, ``warm_start``,
  ``upsample`` and, under a parent ``scale <sl>``, ``extract``,
  ``coarse``, ``opti``, ``aggregate``, ``var_ref``; with
  forward-backward consistency the backward grid's work in leaves of its
  own, ``extract_bw``, ``coarse_bw``, ``opti_bw``, ``aggregate_bw``,
  ``var_ref_bw``, and both directions' merges in ``fb_merge``;
* counters: launches by mode, bytes across the host link each way (from
  the shape and the dtype that crosses) and how many of them crossed
  through pinned host memory, the new pinned blocks the program's
  transfers made the caching host allocator allocate
  (``utils/device.py``), recordings made, device readings dropped, and
  the named counters of :func:`count`: ``patches_fw`` and
  ``patches_bw``, the patches each direction solved.  A recording keeps
  what its capture counted and adds it to the traced call on each replay
  (no Python runs then);
* kernel counters, counted on the card: ``gn_trips`` and
  ``gn_window_loads``, the patch solve's (K2's) trips and the trips of
  them that loaded the window's taps anew (:func:`kernel_counts`).

A device span is timed by CUDA events on the card (by the host clock on
the CPU).  Leaves share their boundaries: a leaf starts at the event that
ended the one before it, so device work between two leaves counts to the
later one, and the leaves of a call add up to its first-to-last event
time.  A parent runs from its first leaf's start to its last leaf's end.
On a captured path (``utils/graphs.py``) no Python runs on a replay, so
every recording has traced twins, captured right after it in the same
memory pool with an event-record node at each boundary
(:class:`Marks`); a twin replays instead of the plain graph only in a
traced call.  Event times are read without waiting, and only where the
last event is done: after a traced call's launch, on the twin's next
use, at a call after tracing stopped, or by :func:`report`; a twin
replayed again before its times were done drops them (``dropped``).

:func:`report` sums what was kept since :func:`enable` or since the
profiler started; ``report(calls=n)`` over the last ``n`` entry calls,
but for the kernel counters, which are the session's.  A traced K2
launch counts per patch into a device buffer that tracing owns (an eager
launch's is kept by size and stored into while fresh, a twin's is made
zeroed before its capture and added to): no launch, copy or wait is
added to a traced call.  The buffers are folded into the session's sums
on the card (their sums added, the buffers cleared: launches, no wait)
when the session ends, at the first untraced call or :func:`disable`, and
by :func:`report`, which then waits for the card to read the sums.
:func:`spans` returns the kept spans.  Spans are no profiler ranges: a
range around device work leaves its shadow on the device's timeline.
Nothing here touches CUDA when the module is imported or when there is
no GPU.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import threading
import time
from typing import NamedTuple, Optional

import torch

RING_CALLS = 1024      # entry calls kept for report(calls=n) and the trace
LEAVES = ("pyramid", "pad", "warm_start", "upsample", "extract", "coarse",
          "opti", "aggregate", "var_ref", "extract_bw", "coarse_bw",
          "opti_bw", "fb_merge", "aggregate_bw", "var_ref_bw")
KERNEL_COUNTERS = ("gn_trips", "gn_window_loads")

_NOOP = contextlib.nullcontext()
clock_ns = time.time_ns


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, create_perfetto_link: bool = False):
    """Capture a trace: ``with trace("out/t"): run()``.

    Writes ``<log_dir>/trace.json`` (Chrome trace format: load it in
    Perfetto or ``chrome://tracing``) when the block ends and yields
    ``log_dir`` (default: ``fot_trace`` under the temporary directory).
    Host activity is always recorded, device activity where there is a
    GPU; the program's spans of the calls made inside the block are added
    as two threads of their own (``program host spans``, ``program device
    spans``: an event-timed span sits at its offset from its launch).
    ``create_perfetto_link`` is the JAX package's argument, accepted and
    unused: nothing is uploaded anywhere."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "fot_trace")
    os.makedirs(log_dir, exist_ok=True)
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    first = _rec.next_id
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        _rec.harvest()
        _add_spans_to_chrome_trace(
            path, [s for s in spans() if s.call >= first])


def annotate(name: str):
    """Named range for trace timelines (phase-timer analogue)."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> dict:
    """Per-device memory stats: ``{device: {"bytes_in_use",
    "peak_bytes_in_use", "bytes_limit"}}`` of every visible GPU, from
    PyTorch's allocator (``torch.cuda.memory_stats``) and the device's
    total memory; ``{}`` with no GPU."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return stats


# ------------------------------------------------------------------- state

class Span(NamedTuple):
    name: str
    parent: Optional[str]    # the enclosing device span, "launch" for a
                             # device span at the top, None for a host span
    call: int                # the entry call's id
    scale: Optional[int]
    mode: Optional[str]      # a launch's
    start_ns: int            # the profiler's host clock; an event-timed
    end_ns: int              # span: its launch's start + its offset
    on: str                  # "host" or "device"


class _Call:
    """What one traced entry call kept: its host spans and host-timed
    device spans as tuples, its event readings as (layout, offsets,
    anchor), device ms by span name; :func:`spans` makes the records."""

    def __init__(self, cid: int):
        self.id = cid
        self.host = []           # (name, mode, start_ns, end_ns)
        self.device = []         # (name, parent, scale, start_ns, end_ns)
        self.readings = []       # (Marks.layout, ms offsets, launch start)
        self.device_ms = {}
        self.modes = collections.Counter()
        self.counters = collections.Counter()
        self.htod = self.dtoh = self.pinned = self.blocks = 0
        self.recordings = 0
        self.unread = 0          # device readings still to come
        self.dropped = 0
        self.kept = False        # in the ring, its host side in the totals
        self.launch_ns = 0       # the latest launch's start

    def spans(self) -> list:
        out = [Span(name, None, self.id, None, mode, t0, t1, "host")
               for name, mode, t0, t1 in self.host]
        out += [Span(name, parent or "launch", self.id, sl, None, t0, t1,
                     "device") for name, parent, sl, t0, t1 in self.device]
        for layout, off, t0 in self.readings:
            out += [Span(name, parent or "launch", self.id, sl, None,
                         t0 + int(off[i] * 1e6), t0 + int(off[j] * 1e6),
                         "device") for name, parent, sl, i, j in layout]
        return out


class _Totals:
    def __init__(self):
        self.calls = self.htod = self.dtoh = self.recordings = 0
        self.pinned = self.blocks = 0
        self.dropped = self.device_calls = 0
        self.modes = collections.Counter()
        self.counters = collections.Counter()
        self.host_ms = collections.Counter()
        self.device_ms = collections.Counter()

    def add_host(self, c: _Call) -> None:
        self.calls += 1
        self.modes.update(c.modes)
        self.counters.update(c.counters)
        self.htod += c.htod
        self.dtoh += c.dtoh
        self.pinned += c.pinned
        self.blocks += c.blocks
        self.recordings += c.recordings
        self.dropped += c.dropped
        for name, _, t0, t1 in c.host:
            self.host_ms[name] += (t1 - t0) / 1e6

    def add_device(self, c: _Call) -> None:
        """A call's device spans, once all were read and none dropped."""
        if c.unread or c.dropped:
            return
        self.device_calls += 1
        self.device_ms.update(c.device_ms)

    def as_dict(self, pending: int) -> dict:
        return {"calls": self.calls, "modes": dict(self.modes),
                "htod_bytes": self.htod, "dtoh_bytes": self.dtoh,
                "pinned_bytes": self.pinned, "pinned_blocks": self.blocks,
                "recordings": self.recordings, "dropped": self.dropped,
                "pending": pending, "device_calls": self.device_calls,
                "counters": dict(self.counters),
                "host_ms": dict(self.host_ms),
                "device_ms": dict(self.device_ms)}


class _Recorder:
    """The process's kept calls (a bounded ring), running totals and the
    device readings still to read."""

    def __init__(self):
        self.lock = threading.RLock()
        self.enabled = False
        self.was_on = False
        self.next_id = 0
        self.eager_counts = {}   # (device, rows) -> a traced eager launch's
        self.fresh = set()       # ids of eager counters not written yet
        self.unsummed = {}       # kernel counters written since a fold
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self.ring = collections.deque(maxlen=RING_CALLS)
            self.totals = _Totals()
            self.pending = []        # Marks holding a call's unread events
            for t in self.unsummed.values():
                self.clear(t)        # counts of a session that ended unread
            self.unsummed = {}
            self.sums = None         # device -> the folded sums, int64 [2]

    def added(self, tensors) -> None:
        """Traced launches write to these kernel counters."""
        with self.lock:
            for t in tensors:
                self.unsummed[id(t)] = t
            if self.sums is None:
                self.sums = {}

    def clear(self, t: torch.Tensor) -> None:
        if any(t is e for e in self.eager_counts.values()):
            self.fresh.add(id(t))    # the next launch stores
        else:
            t.zero_()

    def fold(self) -> None:
        """Add what the kernel counters written since the last fold hold to
        the session's sums, on their device, and clear them."""
        with self.lock:
            bufs, self.unsummed = list(self.unsummed.values()), {}
            for t in bufs:
                s = t.sum(0, dtype=torch.int64)
                acc = self.sums.get(t.device)
                self.sums[t.device] = s if acc is None else acc + s
                self.clear(t)

    def kernel_sums(self) -> Optional[dict]:
        """The session's kernel counters, None where no traced launch
        counted: fold, wait for the card, read."""
        with self.lock:
            if self.sums is None:
                return None
            self.fold()
            out = dict.fromkeys(KERNEL_COUNTERS, 0)
            for dev, acc in self.sums.items():
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                for k, v in zip(KERNEL_COUNTERS, acc.tolist()):
                    out[k] += v
            return out

    def finish(self, c: _Call) -> None:
        """A traced call has returned: keep it, if it launched."""
        if not c.modes:
            return
        with self.lock:
            self.ring.append(c)
            c.kept = True
            self.totals.add_host(c)
            if not c.unread:
                self.totals.add_device(c)

    def harvest(self) -> None:
        """Read every pending reading that is done; never wait."""
        with self.lock:
            left = []
            for marks in self.pending:
                if not marks.read():
                    left.append(marks)
            self.pending = left

    def settle(self, c: _Call, dropped: bool) -> None:
        with self.lock:
            c.unread -= 1
            c.dropped += dropped
            self.totals.dropped += dropped
            if c.unread == 0 and c.kept:
                self.totals.add_device(c)


_rec = _Recorder()


class _Local(threading.local):
    call = None          # the traced entry call running on this thread
    tally = None         # the counters a recording's capture fills
    sizes = None         # the kernel counters a plain capture asks for
    marks = None         # an eager launch's Marks on the card
    capture = None       # the Marks a traced twin's capture fills
    timer = None         # a PhaseTimer fed by the leaves
    scale = None

    def __init__(self):
        self.open = []   # the device spans open on this thread


_local = _Local()


def enable() -> None:
    """Trace every entry call from now on (until :func:`disable`), and
    start the totals afresh."""
    _rec.reset()
    _rec.enabled = _rec.was_on = True


def disable() -> None:
    _rec.enabled = False
    _rec.harvest()
    _rec.fold()


def is_on() -> bool:
    """Whether an entry call starting now is traced."""
    return _rec.enabled or torch._C._autograd._profiler_enabled()


def active() -> bool:
    """Whether a traced entry call is running on this thread."""
    return _local.call is not None


def report(calls: Optional[int] = None) -> dict:
    """The totals since :func:`enable` or since the profiler started
    (``calls``: over the last ``calls`` entry calls kept): entry calls and
    their launches by mode, bytes across the host link (``pinned_bytes``
    of them through pinned memory; ``pinned_blocks``: new pinned blocks
    allocated for them), recordings,
    dropped and still pending device readings, the named counters of
    :func:`count` (``counters``), host ms and device ms by
    span name (device ms over the ``device_calls`` whose spans were all
    read), and among the counters the session's kernel counters where a
    traced launch counted (``gn_trips``, ``gn_window_loads``: read after
    waiting for the card).  Pending readings that are done are read
    first."""
    _rec.harvest()
    with _rec.lock:
        kernel = _rec.kernel_sums()
        kept = list(_rec.ring)
        if calls is not None:
            kept = kept[-calls:] if calls > 0 else []
        pending = sum(1 for c in kept if c.unread)
        if calls is None:
            out = _rec.totals.as_dict(pending)
        else:
            tot = _Totals()
            for c in kept:
                tot.add_host(c)
                tot.add_device(c)
            out = tot.as_dict(pending)
    if kernel is not None:
        out["counters"].update(kernel)
    return out


def spans() -> list:
    """The spans of the kept calls, call by call."""
    with _rec.lock:
        return [s for c in _rec.ring for s in c.spans()]


# -------------------------------------------------------------- entry calls

def call():
    """The context of an entry call: traced whole if tracing is on when it
    starts, joined if a traced call is already running on the thread."""
    if _local.call is not None:
        return _NOOP
    if not is_on():
        if _rec.was_on:          # tracing stopped: read what is done
            _rec.was_on = False
            _rec.harvest()
            _rec.fold()
        return _NOOP
    return _traced_call()


@contextlib.contextmanager
def _traced_call():
    if not _rec.was_on:          # the profiler started: a new session
        _rec.reset()
        _rec.was_on = True
    with _rec.lock:
        c = _Call(_rec.next_id)
        _rec.next_id += 1
    _local.call = c
    try:
        yield c
    finally:
        _local.call = None
        _rec.finish(c)


def host_span(name: str):
    """A host span of the traced call running on this thread."""
    if _local.call is None:
        return _NOOP
    return _host_span(name, None)


@contextlib.contextmanager
def _host_span(name: str, mode: Optional[str]):
    c = _local.call
    t0 = clock_ns()
    if mode is not None:
        c.launch_ns = t0
    try:
        yield
    finally:
        c.host.append((name, mode, t0, clock_ns()))


def launch(mode: str, device):
    """The ``launch`` span of a traced call: the eager run (``eager``), the
    eager run and the recording (``record``), or a replay (``replay``) on
    ``device``."""
    if _local.call is None:
        return _NOOP
    return _launch(mode, torch.device(device))


@contextlib.contextmanager
def _launch(mode: str, device: torch.device):
    c = _local.call
    c.modes[mode] += 1
    marks = Marks(external=False) if (
        mode != "replay" and device.type == "cuda") else None
    outer, _local.marks = _local.marks, marks
    try:
        with _host_span("launch", mode):
            yield
    finally:
        _local.marks = outer
        if marks is not None:
            marks.replayed()
    if _rec.pending:       # earlier launches' device times, read while
        with _host_span("read", None):     # the card runs this one
            _rec.harvest()


def moved(nbytes: int, src, dst, host: Optional[torch.Tensor] = None) -> None:
    """Count ``nbytes`` crossing between host and card, if they do, and
    whether through pinned host memory: ``host``, the host side of the
    copy, is page-locked."""
    c = _local.call
    if c is None:
        return
    src, dst = torch.device(src).type, torch.device(dst).type
    if src == "cpu" and dst != "cpu":
        c.htod += int(nbytes)
    elif src != "cpu" and dst == "cpu":
        c.dtoh += int(nbytes)
    else:
        return
    if host is not None and host.is_pinned():
        c.pinned += int(nbytes)


def pinned_blocks(n: int) -> None:
    """Count ``n`` pinned host blocks newly allocated in the traced call."""
    if _local.call is not None:
        _local.call.blocks += int(n)


def recorded() -> None:
    """Count a recording made in the traced call."""
    if _local.call is not None:
        _local.call.recordings += 1


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of what runs now: a recording
    being captured (:func:`tally`), else the traced call on this
    thread."""
    loc = _local
    if loc.tally is not None:
        loc.tally[name] += n
    elif loc.call is not None:
        loc.call.counters[name] += n


@contextlib.contextmanager
def tally():
    """Collect what :func:`count` counts inside the block, traced or not,
    into the Counter it yields (a recording's own, added by
    :func:`counted` on each replay) and nowhere else."""
    outer, _local.tally = _local.tally, collections.Counter()
    try:
        yield _local.tally
    finally:
        _local.tally = outer


def counted(counters) -> None:
    """Add a recording's counters to the traced call replaying it."""
    if _local.call is not None:
        _local.call.counters.update(counters)


def kernel_counts(device, rows: int):
    """(the int32 [rows, 2] buffer a kernel launched now on ``device``
    counts per item into (K2: a patch's trips and window loads), whether
    the launch stores into it instead of adding), or (None, False) where
    nothing is counted: tracing off, a plain capture, the CPU.  A traced
    twin's capture takes the buffers made for it before it began
    (:class:`Marks`), in the order of the plain capture's requests
    (:func:`kernel_sizes`), counted when the twin replays in a traced
    call: a buffer in the graphs' shared pool would be written by the
    plain graph's replays.  A traced eager launch shares one buffer with
    the launches of its size, stored into while fresh, so that no launch
    zeroes it."""
    loc = _local
    if loc.capture is None and loc.sizes is None and loc.call is None:
        return None, False
    device = torch.device(device)
    if device.type != "cuda":
        return None, False
    if _capturing():
        if loc.capture is not None:
            return loc.capture.take_counts(rows), False
        if loc.sizes is not None:
            loc.sizes.append((device, rows))
        return None, False
    if loc.call is None:
        return None, False
    key = (device, rows)
    with _rec.lock:
        t = _rec.eager_counts.get(key)
        if t is None:
            t = _rec.eager_counts[key] = torch.empty(
                (rows, 2), dtype=torch.int32, device=device)
            _rec.fresh.add(id(t))
        fresh = id(t) in _rec.fresh
        _rec.fresh.discard(id(t))
        _rec.added([t])
    return t, fresh


@contextlib.contextmanager
def kernel_sizes():
    """Collect, into the list it yields, the (device, rows) of each kernel
    counter a capture inside the block would take if it were a twin's."""
    outer, _local.sizes = _local.sizes, []
    try:
        yield _local.sizes
    finally:
        _local.sizes = outer


# ------------------------------------------------------------- device spans

def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


class Marks:
    """The timing events at the device-span boundaries of one launch: an
    eager launch's own, or a traced twin's, recorded into its graph at
    capture as external event-record nodes and rewritten by each replay.

    ``events`` are the boundaries in stream order; ``layout`` holds a span
    a row, (name, parent, scale, index of its start event, of its end
    event)."""

    def __init__(self, external: bool = True, counts=()):
        self.external = external
        self.events = []
        self.layout = []
        self.stack = []
        self.tail = None
        self.unread = None       # the call whose times the events hold
        self.anchor = 0          # its launch's start
        # the kernel counters its capture hands out in turn, made (zeroed)
        # outside the capture for each (device, rows) of ``counts``
        self.counts = [torch.zeros((rows, 2), dtype=torch.int32,
                                   device=dev) for dev, rows in counts]
        self.taken = 0

    def capture(self, fn):
        """``fn()`` with this object collecting the boundaries (a twin's
        capture; on the CPU, where no graph records, the spans are timed
        on the host as any eager run's)."""
        outer, _local.capture = _local.capture, self
        try:
            return fn()
        finally:
            _local.capture = outer

    def _mark(self) -> int:
        ev = torch.cuda.Event(enable_timing=True, external=self.external)
        ev.record()
        self.events.append(ev)
        return len(self.events) - 1

    def open(self, name: str, parent: Optional[str], scale, leaf: bool):
        start = None
        if leaf:
            start = self.tail if self.tail is not None else self._mark()
            for row in self.stack:          # parents start at a first leaf
                if row[3] is None:
                    row[3] = start
        self.stack.append([name, parent, scale, start, leaf])

    def close(self) -> None:
        name, parent, scale, start, leaf = self.stack.pop()
        if leaf:
            self.tail = self._mark()
        elif start is None:                 # a parent with no leaf
            return
        self.layout.append((name, parent, scale, start, self.tail))

    def take_counts(self, rows: int) -> Optional[torch.Tensor]:
        """The next kernel counter of the capture, if it has ``rows``."""
        if self.taken < len(self.counts) and \
                self.counts[self.taken].shape[0] == rows:
            self.taken += 1
            return self.counts[self.taken - 1]
        return None

    def replayed(self) -> None:
        """The events now hold the times of the traced call running."""
        c = _local.call
        if c is None:
            return
        if self.counts:
            _rec.added(self.counts)
        if not self.layout:
            return
        self.unread, self.anchor = c, c.launch_ns
        c.unread += 1
        with _rec.lock:
            _rec.pending.append(self)

    def before_replay(self) -> None:
        """About to be rewritten: read the times if done, else drop them."""
        if self.unread is not None and not self.read():
            c, self.unread = self.unread, None
            with _rec.lock:
                if self in _rec.pending:
                    _rec.pending.remove(self)
            _rec.settle(c, dropped=True)

    def read(self) -> bool:
        """Turn done events into the unread call's spans; False where the
        last event has not completed."""
        c = self.unread
        if c is None:
            return True
        if not self.events[-1].query():
            return False
        first = self.events[0]
        off = [0.0]
        off.extend(first.elapsed_time(e) for e in self.events[1:])
        ms = c.device_ms
        for name, _, _, i, j in self.layout:
            ms[name] = ms.get(name, 0.0) + off[j] - off[i]
        c.readings.append((self.layout, off, self.anchor))
        self.unread = None
        _rec.settle(c, dropped=False)
        return True


def _target():
    """Where a device span opened now is kept: a twin's :class:`Marks` in
    its capture, an eager launch's on the card, ``"host"`` (timed by the
    host clock: the CPU), or None (tracing off, or a plain capture)."""
    loc = _local
    if loc.capture is not None and _capturing():
        return loc.capture
    if loc.call is None or _capturing():
        return None
    return loc.marks if loc.marks is not None else "host"


def span(name: str):
    """A device span, a leaf (one of :data:`LEAVES`); with a PhaseTimer
    fed (:func:`phases`), the leaf is that timer's phase too."""
    loc = _local
    if loc.timer is None and loc.call is None and loc.capture is None:
        return _NOOP
    return _device_span(name, None, True)


def scale(sl: int):
    """The parent span ``scale <sl>`` of a scale's five phases."""
    loc = _local
    if loc.call is None and loc.capture is None:
        return _NOOP
    return _device_span(f"scale {sl}", sl, False)


@contextlib.contextmanager
def _device_span(name: str, sl, leaf: bool):
    loc = _local
    timed = loc.timer.phase(name) if leaf and loc.timer is not None \
        else _NOOP
    target = _target()
    outer_scale = loc.scale
    if sl is not None:
        loc.scale = sl
    parent = loc.open[-1] if loc.open else None
    loc.open.append(name)
    with timed:
        try:
            if target is None:
                yield
            elif target == "host":
                c, t0 = loc.call, clock_ns()
                yield
                t1 = clock_ns()
                c.device.append((name, parent, loc.scale, t0, t1))
                c.device_ms[name] = (c.device_ms.get(name, 0.0)
                                     + (t1 - t0) / 1e6)
            else:
                target.open(name, parent, loc.scale, leaf)
                yield
                target.close()
        finally:
            loc.open.pop()
            loc.scale = outer_scale


@contextlib.contextmanager
def phases(timer):
    """Feed ``timer`` (a ``utils.timing.PhaseTimer``) from the leaves run
    inside the block (``None``: nothing)."""
    outer = _local.timer
    if timer is not None:
        _local.timer = timer
    try:
        yield
    finally:
        _local.timer = outer


# ------------------------------------------------------------- chrome trace

_TIDS = {"host": ("program host spans", 1_000_001),
         "device": ("program device spans", 1_000_002)}


def _add_spans_to_chrome_trace(path: str, kept: list) -> None:
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    for label, tid in _TIDS.values():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": label}})
    for s in kept:
        args = {"call": s.call, "parent": s.parent}
        if s.scale is not None:
            args["scale"] = s.scale
        if s.mode is not None:
            args["mode"] = s.mode
        events.append({"ph": "X", "cat": "program span", "name": s.name,
                       "pid": pid, "tid": _TIDS[s.on][1],
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)
