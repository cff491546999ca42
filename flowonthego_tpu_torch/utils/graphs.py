"""The jitted forms of the entry points: CUDA-graph captures, one graph
launch per static path.

The JAX package compiles each entry point into one program with
``jax.jit`` (``flow_full_padded``, ``batched_flow``, the ``step`` of
``stream_flow``, ``MultiStream``'s ``step_fn``).  PyTorch runs eagerly, a
few hundred to a few thousand launches a pair, and on this pipeline the
host cannot enqueue them as fast as the card runs them.  The counterpart
of ``jit`` for that case is a CUDA graph: the launches of one call are
recorded once on fixed tensors and replayed as one launch.  A graph
replays the same hand-written kernels and the same PyTorch kernels with
the same arguments, so a captured call returns the eager call's numbers
bit for bit.

Two kinds of path:

* :func:`run` — a stateless function of tensors (``flow_full_padded``,
  ``dis_flow_padded``, ``compute_disparity``; ``compute_flow`` is
  ``flow_full_padded`` with its padding as a static argument).  Paths are
  cached by (entry, shapes and dtypes, static arguments such as ``cfg``,
  device).  The first call of a path runs eagerly on the caller's tensors
  and its result is the answer; it is also the warm-up (it builds and
  loads the kernels and fills the constant caches, which must not happen
  while capturing), and the graph is recorded right after it.  Every later call copies its
  inputs into the path's input tensors, replays, and returns a copy of
  the output, so a returned flow never changes when the next call
  replays.
* :class:`StreamPath` — the step of a warm-started stream, whose carried
  state (the previous frame's pyramid, the warm start) is both read and
  written by a step.  The state lives in two sets of fixed tensors, on the
  CPU and eagerly too, and two captures alternate between them, step k
  reading set k and writing set 1 - k, so no pyramid is copied from frame
  to frame.  Both captures share one memory pool (they never run at
  once).  A path serves one stream at a time: a second stream of the same
  key, started while the first still runs, gets a path of its own that
  dies with it.

Which entries are captured is the table :data:`ENTRIES`, and nothing
else: a capture that fails raises, and no call falls back to eager
execution because of an error.  On the CPU there is no graph and every
entry runs the same Python eagerly.  :func:`eager` switches capturing off
for a block (to compare, to profile launch by launch).

Each capture owns a private memory pool.  The cache holds at most
:data:`MAX_ENTRIES` paths, the least recently used goes, and
:func:`clear` frees them all, with the constants the paths read
(``utils.device.device_constant``).  The kernel wrappers' launch counts
are theirs alone: a wrapper counts where it is called (eagerly, or once
while a capture records it), and a replay, which calls no wrapper, counts
nothing; what a replay ran on the device is read from a profile.

Every recording has traced twins (``utils/profiling.py``): the same
function recorded right after it, in the same memory pool, with a timing
event at each device-span boundary.  A call traced by
``utils/profiling`` replays a twin, any other call the plain graph; both
run the same kernels on the same tensors.  What the recording counted
(``profiling.count``: the patches each direction solves) is added to a
traced call on each replay, since a replay runs no Python; a twin's
kernels count on the card into buffers made for it outside the pool
(``profiling.kernel_counts``), the plain graph's count nothing.

Captured paths run on the current CUDA stream and a path's tensors are
shared by its calls, so calls of one path must come from one stream.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
from typing import Callable, Sequence

import torch

from . import device as device_mod
from . import profiling

MAX_ENTRIES = 8

# entry -> None where it is captured on the card, else why it runs eagerly
ENTRIES = {
    "flow_full_padded": None,          # flow_full_padded, batched_flow, and
                                       # with their padding and crop
                                       # compute_flow and DISFlow
    "dis_flow_padded": None,           # batched_flow(full_res=False)
    "compute_disparity": None,         # compute_disparity
    "stream_step": None,               # stream_flow, MultiStream.push
    "spatial_flow": None,              # the spatial forms (make_spatial_flow,
                                       # make_batch_spatial_flow,
                                       # make_fine_spatial_flow,
                                       # make_tile2d_flow) on a mesh whose
                                       # positions are all one device
    "spatial_flow_devices": "the spatial forms on a mesh over several "
                            "cards: a CUDA graph records one device's work",
    "stream_start": "runs once a stream: it writes the first frame's "
                    "pyramid into the step's tensors",
    "compute_flow_timed": "synchronises after every phase to time it",
    "command_line": "computes one pair a process: recording the graph "
                    "costs more than the one eager call it would follow",
}

_lock = threading.RLock()
_cache: "collections.OrderedDict" = collections.OrderedDict()
_local = threading.local()


@contextlib.contextmanager
def eager():
    """Run every entry eagerly inside the block (no capture, no replay)."""
    old = getattr(_local, "eager", False)
    _local.eager = True
    try:
        yield
    finally:
        _local.eager = old


def enabled(entry: str, device) -> bool:
    """Whether ``entry`` takes a captured path on ``device``: on a CUDA
    device, unless the table or :func:`eager` says otherwise."""
    if ENTRIES[entry] is not None or getattr(_local, "eager", False):
        return False
    return torch.device(device).type == "cuda"


class _Recording:
    """``fn()`` recorded once on fixed tensors as a CUDA graph (recording
    runs nothing); :meth:`replay` runs it into the same output tensors."""

    def __init__(self, fn: Callable, device: torch.device, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        # the graph reads the device constants at fixed addresses: they
        # live as long as it does, whatever clear() drops meanwhile
        self.constants = device_mod.constants()
        # No graph may be destroyed while a stream captures (the capture is
        # invalidated): collect what is garbage now and keep the collector
        # from running inside the capture.
        gc.collect()
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(device):
                with torch.cuda.graph(self.graph, pool=pool):
                    self.out = fn()
        finally:
            if gc_was_on:
                gc.enable()

    def pool(self):
        return self.graph.pool()

    def free(self) -> None:
        """Give the graph and its output tensors back now."""
        self.out = self.constants = None
        if self.graph is not None:
            self.graph.reset()
            self.graph = None

    def replay(self):
        self.graph.replay()
        return self.out


class _Traced:
    """A recording of ``fn()`` and its traced twins (recorded after it in
    its pool, a timing event at each device-span boundary): a traced call
    replays a twin, any other call the plain graph.  ``twins`` twins take
    the traced calls in turn, so that a twin's times are read (after the
    next call's launch) before it replays again: 2 for a path whose calls
    all replay it, 1 for each of a stream's two alternating recordings."""

    def __init__(self, fn: Callable, device: torch.device, pool=None,
                 twins: int = 2):
        # what the capture counts (profiling.count), added on each replay
        # and the kernel counters a twin's capture will take
        with profiling.tally() as self.counters, \
                profiling.kernel_sizes() as sizes:
            self.plain = _Recording(fn, device, pool)
        self.twins = []
        with profiling.tally():             # the same work: counted once
            for _ in range(twins):
                marks = profiling.Marks(counts=sizes)
                self.twins.append((_Recording(
                    lambda marks=marks: marks.capture(fn), device,
                    pool=self.plain.pool()), marks))
        self.turn = 0
        profiling.recorded()

    def pool(self):
        return self.plain.pool()

    def free(self) -> None:
        self.plain.free()
        for twin, _ in self.twins:
            twin.free()

    def replay(self):
        if not profiling.active():
            return self.plain.replay()
        profiling.counted(self.counters)
        twin, marks = self.twins[self.turn]
        self.turn = (self.turn + 1) % len(self.twins)
        marks.before_replay()
        out = twin.replay()
        marks.replayed()
        return out


def _copy_out(out):
    """A call's result: copies, so the next replay cannot change it."""
    with profiling.host_span("copy_out"):
        if isinstance(out, torch.Tensor):
            return out.clone()
        return tuple(x.clone() for x in out)


def _ingest(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy a call's input into a path's tensor (``utils.device.copy_in``:
    a host input through pinned staging in ``dst``'s dtype, which a
    stream path gives its frames' dtype; the bytes that cross counted)."""
    device_mod.copy_in(dst, src)


# ---------------------------------------------------------- stateless paths

class _StaticPath:
    """One stateless function recorded on input tensors of its own."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor]):
        dev = inputs[0].device
        fixed = [torch.empty(x.shape, dtype=x.dtype, device=dev)
                 for x in inputs]
        self.inputs = fixed
        self.device = dev
        self.recording = _Traced(lambda: fn(*fixed), dev)
        self.replays = 0
        self.busy = False

    def free(self) -> None:
        self.recording.free()

    def __call__(self, inputs):
        with profiling.host_span("ingest"):
            for dst, src in zip(self.inputs, inputs):
                _ingest(dst, src)
        self.replays += 1
        with profiling.launch("replay", self.device):
            out = self.recording.replay()
        return _copy_out(out)


def _insert(key, path) -> None:
    _cache[key] = path
    _cache.move_to_end(key)
    while len(_cache) > MAX_ENTRIES:
        _drop(_cache.popitem(last=False)[1])


def _drop(path) -> None:
    """Free a path that left the cache, unless a stream still holds it
    (then it goes with the stream)."""
    if not path.busy:
        path.free()


def run(entry: str, fn: Callable, inputs: Sequence[torch.Tensor],
        static=()):
    """``fn(*inputs)`` through the captured path of (``entry``, the
    inputs' shapes, dtypes and device, ``static``); eagerly where
    :func:`enabled` says so.  ``static`` holds every argument ``fn`` closes
    over that changes what it computes (``cfg``, flags); it must be
    hashable.  ``fn`` returns a tensor or a tuple of tensors."""
    dev = inputs[0].device
    with profiling.call():
        if not enabled(entry, dev):
            with profiling.launch("eager", dev):
                return fn(*inputs)
        key = (entry, static, str(dev),
               tuple((tuple(x.shape), x.dtype) for x in inputs))
        with _lock:
            path = _cache.get(key)
            if path is None:
                # first call: eager, and everything a capture must find
                # ready (kernels built, constants on the device) is ready
                # after it
                with profiling.launch("record", dev):
                    out = fn(*inputs)
                    _insert(key, _StaticPath(fn, inputs))
                return out
            _cache.move_to_end(key)
            return path(inputs)


# ------------------------------------------------------------- stream paths

class StreamPath:
    """The step of a warm-started stream on fixed tensors: with
    ``capture`` as two alternating recordings, without it as the same
    step run eagerly on the same tensors.

    ``make(device)`` builds the stream's fixed tensors and returns
    ``(state, frames, step)``: the two state sets (kept here as
    :attr:`state` for the stream's owner), the tensor a new batch of
    frames is copied into, and ``step(k)``, which reads ``frames`` and
    state set ``k``, writes state set ``1 - k`` and returns the flow.  The
    owner (``parallel.frame_parallel.StreamCore``) starts a stream by
    writing set 0 itself and then calls :meth:`step` once a frame.
    """

    def __init__(self, make: Callable, device: torch.device,
                 capture: bool = True):
        self.device = device
        self.capture = capture
        self.busy = False
        self.state, self.frames, self._step_fn = make(device)
        self._recordings = None
        self.k = 0
        self.replays = 0

    def step(self, frames):
        """Copy ``frames`` in, advance one step, return the flow (the
        caller's own: a copy where a graph wrote it).  The first step of
        a new captured path runs eagerly (its result is the answer) and
        then records both alternations."""
        with profiling.call():
            with profiling.host_span("ingest"):
                _ingest(self.frames, frames if isinstance(
                    frames, torch.Tensor) else torch.as_tensor(frames))
            k = self.k
            self.k = 1 - k
            step = self._step_fn
            if not self.capture:
                with profiling.launch("eager", self.device):
                    return step(k)
            if self._recordings is None:
                with profiling.launch("record", self.device):
                    out = step(k)
                    first = _Traced(lambda: step(0), self.device,
                                    twins=1)
                    second = _Traced(lambda: step(1), self.device,
                                     pool=first.pool(), twins=1)
                self._recordings = (first, second)
                return out
            self.replays += 1
            with profiling.launch("replay", self.device):
                out = self._recordings[k].replay()
            return _copy_out(out)

    def release(self) -> None:
        """The stream has ended: another may take the path, or, if the
        path is in the cache no more, its memory goes now."""
        self.busy = False
        with _lock:
            if self not in _cache.values():
                self.free()

    def free(self) -> None:
        for rec in self._recordings or ():
            rec.free()
        self._recordings = None
        self.state = self.frames = self._step_fn = None


def acquire_stream(entry: str, key, make: Callable, device) -> StreamPath:
    """The stream path of (``entry``, ``key``, ``device``) for one stream,
    marked busy until its :meth:`StreamPath.release`: the cached one if no
    stream holds it, else a new one (cached if the key is new, private if
    the cached one is in use).  Where :func:`enabled` says the entry runs
    eagerly, a private path that captures nothing."""
    device = torch.device(device)
    full_key = (entry, key, str(device))
    with _lock:
        if not enabled(entry, device):
            path = StreamPath(make, device, capture=False)
            path.busy = True
            return path
        path = _cache.get(full_key)
        if path is not None and not path.busy:
            _cache.move_to_end(full_key)
        else:
            fresh = StreamPath(make, device)
            if path is None:
                _insert(full_key, fresh)
            path = fresh
        path.busy = True
        path.k = 0          # the stream's first step reads state set 0
        return path


# -------------------------------------------------------------------- cache

def clear() -> None:
    """Drop every cached path (its graphs, tensors and memory pool go once
    no stream holds it) and the device constants."""
    with _lock:
        while _cache:
            _drop(_cache.popitem()[1])
    device_mod.clear_constants()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def cached_paths() -> list:
    """(entry, replays so far) of every cached path, least recently used
    first."""
    with _lock:
        return [(key[0], path.replays) for key, path in _cache.items()]


def table() -> str:
    """The captured and the eager entries, one a line, with the reasons."""
    return "\n".join(
        f"  {entry}: " + ("captured (one graph launch a call)"
                          if reason is None else f"eager: {reason}")
        for entry, reason in ENTRIES.items())
