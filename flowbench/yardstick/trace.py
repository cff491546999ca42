"""A traced stretch of a window: ``torch.profiler`` over a number of
frames, reduced to the summary the per-layer readers take.

The profile opens with a warm-up step of :data:`.categories.THROW_AWAY`
throw-away kernels that no path runs (lgamma), and the recorded step
begins with as many others (digamma): the tracer at times loses device
events at the start of what it records, so a profile that does not show
exactly that many digamma kernels is incomplete (the manner of
``profile_paths.device_breakdown`` at commit 5c83323).

Device time is the union of the device events' intervals: events that
overlap count once, so the busy share cannot pass the window.  Idle gaps
are the stretches of the traced window that no device event covers,
each named by the innermost of the benchmark's own spans
(``record_function``) that holds its midpoint on the host's clock.  The
host's operations and runtime calls are summed by name on their own time
(the frame conversion, the pageable copies' host side, the syncs), for
the log.
"""

from __future__ import annotations

import bisect
import collections

import torch

from .categories import LAUNCH_CALLS, THROW_AWAY, category

SPANS = ("entry call", "fetch", "next frame")
OUTSIDE = "between calls"


def union(intervals) -> list:
    """The intervals (start, end) merged where they overlap or touch,
    sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def gaps(merged, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that the merged intervals leave free."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def innermost(spans, starts, t: float, default: str = OUTSIDE) -> str:
    """The name of the latest-starting span holding ``t``; ``spans`` are
    (name, start, end) sorted by start, ``starts`` their starts.  The
    benchmark's spans nest two deep at most, so the search looks at the
    last few that start before ``t``."""
    k = bisect.bisect_right(starts, t)
    for name, s, e in reversed(spans[max(0, k - 3):k]):
        if e >= t:
            return name
    return default


class Tracer:
    """``start()`` before a stretch of frames, ``stop(frames)`` after it:
    the summary of what ran (its ``complete`` says whether the profile
    showed every throw-away kernel)."""

    def __init__(self):
        self.prof = None

    def warm(self) -> None:
        """Take one short profile now: the tracer's own set-up (seconds on
        its first use in a process) then happens here, not in a window."""
        self.start()
        torch.cuda.synchronize()
        self.prof.stop()
        self.prof.events()
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule
        scratch = torch.ones(1, device="cuda")
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=1, active=1))
        self.prof.start()
        self._throw_away(scratch.lgamma_)
        self.prof.step()
        self._throw_away(scratch.digamma_)

    @staticmethod
    def _throw_away(op) -> None:
        for _ in range(THROW_AWAY):
            op()
        torch.cuda.synchronize()

    def stop(self, frames: int):
        torch.cuda.synchronize()
        self.prof.stop()
        events = self.prof.events()
        self.prof = None
        return summarize(events, frames)


def summarize(events, frames: int) -> dict:
    """The summary of a profile's events over ``frames`` frames."""
    from torch.autograd import DeviceType
    device, spans, host, ops = [], [], [], []
    thrown = 0
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name in SPANS:           # a span's shadow on the device
                continue
            if "digamma" in e.name or "lgamma" in e.name:
                thrown += "digamma" in e.name
                continue
            device.append((s, t, category(e.name)))
        elif e.name in SPANS:
            spans.append((e.name, s, t))
        else:
            if e.name.startswith(LAUNCH_CALLS):
                host.append(s)
            ops.append((s, e.name, e.self_cpu_time_total))
    if not spans:
        raise RuntimeError("the profile holds none of the benchmark's spans")
    lo = min(s for _, s, _ in spans)
    hi = max(e for _, _, e in spans)
    by_cat = collections.Counter()
    for s, t, cat in device:
        if t > lo and s < hi:
            by_cat[cat] += (min(t, hi) - max(s, lo)) / 1e6
    busy = union(clip([(s, t) for s, t, _ in device], lo, hi))
    spans.sort(key=lambda x: x[1])
    starts = [s for _, s, _ in spans]
    idle = collections.Counter()
    for s, t in gaps(busy, lo, hi):
        idle[innermost(spans, starts, 0.5 * (s + t))] += (t - s) / 1e6
    host_s = collections.Counter()
    for s, name, self_us in ops:
        if lo <= s <= hi:
            host_s[name] += self_us / 1e6
    return {
        "complete": thrown == THROW_AWAY,
        "frames": frames,
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(t - s for s, t in busy) / 1e6,
        "device_s": dict(by_cat),
        "idle_s": dict(idle),
        "launch_calls": sum(1 for s in host if lo <= s <= hi),
        "host_s": dict(host_s),
    }
