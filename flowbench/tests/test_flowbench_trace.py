"""The trace arithmetic: interval unions, idle gaps named by spans, the
device's idle share, and a summary of hand-made events."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from flowbench.layer_metrics import (device_idle_share, launch_calls,
                                     stream_frame_ms_p95)
from flowbench.yardstick import trace


def test_union_merges_overlaps_and_touches():
    assert trace.union([(5, 7), (0, 2), (1, 3), (3, 4), (6, 6.5)]) == [
        (0, 4), (5, 7)]
    assert trace.union([]) == []


def test_gaps_and_clip():
    merged = trace.union(trace.clip([(-5, 1), (2, 3), (2.5, 4), (9, 20)],
                                    0, 10))
    assert merged == [(0, 1), (2, 4), (9, 10)]
    assert trace.gaps(merged, 0, 10) == [(1, 2), (4, 9)]
    assert trace.gaps([], 0, 3) == [(0, 3)]


def test_idle_share_counts_overlap_once():
    # two streams of events overlapping: summed they would read 150% busy
    ivs = [(0, 6), (3, 9), (10, 12)]
    busy = sum(e - s for s, e in trace.union(ivs))
    assert busy == 11
    s = {"busy_s": busy, "window_s": 20.0}
    assert device_idle_share.read(s) == pytest.approx(45.0)


def test_stream_frame_p95_reads_the_frames_outside_the_profiler():
    ms = np.arange(1.0, 101.0)
    assert stream_frame_ms_p95.read({"frame_ms": ms}) == pytest.approx(
        np.percentile(ms, 95))
    assert stream_frame_ms_p95.read({"frame_ms": ms[:0]}) is None
    assert stream_frame_ms_p95.read({}) is None


def test_innermost_span():
    spans = sorted([("entry call", 0, 10), ("next frame", 1, 2),
                    ("fetch", 10, 12), ("entry call", 13, 20)],
                   key=lambda x: x[1])
    starts = [s for _, s, _ in spans]
    assert trace.innermost(spans, starts, 1.5) == "next frame"
    assert trace.innermost(spans, starts, 5) == "entry call"
    assert trace.innermost(spans, starts, 11) == "fetch"
    assert trace.innermost(spans, starts, 12.5) == trace.OUTSIDE


def ev(name, start, end, device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end),
                           self_cpu_time_total=end - start)


def test_summarize_hand_made_profile():
    cpu = DeviceType.CPU
    events = [ev("digamma_kernel", -50 + k, -49 + k) for k in range(32)]
    events += [ev("cudaLaunchKernel", -60 + k, -59 + k, cpu)
               for k in range(32)]
    events += [ev("entry call", 0, 100, cpu), ev("entry call", 0, 100),
               ev("next frame", 2, 4, cpu),
               ev("fetch", 100, 120, cpu), ev("entry call", 130, 200, cpu),
               ev("cudaGraphLaunch", 5, 6, cpu),
               ev("cudaMemcpyAsync", 7, 8, cpu),
               ev("cudaGraphLaunch", 140, 141, cpu),
               ev("void dis_gn_kernel<float, 12, 3>", 10, 60),
               ev("glue_extract_kernel", 50, 70),          # overlaps K2
               ev("Memcpy DtoH (Device -> Pageable)", 90, 121),
               ev("void at::native::vectorized_elementwise_kernel", 129, 140),
               ev("void at::native::elementwise_kernel", 150, 200)]
    s = trace.summarize(events, frames=2)
    assert s["complete"]
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx((60 + 31 + 11 + 50) * 1e-6)
    assert s["device_s"]["K2 gn"] == pytest.approx(50e-6)
    assert s["device_s"]["G2 extract"] == pytest.approx(20e-6)
    assert s["device_s"]["copy DtoH"] == pytest.approx(31e-6)
    assert s["device_s"]["torch kernels"] == pytest.approx(61e-6)
    # gaps [0, 10], [70, 90], [140, 150] in an entry call, [121, 129]
    # between the fetch and the next call
    assert s["idle_s"] == pytest.approx({"entry call": 40e-6,
                                         trace.OUTSIDE: 8e-6})
    assert s["launch_calls"] == 3
    assert launch_calls.read(s) == 1.5
    # the host's own time by operation, inside the traced window only
    assert s["host_s"] == pytest.approx({"cudaGraphLaunch": 2e-6,
                                         "cudaMemcpyAsync": 1e-6})
    # a profile that lost throw-away kernels says so
    assert not trace.summarize(events[1:], frames=2)["complete"]
