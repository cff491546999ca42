"""The reader of ``gn_window_reuse`` (the share of the patch solve's trips
that loaded no window tap, by the program's kernel counters) on hand-made
reports and on a program without the counters; on the card, the tiny
traced cells read it."""

from __future__ import annotations

import sys
import types

import pytest
import torch

from flowbench import program_spans
from flowbench.layer_metrics import gn_window_reuse

# four Sintel stream frames at op 4
REPORT = {"calls": 4, "modes": {"replay": 4}, "htod_bytes": 0,
          "dtoh_bytes": 0, "recordings": 0, "dropped": 0, "pending": 0,
          "device_calls": 4,
          "counters": {"patches_fw": 4 * 68_485,
                       "gn_trips": 4 * 8_760_000,
                       "gn_window_loads": 4 * 700_800},
          "host_ms": {"launch": 2.0}, "device_ms": {"opti": 24.0}}


@pytest.fixture
def program(monkeypatch):
    """Install a stand-in for the program's profiling module whose
    ``report`` returns the given report."""
    def install(report):
        mod = types.ModuleType(program_spans.PROFILING)
        mod.report = lambda calls=None: report
        monkeypatch.setitem(sys.modules, program_spans.PROFILING, mod)
    return install


def read():
    return gn_window_reuse.read({"frames": 4})


@pytest.mark.parametrize("loads,share", [(4 * 700_800, 92.0),
                                         (4 * 8_760_000, 0.0),
                                         (0, 100.0)])
def test_share_of_the_trips_that_loaded_nothing(program, loads, share):
    counters = dict(REPORT["counters"], gn_window_loads=loads)
    program(dict(REPORT, counters=counters))
    assert read() == pytest.approx(share)


@pytest.mark.parametrize("counters", [
    {"patches_fw": 4 * 68_485},                         # before the counters
    {"gn_trips": 4 * 8_760_000},                        # half of them
    {"gn_trips": 0, "gn_window_loads": 0}])             # no trip counted
def test_none_where_there_is_nothing_to_read(program, counters):
    program(dict(REPORT, counters=counters))
    assert read() is None


def test_none_without_a_call_or_the_programs_report(program, monkeypatch):
    program(dict(REPORT, calls=0))
    assert read() is None
    monkeypatch.setitem(sys.modules, program_spans.PROFILING,
                        types.ModuleType(program_spans.PROFILING))
    assert read() is None


@pytest.mark.cuda
def test_traced_tiny_cells_read_gn_window_reuse(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from flowbench.run import run_cell
    for k, cell in enumerate(("tiny-op4.ring", "tiny-op4.pairs",
                              "tiny-op2.ring-device")):
        r = run_cell(cell, 2 ** 31 + 93 + k, 1.0, True, device="cuda",
                     root=tiny_root)
        assert r["correct"], r["checks"]
        assert 0.0 <= r["metrics"]["gn_window_reuse"]["value"] < 100.0
