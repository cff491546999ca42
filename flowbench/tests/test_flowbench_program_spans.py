"""The readers of the program's own spans and counters
(``program_spans.py`` and its five per-layer metrics) on hand-made
reports, on a program without a report, and on the program's report of
a tiny CPU run; on the card, a tiny traced cell prints them."""

from __future__ import annotations

import sys
import types

import pytest
import torch

from flowbench import program_spans
from flowbench.layer_metrics import (finest_scale_ms, graph_replay_share,
                                     host_enqueue_ms, transfer_mb,
                                     warm_start_ms)

READERS = {"host_enqueue_ms": host_enqueue_ms, "transfer_mb": transfer_mb,
           "graph_replay_share": graph_replay_share,
           "warm_start_ms": warm_start_ms,
           "finest_scale_ms": finest_scale_ms}

# four Sintel stream frames: a float32 frame up, a flow down, each
REPORT = {"calls": 4, "modes": {"replay": 4}, "htod_bytes": 4 * 5_505_024,
          "dtoh_bytes": 4 * 3_670_016, "recordings": 0, "dropped": 0,
          "pending": 0, "device_calls": 4,
          "host_ms": {"ingest": 4.0, "launch": 2.0, "copy_out": 0.4,
                      "fetch": 8.0},
          "device_ms": {"pyramid": 0.4, "warm_start": 1.2, "coarse": 0.8,
                        "scale 5": 0.2, "scale 1": 6.0, "scale 0": 20.0,
                        "opti": 22.0}}
EMPTY = {"calls": 0, "modes": {}, "htod_bytes": 0, "dtoh_bytes": 0,
         "recordings": 0, "dropped": 0, "pending": 0, "device_calls": 0,
         "host_ms": {}, "device_ms": {}}


@pytest.fixture
def program(monkeypatch):
    """Install a stand-in for the program's profiling module whose
    ``report`` returns the given report and keeps the ``calls`` asked."""
    def install(report, with_report=True):
        mod = types.ModuleType(program_spans.PROFILING)
        asked = []
        if with_report:
            def fake(calls=None):
                asked.append(calls)
                return report
            mod.report = fake
        monkeypatch.setitem(sys.modules, program_spans.PROFILING, mod)
        return asked
    return install


def read_all(frames=4):
    return {name: r.read({"frames": frames}) for name, r in READERS.items()}


def test_readers_on_a_report(program):
    asked = program(REPORT)
    got = read_all(frames=4)
    assert got == pytest.approx({
        "host_enqueue_ms": 1.5, "transfer_mb": 9.17504,
        "graph_replay_share": 100.0, "warm_start_ms": 0.5,
        "finest_scale_ms": 5.0})
    assert set(asked) == {4}          # the traced frames' calls


def test_readers_on_mixed_modes_and_no_device_reading(program):
    program(dict(REPORT, modes={"record": 1, "replay": 3}, device_calls=0,
                 device_ms={}))
    got = read_all()
    assert got["graph_replay_share"] == 75.0
    assert got["host_enqueue_ms"] == 1.5
    assert got["warm_start_ms"] is None and got["finest_scale_ms"] is None


def test_readers_give_none_on_an_empty_report(program):
    program(EMPTY)
    assert set(read_all().values()) == {None}


def test_readers_give_none_without_the_programs_report(program, monkeypatch):
    program(None, with_report=False)       # a program from before it
    assert set(read_all().values()) == {None}
    monkeypatch.delitem(sys.modules, program_spans.PROFILING)
    assert set(read_all().values()) == {None}


def test_readers_on_the_programs_report_of_a_cpu_run():
    import flowonthego_tpu_torch as port
    from flowonthego_tpu_torch.utils import profiling
    from flowonthego_tpu_torch.utils.synth import synthetic_frames
    cfg = port.DISConfig(coarsest_scale=2, finest_scale=1,
                         grad_descent_iter=4, use_var_ref=True)
    frames = synthetic_frames(2, 4, 44, 64, (2, 1), factor=4)
    profiling.enable()
    try:
        flows = list(port.stream_flow(frames, cfg, device="cpu"))
    finally:
        profiling.disable()
    assert len(flows) == 3
    got = read_all(frames=2)
    assert got["transfer_mb"] == 0.0            # nothing left the host
    assert got["graph_replay_share"] == 0.0     # eager on the CPU
    for name in ("host_enqueue_ms", "warm_start_ms", "finest_scale_ms"):
        assert got[name] > 0, name
    assert program_spans.report({"frames": 2})["calls"] == 2


@pytest.mark.cuda
def test_traced_tiny_cell_prints_the_program_metrics(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from flowbench.run import run_cell
    for cell, crossing in (("tiny-op4.ring", True),
                           ("tiny-op2.ring-device", False)):
        r = run_cell(cell, 2 ** 31 + 77, 1.0, True, device="cuda",
                     root=tiny_root)
        assert r["correct"], r["checks"]
        m = {k: v["value"] for k, v in r["metrics"].items()}
        assert m["graph_replay_share"] == 100.0
        assert m["host_enqueue_ms"] > 0 and m["finest_scale_ms"] > 0
        assert m["warm_start_ms"] > 0
        assert (m["transfer_mb"] > 0) == crossing
        ops = {k for k, _ in r["breakdown"]["device_ops"]}
        assert not ops & {"ingest", "launch", "copy_out", "fetch",
                          "pyramid", "opti"}
