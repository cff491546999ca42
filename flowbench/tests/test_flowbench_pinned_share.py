"""The reader of ``pinned_share`` (the program's pinned byte counter over
its bytes across the host link) on hand-made reports, on a program
without the counter, and on the program's report of a tiny CPU run; on
the card, a tiny traced cell prints it."""

from __future__ import annotations

import sys
import types

import pytest
import torch

from flowbench import program_spans
from flowbench.layer_metrics import pinned_share

# four 4K stream frames: a uint8 frame up and a flow down, each
REPORT = {"calls": 4, "modes": {"replay": 4},
          "htod_bytes": 4 * 25_067_520, "dtoh_bytes": 4 * 66_846_720,
          "pinned_bytes": 4 * (25_067_520 + 66_846_720), "pinned_blocks": 1,
          "recordings": 0, "dropped": 0, "pending": 0, "device_calls": 4,
          "host_ms": {"ingest": 4.0, "launch": 2.0, "fetch": 8.0},
          "device_ms": {"pyramid": 0.3}}


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
    return pinned_share.read({"frames": 4})


@pytest.mark.parametrize("pinned,share", [
    (REPORT["pinned_bytes"], 100.0),
    (4 * 66_846_720, 100.0 * 66_846_720 / (25_067_520 + 66_846_720)),
    (0, 0.0)])
def test_share_of_the_bytes_that_crossed_pinned(program, pinned, share):
    program(dict(REPORT, pinned_bytes=pinned))
    assert read() == pytest.approx(share)


@pytest.mark.parametrize("report", [
    {k: v for k, v in REPORT.items()
     if k not in ("pinned_bytes", "pinned_blocks")},      # before the counter
    dict(REPORT, htod_bytes=0, dtoh_bytes=0, pinned_bytes=0),  # none crossed
    dict(REPORT, calls=0)])                                # no call kept
def test_none_where_there_is_nothing_to_read(program, report):
    program(report)
    assert read() is None


def test_none_without_the_programs_report(monkeypatch):
    monkeypatch.setitem(sys.modules, program_spans.PROFILING,
                        types.ModuleType(program_spans.PROFILING))
    assert read() is None


def test_a_cpu_run_crosses_nothing():
    import flowonthego_tpu_torch as port
    from flowonthego_tpu_torch.utils import profiling
    from flowonthego_tpu_torch.utils.synth import synthetic_frames
    cfg = port.DISConfig(coarsest_scale=2, finest_scale=1,
                         grad_descent_iter=4, use_var_ref=True)
    frames = synthetic_frames(2, 3, 44, 64, (2, 1), factor=4)
    profiling.enable()
    try:
        list(port.stream_flow(frames, cfg, device="cpu"))
    finally:
        profiling.disable()
    r = program_spans.report({"frames": 2})
    assert r["pinned_bytes"] == r["htod_bytes"] == r["dtoh_bytes"] == 0
    assert pinned_share.read({"frames": 2}) is None


@pytest.mark.cuda
def test_traced_tiny_cells_read_pinned_share(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from flowbench.run import run_cell
    shares = {}
    for cell in ("tiny-op4.ring", "tiny-op4.pairs"):
        r = run_cell(cell, 2 ** 31 + 91, 1.0, True, device="cuda",
                     root=tiny_root)
        assert r["correct"], r["checks"]
        shares[cell] = r["metrics"]["pinned_share"]["value"]
    assert 0.0 < shares["tiny-op4.ring"] < 100.0    # small frames pageable
    assert shares["tiny-op4.pairs"] == 0.0          # the harness fetches
    r = run_cell("tiny-op2.ring-device", 2 ** 31 + 92, 1.0, True,
                 device="cuda", root=tiny_root)
    assert "pinned_share" not in r["metrics"]       # nothing crosses
