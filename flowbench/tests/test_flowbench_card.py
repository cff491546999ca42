"""The harness on the card: a tiny cell with and without the trace.
Skipped without a CUDA device (decided inside each test)."""

from __future__ import annotations

import pytest
import torch

from flowbench.run import run_cell


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny-op4.ring", "tiny-op4.pairs",
                                  "tiny-op2.ring-device"])
def test_traced_run_on_the_card(tiny_root, cell):
    need_card()
    r = run_cell(cell, 11, 1.0, True, device="cuda", root=tiny_root)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    for name in ("launch_calls", "pyramid_ms", "patch_solve_ms",
                 "device_idle_share", "stream_frame_ms_p95"):
        assert r["metrics"][name]["value"] > 0
    assert r["breakdown"]["device_ops"]
    assert list(r)[-1] == "checks"


@pytest.mark.cuda
def test_untraced_run_on_the_card(tiny_root):
    need_card()
    r = run_cell("tiny-op2.ring", 12, 1.0, False, device="cuda",
                 root=tiny_root)
    assert r["correct"], r["checks"]
    assert r["device"]["memory_peak_bytes"] > 0
    assert set(r["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
