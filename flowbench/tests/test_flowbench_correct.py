"""``correct`` on tiny cells on the CPU: a sound run passes, and the
control (the program's bf16 mode) and each fault the cells can have fail.
These runs skip the harness's look for a card (``run_cell`` with
``device="cpu"``) and drive the rest of a run.  The tiny cells' limit is
theirs (:data:`conftest.LIMIT`); the benchmark's cells hold their own
(``limits/*.json``), read on the card by ``python -m flowbench.calibrate``.
Where a fault needs a batch of frames or more than one card (half of a
batch left out, the exchange between cards left out) no cell has it: every
cell runs one frame pair a call on one card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import flowonthego_tpu_torch
from flowbench.run import run_cell

from conftest import TINY_CELLS


class Port:
    """The program with ``stream_flow`` and ``compute_flow`` wrapped."""

    def __init__(self, wrap_stream=None, wrap_pair=None):
        self.wrap_stream, self.wrap_pair = wrap_stream, wrap_pair

    def __getattr__(self, name):
        return getattr(flowonthego_tpu_torch, name)

    def stream_flow(self, *args, **kw):
        flows = flowonthego_tpu_torch.stream_flow(*args, **kw)
        return self.wrap_stream(flows) if self.wrap_stream else flows

    def compute_flow(self, *args, **kw):
        flow = flowonthego_tpu_torch.compute_flow(*args, **kw)
        return self.wrap_pair(flow) if self.wrap_pair else flow


def stale_stream(flows):
    """A step that returns its state unchanged: each step yields the flow
    the step before delivered."""
    prev = None
    for f in flows:
        yield f if prev is None else prev
        prev = f


class StalePair:
    def __init__(self):
        self.prev = None

    def __call__(self, flow):
        out = flow if self.prev is None else self.prev
        self.prev = flow
        return out


def altered(flow):
    """An answer altered where it is produced: a quarter of the frame
    0.05 px off in x."""
    out = flow.clone() if isinstance(flow, torch.Tensor) else flow.copy()
    h, w = out.shape[0] // 2, out.shape[1] // 2
    out[:h, :w, 0] += 0.05
    return out


def altered_stream(flows):
    for f in flows:
        yield altered(f)


def alternate_stream(flows):
    """A fault on every other step, as in one of two interleaved
    recordings: the odd steps' flows altered."""
    for n, f in enumerate(flows):
        yield altered(f) if n % 2 else f


class AlternatePair:
    def __init__(self):
        self.n = 0

    def __call__(self, flow):
        self.n += 1
        return altered(flow) if self.n % 2 else flow


def run(root, cell, port=None, changes=None, seed=2 ** 31 + 5):
    return run_cell(cell, seed, 0.5, False, device="cpu", root=root,
                    port=port, changes=changes)


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_control_fails(tiny_root, cell):
    r = run(tiny_root, cell, changes={"dtype": "bfloat16"})
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny-op4.ring", "stale"), ("tiny-op2.ring-device", "stale"),
    ("tiny-op4.pairs", "stale"), ("tiny-op4.ring", "altered"),
    ("tiny-op2.ring-device", "altered"), ("tiny-op4.pairs", "altered"),
    ("tiny-op4.ring", "alternate"), ("tiny-op2.ring-device", "alternate"),
    ("tiny-op4.pairs", "alternate")])
def test_fault_fails(tiny_root, cell, fault):
    if cell.endswith("pairs"):
        wrap = {"stale": StalePair, "altered": lambda: altered,
                "alternate": AlternatePair}[fault]()
        port = Port(wrap_pair=wrap)
    else:
        port = Port(wrap_stream={"stale": stale_stream,
                                 "altered": altered_stream,
                                 "alternate": alternate_stream}[fault])
    r = run(tiny_root, cell, port=port)
    assert not r["correct"], r["checks"]
    assert np.isfinite(r["checks"]["epe_ref_p99"]["value"])
