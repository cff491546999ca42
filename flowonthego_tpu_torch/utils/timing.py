"""Wall-clock phase timers and warm-up (port of
``flowonthego_tpu/utils/timing.py``).

PyTorch returns before the card finishes, so a phase on a CUDA device
ends with ``torch.cuda.synchronize()``, where the JAX package waited with
``block_until_ready``; on the CPU the work is done when the call returns.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def synchronize(device=None) -> None:
    """Wait for the work queued on ``device`` (a no-op for the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulating named phase timer; ``report()`` mirrors the
    reference's ``printTimings`` layout.  ``device`` is where the timed
    work runs: each phase waits for it before reading the clock.
    ``last[name]`` is the latest run of a phase (ms)."""

    def __init__(self, device=None):
        self.device = device
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.last = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        yield
        synchronize(self.device)
        self.last[name] = (time.perf_counter() - start) * 1000.0
        self.totals[name] += self.last[name]
        self.counts[name] += 1

    def report(self) -> str:
        lines = ["=============== Timings (ms) ==============="]
        for name, total in self.totals.items():
            lines.append(f"[{name:<12}] {total:10.3f}  (n={self.counts[name]})")
        lines.append("============================================")
        return "\n".join(lines)


def warmup(device=None) -> None:
    """Absorb device-init cost before timing: one small matmul, waited for."""
    x = torch.ones((8, 128), dtype=torch.float32, device=device)
    (x @ x.T).sum().item()


def time_fn(fn, *args, iters: int = 10, warmup_iters: int = 2,
            device=None) -> float:
    """Median wall time (ms) of ``fn(*args)``, each call waited for on
    ``device``."""
    for _ in range(warmup_iters):
        fn(*args)
        synchronize(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        synchronize(device)
        times.append((time.perf_counter() - t0) * 1000.0)
    times.sort()
    return times[len(times) // 2]
