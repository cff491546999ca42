"""Profiling hooks (port of ``flowonthego_tpu/utils/profiling.py``).

  * :func:`trace` — a ``torch.profiler`` context that writes a Chrome
    trace (host and, on a GPU, device timeline) into a directory.
  * :func:`annotate` — named ranges (``torch.profiler.record_function``)
    that show up inside traces, the analogue of the reference's phase
    names (pconst/pinit/poptim/cflow/tvopt).
  * :func:`device_memory_stats` — bytes in use, peak and limit of every
    visible GPU.

Nothing here touches CUDA when the module is imported or when there is
no GPU.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, create_perfetto_link: bool = False):
    """Capture a trace: ``with trace("out/t"): run()``.

    Writes ``<log_dir>/trace.json`` (Chrome trace format: load it in
    Perfetto or ``chrome://tracing``) when the block ends and yields
    ``log_dir`` (default: ``fot_trace`` under the temporary directory).
    Host activity is always recorded, device activity where there is a
    GPU.  ``create_perfetto_link`` is the JAX package's argument, accepted
    and unused: nothing is uploaded anywhere."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "fot_trace")
    os.makedirs(log_dir, exist_ok=True)
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
