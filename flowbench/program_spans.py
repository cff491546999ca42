"""The program's own spans and counters, as the per-layer readers of
``layer_metrics/`` take them: the loaded program's
``utils/profiling.report`` over the entry calls of the traced frames (the
program traces a call only while the profiler records, so its last calls
are those frames).  None where the program has no such report (one from
before it) or the report holds no call."""

from __future__ import annotations

import sys

PROFILING = "flowonthego_tpu_torch.utils.profiling"


def report(summary: dict):
    fn = getattr(sys.modules.get(PROFILING), "report", None)
    if fn is None:
        return None
    r = fn(calls=int(summary["frames"]))
    return r if r.get("calls") else None


def device_ms(summary: dict):
    """(device ms by span name, entry calls whose device spans were all
    read), or None where none was."""
    r = report(summary)
    if r is None or not r.get("device_calls"):
        return None
    return r["device_ms"], r["device_calls"]
