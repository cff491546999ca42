"""Patch solve: the share, in percent, of the patch solve's (K2's) trips
that loaded no tap of the window, the window's origin being the one its
held taps came from, by the program's kernel counters ``gn_trips`` and
``gn_window_loads``.  None where the program has no such counters (one
from before them) or counted no trip."""

from ..program_spans import report


def read(summary: dict):
    r = report(summary)
    if r is None:
        return None
    counters = r.get("counters", {})
    trips, loads = counters.get("gn_trips"), counters.get("gn_window_loads")
    if not trips or loads is None:
        return None
    return 100.0 * (1.0 - loads / trips)
