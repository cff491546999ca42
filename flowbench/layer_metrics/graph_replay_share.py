"""Capture: the share of the program's launches that replayed a recorded
graph (the rest ran eagerly, or eagerly and recorded), in percent, by its
launch counters."""

from ..program_spans import report


def read(summary: dict):
    r = report(summary)
    if r is None:
        return None
    modes = r["modes"]
    return 100.0 * modes.get("replay", 0) / sum(modes.values())
