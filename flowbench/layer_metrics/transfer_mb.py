"""Host I/O and entry: MB (10^6 bytes) a frame across the host link, both
ways, by the program's byte counters (each from the shape and the dtype
that crosses)."""

from ..program_spans import report


def read(summary: dict):
    r = report(summary)
    if r is None:
        return None
    return (r["htod_bytes"] + r["dtoh_bytes"]) / r["calls"] / 1e6
