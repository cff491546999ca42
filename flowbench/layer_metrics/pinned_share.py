"""Host I/O and entry: the share, in percent, of the bytes across the
host link (both ways) that crossed through pinned host memory, by the
program's byte counters.  None where the program counts no pinned bytes
(one from before the counter) or nothing crossed."""

from ..program_spans import report


def read(summary: dict):
    r = report(summary)
    if r is None or "pinned_bytes" not in r:
        return None
    crossed = r["htod_bytes"] + r["dtoh_bytes"]
    if not crossed:
        return None
    return 100.0 * r["pinned_bytes"] / crossed
