"""Host I/O and entry: host ms a frame in the program's own spans
``ingest`` (the frame converted on the host, copied up, copied into the
path's tensors) and ``launch`` (the graph launched, or the eager run),
on the host clock."""

from ..program_spans import report


def read(summary: dict):
    r = report(summary)
    if r is None:
        return None
    ms = r["host_ms"]
    return (ms.get("ingest", 0.0) + ms.get("launch", 0.0)) / r["calls"]
