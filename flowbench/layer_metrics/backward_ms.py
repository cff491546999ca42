"""Patch solve, the backward chain of forward-backward consistency:
device ms a frame in the program's device spans of the backward grid
(every ``*_bw`` leaf: its extraction, warm start, solve, aggregation and
refinement), timed by CUDA events.  None where the program has no such
span (no fb, or a program from before them)."""

from ..program_spans import device_ms


def read(summary: dict):
    got = device_ms(summary)
    if got is None:
        return None
    ms, calls = got
    bw = [v for k, v in ms.items() if k.endswith("_bw")]
    if not bw:
        return None
    return sum(bw) / calls
