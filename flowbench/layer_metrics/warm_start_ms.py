"""Glue across layers: device ms a frame in the program's device spans
``warm_start`` (the next frame's warm start resized from the flow) and
every scale's ``coarse`` (a scale's patches started from the coarser
flow), timed by CUDA events."""

from ..program_spans import device_ms


def read(summary: dict):
    got = device_ms(summary)
    if got is None:
        return None
    ms, calls = got
    if "warm_start" not in ms and "coarse" not in ms:
        return None
    return (ms.get("warm_start", 0.0) + ms.get("coarse", 0.0)) / calls
