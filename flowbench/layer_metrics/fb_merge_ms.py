"""Densify, the merges of forward-backward consistency: device ms a frame
in the program's device span ``fb_merge`` (both directions' merges at
every scale), timed by CUDA events.  None where the program has no such
span."""

from ..program_spans import device_ms


def read(summary: dict):
    got = device_ms(summary)
    if got is None:
        return None
    ms, calls = got
    if "fb_merge" not in ms:
        return None
    return ms["fb_merge"] / calls
