"""Scale: device ms a frame in the program's device span of the finest
processed scale (``scale <sl>``, its five phases), timed by CUDA
events."""

from ..program_spans import device_ms


def read(summary: dict):
    got = device_ms(summary)
    if got is None:
        return None
    ms, calls = got
    scales = [int(k.split()[1]) for k in ms if k.startswith("scale ")]
    if not scales:
        return None
    return ms[f"scale {min(scales)}"] / calls
