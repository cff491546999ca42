"""Upsample: device ms a frame of the GEMMs (the final flow upsample's two
matrix products are the program's only ones)."""

from ..yardstick.categories import layer_ms


def read(summary: dict):
    return layer_ms(summary, "upsample_ms")
