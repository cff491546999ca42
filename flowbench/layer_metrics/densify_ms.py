"""Densify: device ms a frame of G3 (and G5, the fb merge)."""

from ..yardstick.categories import layer_ms


def read(summary: dict):
    return layer_ms(summary, "densify_ms")
