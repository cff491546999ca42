"""Pyramid: device ms a frame of K1 (the 2x2 pool) and G1 (a kept level's
borders and gradients)."""

from ..yardstick.categories import layer_ms


def read(summary: dict):
    return layer_ms(summary, "pyramid_ms")
