"""Variational refinement: device ms a frame of K3, K4 (both routes), K5
(the warp) and G4 (the derivatives)."""

from ..yardstick.categories import layer_ms


def read(summary: dict):
    return layer_ms(summary, "varref_ms")
