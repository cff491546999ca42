"""Patch solve: device ms a frame of G2 (templates and Hessians), K2 (the
L2 inverse search) and G6 (the reference-form solve)."""

from ..yardstick.categories import layer_ms


def read(summary: dict):
    return layer_ms(summary, "patch_solve_ms")
