"""Glue across layers: device ms a frame of the small PyTorch kernels, the
copies on the device and the memsets that no layer's kernels claim."""

from ..yardstick.categories import layer_ms


def read(summary: dict):
    return layer_ms(summary, "torch_kernels_ms")
