"""Host I/O: device ms a frame of the copies between host and card (HtoD,
DtoH)."""

from ..yardstick.categories import layer_ms


def read(summary: dict):
    return layer_ms(summary, "transfer_ms")
