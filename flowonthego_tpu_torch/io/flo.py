"""Middlebury ``.flo`` optical-flow file I/O (numpy only).

Format:
  bytes 0-3   float32 tag 202021.25 (reads as "PIEH" in ASCII)
  bytes 4-7   int32 width
  bytes 8-11  int32 height
  then height*width*2 float32 little-endian, row-major, interleaved (u, v).

Values with magnitude >= UNKNOWN_FLOW_THRESH mark unknown flow.
"""

from __future__ import annotations

import os

import numpy as np

TAG_FLOAT = 202021.25
TAG_STRING = b"PIEH"
UNKNOWN_FLOW_THRESH = 1e9


def read_flo(path: str | os.PathLike) -> np.ndarray:
    """Read a .flo file -> float32 array of shape [H, W, 2] (u, v)."""
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), dtype=np.float32)[0]
        if tag != np.float32(TAG_FLOAT):
            raise ValueError(f"{path}: bad .flo tag {tag!r} (wrong endianness "
                             "or not a flow file)")
        width = int(np.frombuffer(f.read(4), dtype=np.int32)[0])
        height = int(np.frombuffer(f.read(4), dtype=np.int32)[0])
        if not (0 < width < 99999 and 0 < height < 99999):
            raise ValueError(f"{path}: implausible size {width}x{height}")
        data = np.frombuffer(f.read(height * width * 2 * 4), dtype=np.float32)
        if data.size != height * width * 2:
            raise ValueError(f"{path}: file too short")
    return data.reshape(height, width, 2).copy()


def write_flo(path: str | os.PathLike, flow) -> None:
    """Write a [H, W, 2] flow (numpy array or tensor) to a .flo file."""
    if hasattr(flow, "detach"):
        flow = flow.detach().cpu().numpy()
    flow = np.asarray(flow, dtype=np.float32)
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"expected [H, W, 2] flow, got {flow.shape}")
    height, width = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(TAG_STRING)
        f.write(np.asarray([width, height], dtype=np.int32).tobytes())
        f.write(np.ascontiguousarray(flow).tobytes())


def unknown_flow_mask(flow) -> np.ndarray:
    """Boolean [H, W] mask of pixels whose flow is unknown."""
    if hasattr(flow, "detach"):
        flow = flow.detach().cpu().numpy()
    flow = np.asarray(flow)
    return (np.abs(flow) > UNKNOWN_FLOW_THRESH).any(axis=-1) | np.isnan(
        flow).any(axis=-1)
