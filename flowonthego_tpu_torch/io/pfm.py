"""PFM (portable float map) I/O, numpy only: the depth mode saves its
disparity maps as PFM.  A copy of ``flowonthego_tpu/io/pfm.py`` (importing
that package would import JAX)."""

from __future__ import annotations

import os
import re

import numpy as np


def write_pfm(path: str | os.PathLike, data: np.ndarray, scale: float = -1.0) -> None:
    """Write a [H, W] (grayscale 'Pf') or [H, W, 3] ('PF') float32 PFM.

    Negative ``scale`` marks little-endian, per the PFM spec.  Rows are
    stored bottom-to-top.
    """
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 2:
        header = b"Pf"
    elif data.ndim == 3 and data.shape[2] == 3:
        header = b"PF"
    else:
        raise ValueError(f"PFM needs [H,W] or [H,W,3], got {data.shape}")
    h, w = data.shape[:2]
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{w} {h}\n".encode())
        f.write(f"{scale:f}\n".encode())
        f.write(np.ascontiguousarray(data[::-1]).tobytes())


def read_pfm(path: str | os.PathLike) -> np.ndarray:
    """Read a PFM file -> float32 [H, W] or [H, W, 3]."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(rb"^(\d+)\s+(\d+)\s*$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM dimensions")
        w, h = int(dims.group(1)), int(dims.group(2))
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * channels * 4), dtype=dtype)
    data = data.reshape(h, w, channels)[::-1]
    return data[..., 0].copy() if channels == 1 else data.astype(np.float32)
