"""Image loading and saving (port of ``flowonthego_tpu/io/images.py``).

Images load as float32 [H, W, 3] in **BGR** order with values 0..255
(``cv::imread`` + ``convertTo(CV_32F)`` numerics), so flows compare
directly with the reference engine's.

Binary PPM (P6) and PGM (P5) with maxval 255 are read and written with
numpy, byte for byte as Pillow writes them, so a machine without Pillow
can still load and save frames.  Every other format goes through a
lazily imported Pillow; without it, loading or saving one raises an
error that names the format.
"""

from __future__ import annotations

import os

import numpy as np

_PNM_CHANNELS = {b"P5": 1, b"P6": 3}
_PNM_SUFFIXES = (".ppm", ".pgm", ".pnm")


def _pil(path, action: str):
    try:
        from PIL import Image
    except ImportError:
        fmt = os.path.splitext(os.fspath(path))[1].lstrip(".") or "this"
        raise RuntimeError(
            f"{action} {fmt!r} images needs Pillow, which is not installed "
            f"({path}); binary PPM (P6) and PGM (P5) images with maxval "
            "255 need no Pillow") from None
    return Image


def _read_pnm(data: bytes):
    """[H, W, C] uint8 of a binary P5/P6 file with maxval 255, or None
    for anything else."""
    channels = _PNM_CHANNELS.get(data[:2])
    if channels is None:
        return None
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":               # comment to end of line
            pos = data.find(b"\n", pos)
            if pos < 0:
                return None
            continue
        start = pos
        while (pos < len(data) and not data[pos:pos + 1].isspace()
               and data[pos:pos + 1] != b"#"):
            pos += 1
        if not data[start:pos].isdigit():
            return None
        fields.append(int(data[start:pos]))
    w, h, maxval = fields
    pos += 1                                        # one whitespace byte
    if maxval != 255 or len(data) - pos < w * h * channels:
        return None
    return np.frombuffer(data, np.uint8, count=w * h * channels,
                         offset=pos).reshape(h, w, channels)


def load_image(path: str | os.PathLike) -> np.ndarray:
    """Load an image as float32 [H, W, 3] in BGR order, values 0..255."""
    with open(path, "rb") as f:
        data = f.read()
    rgb = _read_pnm(data)
    if rgb is None:
        Image = _pil(path, "reading")
        rgb = np.asarray(Image.open(path).convert("RGB"))
    elif rgb.shape[2] == 1:
        rgb = np.repeat(rgb, 3, axis=2)             # gray -> RGB
    return rgb[..., ::-1].astype(np.float32)         # RGB -> BGR


def save_image(path: str | os.PathLike, img: np.ndarray) -> None:
    """Save a float32 BGR [H, W, 3] (0..255) or uint8 image; values are
    clipped to 0..255 and truncated to uint8.  ``.ppm``/``.pgm``/``.pnm``
    are written as P6 (3 channels) or P5 (1 channel)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 3:
        arr = arr[..., ::-1]                        # BGR -> RGB
    elif arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    if os.fspath(path).lower().endswith(_PNM_SUFFIXES):
        head = b"P6" if arr.ndim == 3 else b"P5"
        h, w = arr.shape[:2]
        with open(path, "wb") as f:
            f.write(head + b"\n%d %d\n255\n" % (w, h))
            f.write(np.ascontiguousarray(arr).tobytes())
        return
    Image = _pil(path, "writing")
    Image.fromarray(np.ascontiguousarray(arr)).save(path)
