"""Input channel modes (port of ``flowonthego_tpu/ops/channels.py``).

``rgb`` keeps the three channels; ``gray`` is the intensity and
``gradmag`` the gradient magnitude of the intensity, each one channel.
The pipeline is channel-count generic ([H, W, C]), so the 1-channel
modes run the same modules and kernels with C = 1.
"""

from __future__ import annotations

import torch

from .pyramid import central_diff


def to_grayscale(img_bgr: torch.Tensor) -> torch.Tensor:
    """BGR [H, W, 3] -> intensity [H, W, 1] (ITU-R BT.601)."""
    b, g, r = img_bgr[..., 0], img_bgr[..., 1], img_bgr[..., 2]
    return (0.114 * b + 0.587 * g + 0.299 * r)[..., None]


def to_gradient_magnitude(img_bgr: torch.Tensor) -> torch.Tensor:
    """sqrt(dx^2 + dy^2) of the intensity, central differences with a
    replicated border (as the pyramid's gradients)."""
    gx, gy = central_diff(to_grayscale(img_bgr))
    return torch.sqrt(gx * gx + gy * gy)


def prepare_input(img_bgr, mode: str) -> torch.Tensor:
    """A BGR [H, W, 3] image (numpy or tensor) in channel mode ``mode``:
    ``rgb``/``3``, ``gray``/``1`` or ``gradmag``/``2``."""
    img = torch.as_tensor(img_bgr)
    if mode in ("rgb", "3"):
        return img
    if mode in ("gray", "1"):
        return to_grayscale(img)
    if mode in ("gradmag", "2"):
        return to_gradient_magnitude(img)
    raise ValueError(f"unknown channel mode {mode!r}")
