"""Batched frame pairs and video streaming (port of ``batched_flow`` and
``stream_flow`` from ``flowonthego_tpu/parallel/frame_parallel.py``).

``batched_flow`` runs B pre-padded pairs as one batch through the
pipeline: each kernel launches once per scale for the whole batch, where
JAX ``vmap``s the pipeline.  Its multi-device form
(``make_data_parallel_flow``) is not ported yet.

``stream_flow`` carries two things from frame to frame:
  * the previous pair's flow, downsampled to the coarsest-scale warm-start
    resolution, as ``init_flow``;
  * the previous frame's pyramid: frame t is I1 of pair t-1 and I0 of
    pair t, so each pyramid is built once and used twice.
"""

from __future__ import annotations

from typing import Iterable

import torch

from ..config import DISConfig, pool_backend
from ..models.dis_flow import (as_image, dis_flow_from_pyramids,
                               dis_flow_padded, flow_full_padded, pin_fp32,
                               upsample_flow_to_full)
from ..ops.pyramid import build_pyramid
from ..ops.resize import resize_linear_antialias
from ..utils.device import resolve_device


def batched_flow(I0, I1, cfg: DISConfig, full_res: bool = True,
                 device=None) -> torch.Tensor:
    """Flow for a batch of padded frame pairs.

    I0, I1: [B, H, W, C] (numpy or tensors) with H, W divisible by
    2**coarsest_scale.  They run on ``device``; with ``device=None``
    tensors run where I0 lies and numpy inputs on the GPU (without one
    that raises: pass ``device="cpu"``).
    Returns [B, H, W, 2] (``full_res``) or [B, H/2^fs, W/2^fs, 2].
    """
    device = resolve_device(device, I0, I1)
    I0 = as_image(I0, device)
    I1 = as_image(I1, device)
    if I0.dim() != 4 or I0.shape != I1.shape:
        raise ValueError(f"batched_flow takes two [B, H, W, C] batches of "
                         f"one shape, got {tuple(I0.shape)} and "
                         f"{tuple(I1.shape)}")
    if full_res:
        return flow_full_padded(I0, I1, cfg)
    return dis_flow_padded(I0, I1, cfg)


def warm_start(flow: torch.Tensor, cfg: DISConfig, init_h: int,
               init_w: int) -> torch.Tensor:
    """The next pair's warm start from finest flows [B, h, w, 2]: the flow
    at 1/2^(cs+1) (init is read at floor(mid/2) x2)."""
    return resize_linear_antialias(
        flow / (2.0 ** (cfg.coarsest_scale + 1 - cfg.finest_scale)),
        init_h, init_w)


def stream_flow(frames: Iterable, cfg: DISConfig, full_res: bool = True,
                fetch: bool = True, device=None):
    """Yield the flow of each consecutive frame pair.

    frames: [H, W, 1|3] images (numpy or tensors), pre-padded to
    2^coarsest_scale divisibility, all of one shape.  They run on
    ``device``; with ``device=None`` the stream runs where its first
    frame lies if that is a tensor, and on the GPU if it is a numpy array
    (without a GPU that raises: pass ``device="cpu"``).
    Yields [H, W, 2] (``full_res``) or finest-scale flows, as numpy with
    ``fetch`` or as device tensors without.
    """
    pin_fp32()
    n_levels = cfg.coarsest_scale + 1
    kw = dict(start_level=cfg.finest_scale, backend=pool_backend(cfg))
    pyr = None
    init = None
    shape0 = None
    for frame in frames:
        if shape0 is None:
            device = resolve_device(device, frame)
        cur = as_image(frame, device)
        if cur.dim() != 3 or cur.shape[2] not in (1, 3):
            raise ValueError(
                f"stream frame must be [H, W, 1|3], got {tuple(cur.shape)}")
        if shape0 is None:
            shape0 = tuple(cur.shape)
            div = 2 ** cfg.coarsest_scale
            if shape0[0] % div or shape0[1] % div:
                raise ValueError(
                    f"stream frames must be pre-padded to 2^{cfg.coarsest_scale}"
                    f" divisibility, got {shape0[0]}x{shape0[1]}")
        elif tuple(cur.shape) != shape0:
            raise ValueError(
                f"stream frame shape changed: {tuple(cur.shape)} vs "
                f"{shape0} — all frames of a stream must match")
        init_h = cur.shape[0] >> (cfg.coarsest_scale + 1)
        init_w = cur.shape[1] >> (cfg.coarsest_scale + 1)
        if pyr is None:
            pyr = build_pyramid(cur[None], n_levels, cfg.padding, **kw)
            init = torch.zeros((1, init_h, init_w, 2), dtype=torch.float32,
                               device=cur.device)
            continue
        pyr1 = build_pyramid(cur[None], n_levels, cfg.padding, **kw)
        flow = dis_flow_from_pyramids(pyr, pyr1, cfg, init_flow=init)
        out = (upsample_flow_to_full(flow[0], cfg, cur.shape[0],
                                     cur.shape[1])
               if full_res else flow[0])
        init = warm_start(flow, cfg, init_h, init_w)
        pyr = pyr1
        yield out.cpu().numpy() if fetch else out
