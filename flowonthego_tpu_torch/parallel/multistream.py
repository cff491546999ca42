"""N warm-started video streams as one batch on one card (port of
``flowonthego_tpu/parallel/multistream.py``).

Each stream carries what :func:`.frame_parallel.stream_flow` carries from
frame to frame: the previous frame's pyramid (built once, used twice) and
the previous pair's flow as the coarsest-scale warm start.  Here the N
streams are one batch [N, ...]: every tick builds one batched pyramid and
runs one batched pair through the pipeline, so each kernel launches once
per scale for all N streams.  The carried pyramids and warm starts stay on
the device.

The JAX package shards the stream axis over its mesh's 'data' axis, one
stream per chip; on one card that axis is ``n_streams`` on one device.
Sharding the streams over several GPUs is not ported yet.

Deployment shapes this covers:
  * N live camera/video feeds (the multi-feed server);
  * one long video split into N chunks processed in parallel
    (:func:`stream_video_chunks`; each chunk starts cold, so a splice
    point loses only the warm start).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DISConfig, pool_backend
from ..models.dis_flow import (as_image, dis_flow_from_pyramids, pin_fp32,
                               upsample_flow_to_full)
from ..ops.pyramid import build_pyramid
from .frame_parallel import warm_start


class MultiStream:
    """N independent warm-started video streams, one batch on ``device``
    (required: the streams run where they are told, never elsewhere).

    Frames are pushed as a batch [N, H, W, C] (or packed [N, H, W*C]);
    one flow field per stream comes back, device-resident.

    Usage::

        ms = MultiStream(cfg, H, W, n_streams=4, device="cuda")
        ms.start(first_frames)          # builds the batched pyramid
        for batch in feed:              # [N, H, W, C] per tick
            flows = ms.push(batch)      # [N, H, W, 2] on the device
    """

    def __init__(self, cfg: DISConfig, height: int, width: int,
                 channels: int = 3, full_res: bool = True, *,
                 n_streams: int, device):
        div = 2 ** cfg.coarsest_scale
        if height % div or width % div:
            raise ValueError(
                f"stream frames must be pre-padded to 2^{cfg.coarsest_scale}"
                f" divisibility, got {height}x{width}")
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.cfg = cfg
        self.H, self.W, self.C = height, width, channels
        self.full_res = full_res
        self.n_streams = int(n_streams)
        self.device = torch.device(device)
        cs = cfg.coarsest_scale
        self._init_hw = (height >> (cs + 1), width >> (cs + 1))
        self._pyr_kw = dict(start_level=cfg.finest_scale,
                            backend=pool_backend(cfg))
        self._state = None

    def _pack(self, frames) -> torch.Tensor:
        a = as_image(frames, self.device)
        if a.dim() == 4:
            if tuple(a.shape[1:]) != (self.H, self.W, self.C):
                raise ValueError(
                    f"stream batch must be [N, {self.H}, {self.W}, "
                    f"{self.C}], got {tuple(a.shape)}")
        elif a.dim() != 3 or tuple(a.shape[1:]) != (self.H, self.W * self.C):
            raise ValueError(
                f"stream batch must be [N, H, W, C] or packed [N, H, W*C],"
                f" got {tuple(a.shape)}")
        else:
            a = a.reshape(a.shape[0], self.H, self.W, self.C)
        if a.shape[0] != self.n_streams:
            raise ValueError(f"expected {self.n_streams} streams, got batch "
                             f"of {a.shape[0]}")
        return a

    def _pyramid(self, frames: torch.Tensor):
        return build_pyramid(frames, self.cfg.coarsest_scale + 1,
                             self.cfg.padding, **self._pyr_kw)

    def start(self, first_frames) -> None:
        """Prime every stream with its first frame (no flow output)."""
        pin_fp32()
        frames = self._pack(first_frames)
        init = torch.zeros((self.n_streams, *self._init_hw, 2),
                           dtype=torch.float32, device=self.device)
        self._state = (self._pyramid(frames), init)

    def push(self, frames) -> torch.Tensor:
        """Advance every stream one frame; returns [N, H, W, 2] flows (or
        the finest-scale flows without ``full_res``) on the device: row i
        is stream i's flow from its previous frame to this one."""
        if self._state is None:
            raise RuntimeError("call start(first_frames) before push()")
        pyr_prev, init = self._state
        pyr = self._pyramid(self._pack(frames))
        flow = dis_flow_from_pyramids(pyr_prev, pyr, self.cfg,
                                      init_flow=init)
        out = (upsample_flow_to_full(flow, self.cfg, self.H, self.W)
               if self.full_res else flow)
        self._state = (pyr, warm_start(flow, self.cfg, *self._init_hw))
        return out


def stream_video_chunks(frames, cfg: DISConfig, n_streams: int, device,
                        full_res: bool = True) -> np.ndarray:
    """Process ONE video of T frames as ``n_streams`` parallel chunks.

    Splits [T, H, W, C] into N contiguous chunks with one-frame overlap
    (chunk k's first frame is chunk k-1's last), runs them as N streams of
    one :class:`MultiStream`, and reassembles the T-1 pairwise flows in
    order.  Chunk boundaries lose only the warm start (each chunk's first
    pair starts from zero init); every flow is still computed from its
    true frame pair.  Streams past their chunk's end re-feed their last
    frame (result discarded), so every tick keeps the full batch.

    ``frames`` is a numpy array or a tensor (on any device).  Returns
    [T-1, H, W, 2] (``full_res``) as a host array.
    """
    if frames.ndim != 4:
        raise ValueError(f"frames must be [T, H, W, C], got "
                         f"{tuple(frames.shape)}")
    T = frames.shape[0]
    N = int(n_streams)
    n_pairs = T - 1
    if n_pairs < N:
        raise ValueError(f"need at least {N + 1} frames for {N} chunks")
    H, W, C = frames.shape[1], frames.shape[2], frames.shape[3]
    ms = MultiStream(cfg, H, W, C, full_res=full_res, n_streams=N,
                     device=device)

    # chunk k handles pairs [starts[k], starts[k+1])
    starts = [k * n_pairs // N for k in range(N + 1)]
    ticks = max(starts[k + 1] - starts[k] for k in range(N))
    stack = torch.stack if isinstance(frames, torch.Tensor) else np.stack
    ms.start(stack([frames[starts[k]] for k in range(N)]))
    out = np.empty((n_pairs, H, W, 2) if full_res else
                   (n_pairs,
                    H >> cfg.finest_scale, W >> cfg.finest_scale, 2),
                   np.float32)
    for t in range(ticks):
        idx = [min(starts[k] + 1 + t, starts[k + 1]) for k in range(N)]
        flows = ms.push(stack([frames[i] for i in idx]))
        flows = flows.cpu().numpy()
        for k in range(N):
            p = starts[k] + t
            if p < starts[k + 1]:
                out[p] = flows[k]
    return out
