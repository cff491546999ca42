"""N warm-started video streams as one batch on one card (port of
``flowonthego_tpu/parallel/multistream.py``).

Each stream carries what :func:`.frame_parallel.stream_flow` carries from
frame to frame: the previous frame's pyramid (built once, used twice) and
the previous pair's flow as the coarsest-scale warm start.  Here the N
streams are one batch [N, ...]: every tick builds one batched pyramid and
runs one batched pair through the pipeline, so each kernel launches once
per scale for all N streams.  The carried pyramids and warm starts stay on
the device.

Every tick's work (the new frames' pyramid, the pipeline, the upsample,
the next warm start) is :class:`.frame_parallel.StreamCore`; on the card
it is replayed from a CUDA graph, the counterpart of the JAX package's
jitted ``step_fn`` with its donated state, one graph launch a tick.

The JAX package shards the stream axis over its mesh's 'data' axis, one
stream per chip; on one card that axis is ``n_streams`` on one device.
With ``devices=[...]`` the streams are split over several devices, a
contiguous sub-batch each with its pyramids and warm starts there; the
devices share nothing, and every device's tick is queued before any flow
is gathered.

Deployment shapes this covers:
  * N live camera/video feeds (the multi-feed server);
  * one long video split into N chunks processed in parallel
    (:func:`stream_video_chunks`; each chunk starts cold, so a splice
    point loses only the warm start).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DISConfig
from ..utils import profiling
from ..utils.device import to_host
from .frame_parallel import StreamCore


class MultiStream:
    """N independent warm-started video streams, one batch on ``device``
    or split over ``devices`` (one of the two is required: the streams run
    where they are told, never elsewhere).

    Frames are pushed as a batch [N, H, W, C] (or packed [N, H, W*C]);
    one flow field per stream comes back, device-resident (on the first
    device of ``devices``).

    Usage::

        ms = MultiStream(cfg, H, W, n_streams=4, device="cuda")
        ms.start(first_frames)          # builds the batched pyramid
        for batch in feed:              # [N, H, W, C] per tick
            flows = ms.push(batch)      # [N, H, W, 2] on the device
    """

    def __init__(self, cfg: DISConfig, height: int, width: int,
                 channels: int = 3, full_res: bool = True, *,
                 n_streams: int, device=None, devices=None):
        div = 2 ** cfg.coarsest_scale
        if height % div or width % div:
            raise ValueError(
                f"stream frames must be pre-padded to 2^{cfg.coarsest_scale}"
                f" divisibility, got {height}x{width}")
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        if (device is None) == (devices is None):
            raise ValueError("MultiStream takes either device= or devices=")
        devices = [torch.device(d) for d in
                   (devices if devices is not None else [device])]
        if not devices or n_streams % len(devices):
            raise ValueError(f"{n_streams} streams do not divide over "
                             f"{len(devices)} devices")
        self.cfg = cfg
        self.H, self.W, self.C = height, width, channels
        self.full_res = full_res
        self.n_streams = int(n_streams)
        self.devices = devices
        self.device = devices[0]
        per = self.n_streams // len(devices)
        self._cores = [StreamCore(cfg, per, height, width, channels, full_res,
                                  d) for d in devices]

    def _pack(self, frames):
        """The batch as [N, H, W, C] (a tensor or a host array, not
        moved: each device takes its own streams)."""
        a = frames if isinstance(frames, torch.Tensor) else np.asarray(frames)
        if a.ndim == 4:
            if tuple(a.shape[1:]) != (self.H, self.W, self.C):
                raise ValueError(
                    f"stream batch must be [N, {self.H}, {self.W}, "
                    f"{self.C}], got {tuple(a.shape)}")
        elif a.ndim != 3 or tuple(a.shape[1:]) != (self.H, self.W * self.C):
            raise ValueError(
                f"stream batch must be [N, H, W, C] or packed [N, H, W*C],"
                f" got {tuple(a.shape)}")
        else:
            a = a.reshape(a.shape[0], self.H, self.W, self.C)
        if a.shape[0] != self.n_streams:
            raise ValueError(f"expected {self.n_streams} streams, got batch "
                             f"of {a.shape[0]}")
        return a

    def _shards(self, frames):
        a = self._pack(frames)
        per = self.n_streams // len(self._cores)
        return [a[k * per:(k + 1) * per] for k in range(len(self._cores))]

    def start(self, first_frames) -> None:
        """Prime every stream with its first frame (no flow output)."""
        for core, part in zip(self._cores, self._shards(first_frames)):
            core.start(part)

    def push(self, frames) -> torch.Tensor:
        """Advance every stream one frame; returns [N, H, W, 2] flows (or
        the finest-scale flows without ``full_res``) on the (first)
        device: row i is stream i's flow from its previous frame to this
        one.  The flows are the caller's own: no later tick changes
        them."""
        if not self._cores[0].started:
            raise RuntimeError("call start(first_frames) before push()")
        with profiling.call():
            flows = [core.step(part) for core, part in
                     zip(self._cores, self._shards(frames))]
            if len(flows) == 1:
                return flows[0]
            return torch.cat([f.to(self.device) for f in flows], dim=0)

    def close(self) -> None:
        """End the streams (on the card their captured paths may then
        serve other streams of the same shape)."""
        for core in self._cores:
            core.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def stream_video_chunks(frames, cfg: DISConfig, n_streams: int, device,
                        full_res: bool = True,
                        overlap_warmup: bool = True) -> np.ndarray:
    """Process ONE video of T frames as ``n_streams`` parallel chunks.

    Splits [T, H, W, C] into N contiguous chunks with one-frame overlap
    (chunk k's first frame is chunk k-1's last), runs them as N streams of
    one :class:`MultiStream`, and reassembles the T-1 pairwise flows in
    order.  Chunk boundaries lose only the warm start (each chunk's first
    pair starts from zero init); every flow is still computed from its
    true frame pair.  Streams past their chunk's end re-feed their last
    frame (result discarded), so every tick keeps the full batch.

    ``frames`` is a numpy array or a tensor (on any device); ``device``
    is one device or a list of them (the chunks split over it).
    ``overlap_warmup`` is accepted and unused, as in the JAX package.
    Returns [T-1, H, W, 2] (``full_res``) as a host array in pageable
    memory; each tick's flows cross through one page-locked block
    (``utils.device.to_host``), copied out and handed back at once.
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
    where = (dict(devices=list(device)) if isinstance(device, (list, tuple))
             else dict(device=device))
    ms = MultiStream(cfg, H, W, C, full_res=full_res, n_streams=N, **where)

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
        flows = to_host(flows)
        for k in range(N):
            p = starts[k] + t
            if p < starts[k + 1]:
                out[p] = flows[k]
    ms.close()
    return out
