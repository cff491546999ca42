"""Batched frame pairs and video streaming (port of ``batched_flow``,
``make_data_parallel_flow`` and ``stream_flow`` from
``flowonthego_tpu/parallel/frame_parallel.py``).

``batched_flow`` runs B pre-padded pairs as one batch through the
pipeline: each kernel launches once per scale for the whole batch, where
JAX ``vmap``s the pipeline; on the card the whole call is one CUDA graph
(``models.dis_flow.flow_padded``).  ``make_data_parallel_flow`` splits a
batch over the 'data' devices of a mesh (``parallel/mesh.py``), one
``batched_flow`` a device and no communication.

``stream_flow`` carries two things from frame to frame:
  * the previous pair's flow, downsampled to the coarsest-scale warm-start
    resolution, as ``init_flow``;
  * the previous frame's pyramid: frame t is I1 of pair t-1 and I0 of
    pair t, so each pyramid is built once and used twice.
Its step (the new frame's pyramid, the pipeline, the upsample, the next
warm start) is :class:`StreamCore`, which ``MultiStream`` shares.  On the
card the step is the counterpart of the JAX package's jitted ``step``: two
alternating CUDA graphs over two sets of carried tensors
(``utils/graphs.StreamPath``), one graph launch a frame.
"""

from __future__ import annotations

import functools
from typing import Iterable

import numpy as np
import torch

from ..config import DISConfig, pool_backend
from ..models.dis_flow import (as_image, dis_flow_from_pyramids, flow_padded,
                               pin_fp32, upsample_flow_to_full)
from ..ops.pyramid import build_pyramid, pyramid_buffers
from ..ops.resize import resize_linear_antialias
from ..utils import graphs, profiling
from ..utils.device import resolve_device, to_host
from .mesh import Mesh, batch_sharding


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
    with profiling.call():
        I0 = as_image(I0, device)
        I1 = as_image(I1, device)
        if I0.dim() != 4 or I0.shape != I1.shape:
            raise ValueError(f"batched_flow takes two [B, H, W, C] batches "
                             f"of one shape, got {tuple(I0.shape)} and "
                             f"{tuple(I1.shape)}")
        return flow_padded(I0, I1, cfg, full_res=full_res)


def make_data_parallel_flow(mesh: Mesh, cfg: DISConfig,
                            full_res: bool = True):
    """``fn(I0, I1)``: :func:`batched_flow` with the batch axis split over
    the 'data' devices of ``mesh``.

    The pipeline is local to a frame, so the devices share nothing: shard
    d of the batch runs as one ``batched_flow`` on device d, every
    device's work is queued before any result is gathered, and the flows
    come back as one [B, H, W, 2] tensor on the mesh's first device.  A
    batch that does not divide by the number of 'data' devices raises, as
    the JAX package's sharding does.
    """
    sharding = batch_sharding(mesh)
    first = mesh.devices[0][0]

    def fn(I0, I1):
        parts = zip(sharding.shards(I0), sharding.shards(I1),
                    sharding.devices)
        flows = [batched_flow(a, b, cfg, full_res, device=d)
                 for a, b, d in parts]
        return torch.cat([f.to(first) for f in flows], dim=0)

    return fn


def warm_start(flow: torch.Tensor, cfg: DISConfig, init_h: int,
               init_w: int) -> torch.Tensor:
    """The next pair's warm start from finest flows [B, h, w, 2]: the flow
    at 1/2^(cs+1) (init is read at floor(mid/2) x2)."""
    return resize_linear_antialias(
        flow / (2.0 ** (cfg.coarsest_scale + 1 - cfg.finest_scale)),
        init_h, init_w)


def _pyramid_args(cfg: DISConfig):
    """``build_pyramid``'s arguments after the frames, for ``cfg``."""
    return ((cfg.coarsest_scale + 1, cfg.padding),
            dict(start_level=cfg.finest_scale, backend=pool_backend(cfg)))


def frame_dtype(frames) -> torch.dtype:
    """The dtype a stream path holds ``frames`` (numpy or a tensor) in:
    uint8 frames as uint8 (``build_pyramid`` converts them on the device,
    or K1 reads them as they are), any other as float32."""
    if isinstance(frames, torch.Tensor):
        uint8 = frames.dtype == torch.uint8
    else:
        uint8 = np.asarray(frames).dtype == np.uint8
    return torch.uint8 if uint8 else torch.float32


def _make_stream_path(cfg: DISConfig, shape, dtype: torch.dtype,
                      full_res: bool, device):
    """The fixed tensors of a stream path and its step (see
    :class:`..utils.graphs.StreamPath`): the frames' tensor (of
    ``dtype``), two sets of carried state (pyramid from the finest
    processed level up, warm start), and ``step(k)``, which reads set k
    and writes set 1 - k."""
    B, H, W, C = shape
    args, kw = _pyramid_args(cfg)
    init_hw = (H >> (cfg.coarsest_scale + 1), W >> (cfg.coarsest_scale + 1))
    frames = torch.empty(shape, dtype=dtype, device=device)
    pyrs = [pyramid_buffers(B, H, W, C, *args, cfg.finest_scale, device)
            for _ in range(2)]
    inits = [torch.zeros((B, *init_hw, 2), dtype=torch.float32,
                         device=device) for _ in range(2)]

    def step(k):
        with profiling.span("pyramid"):
            pyr = build_pyramid(frames, *args, **kw, out=pyrs[1 - k])
        flow = dis_flow_from_pyramids(pyrs[k], pyr, cfg, init_flow=inits[k])
        with profiling.span("warm_start"):
            inits[1 - k].copy_(warm_start(flow, cfg, *init_hw))
        if not full_res:
            return flow
        with profiling.span("upsample"):
            return upsample_flow_to_full(flow, cfg, H, W)

    return (pyrs, inits), frames, step


class StreamCore:
    """The state and the step of B warm-started streams on one device.

    ``start(frames)`` takes the first frames [B, H, W, C]; each
    ``step(frames)`` returns the flows [B, H, W, 2] (``full_res``) or the
    finest-scale flows from the previous frames to these.  Frames are
    tensors or numpy arrays, on any device.  The first frames' dtype
    chooses the path (:func:`frame_dtype`): uint8 frames stay uint8 up to
    the card and in the path's frames tensor, any other dtype is held as
    float32; a host frame crosses through pinned staging
    (``utils.device.copy_in``).  A uint8 stream takes no later frame of
    another dtype.

    The carried pyramid and warm start live in two sets of fixed tensors
    that a step reads and writes in turn
    (:class:`..utils.graphs.StreamPath`).  On the card the step is
    replayed from a CUDA graph; on the CPU (and inside
    ``graphs.eager()``) the same step runs eagerly on the same tensors.
    ``close()`` hands a captured path back for the next stream of the same
    shape and ``cfg``.
    """

    def __init__(self, cfg: DISConfig, n_streams: int, height: int,
                 width: int, channels: int, full_res: bool, device):
        self.cfg = cfg
        self.shape = (int(n_streams), height, width, channels)
        self.full_res = full_res
        self.device = torch.device(device)
        self._path = None        # the fixed-tensor path, once started

    def start(self, frames) -> None:
        pin_fp32()
        self.close()
        dtype = frame_dtype(frames)
        key = (self.shape, self.cfg, self.full_res, dtype)
        path = graphs.acquire_stream(
            "stream_step", key, functools.partial(
                _make_stream_path, self.cfg, self.shape, dtype,
                self.full_res),
            self.device)
        pyrs, inits = path.state
        args, kw = _pyramid_args(self.cfg)
        build_pyramid(as_image(frames, self.device), *args, **kw, out=pyrs[0])
        inits[0].zero_()
        self._path = path

    @property
    def started(self) -> bool:
        return self._path is not None

    def step(self, frames) -> torch.Tensor:
        if (self._path.frames.dtype == torch.uint8
                and frame_dtype(frames) != torch.uint8):
            raise ValueError("a stream started on uint8 frames takes uint8 "
                             f"frames, got {frames.dtype}")
        return self._path.step(frames)

    def close(self) -> None:
        """End the stream (its path may serve another)."""
        if self._path is not None:
            self._path.release()
        self._path = None


def stream_flow(frames: Iterable, cfg: DISConfig, full_res: bool = True,
                fetch: bool = True, device=None):
    """Yield the flow of each consecutive frame pair.

    frames: [H, W, 1|3] images (numpy or tensors), pre-padded to
    2^coarsest_scale divisibility, all of one shape.  They run on
    ``device``; with ``device=None`` the stream runs where its first
    frame lies if that is a tensor, and on the GPU if it is a numpy array
    (without a GPU that raises: pass ``device="cpu"``).
    Yields [H, W, 2] (``full_res``) or finest-scale flows, as numpy with
    ``fetch`` or as device tensors without; a yielded flow is the
    caller's own and no later step changes it.  A flow fetched from the
    card lies in page-locked host memory of its own for as long as the
    caller keeps it, up to ``utils.device.PINNED_FLOW_BYTES`` kept in all
    (then in pageable memory; ``utils.device.to_host``).  Each frame is
    an entry call of its own (``utils/profiling``), from the frame in
    hand to its flow, fetched where ``fetch`` asks.
    """
    core = None
    shape0 = None
    try:
        for frame in frames:
            with profiling.call():
                if shape0 is None:
                    device = resolve_device(device, frame)
                shape = tuple(frame.shape)
                if len(shape) != 3 or shape[2] not in (1, 3):
                    raise ValueError(
                        f"stream frame must be [H, W, 1|3], got {shape}")
                if shape0 is None:
                    shape0 = shape
                    div = 2 ** cfg.coarsest_scale
                    if shape0[0] % div or shape0[1] % div:
                        raise ValueError(
                            f"stream frames must be pre-padded to "
                            f"2^{cfg.coarsest_scale} divisibility, got "
                            f"{shape0[0]}x{shape0[1]}")
                    core = StreamCore(cfg, 1, *shape0, full_res, device)
                    core.start(frame[None])
                    continue
                if shape != shape0:
                    raise ValueError(
                        f"stream frame shape changed: {shape} vs "
                        f"{shape0} — all frames of a stream must match")
                batch = (frame[None] if isinstance(frame, torch.Tensor)
                         else torch.as_tensor(frame)[None])
                out = core.step(batch)[0]
                if fetch:
                    with profiling.host_span("fetch"):
                        out = to_host(out)
            yield out
    finally:
        if core is not None:
            core.close()
