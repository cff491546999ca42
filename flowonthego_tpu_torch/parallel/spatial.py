"""Spatial (row-strip) sharding of a frame pair (port of
``flowonthego_tpu/parallel/spatial.py``): replicate coarse, shard fine.

At the operating points the DIS and variational work runs at 1/2^fs of
the frame; what is done at full resolution is the pyramid's downsample
chain down to the finest processed level and the final flow upsample.
So:

  1. each shard holds a row strip of the frames and pools it down to the
     finest level itself (K1; a 2x2 pool needs no halo when the strip
     height divides by 2^fs);
  2. one ``all_gather`` replicates the finest-level images, and the whole
     DIS + variational pipeline (K2-K5) runs replicated,
     ``dis_flow_padded(..., level_offset=fs)``;
  3. each shard computes only its own rows of the full-resolution
     bilinear upsample (``ops/resize.resize_rows_strip``).

The JAX package's ``shard_map`` worker becomes a function over the list
of shards (``parallel/halo.py``); the replicated stage is computed once
per distinct device of the mesh.  ``fn(I0, I1)`` takes whole frames,
cuts them as the mesh says, and returns the flow gathered on the mesh's
first device, as ``make_data_parallel_flow`` does.  On a mesh whose
positions are all one CUDA device the whole call is one CUDA graph
(``utils/graphs.run``, entry "spatial_flow"); across several cards it
runs eagerly (entry "spatial_flow_devices").
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import DISConfig, pool_backend
from ..models.dis_flow import as_image, dis_flow_padded, pin_fp32
from ..ops.pyramid import downsample_half
from ..ops.resize import resize_rows_strip
from ..utils import graphs
from .halo import all_gather, per_device, send
from .mesh import DATA_AXIS, SPACE_AXIS, Mesh, Sharding


def spatial_entry(mesh: Mesh) -> str:
    """The ``graphs.ENTRIES`` row of a spatial form on ``mesh``: captured
    where every position is one device, eager across several cards."""
    return "spatial_flow" if mesh.one_device else "spatial_flow_devices"


def run_sharded(mesh: Mesh, static, fn, I0, I1):
    """``fn(I0, I1)`` on whole frames moved to the mesh's first device: on
    a one-device CUDA mesh through the captured path of ``static``, across
    several cards eagerly (the choice is the mesh's, :data:`graphs.ENTRIES`)."""
    first = mesh.devices[0][0]
    I0 = as_image(I0, first)
    I1 = as_image(I1, first)
    if I0.shape != I1.shape:
        raise ValueError(f"frame shapes differ: {tuple(I0.shape)} vs "
                         f"{tuple(I1.shape)}")
    pin_fp32()
    return graphs.run(spatial_entry(mesh), fn, (I0, I1),
                      static=(static, mesh))


def cut(x: torch.Tensor, sharding: Sharding) -> list:
    """``x`` cut as ``sharding`` says, each piece on its position's device."""
    return [send(p, d) for p, d in zip(sharding.shards(x),
                                       sharding.devices)]


def _strip_flow(a_strips, b_strips, cfg: DISConfig, small_cfg: DISConfig,
                H: int, W: int) -> list:
    """The worker over the 'space' shards of one data row: frames [B,
    h_local, W, C] a shard -> its flow rows [B, h_local, W, 2]."""
    fs = cfg.finest_scale
    n = len(a_strips)
    h_local = H // n
    backend = pool_backend(cfg)
    for _ in range(fs):
        a_strips = [downsample_half(a, backend) for a in a_strips]
        b_strips = [downsample_half(b, backend) for b in b_strips]
    a_full = all_gather(a_strips, dim=1)
    b_full = all_gather(b_strips, dim=1)
    flows = per_device([a.device for a in a_strips],
                       lambda i: dis_flow_padded(a_full[i], b_full[i],
                                                 small_cfg, level_offset=fs))
    if fs == 0:
        return [f[:, i * h_local:(i + 1) * h_local]
                for i, f in enumerate(flows)]
    scale = float(2 ** fs)
    return [resize_rows_strip(f * scale, scale, scale, i * h_local, h_local,
                              W) for i, f in enumerate(flows)]


def _check_geometry(cfg: DISConfig, H: int, n_space: int) -> None:
    fs = cfg.finest_scale
    if H % (2 ** cfg.coarsest_scale) != 0 or H % n_space != 0 \
            or (H // n_space) % (2 ** fs) != 0:
        raise ValueError(
            f"H={H} must satisfy H % 2^{cfg.coarsest_scale} == 0 and "
            f"(H/{n_space}) % 2^{fs} == 0")


def _small_cfg(cfg: DISConfig) -> DISConfig:
    """The replicated pipeline runs on the finest-level images with
    re-indexed scales (``level_offset`` restores the true level numbers
    for the variational iteration count)."""
    return dataclasses.replace(
        cfg, coarsest_scale=cfg.coarsest_scale - cfg.finest_scale,
        finest_scale=0)


def make_spatial_flow(mesh: Mesh, cfg: DISConfig, H: int, W: int):
    """``fn(I0, I1)``: padded [H, W, C] frames -> full-resolution flow [H,
    W, 2] on the mesh's first device, rows sharded over the 'space'
    devices of the mesh's first data row.  H must be divisible by
    n_space * 2^finest_scale and by 2^coarsest_scale."""
    n_space = mesh.shape[SPACE_AXIS]
    _check_geometry(cfg, H, n_space)
    small_cfg = _small_cfg(cfg)
    rows = Sharding(mesh, (SPACE_AXIS,))

    def run(I0, I1):
        flows = _strip_flow([x[None] for x in cut(I0, rows)],
                            [x[None] for x in cut(I1, rows)], cfg,
                            small_cfg, H, W)
        return torch.cat([send(f, I0.device) for f in flows], dim=1)[0]

    def fn(I0, I1):
        return run_sharded(mesh, ("make_spatial_flow", cfg, H, W), run,
                           I0, I1)

    return fn


def make_batch_spatial_flow(mesh: Mesh, cfg: DISConfig, H: int, W: int):
    """The 2-D mesh form: ``fn(I0, I1)`` on [B, H, W, C] batches, frames
    split over 'data' and each frame's rows over 'space' -> [B, H, W, 2]
    on the mesh's first device.  Data row r runs :func:`make_spatial_flow`'s
    worker on its frames over its own 'space' devices."""
    n_data, n_space = mesh.shape[DATA_AXIS], mesh.shape[SPACE_AXIS]
    _check_geometry(cfg, H, n_space)
    small_cfg = _small_cfg(cfg)
    tiles = Sharding(mesh, (DATA_AXIS, SPACE_AXIS))

    def run(I0, I1):
        a, b = cut(I0, tiles), cut(I1, tiles)
        out = []
        for r in range(n_data):
            row = slice(r * n_space, (r + 1) * n_space)
            flows = _strip_flow(a[row], b[row], cfg, small_cfg, H, W)
            out.append(torch.cat([send(f, I0.device) for f in flows], dim=1))
        return torch.cat(out, dim=0)

    def fn(I0, I1):
        if getattr(I0, "ndim", 0) != 4:
            raise ValueError("make_batch_spatial_flow takes [B, H, W, C] "
                             "batches")
        return run_sharded(mesh, ("make_batch_spatial_flow", cfg, H, W), run,
                           I0, I1)

    return fn
