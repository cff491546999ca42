"""Device-mesh helpers for frame-batch ('data') x spatial-tile ('space')
parallelism (port of ``flowonthego_tpu/parallel/mesh.py``).

The JAX package hands XLA a ``jax.sharding.Mesh`` and a ``NamedSharding``
and lets it partition a jitted program.  PyTorch has no such partitioner,
and the data-parallel forms need none: no device reads another's frames.
So a mesh here is a plain 2-D arrangement of ``torch.device``s under two
axis names ([data, space], or [rows, cols] for the tile mesh of the 2-D
spatial forms), and a sharding is a small description of how leading
axes split over it, which ``make_data_parallel_flow``,
``MultiStream(devices=...)`` and the spatial forms apply by hand: slice,
move, run, gather.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
SPACE_AXIS = "space"
ROW_AXIS = "rows"      # the axes of a tile mesh (make_tile_mesh)
COL_AXIS = "cols"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[i][j]``: the device at position i of the first axis
    (``axis_names[0]``: 'data', or 'rows' on a tile mesh) and j of the
    second ('space', or 'cols')."""
    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = (DATA_AXIS, SPACE_AXIS)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    @property
    def flat_devices(self) -> list:
        """Every position's device, row-major."""
        return [d for row in self.devices for d in row]

    @property
    def one_device(self) -> bool:
        """Whether every position of the mesh is the same device."""
        return len(set(self.flat_devices)) == 1


def visible_devices() -> list:
    """Every visible GPU, as the default of :func:`make_mesh`."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _arrange(n_rows: int, n_cols: int, devices: list, axis_names,
             what: str) -> Mesh:
    if n_rows * n_cols != len(devices) or not devices:
        raise ValueError(f"{n_rows}x{n_cols} {what} != {len(devices)} devices")
    return Mesh(tuple(tuple(devices[i * n_cols:(i + 1) * n_cols])
                      for i in range(n_rows)), tuple(axis_names))


def make_mesh(n_data: Optional[int] = None, n_space: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a [data, space] mesh over ``devices`` (default: every
    visible GPU); the same device may stand at several positions."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else visible_devices())]
    if n_data is None:
        n_data = len(devices) // n_space
    return _arrange(n_data, n_space, devices, (DATA_AXIS, SPACE_AXIS), "mesh")


def make_tile_mesh(n_rows: int, n_cols: int,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A (rows, cols) tile mesh over ``devices`` (default: every visible
    GPU), row-major (port of ``make_tile_mesh`` of
    ``flowonthego_tpu/parallel/varref_tiled2d.py``); the same device may
    stand at several positions."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else visible_devices())]
    return _arrange(n_rows, n_cols, devices, (ROW_AXIS, COL_AXIS),
                    "tile mesh")


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array's leading axes split over a mesh: ``spec[k]`` names
    the mesh axis that array axis k is cut along (a spec shorter than the
    array leaves the other axes whole; an empty spec replicates)."""
    mesh: Mesh
    spec: Tuple[str, ...]

    @property
    def devices(self) -> list:
        """The devices of the shards, in shard order: one per position of
        the first axis ('data', 'rows') for a spec cut along it alone (the
        first of each row), one per position of the second ('space',
        'cols') for a spec cut along that alone (the first row), every
        device (row-major) for one cut along both or along none."""
        first, second = self.mesh.axis_names
        if self.spec == (first,):
            return [row[0] for row in self.mesh.devices]
        if self.spec == (second,):
            return list(self.mesh.devices[0])
        return self.mesh.flat_devices

    def shards(self, x) -> list:
        """``x`` cut as the spec says, one piece per device of
        :attr:`devices` (views, still where ``x`` lies; a replicated
        array gives ``x`` itself for every device).  An axis that does not
        divide by its mesh axis raises."""
        if not self.spec:
            return [x] * len(self.devices)
        pieces = [x]
        for axis, name in enumerate(self.spec):
            n = self.mesh.shape[name]
            if x.shape[axis] % n:
                raise ValueError(
                    f"axis {axis} of size {x.shape[axis]} does not divide "
                    f"over the {n} devices of mesh axis '{name}'")
            size = x.shape[axis] // n
            index = (slice(None),) * axis
            pieces = [p[index + (slice(k * size, (k + 1) * size),)]
                      for p in pieces for k in range(n)]
        return pieces


def batch_sharding(mesh: Mesh) -> Sharding:
    """Shard the leading frame-batch axis over 'data'."""
    return Sharding(mesh, (DATA_AXIS,))


def batch_space_sharding(mesh: Mesh) -> Sharding:
    """Shard [batch, H, ...] over ('data', 'space')."""
    return Sharding(mesh, (DATA_AXIS, SPACE_AXIS))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())
