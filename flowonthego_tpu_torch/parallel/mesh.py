"""Device-mesh helpers for frame-batch ('data') x spatial-tile ('space')
parallelism (port of ``flowonthego_tpu/parallel/mesh.py``).

The JAX package hands XLA a ``jax.sharding.Mesh`` and a ``NamedSharding``
and lets it partition a jitted program.  PyTorch has no such partitioner,
and the data-parallel forms need none: no device reads another's frames.
So a mesh here is a plain [n_data, n_space] arrangement of
``torch.device``s, and a sharding is a small description of how a leading
axis splits over it, which ``make_data_parallel_flow`` and
``MultiStream(devices=...)`` apply by hand: slice, move, run, gather.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
SPACE_AXIS = "space"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[i][j]``: the device at position i of 'data', j of
    'space'."""
    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = (DATA_AXIS, SPACE_AXIS)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices),
                SPACE_AXIS: len(self.devices[0])}


def visible_devices() -> list:
    """Every visible GPU, as the default of :func:`make_mesh`."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: Optional[int] = None, n_space: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Create a [data, space] mesh over ``devices`` (default: every
    visible GPU); the same device may stand at several positions."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else visible_devices())]
    if n_data is None:
        n_data = len(devices) // n_space
    if n_data * n_space != len(devices) or not devices:
        raise ValueError(f"{n_data}x{n_space} mesh != {len(devices)} devices")
    return Mesh(tuple(tuple(devices[i * n_space:(i + 1) * n_space])
                      for i in range(n_data)))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array's leading axes split over a mesh: ``spec[k]`` names
    the mesh axis that array axis k is cut along (a spec shorter than the
    array leaves the other axes whole; an empty spec replicates)."""
    mesh: Mesh
    spec: Tuple[str, ...]

    @property
    def devices(self) -> list:
        """The devices of the shards, in shard order: one per 'data'
        position for a spec cut along 'data' alone, every device
        (data-major) for one cut along both or along none."""
        if self.spec == (DATA_AXIS,):
            return [row[0] for row in self.mesh.devices]
        return [d for row in self.mesh.devices for d in row]

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
