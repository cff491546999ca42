"""Halo exchange between spatial shards (port of
``flowonthego_tpu/parallel/halo.py``).

The JAX package writes the exchange inside ``shard_map``: each device
holds its shard, and ``lax.ppermute`` moves a few rows to the neighbour.
PyTorch has no ``shard_map``; here one process holds the list of every
shard along a mesh axis, each on the device of its position, and a
collective is a function from that list to a new one.  Shard ``i`` of the
list is the device at position ``i``, so ``axis_index`` is the list
index, a Python int, and every per-shard offset derived from it is static.

Every tensor that crosses from one shard to another goes through
:func:`send`: on a mesh whose positions are one device it is the tensor
itself, across cards a peer copy.  The stencil stages need a few rows
(or columns) from the neighbour; the outer shards replicate their own
edge (``mode="edge"``, for replicate-border stencils) or zero-fill
(``mode="zero"``); the accumulate forms fold scatter margins into the
neighbour's interior and drop what falls outside the image.

Convention as in the JAX package: along ``dim`` shard ``i`` holds the
slice [i*n, (i+1)*n).  The defaults (``dim=0`` rows, ``dim=1`` columns)
are the JAX package's layout; the port's batched tensors [B, h, w, ...]
pass ``dim=1`` and ``dim=2``.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch


def send(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` on the receiving shard's ``device``: the same tensor where it
    already lies there, else a copy (peer to peer between cards)."""
    device = torch.device(device)
    if x.device == device:
        return x
    return x.to(device, non_blocking=True)


def _take(x: torch.Tensor, dim: int, start: int, stop: int) -> torch.Tensor:
    return x.narrow(dim, start, stop - start)


def _repeat_edge(x: torch.Tensor, dim: int, index: int,
                 halo: int) -> torch.Tensor:
    """``halo`` copies of the slice ``index`` (0 or -1) along ``dim``."""
    n = x.shape[dim]
    edge = x.narrow(dim, index % n, 1)
    return edge.expand(*x.shape[:dim], halo, *x.shape[dim + 1:])


def _zeros(x: torch.Tensor, dim: int, halo: int) -> torch.Tensor:
    return x.new_zeros((*x.shape[:dim], halo, *x.shape[dim + 1:]))


def _exchange(xs: Sequence[torch.Tensor], halo: int, mode: str,
              dim: int) -> List[torch.Tensor]:
    if mode not in ("edge", "zero"):
        raise ValueError(f"mode must be 'edge' or 'zero', got {mode!r}")
    if halo == 0:
        return list(xs)
    n = len(xs)
    out = []
    for i, x in enumerate(xs):
        if i == 0:
            top = (_repeat_edge(x, dim, 0, halo) if mode == "edge"
                   else _zeros(x, dim, halo))
        else:
            prev = xs[i - 1]
            top = send(_take(prev, dim, prev.shape[dim] - halo,
                             prev.shape[dim]), x.device)
        if i == n - 1:
            bot = (_repeat_edge(x, dim, -1, halo) if mode == "edge"
                   else _zeros(x, dim, halo))
        else:
            bot = send(_take(xs[i + 1], dim, 0, halo), x.device)
        out.append(torch.cat([top, x, bot], dim=dim))
    return out


def _accumulate(xs: Sequence[torch.Tensor], halo: int,
                dim: int) -> List[torch.Tensor]:
    n = len(xs)
    out = []
    for i, x in enumerate(xs):
        interior = _take(x, dim, halo, x.shape[dim] - halo)
        if n == 1:
            out.append(interior)
            continue
        # my first rows gain the previous shard's bottom margin, then my
        # last rows the next shard's top margin (in that order, as the JAX
        # package adds them); the outer shards' outer margins are dropped
        interior = interior.clone()
        h = interior.shape[dim]
        if i > 0:
            prev = xs[i - 1]
            _take(interior, dim, 0, halo).add_(send(
                _take(prev, dim, prev.shape[dim] - halo, prev.shape[dim]),
                x.device))
        if i < n - 1:
            _take(interior, dim, h - halo, h).add_(send(
                _take(xs[i + 1], dim, 0, halo), x.device))
        out.append(interior)
    return out


def exchange_rows(xs: Sequence[torch.Tensor], halo: int, mode: str = "edge",
                  dim: int = 0) -> List[torch.Tensor]:
    """Each shard extended by ``halo`` rows from each neighbour: [h +
    2*halo, ...].  ``mode="edge"``: the outer shards replicate their own
    border rows; ``"zero"``: they zero-fill.  One shard: its own edge (or
    zeros) on both sides."""
    return _exchange(xs, halo, mode, dim)


def exchange_cols(xs: Sequence[torch.Tensor], halo: int, mode: str = "edge",
                  dim: int = 1) -> List[torch.Tensor]:
    """Column form of :func:`exchange_rows` (shards split along ``dim``).
    After :func:`exchange_rows` on a row-extended tile it also fills the
    corners: the lateral neighbour's columns already carry its row halo,
    which came from the diagonal neighbour, so a 2-D halo is two hops."""
    return _exchange(xs, halo, mode, dim)


def exchange_accumulate_rows(xs: Sequence[torch.Tensor], halo: int,
                             dim: int = 0) -> List[torch.Tensor]:
    """Fold scatter margins into the neighbours: each shard is an
    accumulator with ``halo`` extra rows on each side holding
    contributions that belong to the neighbouring shard.  Returns the [h,
    ...] interiors with the neighbours' margins added to their edge rows;
    margins beyond the image (outer shards) are dropped."""
    return _accumulate(xs, halo, dim)


def exchange_accumulate_cols(xs: Sequence[torch.Tensor], halo: int,
                             dim: int = 1) -> List[torch.Tensor]:
    """Column form of :func:`exchange_accumulate_rows`; after the row fold
    the column margins carry the folded corners."""
    return _accumulate(xs, halo, dim)


def all_gather(xs: Sequence[torch.Tensor], dim: int = 0) -> List[torch.Tensor]:
    """The shards concatenated along ``dim``, placed on each shard's
    device (``lax.all_gather(..., tiled=True)``).  Shards on one device
    share one concatenation."""
    made = {}
    out = []
    for x in xs:
        key = str(x.device)
        if key not in made:
            made[key] = torch.cat([send(y, x.device) for y in xs], dim=dim)
        out.append(made[key])
    return out


def total(counts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of per-shard counts (``lax.psum``), on the first shard's
    device."""
    dev = counts[0].device
    out = counts[0]
    for c in counts[1:]:
        out = out + send(c, dev)
    return out


def per_device(devices: Sequence, fn: Callable) -> list:
    """For each position of ``devices``, ``fn(i)`` run at the first
    position ``i`` on that position's device: the replicated stages, whose
    value is the same on every shard by construction, are computed once
    per distinct device."""
    made = {}
    out = []
    for i, d in enumerate(devices):
        key = str(torch.device(d))
        if key not in made:
            made[key] = fn(i)
        out.append(made[key])
    return out


def along(xs: Sequence, n_rows: int, n_cols: int, axis: int,
          fn: Callable) -> list:
    """Apply the list function ``fn`` to every line of a row-major
    (n_rows, n_cols) tile list along mesh ``axis`` (0: the tiles of a
    column, exchanged over 'rows'; 1: the tiles of a row, over 'cols'),
    and return the results in row-major order."""
    out = [None] * (n_rows * n_cols)
    if axis == 0:
        for c in range(n_cols):
            idx = [r * n_cols + c for r in range(n_rows)]
            for k, y in zip(idx, fn([xs[k] for k in idx])):
                out[k] = y
    else:
        for r in range(n_rows):
            idx = [r * n_cols + c for c in range(n_cols)]
            for k, y in zip(idx, fn([xs[k] for k in idx])):
                out[k] = y
    return out
