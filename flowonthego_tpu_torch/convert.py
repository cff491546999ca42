"""Carry the JAX package's parameters and intermediate state across.

DIS has no trained weights: its parameter set is the config (one config
serves a whole batch).  These
converters take plain numpy data (``dataclasses.asdict`` of a JAX
``DISConfig``, ``np.asarray`` of JAX arrays), so this module imports no
JAX; a test hands the port exactly what the JAX package fed its own
module.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .config import DISConfig
from .ops.dis import PatchState
from .ops.pyramid import PyramidLevel


def config_from_jax(fields: Mapping) -> DISConfig:
    """The port's config from ``dataclasses.asdict`` of a JAX DISConfig."""
    return DISConfig(**dict(fields))


def _tensor(x, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(np.array(x), device=device)


def pyramid_from_numpy(levels: Sequence, device=None) -> list[PyramidLevel]:
    """A batched pyramid from (image, grad_x, grad_y) numpy triples per
    level (a JAX ``PyramidLevel`` converted field by field; grads may be
    None).  Levels of a ``vmap``ped pyramid ([B, H, W, C]) keep their
    batch axis; a single pyramid's levels ([H, W, C]) become B = 1."""
    out = []
    for lvl in levels:
        fields = [_tensor(x, device) for x in lvl]
        if fields[0].dim() == 3:
            fields = [None if x is None else x[None] for x in fields]
        out.append(PyramidLevel(*fields))
    return out


def patch_state_from_numpy(fields: Mapping, device=None) -> PatchState:
    """A batched PatchState from a mapping of numpy arrays, e.g.
    ``{k: np.asarray(v) for k, v in jax_state._asdict().items()}``.  A
    ``vmap``ped state ([B, n_h, n_w, ...]) keeps its batch axis; a single
    state ([n_h, n_w, ...]) becomes B = 1."""
    state = {k: _tensor(fields[k], device) for k in PatchState._fields}
    if state["converged"].dim() == 2:
        state = {k: v[None] for k, v in state.items()}
    return PatchState(**state)
