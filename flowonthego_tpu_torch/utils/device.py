"""Where an entry point runs: on the card unless the caller asks for the
CPU.

The port has no counterpart in the JAX package for this module: JAX
places host arrays on its default backend by itself.  Here the rule is
written out once and every entry point that takes host arrays
(``compute_flow``, ``compute_flow_timed``, ``DISFlow``, ``stream_flow``,
``batched_flow``, ``compute_disparity``) resolves its device through it.
"""

from __future__ import annotations

import threading

import torch

_constants: dict = {}
_constants_lock = threading.Lock()


def device_constant(key, device, build) -> torch.Tensor:
    """The tensor ``torch.as_tensor(build())`` on ``device``, made once
    per (``key``, device) and kept until :func:`clear_constants`.

    For the small tensors a path builds on the host from static geometry
    alone (grid midpoints, gather indices, interpolation matrices).  A
    copy from host memory cannot be recorded into a CUDA graph, and a
    recorded graph reads its inputs at fixed addresses: so such a tensor
    is uploaded once, on a path's first (eager) call, and every later
    call, captured or not, reads the same tensor (a recorded graph holds
    on to the ones it reads).  Callers never write to it.  ``key`` names
    the function and every value ``build`` depends on."""
    device = torch.device(device)
    full = (key, str(device))
    with _constants_lock:
        t = _constants.get(full)
        if t is None:
            t = _constants[full] = torch.as_tensor(build()).to(device)
        return t


def constants() -> list:
    """Every constant there is now (for a holder that must keep them
    alive)."""
    with _constants_lock:
        return list(_constants.values())


def clear_constants() -> None:
    """Forget every constant; each is built anew when next asked for."""
    with _constants_lock:
        _constants.clear()


def resolve_device(device, *inputs) -> torch.device:
    """The device an entry point runs on.

    * an explicit ``device`` wins;
    * with ``device=None``, the first tensor among ``inputs`` keeps its own
      device (the caller chose it when making the tensor);
    * with ``device=None`` and only host inputs (numpy arrays, lists), the
      answer is ``cuda``; where ``torch.cuda.is_available()`` is false that
      raises — work never moves to the CPU on its own.
    """
    if device is not None:
        return torch.device(device)
    for x in inputs:
        if isinstance(x, torch.Tensor):
            return x.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "host (numpy) inputs run on the GPU by default, but "
            "torch.cuda.is_available() is false; pass device=\"cpu\" (or CPU "
            "tensors) to run on the CPU")
    return torch.device("cuda")
