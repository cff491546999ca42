"""Where an entry point runs: on the card unless the caller asks for the
CPU.

The port has no counterpart in the JAX package for this module: JAX
places host arrays on its default backend by itself.  Here the rule is
written out once and every entry point that takes host arrays
(``compute_flow``, ``compute_flow_timed``, ``DISFlow``, ``stream_flow``,
``batched_flow``, ``compute_disparity``) resolves its device through it.
"""

from __future__ import annotations

import torch


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
