"""Where an entry point runs (on the card unless the caller asks for the
CPU), and how its frames and flows cross the host link.

The port has no counterpart in the JAX package for this module: JAX
places host arrays on its default backend by itself.  Here the rule is
written out once and every entry point that takes host arrays
(``compute_flow``, ``compute_flow_timed``, ``DISFlow``, ``stream_flow``,
``batched_flow``, ``compute_disparity``) resolves its device through it.

Host and card exchange data through page-locked (pinned) host memory
from PyTorch's caching host allocator, in the dtype the data has (no
conversion runs on the host): :func:`copy_in` and :func:`upload` stage a
large host frame in a pinned block and copy it up without blocking the
host (a small one takes a plain pageable copy), :func:`to_host`
copies a flow down into a pinned block that becomes the caller's array,
up to a bound on the pinned bytes that callers hold.  A staging block is
handed out again only once the upload that reads it is done (the
allocator records the copy's stream).  The CPU and the meta device take
plain copies.  The bytes that cross, and those that cross from or into
pinned memory, are counted by ``utils/profiling``.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from . import profiling

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


# ---------------------------------------------------------------- host link

# A host frame under this size goes up by a plain pageable copy (CUDA's):
# staging a Sintel frame's 1.3 MB in pinned memory first saved nothing end
# to end and made cold pairs ~3% slower, while a 4K frame's 25 MB staged by
# copy_ and uploaded pinned takes 1.3-1.9 ms against ~4.4 ms pageable (H100
# host, 8 cores).
PINNED_UPLOAD_BYTES = 4 << 20

# Fetched flows that their callers still hold keep at most this many bytes
# of page-locked host memory; a flow fetched beyond it lands in ordinary
# pageable memory (``t.cpu()``).  The caching host allocator keeps every
# block it makes until the process ends, handing a dropped flow's block to
# a later fetch, so this also bounds what a stream whose flows are all kept
# leaves locked.
PINNED_FLOW_BYTES = 4 << 30

_held = 0                      # bytes of pinned flows their callers hold
_held_lock = threading.Lock()


def _host_blocks() -> int:
    """Pinned blocks the caching host allocator has made so far."""
    stats = torch.cuda.memory.host_memory_stats_as_nested_dict()
    return int(stats.get("num_host_alloc", 0))


def pinned_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised page-locked host tensor of ``t``'s shape, dtype
    and layout (so a copy between the two is one DMA) from PyTorch's
    caching host allocator; in a traced call, a new block the allocator
    had to make for it is counted."""
    if not profiling.active():
        return torch.empty_like(t, device="cpu", pin_memory=True)
    made = _host_blocks()
    out = torch.empty_like(t, device="cpu", pin_memory=True)
    profiling.pinned_blocks(_host_blocks() - made)
    return out


def copy_in(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``, with the bytes that cross between host and card
    counted in ``dst``'s dtype.  A host ``src`` of at least
    :data:`PINNED_UPLOAD_BYTES` bound for a CUDA ``dst`` is copied into a
    pinned block of ``dst``'s dtype and layout (converting on the host only
    where the dtypes differ) and uploaded from there on the current stream
    without blocking the host; a smaller one takes the plain copy."""
    if (src.device.type != "cpu" or not dst.is_cuda
            or dst.nbytes < PINNED_UPLOAD_BYTES):
        profiling.moved(dst.nbytes, src.device, dst.device, host=src)
        dst.copy_(src)
        return
    stage = pinned_like(dst)
    stage.copy_(src)
    profiling.moved(dst.nbytes, src.device, dst.device, host=stage)
    dst.copy_(stage, non_blocking=True)


def upload(x: torch.Tensor, device) -> torch.Tensor:
    """``x.to(device)`` in ``x``'s dtype, a large host tensor bound for the
    card through :func:`copy_in`."""
    device = torch.device(device)
    if (x.device.type != "cpu" or device.type != "cuda"
            or x.nbytes < PINNED_UPLOAD_BYTES):
        profiling.moved(x.nbytes, x.device, device, host=x)
        return x.to(device)
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    copy_in(out, x)
    return out


def _let_go(nbytes: int) -> None:
    global _held
    with _held_lock:
        _held -= nbytes


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t.cpu().numpy()``.  A CUDA tensor is copied into a pinned block of
    its layout on its device's current stream, and the host waits for an
    event of that copy (no device-wide sync).  The array is the caller's
    own and holds the block, page-locked, for as long as the caller keeps
    it (or a view of it); dropped, the block goes back to the allocator's
    cache.  Past :data:`PINNED_FLOW_BYTES` held, the array is pageable."""
    global _held
    nbytes = t.nbytes
    with _held_lock:
        pinned = t.is_cuda and _held + nbytes <= PINNED_FLOW_BYTES
        if pinned:
            _held += nbytes
    if not pinned:
        out = t.cpu()
        profiling.moved(nbytes, t.device, "cpu", host=out)
        return out.numpy()
    host = pinned_like(t)
    with torch.cuda.device(t.device):
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    profiling.moved(nbytes, t.device, "cpu", host=host)
    out = host.numpy()           # holds the block (through an alias of host)
    weakref.finalize(out, _let_go, nbytes)
    done.synchronize()
    return out
