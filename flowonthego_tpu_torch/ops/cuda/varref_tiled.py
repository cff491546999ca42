"""K4: the variational-refinement inner loop on fields too large for one CTA.

Replaces ``flowonthego_tpu/ops/pallas/varref_fused.py``
(``variational_refine_tiled``, kernel ``_tiled_kernel``) with
``csrc/varref_tiled.cu``.  It is K3's function (:mod:`.varref_fused`),
from the same per-pixel expressions (``csrc/varref_common.cuh``), so all
forms agree bit for bit.  The card could do the work in its bytes' time
(29 planes at C = 3, ``bounds.varref_tiled_bound``); what a launch costs
is its chain of dependent phases, 1 + rounds * (1 + 2 *
``var_ref_iter``) barriers, so the two routes differ in what a barrier
costs (~0.45 us for a cluster of 128- to 256-thread CTAs, ~1.1 us for the
grid, by ``probes/barrier_probe.cu`` on an NVIDIA H100 80GB HBM3 at 700
W) and in how many SMs share a phase's work:

* ``route="cluster"``, mid-size fields (a few thousand pixels: scale 4
  of a 1024x448 pair, scale 6 of a 4K frame): one thread-block cluster of
  up to 8 CTAs per field, the 9 work planes split by rows over the CTAs'
  shared memory, each CTA's border rows mirrored into its neighbours'
  halo rows through distributed shared memory, the hardware cluster
  barrier between phases; a batch is one cluster per frame.
  :func:`cluster_plan` says how a field is split and whether it fits.
* ``route="grid"``, larger fields (up to 458,752 px at 1024x448): one
  cooperative launch with as many CTAs as fit on the card at once,
  walking the field (and the batch) grid-stride with the work planes in
  device memory and a grid-wide barrier between phases.  Why a grid
  barrier and not the TPU kernel's recompute halo is in the CUDA source.

The resolver (``ops/variational.varref_backend_for``) chooses the route
by one field's size.  A launch the card refuses raises; no route ever
stands in for another.

:func:`refine_inner_tiled` launches the kernel for CUDA tensors and runs
:func:`refine_inner_plain` for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .varref_fused import (_N_SCRATCH, CTA_SHARED_BYTES, launch_loop,
                           refine_inner_plain, warp_and_derivs)

# Kernel launches since the last reset (read and reset by chip_smoke.py);
# launches_cluster counts those of them that took the cluster route.
launches = 0
launches_cluster = 0

ROUTES = ("cluster", "grid")
CLUSTER_MAX_CTAS = 8            # the portable cluster size
CLUSTER_THREADS = 1024          # threads of a cluster route's CTA, at most
CLUSTER_MIN_CTA_PIXELS = 64     # fewer pixels a CTA: halve the cluster
CLUSTER_HALO_ROWS = 3           # neighbours' rows a CTA keeps: 1 up, 2 down


class ClusterPlan(NamedTuple):
    n_ctas: int         # CTAs of one field's cluster (a power of two)
    rows_per: int       # field rows held by each CTA
    threads: int        # threads of each CTA
    shared_bytes: int   # shared memory a CTA needs for its rows
    fits: bool          # within a CTA's shared memory


def cluster_plan(h: int, w: int) -> ClusterPlan:
    """How the cluster route splits an h x w field: the most CTAs (a power
    of two up to 8) that still hold two rows each (a stencil reads two
    rows down, which must stay in the neighbouring CTA's rows) and two
    warps' worth of pixels; each CTA holds ``rows_per`` rows of the 9 work
    planes, and three halo rows of its neighbours', in shared memory and
    has a thread per pixel of its rows, in whole warps, from 128 up to
    1024."""
    n_ctas = CLUSTER_MAX_CTAS
    while n_ctas > 1 and (-(-h // n_ctas) < 2
                          or h * w < CLUSTER_MIN_CTA_PIXELS * n_ctas):
        n_ctas //= 2
    rows_per = -(-h // n_ctas)
    threads = min(CLUSTER_THREADS, max(128, -(-rows_per * w // 32) * 32))
    shared = _N_SCRATCH * (rows_per + CLUSTER_HALO_ROWS) * w * 4
    return ClusterPlan(n_ctas, rows_per, threads, shared,
                       shared <= CTA_SHARED_BYTES)


def refine_inner_tiled(wx, wy, mask, dIs, cfg, inner_iter: int,
                       route: str = "grid"):
    """The loop on one of K4's routes (``"cluster"`` or ``"grid"``): the
    kernel for CUDA tensors, the plain version for CPU tensors -> (uu,
    vv) [B, h, w]."""
    global launches, launches_cluster
    if route not in ROUTES:
        raise ValueError(f"refine_inner_tiled: unknown route {route!r}, "
                         f"expected one of {ROUTES}")
    if not wx.is_cuda:
        return refine_inner_plain(wx, wy, mask, dIs, cfg, inner_iter)
    if route == "cluster":
        plan = cluster_plan(wx.shape[1], wx.shape[2])
        # a plan that does not fit is launched all the same: the card
        # refuses it and launch_loop raises
        out = launch_loop("fot_varref_cluster", wx, wy, mask, dIs, cfg,
                          inner_iter, plan[:3])
        launches_cluster += 1
    else:
        scratch = torch.empty((_N_SCRATCH,) + tuple(wx.shape),
                              dtype=torch.float32, device=wx.device)
        out = launch_loop("fot_varref_tiled", wx, wy, mask, dIs, cfg,
                          inner_iter, (scratch.data_ptr(),))
    launches += 1
    return out


def variational_refine_tiled(flow, im1, im2, cfg, level: int,
                             route: str = "grid") -> torch.Tensor:
    """Refine dense flows [B, h, w, 2]: warp + derivatives
    (:func:`warp_and_derivs`), then :func:`refine_inner_tiled`."""
    wx, wy, mask, dIs = warp_and_derivs(flow, im1, im2, cfg)
    uu, vv = refine_inner_tiled(wx, wy, mask, dIs, cfg, level + 1, route)
    return torch.stack([uu, vv], dim=-1)
