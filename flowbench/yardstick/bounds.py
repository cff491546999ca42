"""Frozen copy of the part of ``flowonthego_tpu_torch/ops/cuda/bounds.py``
at commit 5c83323 that a metric of the benchmark reads (the arithmetic of
K2 and G2 and its peaks, unchanged), so that the benchmark measures every
later program against the same yardstick.  A metric that reads another
kernel's bound brings a frozen copy of that kernel's function with it.

The least time the card could take for each kernel's work.

For a kernel's call this module counts, from the shapes of its inputs and
outputs alone, the bytes it must move (each input read once, each output
written once, whatever the kernel reads again or keeps in scratch) and
the float32 operations its function does on them, and returns the larger
of bytes / memory rate and operations / peak rate, with which of the two
binds.  It never looks at a kernel's implementation, so a redesigned
kernel keeps its bound.  Rates: one NVIDIA H100 SXM at its full power
limit, 3.35 TB/s of device memory and 67 TFLOP/s of float32 outside the
tensor cores (NVIDIA's data sheet).

Operation counts are per value of the plain PyTorch versions' arithmetic
(an add, multiply, divide, compare, floor, square root or reciprocal
square root each count one):

* K2, per template value and iteration: a 4-tap blend (4 multiplies, 3
  adds) and the three sums S, gx.S, gy.S (2 multiplies, 3 adds) = 12; per
  patch and iteration the window origin, blend weights, 2x2 step and
  outlier test = 40.  After the loop, per value of a started patch, the
  blend, the mean's sum and ((S - mean) - T)^2 = 11, and in float32 mode
  the projection's constant sums (gx, gy, gx.T, gy.T) = 6 (in bf16 mode
  they are inputs).  Iterations are those the patches really run: a patch
  never started runs none, one that resets at iteration k runs k.
* G2, extraction: per window value the mean's add, its subtraction and
  the three Hessian products and adds = 8; per patch the mean's divide,
  the determinant (3), its test and the two bumps = 7.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

K2_VALUE_ITER_FLOPS = 12
K2_PATCH_ITER_FLOPS = 40
K2_VALUE_COST_FLOPS = 11
K2_VALUE_SUMS_FLOPS = 6
EXTRACT_VALUE_FLOPS = 8
EXTRACT_PATCH_FLOPS = 7

class Bound(NamedTuple):
    bytes: int          # inputs read once + outputs written once
    flops: int          # float32 operations of the function
    bound_ms: float     # max(bytes / memory rate, flops / peak rate)
    bound_by: str       # "bytes" or "operations"


def bound(n_bytes: int, n_flops: int) -> Bound:
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flops_ms = n_flops / FP32_FLOPS_PER_S * 1e3
    return Bound(int(n_bytes), int(n_flops), max(bytes_ms, flops_ms),
                 "bytes" if bytes_ms >= flops_ms else "operations")


def gn_bound(B: int, P: int, ps: int, C: int, Hp: int, Wp: int,
             n_iters: int, patch_iters: Optional[int] = None,
             n_started: Optional[int] = None, bf16: bool = False) -> Bound:
    """K2 on B frames of P patches of ps x ps x C values against padded
    level images [B, Hp, Wp, C].

    ``patch_iters``: the iterations summed over all B*P patches that these
    inputs really run (default: every patch runs all ``n_iters``);
    ``n_started``: patches that were started (default: all).  ``bf16``:
    the image, templates and gradients are 2 bytes wide and the
    projection's four constant sums come in as float32 inputs."""
    n_patches = B * P
    N = ps * ps * C
    if n_started is None:
        n_started = n_patches
    if patch_iters is None:
        patch_iters = n_started * n_iters
    wide = 2 if bf16 else 4
    n_bytes = (B * Hp * Wp * C * wide            # level images
               + n_patches * 3 * N * wide        # templates, gx, gy
               + n_patches * (3 + 2 + 2 + 2) * 4  # H, mid, p_cur, p_org
               + n_patches * 1                   # started
               + (n_patches * 4 * 4 if bf16 else 0)   # sums
               + n_patches * 2 * 4               # p out
               + n_patches * N * 4)              # per-pixel cost out
    n_flops = (patch_iters * (K2_VALUE_ITER_FLOPS * N + K2_PATCH_ITER_FLOPS)
               + n_started * N * (K2_VALUE_COST_FLOPS
                                  + (0 if bf16 else K2_VALUE_SUMS_FLOPS)))
    return bound(n_bytes, n_flops)


def extract_bound(B: int, Hp: int, Wp: int, C: int, n_patches: int,
                  ps: int) -> Bound:
    """G2 on padded levels [B, Hp, Wp, C] x3 -> templates, gx, gy of
    ``n_patches`` patches a frame, ps x ps x C each, and H [.., 3]."""
    P = B * n_patches
    N = ps * ps * C
    return bound((3 * B * Hp * Wp * C + 3 * P * N + 3 * P) * 4,
                 P * (N * EXTRACT_VALUE_FLOPS + EXTRACT_PATCH_FLOPS))
