"""The least time the card could take for each kernel's work.

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

* K1, a 2x2 mean: 3 adds and 1 multiply an output, 1 more add with a
  bias.
* K2, per template value and iteration: a 4-tap blend (4 multiplies, 3
  adds) and the three sums S, gx.S, gy.S (2 multiplies, 3 adds) = 12; per
  patch and iteration the window origin, blend weights, 2x2 step and
  outlier test = 40.  After the loop, per value of a started patch, the
  blend, the mean's sum and ((S - mean) - T)^2 = 11, and in float32 mode
  the projection's constant sums (gx, gy, gx.T, gy.T) = 6 (in bf16 mode
  they are inputs).  Iterations are those the patches really run: a patch
  never started runs none, one that resets at iteration k runs k.
* K3 and K4, per pixel and round: smoothness 26, pair sums 2, data term
  with sub-Laplacian and diagonal 93 C + 44, and 32 per SOR iteration (two
  half-sweeps of 32 on half the cells each); 2 more for the final flow.
  The planes of inputs and outputs count once, however many passes the
  rounds make over them: wx, wy, mask, 8 C derivative planes, uu, vv.
* K5, per pixel: coordinates, floor, weights and the in-bounds mask 12,
  and 11 a channel for the 4-tap blend.
* G1, a pyramid level: 2 (the two central differences) per value of the
  level; the border is copies.
* G2, extraction: per window value the mean's add, its subtraction and
  the three Hessian products and adds = 8; per patch the mean's divide,
  the determinant (3), its test and the two bumps = 7.
* G3, densify: per cost value its clamp (and square root under
  ``densify_weight="abs"``); per patch pixel the C - 1 adds of the
  channel sum, the reciprocal, w*u, w*v and the three canvas adds = C + 5;
  per output pixel the test and two divides = 3 (+ 3 adds of the fb
  merge).
* G4, derivatives: per pixel and channel the mean (2), Iz (1) and seven
  5-tap stencils of 5 = 38.
* G5, the fb merge: per patch its landing point, cell, fraction and four
  bilinear weights = 15; per patch pixel its weight (as G3's, C + 1
  with the square roots apart) and -u w, -v w = 2; per contribution that
  lands (a pixel and a corner, counted on the run's inputs) the three
  products and three adds = 6.
* G6, the reference-form solve, per value: a sample (4-tap blend 7, the
  mean's add, its subtraction and the template's = 10), its residual
  transform (l2 none, l1 4, pseudo-Huber 9) and cost (1) with its sum
  (1); a projection's products and adds (2-D 4, 1-D 2).  Per patch and
  trip the window, the step and the tests = 40.  Samples are one a
  started patch plus one a trip; trips are those the patches really run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

K2_VALUE_ITER_FLOPS = 12
K2_PATCH_ITER_FLOPS = 40
K2_VALUE_COST_FLOPS = 11
K2_VALUE_SUMS_FLOPS = 6
VARREF_SMOOTH_FLOPS = 26
VARREF_PAIR_FLOPS = 2
VARREF_DATA_FLOPS_PER_CHANNEL = 93
VARREF_DATA_FLOPS = 44
VARREF_SOR_FLOPS = 32
VARREF_FINAL_FLOPS = 2
WARP_PIXEL_FLOPS = 12
WARP_CHANNEL_FLOPS = 11
LEVEL_VALUE_FLOPS = 2
EXTRACT_VALUE_FLOPS = 8
EXTRACT_PATCH_FLOPS = 7
DENSIFY_PIXEL_FLOPS = 3
DENSIFY_MERGE_FLOPS = 3
DERIVS_VALUE_FLOPS = 38
MERGE_PATCH_FLOPS = 15
MERGE_PIXEL_FLOPS = 2
MERGE_CONTRIB_FLOPS = 6
REF_SAMPLE_FLOPS = 10
REF_TRANSFORM_FLOPS = {"l2": 0, "l1": 4, "huber": 9}
REF_COST_FLOPS = 2
REF_PROJECT_FLOPS = {False: 4, True: 2}
REF_PATCH_TRIP_FLOPS = 40


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


def pool_bound(H: int, WC: int, in_bytes: int = 4,
               bias: bool = False) -> Bound:
    """K1 on a flat level [H, WC] of ``in_bytes``-wide values (4: float32,
    1: uint8) -> [H/2, WC/2] float32.  A batch is its frames stacked as
    rows: H counts them all."""
    n_out = (H // 2) * (WC // 2)
    return bound(H * WC * in_bytes + n_out * 4, n_out * (5 if bias else 4))


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


def _varref_bound(B, h, w, C, inner_iter, solve_iter) -> Bound:
    n = B * h * w
    planes = 3 + 8 * C + 2          # wx, wy, mask; dIs; uu, vv
    per_round = (VARREF_SMOOTH_FLOPS + VARREF_PAIR_FLOPS
                 + VARREF_DATA_FLOPS_PER_CHANNEL * C + VARREF_DATA_FLOPS
                 + VARREF_SOR_FLOPS * solve_iter)
    return bound(n * planes * 4,
                 n * (inner_iter * per_round + VARREF_FINAL_FLOPS))


def varref_fused_bound(B: int, h: int, w: int, C: int, inner_iter: int,
                       solve_iter: int) -> Bound:
    """K3 on B fields of h x w pixels and C channels: ``inner_iter`` rounds
    of ``solve_iter`` SOR iterations."""
    return _varref_bound(B, h, w, C, inner_iter, solve_iter)


def varref_tiled_bound(B: int, h: int, w: int, C: int, inner_iter: int,
                       solve_iter: int) -> Bound:
    """K4 (either route): K3's function, so K3's count."""
    return _varref_bound(B, h, w, C, inner_iter, solve_iter)


def warp_bound(B: int, h: int, w: int, C: int) -> Bound:
    """K5 on frames [B, h, w, C] with flows wx, wy [B, h, w] -> warped
    [B, h, w, C] and mask [B, h, w]."""
    n = B * h * w
    return bound(n * (2 * C + 3) * 4,
                 n * (WARP_PIXEL_FLOPS + WARP_CHANNEL_FLOPS * C))


def level_bound(B: int, h: int, w: int, C: int, padding: int) -> Bound:
    """G1 on a level [B, h, w, C] -> image, grad_x, grad_y [B, h + 2p,
    w + 2p, C]."""
    n = B * h * w * C
    n_pad = B * (h + 2 * padding) * (w + 2 * padding) * C
    return bound((n + 3 * n_pad) * 4, n * LEVEL_VALUE_FLOPS)


def extract_bound(B: int, Hp: int, Wp: int, C: int, n_patches: int,
                  ps: int) -> Bound:
    """G2 on padded levels [B, Hp, Wp, C] x3 -> templates, gx, gy of
    ``n_patches`` patches a frame, ps x ps x C each, and H [.., 3]."""
    P = B * n_patches
    N = ps * ps * C
    return bound((3 * B * Hp * Wp * C + 3 * P * N + 3 * P) * 4,
                 P * (N * EXTRACT_VALUE_FLOPS + EXTRACT_PATCH_FLOPS))


def densify_bound(B: int, h: int, w: int, C: int, n_patches: int, ps: int,
                  sqrt: bool = False, merge: bool = False) -> Bound:
    """G3 on ``n_patches`` patches a frame (p [.., 2], costs [.., ps, ps,
    C]) -> flows [B, h, w, 2]; ``sqrt``: the weight takes the costs'
    square root; ``merge``: the fb merge's [B, h, w, 3] is added."""
    P = B * n_patches
    n_px = B * h * w
    n_bytes = (P * 2 + P * ps * ps * C + n_px * 2
               + (n_px * 3 if merge else 0)) * 4
    n_flops = (P * ps * ps * C * (2 if sqrt else 1)
               + P * ps * ps * (C + 5)
               + n_px * (DENSIFY_PIXEL_FLOPS
                         + (DENSIFY_MERGE_FLOPS if merge else 0)))
    return bound(n_bytes, n_flops)


def derivs_bound(B: int, h: int, w: int, C: int) -> Bound:
    """G4 on images im1, w_im2 [B, h, w, C] -> dIs [B, 8, C, h, w]."""
    n = B * h * w * C
    return bound(n * (2 + 8) * 4, n * DERIVS_VALUE_FLOPS)


def fb_merge_bound(B: int, P: int, ps: int, C: int, h: int, w: int,
                   n_contrib: int, sqrt: bool = False) -> Bound:
    """G5 on B frames of P complementary patches (p, midpoints [.., 2],
    costs [.., ps, ps, C]) -> the accumulator [B, h, w, 3];
    ``n_contrib``: the (pixel, corner) contributions that land in the
    frames on these inputs."""
    n_px = B * P * ps * ps
    n_bytes = (B * P * 2 * 2 + n_px * C + B * h * w * 3) * 4
    n_flops = (B * P * MERGE_PATCH_FLOPS
               + n_px * (C * (2 if sqrt else 1) + MERGE_PIXEL_FLOPS)
               + n_contrib * MERGE_CONTRIB_FLOPS)
    return bound(n_bytes, n_flops)


def ref_bound(B: int, P: int, ps: int, C: int, Hp: int, Wp: int,
              trips: int, n_started: int, cost_fn: str = "l2",
              one_d: bool = False) -> Bound:
    """G6 on B frames of P patches of ps x ps x C values against padded
    level images [B, Hp, Wp, C]: ``n_started`` patches not converged on
    entry, ``trips`` the trips all patches ran on these inputs.  Reads
    the level; for a started patch its template and gradients (one
    gradient in 1-D), H (H00 alone in 1-D), midpoint and p_org; for a
    patch converged on entry its diff and cost, which it returns; for
    every patch p and the converged flag.  Writes p, diff and cost."""
    n_patches = B * P
    N = ps * ps * C
    n_bytes = (B * Hp * Wp * C * 4
               + n_started * (N * (2 if one_d else 3)
                              + (1 if one_d else 3) + 2 + 2) * 4
               + (n_patches - n_started) * 2 * N * 4
               + n_patches * 2 * 4 + n_patches
               + n_patches * 2 * 4 + n_patches * 2 * N * 4)
    per_sample = (REF_SAMPLE_FLOPS + REF_TRANSFORM_FLOPS[cost_fn]
                  + REF_COST_FLOPS)
    n_flops = ((n_started + trips) * N * per_sample
               + trips * (N * REF_PROJECT_FLOPS[one_d]
                          + REF_PATCH_TRIP_FLOPS))
    return bound(n_bytes, n_flops)
