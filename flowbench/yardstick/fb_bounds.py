"""Frozen copy of G5's bound in ``flowonthego_tpu_torch/ops/cuda/bounds.py``
at commit 84e972d (``fb_merge_bound`` and its three constants, unchanged),
which ``layer_metrics/fb_merge_roofline.py`` reads, so that every later
program's merge is measured against the same yardstick.  The rates and
:func:`.bounds.bound` are those of :mod:`.bounds`, frozen there.

G5, the fb merge: per patch its landing point, cell, fraction and four
bilinear weights = 15; per patch pixel its weight (as G3's, C + 1 with
the square roots apart) and -u w, -v w = 2; per contribution that lands
(a pixel and a corner, counted on the run's inputs) the three products
and three adds = 6.  Bytes: the patches' flows and midpoints and their
per-pixel costs read once, the [B, h, w, 3] accumulator written once.
"""

from __future__ import annotations

from .bounds import Bound, bound

MERGE_PATCH_FLOPS = 15
MERGE_PIXEL_FLOPS = 2
MERGE_CONTRIB_FLOPS = 6


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
