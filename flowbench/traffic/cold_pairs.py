"""Independent cold pairs: a ring of P unrelated frame pairs.

Pair j is a crop of one seeded texture at an origin of its own and the
same crop with its two halves moved (:mod:`.split`): each half by a whole
motion of a magnitude from ``magnitude_px`` = [lo, hi] in a seeded
direction.  The magnitudes are P evenly spaced values of [lo, hi] in a
seeded order per half, so every seed has the same set of magnitudes.
Frames are not padded: ``compute_flow`` pads them itself.

Mix keys: ``pairs`` (P), ``magnitude_px``, ``texture_factor``.
"""

from __future__ import annotations

import math

import numpy as np

from .split import split_frame, split_truth
from .texture import texture

SPREAD = 512        # px of texture over which the pairs' origins spread


class Pairs:
    kind = "pairs"

    def __init__(self, pairs, shifts, height, width):
        self.pairs = pairs              # P (I0, I1) uint8 [H, W, C]
        self.shifts = shifts            # [P, 2 halves, 2 axes] int
        self.size = (height, width)

    def __len__(self) -> int:
        return len(self.pairs)

    def pair(self, j: int):
        return self.pairs[j % len(self.pairs)]

    def truth(self, j: int):
        s = self.shifts[j % len(self.pairs)]
        return split_truth(*self.size, s[0], s[1])


def make(spec: dict, conf: dict, seed: int) -> Pairs:
    P = int(spec["pairs"])
    lo, hi = spec["magnitude_px"]
    H, W, C = conf["height"], conf["width"], conf["channels"]
    rng = np.random.default_rng(seed)
    mags = np.stack([rng.permutation(np.linspace(lo, hi, P))
                     for _ in range(2)], axis=1)           # [P, 2]
    angle = rng.uniform(0.0, 2.0 * math.pi, size=(P, 2))
    shifts = np.rint(mags[..., None] * np.stack([np.cos(angle),
                                                 np.sin(angle)], -1))
    shifts = shifts.astype(np.int64)                       # [P, 2, 2]
    margin = int(math.ceil(hi)) + 1
    tex = texture(int(rng.integers(2 ** 62)), H + 2 * margin + SPREAD,
                  W + 2 * margin + SPREAD, C, int(spec["texture_factor"]))
    origins = rng.integers(0, SPREAD + 1, size=(P, 2)) + margin
    pairs = []
    for o, s in zip(origins, shifts):
        i0 = split_frame(tex, o, o, H, W)
        i1 = split_frame(tex, o - s[0], o - s[1], H, W)
        pairs.append((i0, i1))
    return Pairs(pairs, shifts, H, W)
