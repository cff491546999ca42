"""A closed ring of split scenes for a stream that never restarts.

Frames 0..R-1 are split scenes (:mod:`.split`).  Per half and axis the
step from frame k to k+1 is ``round(A sin(2 pi k / R + phase))`` whole
pixels, the phase drawn from the seed; the last step is corrected so that
each half's steps sum to zero, so the step from frame R-1 back to frame 0
is a known motion too and the stream can cycle through the ring for as
long as a window lasts.  Every seed runs the same sinusoid at other
phases on another texture: the same set of motions in another order.

Mix keys: ``ring`` (R), ``amplitude_px`` (A), ``texture_factor``.  The
frames are replicate-padded to 2^coarsest divisibility, as ``stream_flow``
takes them.
"""

from __future__ import annotations

import math

import numpy as np

from .split import pad_edge, pad_truth, split_frame, split_truth
from .texture import texture


class Ring:
    kind = "stream"

    def __init__(self, frames, steps, pads, height, width):
        self.frames = frames            # R padded uint8 [Hp, Wp, C]
        self.steps = steps              # [2 halves, 2 axes, R] int
        self.pads = pads
        self.size = (height, width)

    def __len__(self) -> int:
        return len(self.frames)

    def frame(self, i: int) -> np.ndarray:
        """Frame i of the stream (the ring's frame i mod R)."""
        return self.frames[i % len(self.frames)]

    def truth(self, i: int):
        """(flow, known) of the stream's pair (i - 1, i), padded."""
        k = (i - 1) % len(self.frames)
        s = self.steps[:, :, k]
        return pad_truth(*split_truth(*self.size, s[0], s[1]), self.pads)


def make(spec: dict, conf: dict, seed: int) -> Ring:
    R, A = int(spec["ring"]), float(spec["amplitude_px"])
    H, W, C = conf["height"], conf["width"], conf["channels"]
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0.0, 2.0 * math.pi, size=(2, 2, 1))
    k = np.arange(R)
    steps = np.rint(A * np.sin(2.0 * math.pi * k / R + phase)).astype(np.int64)
    steps[..., -1] -= steps.sum(axis=-1)
    # origin of frame k: o(k + 1) = o(k) - step(k)
    origin = -np.concatenate([np.zeros((2, 2, 1), np.int64),
                              np.cumsum(steps[..., :-1], axis=-1)], axis=-1)
    margin = int(np.abs(origin).max()) + 1
    tex = texture(int(rng.integers(2 ** 62)), H + 2 * margin,
                  W + 2 * margin, C, int(spec["texture_factor"]))
    m = 2 ** conf["dis"]["coarsest_scale"]
    ph, pw = (-H) % m, (-W) % m
    pads = (ph // 2, ph - ph // 2, pw // 2, pw - pw // 2)
    o = origin + margin
    frames = [pad_edge(split_frame(tex, o[0, :, j], o[1, :, j], H, W), pads)
              for j in range(R)]
    return Ring(frames, steps, pads, H, W)
