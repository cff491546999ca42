"""What a run keeps of the program's delivered flows to judge them once
the window has closed: a stream's first ``chained`` flows, a sample of
the window's later flows drawn from the seed, and the window's first pair
across the ring's wrap.  Keeping a flow holds a reference to what the
program returned (the caller's own array or tensor): nothing is copied
inside the window."""

from __future__ import annotations

import numpy as np


class Kept:
    def __init__(self, kind: str, chained: int, n_sample: int,
                 ring_len: int, seed: int):
        self.kind = kind
        self.chained = chained        # a stream's flows 1..chained
        self.n_sample = n_sample
        self.ring_len = ring_len
        self.rng = np.random.default_rng([seed, 7])
        self.start = []               # stream: (i, flow), i <= chained
        self.sample = []              # (i, prev, flow) or (j, flow)
        self.wrap = None
        self.prev = None
        self.offered = 0

    def warm(self, items) -> None:
        """The warm-up's (index, flow) pairs."""
        if self.kind == "stream":
            self.start.extend(it for it in items if it[0] <= self.chained)
            self.prev = items[-1][1]

    def offer(self, i: int, flow) -> None:
        """A window flow: pair (i - 1, i) of a stream, or pair i."""
        if self.kind == "stream":
            item = (i, self.prev, flow)
            self.prev = flow
            if i <= self.chained:
                self.start.append((i, flow))
                return
            if self.wrap is None and i % self.ring_len == 0:
                self.wrap = item
        else:
            item = (i, flow)
        self.offered += 1
        if len(self.sample) < self.n_sample:
            self.sample.append(item)
        else:
            r = int(self.rng.integers(self.offered))
            if r < self.n_sample:
                self.sample[r] = item

    @property
    def chain_full(self) -> bool:
        """Whether a stream's flows 1..chained are all kept."""
        return self.kind != "stream" or len(self.start) >= self.chained

    @property
    def steps(self) -> list:
        """The sampled flows, in window order, with the wrap's."""
        items = self.sample + ([self.wrap] if self.wrap is not None else [])
        return sorted({it[0]: it for it in items}.values(),
                      key=lambda it: it[0])
