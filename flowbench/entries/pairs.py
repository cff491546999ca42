"""Cold pairs through ``compute_flow``, closed loop: numpy uint8 pairs
in, the flow fetched to a numpy array with ``.cpu().numpy()``, the next
pair when that is in hand.  No warm start: each call is independent.
Mix key: ``warmup_frames`` (the pairs the warm-up computes: the first
runs eagerly and records the path's graph, the next replays)."""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

from .stream import sync


class Entry:
    def __init__(self, port, cfg, traffic, spec: dict, device):
        self.device = torch.device(device)
        self.port = port
        self.cfg = cfg
        self.pairs = traffic
        self.warmup = int(spec["warmup_frames"])
        self.next = 0

    def call(self):
        """(hand-off time, delivery time, pair index, flow)."""
        with record_function("next frame"):
            j = self.next
            self.next += 1
            a, b = self.pairs.pair(j)
        t0 = time.perf_counter()
        with record_function("entry call"):
            flow = self.port.compute_flow(a, b, self.cfg,
                                            device=self.device)
        with record_function("fetch"):
            out = flow.cpu().numpy()
        return t0, time.perf_counter(), j, out

    def warm(self) -> list:
        out = [self.call()[2:] for _ in range(self.warmup)]
        sync(self.device)
        return out

    def close(self) -> None:
        """Free the program's paths and constants."""
        self.pairs = None
        self.port.utils.graphs.clear()
