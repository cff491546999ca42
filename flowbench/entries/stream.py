"""One warm-started stream through ``stream_flow``, closed loop.

The stream starts at the ring's frame 0 and never restarts: the window
continues the generator the warm-up began.  Mix keys: ``frames_on``
(``host``: uint8 numpy frames, as a decoder on the host delivers them;
``device``: the same frames as uint8 CUDA tensors, as a decoder on the
card delivers them), ``fetch`` (``stream_flow``'s: numpy flows, or
device tensors the caller synchronises on), ``warmup_frames`` (the
frames the warm-up hands off, the first of which starts the stream).

A frame is timed from the moment the feed hands it to ``stream_flow`` to
the moment its flow is where the caller reads it.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Entry:
    def __init__(self, port, cfg, traffic, spec: dict, device):
        self.device = torch.device(device)
        self.port = port
        self.fetch = bool(spec["fetch"])
        self.warmup = int(spec["warmup_frames"])
        if spec["frames_on"] == "device":
            self.frames = [torch.as_tensor(f, device=self.device)
                           for f in traffic.frames]
        else:
            self.frames = traffic.frames
        self.next = 0                 # the stream's next frame index
        self.handoff = 0.0
        self.flows = port.stream_flow(self._feed(), cfg, fetch=self.fetch,
                                      device=self.device)

    def _feed(self):
        while True:
            with record_function("next frame"):
                frame = self.frames[self.next % len(self.frames)]
                self.next += 1
            self.handoff = time.perf_counter()
            yield frame

    def call(self):
        """(hand-off time, delivery time, stream index i, the flow of the
        pair (i - 1, i))."""
        with record_function("entry call"):
            flow = next(self.flows)
        if not self.fetch:
            with record_function("fetch"):
                sync(self.device)
        return self.handoff, time.perf_counter(), self.next - 1, flow

    def warm(self) -> list:
        """The warm-up's (index, flow) pairs: the stream's first step runs
        eagerly and records the step's graphs, the next replays."""
        out = [self.call()[2:] for _ in range(self.warmup - 1)]
        sync(self.device)
        return out

    def close(self) -> None:
        """End the stream and free the program's paths and constants."""
        self.flows.close()
        self.frames = None
        self.port.utils.graphs.clear()
