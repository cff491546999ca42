"""The judge of the configurations with forward-backward consistency: the
program's delivered flows against :mod:`.plain_fb`'s, computed again from
the frames the run made.

What is compared, and how, is :mod:`.check`'s (each compared flow alone,
the statistic ``limits/<cell>.json`` names; a stream's first ``chained``
flows against the reference's own warm-start chain, then single steps
from the program's state; cold pairs from scratch), with the reference
that computes the merge.  The forward flow is the one delivered and
compared; the backward chain starts cold at every step in the program and
in the reference alike, so a step needs no backward state of the
program's.

The readings' ``counts`` hold both directions' patches, started patches
and steps under each scale's number, as :mod:`.check` counts one
direction's, and beside them, as the attribute ``merge`` (which no reader
of the scale keys sees), each scale's merges: {scale: [merges, patches
merged, (pixel, corner) contributions that landed]}.
"""

from __future__ import annotations

import torch

from . import plain_fb as ref
from .check import Readings, _tensor
from .plain_fb import check_params  # noqa: F401  (the judge's own check)


class Counts(dict):
    """{scale: [patches, started, steps]}, both directions summed, with
    the merges' tally as ``merge``."""

    def __init__(self):
        super().__init__()
        self.merge = {}


def _readings() -> Readings:
    out = Readings()
    out.counts = Counts()
    return out


def stream(ring, params: dict, kept, device, memo=None) -> Readings:
    """Readings of a stream's kept flows (:class:`..keep.Kept`).  ``memo``
    (a dict), where given, holds the reference chain's flows by stream
    index, computed once for runs of the same frames."""
    ref.check_params(params)
    out = _readings()
    frame = lambda i: _tensor(ring.frame(i), device)   # noqa: E731
    H, W = ring.frames[0].shape[:2]
    ih, iw = ref.init_shape(params, H, W)
    chain = dict(kept.start)
    if memo is not None and all(i in memo for i in chain):
        refs = ((i, memo[i]) for i in sorted(chain))
    else:
        refs = _chain(frame, params, max(chain, default=0), ih, iw, device)
    for i, full in refs:
        if i in chain:
            if memo is not None:
                memo[i] = full
            out.add(f"chain {i}", _tensor(chain[i], device), full,
                    ring.truth(i) if i == 1 else None)
    for i, prev, flow in kept.steps:
        init = ref.warm_start(ref.finest_from_full(_tensor(prev, device),
                                                   params), params, ih, iw)
        pyr = ref.pyramid(frame(i - 1)[None], params)
        count, merges = {}, {}
        full = ref.stream_step(pyr, frame(i), params, init, count,
                               merges)[0]
        out.add(f"step {i}", _tensor(flow, device), full, ring.truth(i))
        _tally(out, count, merges)
    return out


def _chain(frame, params: dict, last: int, ih: int, iw: int, device):
    """(i, full flow) of the reference's warm-start chain from frame 0 for
    the stream's pairs (i - 1, i), i = 1..last."""
    pyr = ref.pyramid(frame(0)[None], params)
    init = torch.zeros(1, ih, iw, 2, device=device)
    for i in range(1, last + 1):
        full, fin, pyr = ref.stream_step(pyr, frame(i), params, init)
        init = ref.warm_start(fin, params, ih, iw)
        yield i, full


def pairs(traffic, params: dict, kept, device, memo=None) -> Readings:
    """Readings of cold pairs' kept flows."""
    ref.check_params(params)
    out = _readings()
    for j, flow in kept.steps:
        a, b = (_tensor(x, device) for x in traffic.pair(j))
        count, merges = {}, {}
        full = ref.pair_flow(a, b, params, count, merges)
        out.add(f"pair {j}", _tensor(flow, device), full, traffic.truth(j))
        _tally(out, count, merges)
    return out


def _tally(out: Readings, count: dict, merges: dict) -> None:
    for into, got in ((out.counts, count), (out.counts.merge, merges)):
        for sl, c in got.items():
            acc = into.setdefault(sl, [0] * len(c))
            for k, v in enumerate(c):
                acc[k] += v
    out.frames_counted += 1
