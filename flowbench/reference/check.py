"""The comparison that decides ``correct``: the program's delivered flows
against the plain reference's, computed again from the frames the run
made.

Each compared flow is judged on its own: the number compared is the
largest, over the compared flows, of a flow's statistic of its per-pixel
end-point error against the reference's flow of the same pair (whole
frame, every pixel); the cell's ``limits/<cell>.json`` names the
statistic (:data:`STATS`).  A sound flow differs from the reference by
rounding (at most a few 1e-3 px at any pixel), and now and then by an
outlier reset that an ulp flipped, which moves one patch's region, under
one percent of the frame's pixels at operating point 4, by up to several
pixels.  A high quantile of the pixels' errors looks past that region
and sees a flow that is wrong anywhere wider, so one broken flow among
the compared fails the run: the 4K streams, where no reset flips,
compare the 99th percentile, the op-4 cells the 90th.  Which flows are
compared:

* a stream: its first ``chained`` flows (the warm-up's and the window's
  first), against the reference's own warm-start chain from the stream's
  first frame; then sampled pairs of the window past them
  (``kept.steps``) and the window's first pair across the ring's wrap
  when the chain does not reach it, each a single step from the
  program's state: the warm start the program carried into the pair is
  worked out by the reference again from the program's flow of the pair
  before (its finest-scale flow, recovered exactly where the
  configuration's finest scale is 0 and by least squares from the
  upsample otherwise);
* cold pairs: sampled pairs of the window, each against the reference's
  pair from scratch.

The error against the true motion (known pixels only) of the sampled
flows is reported beside it, and not compared: it measures DIS, not the
port.
"""

from __future__ import annotations

import torch

from . import plain_dis as ref
from .plain_dis import check_params  # noqa: F401  (the judge's own check)

QUANTILES = {"p90": 0.9, "p99": 0.99, "p999": 0.999}
OVER_PX = 0.01


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device).float()


def epe(a, b) -> float:
    """Mean end-point error between two flows [H, W, 2]."""
    return float(torch.linalg.vector_norm((a - b).double(), dim=-1).mean())


def epe_known(flow, truth) -> float:
    """Mean end-point error against the true flow on its known pixels."""
    f, known = (torch.as_tensor(x, device=flow.device) for x in truth)
    d = torch.linalg.vector_norm((flow - f).double(), dim=-1)
    return float(d[known].mean())


def pixel_stats(flow, ref_flow) -> dict:
    """The statistics of one flow's per-pixel end-point error against the
    reference's: its mean, quantiles (:data:`QUANTILES`), maximum, and the
    share of pixels over :data:`OVER_PX`."""
    d = torch.linalg.vector_norm((flow - ref_flow).double(), dim=-1)
    d = d.flatten()
    out = {"mean": float(d.mean()), "max": float(d.max()),
           "over": float((d > OVER_PX).double().mean())}
    for name, q in QUANTILES.items():
        k = min(d.numel(), max(1, int(round(q * d.numel()))))
        out[name] = float(d.kthvalue(k).values)
    return out


# the numbers a limits file may name: the largest over the compared flows
STATS = {f"epe_ref_{name}": name for name in QUANTILES}
STATS["share_ref_over_0.01px"] = "over"


class Readings:
    """Each compared flow's error against the reference and against the
    truth, and the reference's patch counts for the roofline."""

    def __init__(self):
        self.flows = []          # (label, pixel_stats)
        self.true = []           # mean EPE vs the truth, known pixels
        self.counts = {}         # scale -> [patches, started, steps]
        self.frames_counted = 0

    def add(self, label, flow, ref_flow, truth=None):
        self.flows.append((label, pixel_stats(flow, ref_flow)))
        if truth is not None:
            self.true.append(epe_known(flow, truth))

    def worst(self, number: str) -> float:
        """A number of :data:`STATS`: its statistic's largest flow."""
        return max(s[STATS[number]] for _, s in self.flows)


def stream(ring, params: dict, kept, device, memo=None) -> Readings:
    """Readings of a stream's kept flows (:class:`..keep.Kept`).  ``memo``
    (a dict), where given, holds the reference chain's flows by stream
    index, computed once for runs of the same frames."""
    ref.check_params(params)
    out = Readings()
    frame = lambda i: _tensor(ring.frame(i), device)   # noqa: E731
    H, W = ring.frames[0].shape[:2]
    ih, iw = ref.init_shape(params, H, W)
    # the chain: the reference's own from the stream's first frame
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
    # single steps from the program's state
    for i, prev, flow in kept.steps:
        init = ref.warm_start(ref.finest_from_full(_tensor(prev, device),
                                                   params), params, ih, iw)
        pyr = ref.pyramid(frame(i - 1)[None], params)
        count = {}
        full = ref.stream_step(pyr, frame(i), params, init, count)[0]
        out.add(f"step {i}", _tensor(flow, device), full, ring.truth(i))
        _tally(out, count)
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
    out = Readings()
    for j, flow in kept.steps:
        a, b = (_tensor(x, device) for x in traffic.pair(j))
        count = {}
        full = ref.pair_flow(a, b, params, count)
        out.add(f"pair {j}", _tensor(flow, device), full, traffic.truth(j))
        _tally(out, count)
    return out


def _tally(out: Readings, count: dict) -> None:
    for sl, c in count.items():
        acc = out.counts.setdefault(sl, [0, 0, 0])
        for k in range(3):
            acc[k] += c[k]
    out.frames_counted += 1
