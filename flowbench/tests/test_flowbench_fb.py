"""The fb configuration's reference (``reference/plain_fb.py``) and judge
(``reference/fb.py``) on the CPU at tiny sizes: the reference against the
program's fb path, its merge against a line-by-line transcription of
OF_DIS's ``patchgrid.cpp`` (lines 277-375 of FlowOnTheGo's copy), the
judge's refusals before the warm-up, the new cell found by name, a tiny
fb cell judged correct where the bf16 control fails, and the three
per-layer readers of the fb cell.

Where the reference and the program may part.  The merge lands a patch
at ceil(x + 1e-5) with the bilinear fraction x - floor(x): a landing
point within 1e-5 below a whole pixel goes one pixel further than one an
ulp away, so rounding of an optimised flow (the split scenes move by
whole pixels, so landing points sit near whole pixels) moves a patch's
merged weight by a pixel.  The reference's own flow moves as much when
its input moves by 5e-4 of a grey level (the sensitivity test below).
At operating point 2's 12 iterations the flows agree to rounding
(a pair's mean end-point error below 1e-5 px); at op 4's 128 iterations,
whose warm starts carry a moved merge into the next scale, up to a few
percent of a tiny frame's pixels part by more than 0.01 px, which the
90th percentile the op-4 cells compare looks past.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys

import numpy as np
import pytest
import torch

import flowonthego_tpu_torch as port
from flowbench import cells
from flowbench.layer_metrics import backward_ms, fb_merge_ms, \
    fb_merge_roofline
from flowbench.reference import check, fb, plain_dis, plain_fb
from flowbench.run import run_cell
from flowbench.traffic import cold_pairs, split_ring

from conftest import TINY_CONFIGS, TINY_MIXES, make_root, write_json

FB_CELL = "sintel-op4-fb.stream-slow"


def fb_conf(name):
    op, h, w = TINY_CONFIGS[name]
    cfg = dataclasses.replace(port.operating_point(op, width=w),
                              use_fb_consistency=True)
    return cfg, dict(height=h, width=w, channels=3,
                     dis=dataclasses.asdict(cfg))


# --------------------------------------------- the reference and the program

@pytest.mark.parametrize("name,stat,bound", [
    # rounding alone: the flows agree to float32's
    ("tiny-op2", "mean", 1e-5),
    # a moved merge on a few percent of the pixels (the module's note);
    # the rest agree to rounding, which the 90th percentile sees
    ("tiny-op4", "p90", 1e-2)])
def test_pair_matches_the_program(name, stat, bound):
    cfg, conf = fb_conf(name)
    pairs = cold_pairs.make(TINY_MIXES["pairs"], conf, 4)
    for j in range(2):
        a, b = pairs.pair(j)
        mine = plain_fb.pair_flow(torch.as_tensor(a), torch.as_tensor(b),
                                  conf["dis"])
        theirs = port.compute_flow(a, b, cfg, device="cpu")
        assert mine.shape == theirs.shape == (*a.shape[:2], 2)
        assert check.pixel_stats(mine, theirs)[stat] < bound


def test_stream_chain_matches_the_program():
    """The first steps of an op-2 fb stream: the reference's warm-start
    chain (its backward grid cold on every step) against ``stream_flow``'s
    flows, each within rounding (mean below 1e-5 px)."""
    cfg, conf = fb_conf("tiny-op2")
    ring = split_ring.make(TINY_MIXES["ring"], conf, 5)
    frames = [ring.frame(i) for i in range(4)]
    theirs = list(port.stream_flow(frames, cfg, device="cpu"))
    p = conf["dis"]
    ih, iw = plain_fb.init_shape(p, *frames[0].shape[:2])
    pyr = plain_fb.pyramid(torch.as_tensor(frames[0])[None], p)
    init = torch.zeros(1, ih, iw, 2)
    for i in range(1, len(frames)):
        full, fin, pyr = plain_fb.stream_step(pyr, torch.as_tensor(frames[i]),
                                              p, init)
        init = plain_fb.warm_start(fin, p, ih, iw)
        assert check.epe(full, torch.as_tensor(theirs[i - 1])) < 1e-5


def test_the_merge_is_as_sensitive_to_rounding():
    """The reference against itself, one frame moved by at most 5e-4 of a
    grey level: at op 4 with the merge its flow parts on some pixels by
    more than 0.01 px; without the merge it moves by under 1e-3 px
    everywhere.  The program's gap at op 4 is of that kind."""
    _, conf = fb_conf("tiny-op4")
    p = conf["dis"]
    a, b = (torch.as_tensor(x).float() for x in
            cold_pairs.make(TINY_MIXES["pairs"], conf, 4).pair(0))
    g = torch.Generator().manual_seed(0)
    moved = b + (torch.rand(b.shape, generator=g) - 0.5) * 1e-3
    with_fb = check.pixel_stats(plain_fb.pair_flow(a, b, p),
                                plain_fb.pair_flow(a, moved, p))
    p_fw = dict(p, use_fb_consistency=False)
    without = check.pixel_stats(plain_dis.pair_flow(a, b, p_fw),
                                plain_dis.pair_flow(a, moved, p_fw))
    assert with_fb["over"] > 0.005
    assert without["max"] < 1e-3


# ------------------------------------------------------------------ the merge

def merge_transcribed(mx, my, cost_px, p_cur, min_errval, h, w):
    """patchgrid.cpp lines 277-375, loop by loop, in float64: each patch,
    each of its pixels, each of the four cells."""
    ps = cost_px.shape[2]
    we = np.zeros((h, w))
    fl = np.zeros((h, w, 2))
    for gy in range(cost_px.shape[0]):
        for gx in range(cost_px.shape[1]):
            u, v = (float(t) for t in p_cur[gy, gx])
            rx, ry = mx[gx] + u, my[gy] + v
            p0, p1 = math.ceil(rx + 1e-5), math.ceil(ry + 1e-5)
            r0, r1 = rx - math.floor(rx), ry - math.floor(ry)
            wb = (r0 * r1, (1 - r0) * r1, r0 * (1 - r1), (1 - r0) * (1 - r1))
            lb = -int(ps / 2)
            for y in range(lb, lb + ps):
                for x in range(lb, lb + ps):
                    xt, yt = p0 + x, p1 + y
                    if 1 <= xt < w - 1 and 1 <= yt < h - 1:
                        c = cost_px[gy, gx, y - lb, x - lb]
                        absw = 1.0 / np.maximum(c, min_errval).sum()
                        for k, (ox, oy) in enumerate(plain_fb.CORNERS):
                            we[yt - oy, xt - ox] += wb[k] * absw
                            fl[yt - oy, xt - ox] -= wb[k] * absw * np.array(
                                [u, v])
    return we, fl


@pytest.mark.parametrize("ps,stride,spread", [(8, 0.4, 1.5), (12, 0.75, 4.0)])
def test_merge_matches_the_transcription(ps, stride, spread):
    """Random flows and costs on a 24x32 grid (op 2's and op 4's patch
    geometry; the larger spread pushes many pixels out of the frame):
    the float32 merge against the float64 loops, within float32's
    rounding of sums of up to ~60 terms."""
    p = dict(patch_size=ps, patch_stride=stride, min_errval=2.0)
    h, w = 24, 32
    g = plain_dis.make_grid(p, w, h)
    rng = np.random.default_rng(ps)
    cost = (rng.random((g.n_h, g.n_w, ps, ps, 3)) * 8).astype(np.float32)
    flow = (spread * rng.standard_normal((g.n_h, g.n_w, 2))).astype(
        np.float32)
    tally = [0, 0, 0]
    acc = plain_fb.merge(torch.as_tensor(flow)[None],
                         torch.as_tensor(cost)[None], g, p, tally)[0].numpy()
    mx = np.arange(g.n_w) * g.steps + g.off_w
    my = np.arange(g.n_h) * g.steps + g.off_h
    we, fl = merge_transcribed(mx, my, cost, flow, 2.0, h, w)
    np.testing.assert_allclose(acc[..., 0], we, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(acc[..., 1:], fl, rtol=1e-5, atol=1e-5)
    assert tally[:2] == [1, g.n_h * g.n_w]
    assert 0 < tally[2] < 4 * g.n_h * g.n_w * ps * ps


# -------------------------------------------------------------- the judge

def test_judge_refuses_what_it_does_not_compute():
    _, conf = fb_conf("tiny-op2")
    p = conf["dis"]
    fb.check_params(p)
    assert fb.check_params is plain_fb.check_params
    for key, value in (("use_fb_consistency", False), ("cost_fn", "huber"),
                       ("dtype", "bfloat16"), ("res_thresh", 0.1)):
        with pytest.raises(ValueError, match=key):
            fb.check_params(dict(p, **{key: value}))
    with pytest.raises(ValueError, match="use_fb_consistency"):
        fb.check_params({k: v for k, v in p.items()
                         if k != "use_fb_consistency"})


def tiny_fb_root(tmp_path, cell="tiny-op2-fb.ring", **dis):
    """A tiny root with the fb cell ``cell``: op 2's preset with the merge
    on and ``dis`` besides, each key off the preset listed under departs,
    judged by ``fb``, compared by the 90th percentile of each flow's
    error."""
    root = make_root(tmp_path, cells=(cell,))
    here = root / "flowbench"
    conf = json.loads((here / "configs" / "tiny-op2.json").read_text())
    preset = dict(conf["dis"])
    conf["dis"].update(dict({"use_fb_consistency": True}, **dis))
    conf.update(departs={k: "test" for k, v in conf["dis"].items()
                         if v != preset[k]}, reference="fb")
    write_json(here / "configs" / f"{cell.split('.')[0]}.json", conf)
    write_json(here / "limits" / f"{cell}.json",
               {"epe_ref_p90": {"limit": 1e-4}})
    return root


class Watched:
    """The program, with every attribute the harness reads recorded."""

    def __init__(self):
        self.read = set()

    def __getattr__(self, name):
        self.read.add(name)
        return getattr(port, name)


@pytest.mark.parametrize("dis,says", [
    ({"use_fb_consistency": False}, "use_fb_consistency"),
    ({"cost_fn": "huber"}, "cost_fn")], ids=["fb-off", "huber"])
def test_judge_refuses_before_the_warm_up(tmp_path, capsys, dis, says):
    root = tiny_fb_root(tmp_path, **dis)
    watched = Watched()
    with pytest.raises(ValueError, match=says):
        run_cell("tiny-op2-fb.ring", 3, 0.5, False, device="cpu", root=root,
                 port=watched)
    assert watched.read == {"operating_point"}
    assert capsys.readouterr().out == ""


def test_the_fb_cell_resolves_by_name():
    cell = cells.load(FB_CELL)
    assert cell.conf["reference"] == "fb"
    assert set(cell.conf["departs"]) == {"use_fb_consistency"}
    assert cell.spec == cells.load("sintel-op4.stream-slow").spec
    cfg = cells.program_config(port, cell.conf)
    assert cfg.use_fb_consistency is True
    base = cells.program_config(port, cells.load(
        "sintel-op4.stream-slow").conf)
    assert dataclasses.replace(base, use_fb_consistency=True) == cfg
    names = {m["name"] for m in cell.per_layer}
    assert {"backward_ms", "fb_merge_ms", "fb_merge_roofline"} <= names
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s",
                                                     "setup_s"}
    judge = cells.module("reference", cell.conf["reference"])
    judge.check_params(cell.conf["dis"])
    assert callable(judge.stream) and callable(judge.pairs)


@pytest.mark.parametrize("changes,correct", [({}, True),
                                             ({"dtype": "bfloat16"}, False)],
                         ids=["sound", "control"])
def test_tiny_fb_cell(tmp_path, changes, correct):
    root = tiny_fb_root(tmp_path)
    got = []
    r = run_cell("tiny-op2-fb.ring", 2 ** 31 + 5, 0.5, False, device="cpu",
                 root=root, changes=changes, readings_out=got)
    assert r["correct"] is correct, r["checks"]
    counts = got[0].counts
    assert set(counts.merge) == set(counts)
    for sl, (n_merges, patches, landed) in counts.merge.items():
        frames = got[0].frames_counted
        assert n_merges == frames * (1 if sl == min(counts) else 2)
        assert 0 < landed <= 4 * patches * 8 * 8
        assert counts[sl][0] == 2 * patches / n_merges * frames


# ----------------------------------------------------------------- readers

def _summary(device_ms=None, device_s=None, counts=None):
    return {"frames": 4, "device_s": device_s or {}, "counts": counts,
            "params": {"patch_size": 12}, "frames_counted": 2,
            "shape": (448, 1024, 3), "device_ms": device_ms}


@pytest.fixture
def program(monkeypatch):
    from flowbench import program_spans

    def install(device_ms):
        r = {"calls": 4, "modes": {"replay": 4}, "device_calls": 4,
             "host_ms": {}, "device_ms": device_ms}
        mod = type(sys)(program_spans.PROFILING)
        mod.report = lambda calls=None: r
        monkeypatch.setitem(sys.modules, program_spans.PROFILING, mod)
    return install


def test_span_readers(program):
    program({"opti": 24.0, "opti_bw": 20.0, "extract_bw": 1.0,
             "var_ref_bw": 2.0, "aggregate_bw": 1.0, "fb_merge": 1.6,
             "scale 0": 30.0})
    s = _summary()
    assert backward_ms.read(s) == pytest.approx(6.0)
    assert fb_merge_ms.read(s) == pytest.approx(0.4)
    program({"opti": 24.0, "aggregate": 2.0, "scale 0": 30.0})  # no fb
    assert backward_ms.read(s) is None and fb_merge_ms.read(s) is None


def test_roofline_reader():
    counts = fb.Counts()
    counts[0] = [2 * 51_300, 2 * 51_300, 10**6]
    counts.merge[0] = [2, 2 * 51_300, 2 * 25_000_000]
    counts.merge[1] = [4, 4 * 12_825, 4 * 6_000_000]
    dev = {"G5 fb merge bins": 0.4e-3, "G5 fb merge cells": 1.2e-3}
    got = fb_merge_roofline.read(_summary(device_s=dev, counts=counts))
    from flowbench.yardstick.fb_bounds import fb_merge_bound
    least = (fb_merge_bound(1, 51_300, 12, 3, 448, 1024, 25_000_000).bound_ms
             + 2 * fb_merge_bound(1, 12_825, 12, 3, 224, 512,
                                  6_000_000).bound_ms)
    assert got == pytest.approx(100 * least / (1.6 / 4))
    assert fb_merge_roofline.read(_summary(device_s=dev)) is None
    plain = {0: [1, 1, 1]}                # check's readings: no merges
    assert fb_merge_roofline.read(_summary(device_s=dev,
                                           counts=plain)) is None
    assert fb_merge_roofline.read(_summary(counts=counts)) is None


def test_readers_on_the_programs_report_of_a_cpu_run():
    from flowbench import program_spans
    from flowonthego_tpu_torch.utils import profiling
    cfg, conf = fb_conf("tiny-op2")
    frames = split_ring.make(TINY_MIXES["ring"], conf, 3).frames[:3]
    profiling.enable()
    try:
        list(port.stream_flow(frames, cfg, device="cpu"))
    finally:
        profiling.disable()
    s = {"frames": 2}
    assert backward_ms.read(s) > 0 and fb_merge_ms.read(s) > 0
    r = program_spans.report(s)
    assert r["counters"]["patches_bw"] == r["counters"]["patches_fw"] > 0
