"""The frozen reference against the program's CPU path at a tiny size,
and the pieces the comparison leans on."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import flowonthego_tpu_torch as port
from flowbench.reference import plain_dis as ref
from flowbench.reference.check import epe
from flowbench.traffic import cold_pairs, split_ring

from conftest import TINY_CONFIGS, TINY_MIXES


def conf_of(name):
    op, h, w = TINY_CONFIGS[name]
    cfg = port.operating_point(op, width=w)
    return cfg, dict(height=h, width=w, channels=3,
                     dis=dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", sorted(TINY_CONFIGS))
def test_pair_matches_the_program(name):
    cfg, conf = conf_of(name)
    pairs = cold_pairs.make(TINY_MIXES["pairs"], conf, 4)
    for j in range(2):
        a, b = pairs.pair(j)
        mine = ref.pair_flow(torch.as_tensor(a), torch.as_tensor(b),
                             conf["dis"])
        theirs = port.compute_flow(a, b, cfg, device="cpu")
        assert mine.shape == theirs.shape == (*a.shape[:2], 2)
        assert epe(mine, theirs) < 1e-5
        assert float((mine - theirs).abs().max()) < 1e-2


@pytest.mark.parametrize("name", sorted(TINY_CONFIGS))
def test_stream_chain_matches_the_program(name):
    cfg, conf = conf_of(name)
    ring = split_ring.make(TINY_MIXES["ring"], conf, 5)
    frames = [ring.frame(i) for i in range(8)]
    theirs = list(port.stream_flow(frames, cfg, device="cpu"))
    p = conf["dis"]
    H, W = frames[0].shape[:2]
    ih, iw = ref.init_shape(p, H, W)
    pyr = ref.pyramid(torch.as_tensor(frames[0])[None], p)
    init = torch.zeros(1, ih, iw, 2)
    for i in range(1, len(frames)):
        full, fin, pyr = ref.stream_step(pyr, torch.as_tensor(frames[i]), p,
                                         init)
        init = ref.warm_start(fin, p, ih, iw)
        assert epe(full, torch.as_tensor(theirs[i - 1])) < 1e-5


def test_finest_from_full_inverts_the_upsample():
    p = dict(finest_scale=2)
    fin = torch.randn(1, 6, 10, 2, dtype=torch.float32) * 5
    full = ref.full_flow(fin, p, 24, 40)[0]
    back = ref.finest_from_full(full, p)
    assert float((back - fin).abs().max()) < 1e-4
    p0 = dict(finest_scale=0)
    assert torch.equal(ref.finest_from_full(full, p0)[0], full)


def test_reference_refuses_modes_it_lacks():
    p = dataclasses.asdict(port.operating_point(2))
    ref.check_params(p)
    for key, value in (("cost_fn", "huber"), ("use_fb_consistency", True),
                       ("dtype", "bfloat16"), ("min_iter", 4)):
        with pytest.raises(ValueError):
            ref.check_params(dict(p, **{key: value}))


def test_reference_counts_steps():
    _, conf = conf_of("tiny-op4")
    pairs = cold_pairs.make(TINY_MIXES["pairs"], conf, 4)
    count = {}
    ref.pair_flow(*(torch.as_tensor(x) for x in pairs.pair(0)), conf["dis"],
                  count)
    p = conf["dis"]
    assert sorted(count) == list(range(p["finest_scale"],
                                       p["coarsest_scale"] + 1))
    for patches, started, steps in count.values():
        assert 0 < started <= patches
        assert 0 < steps <= started * p["grad_descent_iter"]
    assert np.isfinite(sum(c[2] for c in count.values()))
