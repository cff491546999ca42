"""The traffic laws: seeded, closed rings, and a true flow that maps each
frame onto the next on every known pixel."""

from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest

from flowbench.traffic import cold_pairs, split_ring
from flowbench.traffic.texture import texture

from conftest import TINY_MIXES

CONF = dict(height=44, width=128, channels=3, dis={"coarsest_scale": 3})


def moved_matches(a, b, truth) -> int:
    """Known pixels of ``a`` whose content is not at ``a + flow`` in
    ``b``; asserts that there are known pixels."""
    flow, known = truth
    jj, ii = np.nonzero(known)
    u = flow[jj, ii, 0].astype(int)
    v = flow[jj, ii, 1].astype(int)
    assert len(jj) > 0.5 * known.size
    return int(np.any(a[jj, ii] != b[jj + v, ii + u], axis=-1).sum())


def test_texture_is_seeded_uint8():
    a = texture(5, 40, 60, 3, 8)
    assert a.dtype == np.uint8 and a.shape == (40, 60, 3)
    assert np.array_equal(a, texture(5, 40, 60, 3, 8))
    assert not np.array_equal(a, texture(6, 40, 60, 3, 8))
    assert 30 < a.std() < 90


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11])
def test_ring_same_seed_same_bytes(seed):
    spec = TINY_MIXES["ring"]
    a, b = (split_ring.make(spec, CONF, seed) for _ in range(2))
    assert all(np.array_equal(x, y) for x, y in zip(a.frames, b.frames))
    c = split_ring.make(spec, CONF, seed + 1)
    assert not np.array_equal(a.frames[0], c.frames[0])


def test_ring_closes_and_truth_maps_every_step():
    spec = dict(TINY_MIXES["ring"], ring=12, amplitude_px=3)
    ring = split_ring.make(spec, CONF, 77)
    assert np.all(ring.steps.sum(axis=-1) == 0)
    assert ring.frames[0].shape == (48, 128, 3)       # padded to 2^3
    for i in range(1, 2 * len(ring) + 1):           # across the wrap twice
        assert moved_matches(ring.frame(i - 1), ring.frame(i),
                             ring.truth(i)) == 0


def test_ring_motion_law():
    spec = dict(TINY_MIXES["ring"], ring=64, amplitude_px=3)
    ring = split_ring.make(spec, CONF, 3)
    change = np.abs(np.diff(ring.steps[..., :-1], axis=-1))
    assert change.max() <= 1                  # a step moves by <= 1 px
    assert np.abs(ring.steps[..., :-1]).max() == 3


def test_pairs_seeded_and_truth():
    spec = TINY_MIXES["pairs"]
    a = cold_pairs.make(spec, CONF, 9)
    b = cold_pairs.make(spec, CONF, 9)
    for j in range(len(a)):
        assert all(np.array_equal(x, y) for x, y in zip(a.pair(j),
                                                         b.pair(j)))
        assert moved_matches(*a.pair(j), a.truth(j)) == 0
    mags = np.linalg.norm(a.shifts, axis=-1)
    lo, hi = spec["magnitude_px"]
    assert mags.min() >= lo - 1 and mags.max() <= hi + 1
    # every seed the same magnitudes, in another order
    c = cold_pairs.make(spec, CONF, 10)
    assert np.allclose(np.sort(mags.ravel()),
                       np.sort(np.linalg.norm(c.shifts, axis=-1).ravel()),
                       atol=1.5)


def test_mixes_of_the_benchmark_load():
    here = pathlib.Path(__file__).resolve().parents[1]
    for path in (here / "traffic").glob("*.json"):
        spec = json.loads(path.read_text())
        assert (here / "traffic" / f"{spec['law']}.py").exists()
        assert (here / "entries" / f"{spec['entry']}.py").exists()


def test_kept_chain_sample_and_wrap():
    from flowbench.keep import Kept
    kept = Kept("stream", 5, 2, 4, seed=3)
    kept.warm([(1, "f1"), (2, "f2")])
    assert not kept.chain_full
    for i in range(3, 40):
        kept.offer(i, f"f{i}")
    assert kept.chain_full
    assert [i for i, _ in kept.start] == [1, 2, 3, 4, 5]
    steps = kept.steps
    assert all(i > 5 for i, _, _ in steps)
    assert 8 in [i for i, _, _ in steps]          # the first wrap past 5
    assert all(prev == f"f{i - 1}" for i, prev, _ in steps)
