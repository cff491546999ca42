"""JAX golden flows for the card.

``tests/data/torch_port_golden_op{2,3}_1024x448.npz`` hold the JAX
package's finest-scale flow at operating point 2 (56x128x2) and 3
(224x512x2) on the seeded synthetic 1024x436 pair (edge-padded to
1024x448) that ``chip_smoke.py`` drives on the GPU, with the seed and the
shift; ``torch_port_golden_op2_{fb,l1}_1024x448.npz`` the op-2 flow with
forward-backward consistency, and with the l1 cost and ``min_iter=4``.
The GPU machine has no JAX, so these files are how the GPU path is held
against JAX.  ``torch_port_golden_op2_split_1024x448.npz`` is the op-2 flow on the
pair whose left half moves (2, 2) px and whose right half (16, 8) px
(``synthetic_split_pair``): its left half's median is (2.067, 2.061) px,
not (2, 2), in JAX as in the port, so that offset is the algorithm's
answer on this scene at op 2 (8-px cells at the finest scale next to a
seam) and no fault of the port.  The op-2/op-3 tests regenerate each flow
with ``dis_flow_padded_jit`` on the CPU and check both it and the port's
CPU output against the file; the fb, l1 and split tests hold the port's
CPU output against the file.  (Op 4 is held on the card against the all-plain path
instead: its JAX run takes ~90 s on the CPU.)

Write the files anew with ``python tests/test_torch_golden.py`` (all of
them), or only those whose name holds a word: ``python
tests/test_torch_golden.py split``.
"""

import os

import numpy as np
import pytest
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLDEN = os.path.join(DATA, "torch_port_golden_op2_1024x448.npz")
GOLDEN_OP3 = os.path.join(DATA, "torch_port_golden_op3_1024x448.npz")
# the op-2 modes with a golden of their own: file -> config fields
MODES = {
    os.path.join(DATA, "torch_port_golden_op2_fb_1024x448.npz"):
        dict(use_fb_consistency=True),
    os.path.join(DATA, "torch_port_golden_op2_l1_1024x448.npz"):
        dict(cost_fn="l1", min_iter=4),
}
GOLDEN_SPLIT = os.path.join(DATA, "torch_port_golden_op2_split_1024x448.npz")
SEED, SHIFT, HEIGHT, WIDTH = 0, (16, 8), 436, 1024
SPLIT_SHIFTS = ((2, 2), (16, 8))     # left half, right half

torch.set_num_threads(1)


def _padded_pair(seed, shift):
    """The edge-padded pair moving ``shift``; a pair of shifts (left,
    right) gives the split pair."""
    from flowonthego_tpu_torch.config import operating_point, pad_to_divisible
    from flowonthego_tpu_torch.utils.synth import (synthetic_pair,
                                                   synthetic_split_pair)
    if np.ndim(shift) == 2:
        i0, i1 = synthetic_split_pair(seed, HEIGHT, WIDTH, *shift)[:2]
    else:
        i0, i1 = synthetic_pair(seed, HEIGHT, WIDTH, shift)
    cs = operating_point(2, width=WIDTH).coarsest_scale
    pt, pb, pl, pr = pad_to_divisible(WIDTH, HEIGHT, cs)
    pad = ((pt, pb), (pl, pr), (0, 0))
    return np.pad(i0, pad, mode="edge"), np.pad(i1, pad, mode="edge")


def _jax_flow(i0p, i1p, op_point=2, **fields):
    import dataclasses
    import jax.numpy as jnp
    from flowonthego_tpu.config import operating_point
    from flowonthego_tpu.models.dis_flow import dis_flow_padded_jit
    cfg = dataclasses.replace(operating_point(op_point, width=WIDTH),
                              **fields)
    return np.asarray(dis_flow_padded_jit(jnp.asarray(i0p), jnp.asarray(i1p),
                                          cfg))


def _check_golden(path, op_point, shape, with_jax=True, **fields):
    import dataclasses
    from test_torch_slice import assert_flow_band
    from flowonthego_tpu_torch import operating_point
    from flowonthego_tpu_torch.models.dis_flow import dis_flow_padded

    g = np.load(path)
    seed, shift = int(g["seed"]), g["shift"].tolist()
    golden = g["flow"]
    assert golden.shape == shape and golden.dtype == np.float32
    i0p, i1p = _padded_pair(seed, shift)
    assert i0p.shape == (448, 1024, 3)

    if with_jax:
        assert_flow_band(_jax_flow(i0p, i1p, op_point, **fields), golden)
    cfg = dataclasses.replace(operating_point(op_point, width=WIDTH),
                              **fields)
    got = dis_flow_padded(torch.as_tensor(i0p)[None],
                          torch.as_tensor(i1p)[None], cfg)
    assert_flow_band(got[0].numpy(), golden)
    if np.ndim(shift) == 1:
        # the texture moves by a multiple of 8 px: exactly shift / 2^fs
        np.testing.assert_allclose(
            np.median(golden[4:-4, 4:-4].reshape(-1, 2), axis=0),
            np.asarray(shift) / 2 ** cfg.finest_scale, atol=0.01)
    return golden, cfg


def test_golden_matches_jax_and_port():
    _check_golden(GOLDEN, 2, (56, 128, 2))


def test_golden_op3_matches_jax_and_port():
    _check_golden(GOLDEN_OP3, 3, (224, 512, 2))


@pytest.mark.parametrize("path", sorted(MODES))
def test_golden_op2_mode_matches_port(path):
    _check_golden(path, 2, (56, 128, 2), with_jax=False, **MODES[path])


def test_golden_op2_split_pair_matches_port():
    """The port against JAX's op-2 flow on the split pair, and what JAX
    reads on the left half: ~(2.07, 2.06) px for a (2, 2)-px motion, the
    same offset the port shows on the card and on the CPU."""
    golden, cfg = _check_golden(GOLDEN_SPLIT, 2, (56, 128, 2), with_jax=False)
    scale = 2 ** cfg.finest_scale
    # the left half away from the border and the seam, in full-res pixels
    left = golden[2:-2, 2:WIDTH // 2 // scale - 4].reshape(-1, 2) * scale
    med = np.median(left, axis=0)
    assert np.abs(med - np.asarray(SPLIT_SHIFTS[0])).max() <= 0.1
    assert (med > np.asarray(SPLIT_SHIFTS[0]) + 0.03).all(), med


if __name__ == "__main__":
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    runs = [(GOLDEN, 2, SHIFT, {}), (GOLDEN_OP3, 3, SHIFT, {})]
    runs += [(path, 2, SHIFT, fields) for path, fields in MODES.items()]
    runs += [(GOLDEN_SPLIT, 2, SPLIT_SHIFTS, {})]
    for path, op_point, shift, fields in runs:
        if not all(word in os.path.basename(path) for word in sys.argv[1:]):
            continue
        i0p, i1p = _padded_pair(SEED, shift)
        np.savez_compressed(
            path, flow=_jax_flow(i0p, i1p, op_point,
                                 **fields).astype(np.float32),
            seed=np.int64(SEED), shift=np.asarray(shift, np.int64))
        print("wrote", path)
