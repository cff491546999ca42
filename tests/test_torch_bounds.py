"""The kernels' bounds (``ops/cuda/bounds.py``) against numbers worked out
by hand from the shapes: bytes (each input once, each output once),
float32 operations, which of the two binds, and the time at 3.35 TB/s and
67 TFLOP/s.  Pure arithmetic, no device.
"""

import pytest

from flowonthego_tpu_torch.ops.cuda import bounds

# (call, bytes, operations, bound by) -- each total spelt out term by term
CASES = {
    # K1, the 4K level 0 as a flat [2176, 3840*3] float32 level:
    # in 2176*11520*4, out 1088*5760*4; 4 operations an output
    "K1 2176x11520 f32": (
        lambda: bounds.pool_bound(2176, 11520),
        100_270_080 + 25_067_520, 25_067_520, "bytes"),
    # the same level as uint8 with a bias: 1 byte in, 5 operations
    "K1 2176x11520 u8 bias": (
        lambda: bounds.pool_bound(2176, 11520, in_bytes=1, bias=True),
        25_067_520 + 25_067_520, 31_334_400, "bytes"),
    # K2 at op 2, 510 patches of 8x8x3 = 192 values, 12 iterations, level
    # 68x120 padded by 8 -> 84x136x3: image 137,088; T, gx, gy 510*3*192*4;
    # H+mid+p_cur+p_org 510*36; started 510; p 510*8; cost 510*192*4.
    # Operations: 510*12 patch-iterations x (12*192 + 40) + 510*192*(11+6)
    "K2 op 2, 510 patches": (
        lambda: bounds.gn_bound(1, 510, 8, 3, 84, 136, 12),
        137_088 + 1_175_040 + 18_360 + 510 + 4_080 + 391_680,
        6_120 * 2_344 + 1_664_640, "bytes"),
    # K2 at op 4 scale 1, 12,825 patches of 12x12x3 = 432 values, 128
    # iterations, level 224x512 padded by 12 -> 248x536x3
    "K2 op 4, 12,825 patches": (
        lambda: bounds.gn_bound(1, 12_825, 12, 3, 248, 536, 128),
        1_595_136 + 66_484_800 + 461_700 + 12_825 + 102_600 + 22_161_600,
        1_641_600 * 5_224 + 94_186_800, "operations"),
    # its bf16 form: image, T, gx, gy 2 bytes wide, 16 bytes of sums a
    # patch in, and no constant sums to reduce (11 a value after the loop)
    "K2 op 4 bf16": (
        lambda: bounds.gn_bound(1, 12_825, 12, 3, 248, 536, 128, bf16=True),
        797_568 + 33_242_400 + 461_700 + 12_825 + 205_200 + 102_600
        + 22_161_600,
        1_641_600 * 5_224 + 12_825 * 432 * 11, "operations"),
    # K4 at 448x1024 level 0 (1 round, 3 SOR iterations): 3 + 8C + 2
    # planes; a round is 26 + 2 + 93C + 44 + 32*3 operations, 2 at the end
    "K4 448x1024 C=3": (
        lambda: bounds.varref_tiled_bound(1, 448, 1024, 3, 1, 3),
        458_752 * 29 * 4, 458_752 * (447 + 2), "bytes"),
    "K4 448x1024 C=1": (
        lambda: bounds.varref_tiled_bound(1, 448, 1024, 1, 1, 3),
        458_752 * 13 * 4, 458_752 * (261 + 2), "bytes"),
    # K3 at 14x32 level 5 (6 rounds): the same count; 6 rounds on 52 KB
    # are 1.2 MFLOP, 18 ns against 15.5 ns for the bytes
    "K3 14x32 level 5": (
        lambda: bounds.varref_fused_bound(1, 14, 32, 3, 6, 3),
        448 * 29 * 4, 448 * (6 * 447 + 2), "operations"),
    # K5 at 448x1024x3: src + warped 2*3 planes, wx, wy, mask; 12 + 11*3
    "K5 448x1024x3": (
        lambda: bounds.warp_bound(1, 448, 1024, 3),
        458_752 * 9 * 4, 458_752 * 45, "bytes"),
    # G1 at op 4's scale 0 (448x1024x3, padding 12 -> 472x1048x3): the
    # level in, image and both gradients out; 2 operations a value
    "G1 448x1024x3 pad 12": (
        lambda: bounds.level_bound(1, 448, 1024, 3, 12),
        (1_376_256 + 3 * 1_483_968) * 4, 2 * 1_376_256, "bytes"),
    # G2 there: 51,300 patches of 12x12x3 = 432 values from three padded
    # levels; three windows and H out; 8 a value, 7 a patch
    "G2 op 4 scale 0": (
        lambda: bounds.extract_bound(1, 472, 1048, 3, 51_300, 12),
        (3 * 1_483_968 + 3 * 51_300 * 432 + 3 * 51_300) * 4,
        51_300 * (432 * 8 + 7), "bytes"),
    # G3 there: p (2 a patch) and the costs in, the flow out; a clamp a
    # cost value, C + 5 = 8 a patch pixel, 3 an output pixel
    "G3 op 4 scale 0": (
        lambda: bounds.densify_bound(1, 448, 1024, 3, 51_300, 12),
        (51_300 * 2 + 51_300 * 432 + 458_752 * 2) * 4,
        51_300 * 432 + 51_300 * 144 * 8 + 458_752 * 3, "bytes"),
    # ... with abs weights (a square root more a cost value) and an fb
    # merge's [h, w, 3] in (3 adds more an output pixel)
    "G3 op 4 scale 0 abs fb": (
        lambda: bounds.densify_bound(1, 448, 1024, 3, 51_300, 12,
                                     sqrt=True, merge=True),
        (51_300 * 2 + 51_300 * 432 + 458_752 * 5) * 4,
        2 * 51_300 * 432 + 51_300 * 144 * 8 + 458_752 * 6, "bytes"),
    # G4 at 448x1024x3: two images in, eight planes out; 38 a value
    "G4 448x1024x3": (
        lambda: bounds.derivs_bound(1, 448, 1024, 3),
        1_376_256 * 10 * 4, 1_376_256 * 38, "bytes"),
    # G5 at op 2's scale 3 of 1024x448 (56x128, 448 patches of 8x8x3):
    # p and midpoints 2 + 2 a patch, the costs, the accumulator out; 15 a
    # patch, C + 2 = 5 a patch pixel, 6 for each of 100,000 contributions
    "G5 op 2 scale 3": (
        lambda: bounds.fb_merge_bound(1, 448, 8, 3, 56, 128, 100_000),
        (448 * 4 + 448 * 64 * 3 + 56 * 128 * 3) * 4,
        448 * 15 + 448 * 64 * 5 + 100_000 * 6, "bytes"),
    # G6 there under pseudo-Huber, level 72x144x3, every patch started and
    # running its 12 trips: the level, T, gx, gy, H, midpoints, p_org (7
    # floats) a started patch, p (2 floats) and a flag a patch, p, diff,
    # cost out (no entry diff and cost: no patch converged on entry); a
    # sample 10 + 9 + 2 a value, a trip 4 a value and 40
    "G6 op 2 scale 3 huber": (
        lambda: bounds.ref_bound(1, 448, 8, 3, 72, 144, 448 * 12, 448,
                                 "huber"),
        124_416 + 448 * 192 * 4 * 3 + 448 * 28 + 448 * 8 + 448 + 448 * 8
        + 448 * 2 * 192 * 4,
        (448 + 5_376) * 192 * 21 + 5_376 * (192 * 4 + 40), "bytes"),
    # its 1-D form under l2: one gradient and H00 in a started patch (400
    # of them), the entry diff and cost of the 48 converged on entry;
    # 1,000 trips; a sample 10 + 2 a value, a trip 2 a value and 40
    "G6 1-D op 2 scale 3": (
        lambda: bounds.ref_bound(1, 448, 8, 3, 72, 144, 1_000, 400,
                                 one_d=True),
        124_416 + 400 * (192 * 2 + 5) * 4 + 48 * 2 * 192 * 4 + 448 * 8
        + 448 + 448 * 8 + 448 * 2 * 192 * 4,
        1_400 * 192 * 12 + 1_000 * (192 * 2 + 40), "bytes"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bound_matches_hand_count(name):
    call, n_bytes, n_flops, by = CASES[name]
    b = call()
    assert (b.bytes, b.flops, b.bound_by) == (n_bytes, n_flops, by)
    want = max(n_bytes / 3.35e12, n_flops / 67e12) * 1e3
    assert b.bound_ms == pytest.approx(want, rel=1e-12)


def test_known_times():
    """The 4K pool moves 125 MB (0.0374 ms); op 4's solve does 8.67 GFLOP
    (0.129 ms); K4's level 0 moves 53 MB (0.0159 ms)."""
    assert bounds.pool_bound(2176, 11520).bound_ms == pytest.approx(
        0.037414, rel=1e-4)
    assert bounds.gn_bound(1, 12_825, 12, 3, 248, 536, 128
                           ).bound_ms == pytest.approx(0.129402, rel=1e-4)
    assert bounds.varref_tiled_bound(1, 448, 1024, 3, 1, 3
                                     ).bound_ms == pytest.approx(0.015885,
                                                                 rel=1e-4)


def test_gn_counts_live_iterations():
    """Fewer live iterations count less; patches never started cost no
    operation; the bytes stay (every input is still read)."""
    full = bounds.gn_bound(1, 12_825, 12, 3, 248, 536, 128)
    # every patch resets at its first iteration
    early = bounds.gn_bound(1, 12_825, 12, 3, 248, 536, 128,
                            patch_iters=12_825)
    assert early.bytes == full.bytes
    assert early.flops == 12_825 * 5_224 + 94_186_800 < full.flops
    assert early.bound_by == "bytes"
    # half the patches frozen at warm start
    half = bounds.gn_bound(1, 510, 8, 3, 84, 136, 12, n_started=255)
    assert half.flops == 255 * 12 * 2_344 + 255 * 192 * 17


@pytest.mark.parametrize("name,one,batch", [
    ("K1", lambda: bounds.pool_bound(448, 3072),
     lambda: bounds.pool_bound(4 * 448, 3072)),
    ("K3", lambda: bounds.varref_fused_bound(1, 14, 32, 3, 6, 3),
     lambda: bounds.varref_fused_bound(4, 14, 32, 3, 6, 3)),
    ("K4", lambda: bounds.varref_tiled_bound(1, 56, 128, 3, 4, 3),
     lambda: bounds.varref_tiled_bound(4, 56, 128, 3, 4, 3)),
    ("K5", lambda: bounds.warp_bound(1, 448, 1024, 3),
     lambda: bounds.warp_bound(4, 448, 1024, 3)),
    ("K2", lambda: bounds.gn_bound(1, 448, 8, 3, 72, 144, 12),
     lambda: bounds.gn_bound(4, 448, 8, 3, 72, 144, 12)),
    ("K2 bf16", lambda: bounds.gn_bound(1, 448, 8, 3, 72, 144, 12, bf16=True),
     lambda: bounds.gn_bound(4, 448, 8, 3, 72, 144, 12, bf16=True)),
    ("G1", lambda: bounds.level_bound(1, 56, 128, 3, 8),
     lambda: bounds.level_bound(4, 56, 128, 3, 8)),
    ("G2", lambda: bounds.extract_bound(1, 72, 144, 3, 448, 8),
     lambda: bounds.extract_bound(4, 72, 144, 3, 448, 8)),
    ("G3", lambda: bounds.densify_bound(1, 56, 128, 3, 448, 8, merge=True),
     lambda: bounds.densify_bound(4, 56, 128, 3, 448, 8, merge=True)),
    ("G4", lambda: bounds.derivs_bound(1, 56, 128, 3),
     lambda: bounds.derivs_bound(4, 56, 128, 3)),
    ("G5", lambda: bounds.fb_merge_bound(1, 448, 8, 3, 56, 128, 1_000),
     lambda: bounds.fb_merge_bound(4, 448, 8, 3, 56, 128, 4_000)),
    ("G6", lambda: bounds.ref_bound(1, 448, 8, 3, 72, 144, 500, 448, "l1"),
     lambda: bounds.ref_bound(4, 448, 8, 3, 72, 144, 2_000, 1_792, "l1")),
])
def test_batch_counts_b_frames(name, one, batch):
    a, b = one(), batch()
    assert (b.bytes, b.flops) == (4 * a.bytes, 4 * a.flops)
    assert b.bound_ms == pytest.approx(4 * a.bound_ms, rel=1e-12)
