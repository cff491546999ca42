"""The frozen yardstick: the categories of kernel names, the layers they
count under, and the bounds arithmetic against counts by hand."""

from __future__ import annotations

import pytest

from flowbench.layer_metrics import patch_solve_roofline, varref_ms
from flowbench.yardstick import bounds
from flowbench.yardstick.categories import LAYERS, category, layer_ms

NAMES = {
    "void (anonymous namespace)::dis_gn_kernel<float, 12, 3>(x)": "K2 gn",
    "(anonymous namespace)::glue_extract_kernel(float const*)": "G2 extract",
    "void (anonymous namespace)::fb_merge_warp_kernel<3>(x)":
        "G5 fb merge cells",
    "void (anonymous namespace)::warp_kernel<3, 4>(float const*)": "K5 warp",
    "void (anonymous namespace)::varref_kernel<3, 512>(x)": "K3",
    "void (anonymous namespace)::varref_tiled_kernel<3>(x)": "K4 grid",
    "void (anonymous namespace)::pool2x2_kernel<float>(x)": "K1 pool",
    "void (anonymous namespace)::dis_ref_1d_kernel<8>(x)": "G6 dis_ref 1-D",
    "Memcpy HtoD (Pageable -> Device)": "copy HtoD",
    "Memcpy DtoH (Device -> Pageable)": "copy DtoH",
    "Memcpy DtoD (Device -> Device)": "copy DtoD",
    "memcpy32_post": "copy DtoD",
    "Memset (Device)": "memset",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8": "GEMM",
    "void at::native::vectorized_elementwise_kernel<4, x>": "torch kernels",
    "void at::native::(anonymous namespace)::upsample_gen2d_aa_out_frame":
        "torch kernels",
}


@pytest.mark.parametrize("name,cat", sorted(NAMES.items()))
def test_category(name, cat):
    assert category(name) == cat


def test_every_category_has_one_layer():
    cats = set(NAMES.values())
    owners = {c: [m for m, cs in LAYERS.items() if c in cs] for c in cats}
    assert all(len(v) == 1 for v in owners.values()), owners


def test_layer_ms():
    s = {"frames": 4, "device_s": {"K3": 0.002, "K5 warp": 0.002,
                                   "GEMM": 0.1}}
    assert layer_ms(s, "varref_ms") == pytest.approx(1.0)
    assert varref_ms.read(s) == pytest.approx(1.0)
    assert layer_ms(s, "densify_ms") is None


def test_extract_bound_by_hand():
    # 2 patches of 2x2x1 from three [1, 6, 8, 1] levels: 3 x 48 values in,
    # templates, gx, gy (3 x 2 x 4) and H (3 x 2) out, float32
    b = bounds.extract_bound(1, 6, 8, 1, 2, 2)
    assert (b.bytes, b.flops) == ((144 + 24 + 6) * 4, 2 * (4 * 8 + 7))
    assert b.bound_ms == pytest.approx(696 / 3.35e12 * 1e3)
    assert b.bound_by == "bytes"


def test_gn_bound_by_hand():
    # 2 patches of 2x2x1 against a [1, 6, 6, 1] level, 3 steps each
    b = bounds.gn_bound(1, 2, 2, 1, 6, 6, 3)
    n_bytes = (36 * 4 + 2 * 3 * 4 * 4 + 2 * 9 * 4 + 2 + 2 * 2 * 4
               + 2 * 4 * 4)
    n_flops = 2 * 3 * (12 * 4 + 40) + 2 * 4 * (11 + 6)
    assert (b.bytes, b.flops) == (n_bytes, n_flops)
    assert b.bound_by == "bytes"


def test_roofline_reader():
    params = {"patch_size": 2, "grad_descent_iter": 3}
    # one scale (0) of a 2x4 frame, C = 1: 2 patches, both started, 6 steps
    s = {"frames": 1, "frames_counted": 1, "shape": (2, 4, 1),
         "params": params, "counts": {0: [2, 2, 6]},
         "device_s": {"K2 gn": 1e-6, "G2 extract": 1e-6}}
    least = (bounds.gn_bound(1, 2, 2, 1, 6, 8, 3, patch_iters=6,
                             n_started=2).bound_ms
             + bounds.extract_bound(1, 6, 8, 1, 2, 2).bound_ms)
    assert patch_solve_roofline.read(s) == pytest.approx(100 * least / 2e-3)
    assert patch_solve_roofline.read(dict(s, counts={})) is None
