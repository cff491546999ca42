"""The PyTorch port's package rules, config, I/O and kernel loader.

The port (``flowonthego_tpu_torch``) must never import JAX, must carry the
JAX config field for field, and must refuse — not quietly fall back —
when its CUDA kernels cannot be built.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from flowonthego_tpu import config as jcfg
from flowonthego_tpu.io.flo import read_flo as jax_read_flo
from flowonthego_tpu.utils.metrics import average_epe as jax_average_epe

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch import config as pcfg
from flowonthego_tpu_torch.convert import config_from_jax
from flowonthego_tpu_torch.ops.cuda import _build

torch.set_num_threads(1)


def test_import_leaves_jax_out():
    code = ("import sys, flowonthego_tpu_torch, flowonthego_tpu_torch.convert, "
            "flowonthego_tpu_torch.ops.cuda.varref_fused, "
            "flowonthego_tpu_torch.utils.synth; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, "-c", code], check=True)


@pytest.mark.parametrize("op_point", [1, 2, 3, 4])
def test_operating_point_matches_jax(op_point):
    for width in (None, 96, 1024, 3840):
        ref = dataclasses.asdict(jcfg.operating_point(op_point, width=width))
        got = dataclasses.asdict(pcfg.operating_point(op_point, width=width))
        assert got == ref
        assert config_from_jax(ref) == pcfg.operating_point(op_point,
                                                            width=width)
    for w, h in ((1024, 436), (3840, 2160), (97, 33)):
        for cs in (0, 3, 7):
            assert pcfg.pad_to_divisible(w, h, cs) == \
                jcfg.pad_to_divisible(w, h, cs)
        assert pcfg.auto_coarsest_scale(w, 8) == jcfg.auto_coarsest_scale(w, 8)


def test_backend_resolution():
    x = torch.zeros(2)
    assert pcfg.use_kernel("auto", x) is False
    assert pcfg.use_kernel("xla", x) is False
    with pytest.raises(ValueError, match="CUDA kernel"):
        pcfg.use_kernel("pallas", x)
    with pytest.raises(ValueError, match="unknown backend"):
        pcfg.use_kernel("triton", x)
    cfg = pcfg.DISConfig(gn_backend="pallas", coarsest_scale=1,
                         finest_scale=0)
    i0 = np.zeros((16, 16, 3), np.float32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        port.compute_flow(i0, i0, cfg, device="cpu")


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_cuda_home", lambda: None)
    monkeypatch.setattr(_build, "library_path",
                        lambda: tmp_path / "libfot_kernels_missing.so")
    monkeypatch.setattr(_build, "_library", None)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.load_library()
    assert _build._library is None


def test_library_name_follows_sources_and_headers(monkeypatch, tmp_path):
    """The library is named by every csrc/*.cu and *.cuh, so an edited
    header builds anew; only the .cu files are compiled."""
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = _build.library_path()
    assert _build.sources() == [tmp_path / "k.cu"]
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert _build.library_path() != first


def test_parallel_build_reports_every_failure():
    with pytest.raises(_build.KernelBuildError) as err:
        _build._run_all([["sh", "-c", "exit 0"],
                         ["sh", "-c", "echo first; exit 3"],
                         ["sh", "-c", "echo second; exit 4"]])
    msg = str(err.value)
    assert "exited with 3" in msg and "first" in msg
    assert "exited with 4" in msg and "second" in msg


def test_flo_roundtrip_and_metrics(tmp_path, rng):
    flow = rng.standard_normal((7, 9, 2)).astype(np.float32)
    path = tmp_path / "f.flo"
    port.write_flo(path, torch.as_tensor(flow))
    np.testing.assert_array_equal(jax_read_flo(path), flow)
    np.testing.assert_array_equal(port.read_flo(path), flow)
    gt = flow + rng.standard_normal(flow.shape).astype(np.float32)
    gt[0, 0] = 1e10                      # unknown pixel
    assert port.average_epe(flow, gt) == jax_average_epe(flow, gt)


def test_input_validation():
    i0 = np.zeros((32, 32, 3), np.float32)
    with pytest.raises(ValueError, match="differ"):
        port.compute_flow(i0, np.zeros((32, 30, 3), np.float32),
                          device="cpu")
    with pytest.raises(ValueError, match="channels"):
        port.compute_flow(np.zeros((32, 32, 2)), np.zeros((32, 32, 2)),
                          device="cpu")
    cfg = pcfg.operating_point(2, width=64)
    frames = [np.zeros((35, 64, 3), np.float32)] * 2
    with pytest.raises(ValueError, match="pre-padded"):
        list(port.stream_flow(frames, cfg, device="cpu"))
