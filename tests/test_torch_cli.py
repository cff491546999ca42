"""The port's command line against the JAX package's, on the same files.

Each flag of ``python -m flowonthego_tpu`` (tests/test_cli.py's set, plus
``--channels``, ``--mode depth`` and verbosity 2) runs through both
``cli.main``s on one tiny PNG pair; the port runs with ``--device cpu``.
Each output is held against JAX's with the whole-flow band (mean <= 1e-3
px, p99 <= 1e-2 px; see tests/test_torch_slice.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flowonthego_tpu import cli as jax_cli
from flowonthego_tpu.io.flo import read_flo as jax_read_flo
from flowonthego_tpu.io.images import save_image as jax_save_image
from flowonthego_tpu.io.pfm import read_pfm as jax_read_pfm

from flowonthego_tpu_torch import cli, read_flo, read_pfm

from test_torch_slice import assert_flow_band

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 13-param form: cs fs gd ps stride mean var alpha gamma delta it omega verb
_PARAMS = ["3", "1", "4", "8", "0.4", "1", "0",
           "10", "10", "5", "3", "1.6", "0"]


@pytest.fixture(scope="module")
def tiny_pair(tmp_path_factory):
    """The pair of tests/test_cli.py, as PNG (written by Pillow) and as
    PPM (written by the port)."""
    from scipy.ndimage import gaussian_filter
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(0)
    base = gaussian_filter(
        rng.standard_normal((80, 112, 3)).astype(np.float32),
        sigma=(3, 3, 0)) * 120 + 128
    a = np.clip(base[8:72, 8:104], 0, 255).astype(np.uint8)
    b = np.clip(base[6:70, 5:101], 0, 255).astype(np.uint8)
    from flowonthego_tpu_torch.io.images import save_image
    for name, img in (("a", a), ("b", b)):
        jax_save_image(str(d / f"{name}.png"), img)
        save_image(str(d / f"{name}.ppm"), img)
    return d


def _both(d, name, args, suffix=".flo", params=_PARAMS):
    """Run both CLIs on the PNG pair; returns (port's output, JAX's)."""
    p1, p2 = str(d / "a.png"), str(d / "b.png")
    ours, ref = str(d / f"port_{name}{suffix}"), str(d / f"jax_{name}{suffix}")
    assert jax_cli.main([p1, p2, ref] + params + args) == 0
    assert cli.main([p1, p2, ours] + params + args
                    + ["--device", "cpu"]) == 0
    read = (read_pfm, jax_read_pfm) if suffix == ".pfm" else \
        (read_flo, jax_read_flo)
    return read[0](ours), read[1](ref)


@pytest.mark.parametrize("name,args", [
    ("plain", []),
    ("fb", ["--fb"]),
    ("l1", ["--cost", "l1"]),
    ("huber", ["--cost", "huber"]),
    ("absw", ["--densify-weight", "abs"]),
    ("mi", ["--min-iter", "2"]),
    ("gray", ["--channels", "gray"]),
    ("gradmag", ["--channels", "gradmag"]),
])
def test_cli_flow_flags_match_jax(tiny_pair, name, args):
    got, ref = _both(tiny_pair, name, args)
    assert got.shape == (64, 96, 2)
    assert_flow_band(got, ref)


def test_cli_depth_matches_jax(tiny_pair):
    """--mode depth writes a PFM disparity, sign-clamped <= 0."""
    got, ref = _both(tiny_pair, "depth", ["--mode", "depth"], ".pfm")
    assert got.shape == (64, 96) and (got <= 0).all()
    assert_flow_band(np.stack([got, 0 * got], -1),
                     np.stack([ref, 0 * ref], -1))


def test_cli_verbosity2_and_viz(tiny_pair, capsys):
    """Verbosity 2 prints the same TIME lines as JAX's CLI (per-scale
    phases, phase totals) and the flow still matches; --viz writes the
    color wheel, equal to JAX's."""
    from flowonthego_tpu_torch.io.images import load_image
    params = _PARAMS[:-1] + ["2"]
    d = tiny_pair
    viz = ["--viz", str(d / "viz.png")]
    capsys.readouterr()
    got, _ = _both(d, "verb2", ["--fb"], params=params)
    out = capsys.readouterr().out.splitlines()
    ref = jax_read_flo(str(d / "jax_verb2.flo"))
    assert_flow_band(got, ref)

    def time_lines(lines):
        return [ln.split(")")[0] for ln in lines if ln.startswith("TIME")]
    split = [i for i, ln in enumerate(out) if ln.startswith("flow 96x64")]
    assert len(split) == 2
    jax_lines, port_lines = out[:split[0] + 1], out[split[0] + 1:]
    assert time_lines(port_lines) == time_lines(jax_lines)
    assert sum(ln.startswith("TIME (Sc: ") for ln in port_lines) == 3
    assert any(ln.startswith("config: DISConfig(") for ln in port_lines)

    p1, p2 = str(d / "a.png"), str(d / "b.png")
    assert cli.main([p1, p2, str(d / "v.flo")] + _PARAMS + viz
                    + ["--device", "cpu"]) == 0
    from flowonthego_tpu.io.color import flow_to_color
    flow = read_flo(str(d / "v.flo"))
    np.testing.assert_array_equal(load_image(str(d / "viz.png")),
                                  flow_to_color(flow)[..., ::-1])


def test_cli_ppm_pair_and_op_point(tiny_pair):
    """The operating-point form on the PPM pair (read without Pillow) as
    on the PNG pair, through ``python -m flowonthego_tpu_torch``."""
    d = tiny_pair
    out = str(d / "op1.flo")
    subprocess.run([sys.executable, "-m", "flowonthego_tpu_torch",
                    str(d / "a.ppm"), str(d / "b.ppm"), out, "1",
                    "--device", "cpu"], check=True, cwd=REPO)
    ref = str(d / "op1_jax.flo")
    assert jax_cli.main([str(d / "a.png"), str(d / "b.png"), ref, "1"]) == 0
    assert_flow_band(read_flo(out), jax_read_flo(ref))


@pytest.mark.parametrize("args", [["--cost", "bogus"],
                                  ["--densify-weight", "bogus"],
                                  ["--viz"],
                                  ["3", "1", "4"],
                                  ["--device", "tpu"]])
def test_cli_bad_values_exit_2(tiny_pair, args):
    d = tiny_pair
    device = [] if "--device" in args else ["--device", "cpu"]
    with pytest.raises(SystemExit) as err:
        cli.main([str(d / "a.ppm"), str(d / "b.ppm"), str(d / "x.flo")]
                 + device + args)
    assert err.value.code == 2
    assert not (d / "x.flo").exists()


def test_cli_cuda_without_gpu_exits(tiny_pair, monkeypatch, capsys):
    """--device cuda (the default) with no GPU stops with an error; it
    never runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = tiny_pair
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit) as err:
            cli.main([str(d / "a.ppm"), str(d / "b.ppm"),
                      str(d / "never.flo")] + extra)
        assert err.value.code != 0
        assert "needs a CUDA GPU" in capsys.readouterr().err
    assert not (d / "never.flo").exists()
