"""The user-facing scripts' twins (``python -m
flowonthego_tpu_torch.tools.{flow_stream,flow_eval,color_flow,
stream_alley}``) on a few synthetic 64x128 frames written as PPM files to
a temporary directory, on the CPU.

Each twin must give what the port's functions give on the same frames:
``flow_stream`` and ``stream_alley`` write .flo files equal to
``stream_flow``'s flows (cropped to the frame) bit for bit, ``flow_eval``
prints the EPE of ``endpoint_error``, ``color_flow`` writes the image of
``flow_to_color_native``; and the output lines are the JAX scripts'.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

import flowonthego_tpu_torch as port
from flowonthego_tpu_torch.config import pad_to_divisible
from flowonthego_tpu_torch.io.native import flow_to_color_native
from flowonthego_tpu_torch.tools import (color_flow, flow_eval, flow_stream,
                                         stream_alley)
from flowonthego_tpu_torch.utils.synth import synthetic_frames

torch.set_num_threads(1)

H, W, N = 64, 128, 4


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    for k, f in enumerate(synthetic_frames(3, N, H, W, (2, 1), factor=4)):
        port.save_image(str(d / f"frame_{k:04d}.ppm"),
                        np.clip(f, 0, 255).astype(np.uint8))
    return str(d)


@pytest.fixture(scope="module")
def stream_flows(frames_dir):
    """stream_flow over the loaded, padded frames, cropped back: op 2."""
    frames = [port.load_image(p)
              for p in flow_stream.frame_paths(frames_dir, 100)]
    cfg = port.operating_point(2, width=W)
    pt, pb, pl, pr = pad_to_divisible(W, H, cfg.coarsest_scale)
    padded = [np.pad(f, ((pt, pb), (pl, pr), (0, 0)), mode="edge")
              for f in frames]
    return [f[pt:pt + H, pl:pl + W]
            for f in port.stream_flow(padded, cfg, device="cpu")]


def test_flow_stream_writes_stream_flow(frames_dir, stream_flows, tmp_path,
                                        capsys):
    out = str(tmp_path / "flo")
    assert flow_stream.main([frames_dir, "--flo", out, "--out",
                             str(tmp_path / "viz"), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert f"streaming {W}x{H} at operating point 2" in text
    assert re.search(r"frame +3: +[\d.]+ ms  \|flow\| mean", text)
    assert f"{N - 1} flows, steady-state" in text
    for k, want in enumerate(stream_flows):
        got = port.read_flo(os.path.join(out, f"flow_{k + 1:04d}.flo"))
        np.testing.assert_array_equal(got, want)
        viz = port.load_image(str(tmp_path / "viz" / f"flow_{k + 1:04d}.png"))
        np.testing.assert_array_equal(
            viz, port.flow_to_color(want)[..., ::-1].astype(np.float32))


def test_stream_alley_writes_stream_flow(frames_dir, stream_flows, tmp_path,
                                         capsys):
    out = str(tmp_path / "sa")
    assert stream_alley.main([frames_dir, "--save-dir", out,
                              "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert text.startswith(f"streaming {N} frames")
    assert re.search(rf"{N - 1} flows; steady-state [\d.]+ ms/frame", text)
    for k, want in enumerate(stream_flows):
        np.testing.assert_array_equal(
            port.read_flo(os.path.join(out, f"flow_{k + 1:04d}.flo")), want)


def test_flow_eval_prints_endpoint_error(stream_flows, tmp_path, capsys):
    a, b = str(tmp_path / "a.flo"), str(tmp_path / "b.flo")
    port.write_flo(a, stream_flows[0])
    port.write_flo(b, stream_flows[1])
    assert flow_eval.main([a, b]) == 0
    text = capsys.readouterr().out
    epe = port.endpoint_error(stream_flows[0], stream_flows[1])
    assert f"avg EPE        : {np.nanmean(epe):.4f} px" in text
    assert "avg AE" in text and "normalized EPE" in text
    assert flow_eval.main([a]) == 2


@pytest.mark.parametrize("ext", ["png", "ppm"])
def test_color_flow_writes_the_colour_wheel(stream_flows, tmp_path, capsys,
                                            ext):
    src, out = str(tmp_path / "a.flo"), str(tmp_path / f"c.{ext}")
    port.write_flo(src, stream_flows[0])
    assert color_flow.main([src, out, "4"]) == 0
    assert f"({W}x{H}) -> {out}" in capsys.readouterr().out
    want = flow_to_color_native(port.read_flo(src), 4.0)
    np.testing.assert_array_equal(port.load_image(out),
                                  want[..., ::-1].astype(np.float32))


def test_video_source_needs_cv2(monkeypatch, tmp_path):
    """A source that is not a directory needs OpenCV; where it is absent
    the twin stops with an error that says so (no fallback)."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(SystemExit, match="OpenCV"):
        next(flow_stream.frame_source(str(tmp_path / "video.mp4"), 10))
