"""The port's native I/O library (``flowonthego_tpu_torch/io/native.py``,
built from ``flowonthego_tpu_torch/native/src``) against the JAX package's
``io/native.py`` and against the port's Python twins.

The JAX package's bindings are driven two ways, neither of which builds
anything in its tree: with its library reported missing, so that its
functions take their documented Python fallbacks, and bound to the
library the port built (the same C ABI).  .flo files must agree bit for
bit, PNG and PPM decodes exactly (both decode 8-bit samples to the same
floats), colour wheels to one grey level (float32 against float64 arithmetic cut
to a byte).  Where ``g++`` or the PNG/JPEG headers
are missing the library cannot be built: those cases skip, and the
fallback cases still run.
"""

import ctypes

import numpy as np
import pytest
import torch

import flowonthego_tpu.io.native as jnative
from flowonthego_tpu.config import DISConfig as JaxConfig
from flowonthego_tpu.parallel.frame_parallel import stream_flow as jstream_flow

import flowonthego_tpu_torch as port
import flowonthego_tpu_torch.io.native as pnative
from flowonthego_tpu_torch.convert import config_from_jax
from flowonthego_tpu_torch.io import (flow_to_color, load_image, read_flo,
                                      save_image, write_flo)
from flowonthego_tpu_torch.utils.synth import synthetic_frames
from test_torch_slice import assert_flow_band

torch.set_num_threads(1)


@pytest.fixture
def lib():
    if pnative.get_lib() is None:
        pytest.skip("the native library did not build here: "
                    + pnative.build_log[-300:])
    return pnative.get_lib()


def _need_png(suffix=".png"):
    if suffix == ".png" and pnative.variant != "full":
        pytest.skip("the library was built without libpng on this host")


@pytest.fixture(params=["fallback", "ports_library"])
def jax_native(request, monkeypatch):
    """The JAX package's bindings without a build in its tree."""
    monkeypatch.setattr(jnative, "_lib", None)
    if request.param == "fallback":
        monkeypatch.setattr(jnative, "ensure_built", lambda quiet=True: False)
    else:
        if not pnative.ensure_built():
            pytest.skip("the native library did not build here")
        monkeypatch.setattr(jnative, "ensure_built", lambda quiet=True: True)
        monkeypatch.setattr(jnative, "_LIB_PATH",
                            str(pnative.library_path(pnative.variant)))
    return jnative


def _flow(seed, h=37, w=53):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((h, w, 2)) * 5).astype(np.float32)


def _frames(n=5, h=32, w=48):
    return [np.clip(f, 0, 255).astype(np.uint8).astype(np.float32)
            for f in synthetic_frames(3, n, h, w, (2, 1), factor=4)]


def test_library_builds_from_the_ports_sources(lib):
    assert pnative.variant in [v[0] for v in pnative.VARIANTS]
    path = pnative.library_path(pnative.variant)
    assert path.parent == pnative.BUILD_DIR and path.exists()
    assert "flowonthego_tpu_torch" in str(pnative.SRC_DIR)
    assert isinstance(lib, ctypes.CDLL)
    assert "-march=native" not in pnative.CXXFLAGS


def test_flo_round_trip_bit_exact(lib, jax_native, tmp_path):
    flow = _flow(0)
    a, b, c = (str(tmp_path / n) for n in ("a.flo", "b.flo", "c.flo"))
    pnative.write_flo_native(a, flow)
    write_flo(b, flow)
    jax_native.write_flo_native(c, flow)
    assert open(a, "rb").read() == open(b, "rb").read() \
        == open(c, "rb").read()
    for got in (pnative.read_flo_native(a), read_flo(a),
                jax_native.read_flo_native(a)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, flow)


@pytest.mark.parametrize("suffix", [".png", ".ppm"])
def test_image_decode_matches(lib, jax_native, tmp_path, suffix):
    _need_png(suffix)
    img = _frames(1)[0]
    path = str(tmp_path / ("frame" + suffix))
    save_image(path, img)
    got = pnative.load_image_native(path)
    assert got.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, load_image(path))
    np.testing.assert_array_equal(got, jax_native.load_image_native(path))


def test_image_missing_file_raises(lib, tmp_path):
    with pytest.raises(IOError):
        pnative.load_image_native(str(tmp_path / "absent.png"))
    with pytest.raises(IOError):
        pnative.read_flo_native(str(tmp_path / "absent.flo"))


@pytest.mark.parametrize("max_motion", [0.0, 7.5])
def test_flow_to_color_matches(lib, jax_native, max_motion):
    flow = _flow(1)
    got = pnative.flow_to_color_native(flow, max_motion)
    assert got.dtype == np.uint8 and got.shape == flow.shape[:2] + (3,)
    twin = flow_to_color(flow, max_motion or None)
    ref = jax_native.flow_to_color_native(flow, max_motion)
    # the wheel is float arithmetic cut to a byte (float32 in C++, float64
    # in numpy): at most one grey level apart, and equal almost everywhere
    assert np.abs(got.astype(int) - twin.astype(int)).max() <= 1
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert (got == twin).mean() >= 0.97


@pytest.mark.parametrize("suffix", [".png", ".ppm"])
def test_frame_stream_order(lib, tmp_path, suffix):
    """Frames come back in the order of the paths, each equal to its own
    decode, whatever the threads and the read-ahead."""
    _need_png(suffix)
    frames = _frames(7)
    paths = []
    for k, f in enumerate(frames):
        paths.append(str(tmp_path / f"f{k:03d}{suffix}"))
        save_image(paths[-1], f)
    for n_threads, read_ahead in ((1, 1), (3, 2), (2, 8)):
        stream = pnative.FrameStream(paths, n_threads=n_threads,
                                     read_ahead=read_ahead,
                                     max_pixels=32 * 48)
        got = list(stream)
        stream.close()
        assert len(got) == len(frames)
        for g, f in zip(got, frames):
            np.testing.assert_array_equal(g, f)


def test_frame_stream_through_stream_flow(lib, tmp_path):
    """``stream_flow(FrameStream(paths), cfg)`` equals ``stream_flow``
    over the loaded frames bit for bit, and lies within the band of the
    JAX package's ``stream_flow`` on them (mean <= 1e-3 px, p99 <= 1e-2
    px, as tests/test_torch_slice.py)."""
    import dataclasses
    _need_png()
    frames = _frames(4)
    paths = []
    for k, f in enumerate(frames):
        paths.append(str(tmp_path / f"f{k}.png"))
        save_image(paths[-1], f)
    jc = JaxConfig(coarsest_scale=2, finest_scale=1, grad_descent_iter=4,
                   use_var_ref=True)
    cfg = config_from_jax(dataclasses.asdict(jc))
    got = list(port.stream_flow(pnative.FrameStream(paths), cfg,
                                device="cpu"))
    want = list(port.stream_flow(frames, cfg, device="cpu"))
    ref = list(jstream_flow(iter(frames), jc))
    assert len(got) == len(want) == 3
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, w)
        assert_flow_band(g, np.asarray(r))


def test_fallbacks_without_the_library(monkeypatch, tmp_path):
    """With no library the four functions are the Python twins and
    ``FrameStream`` raises, as in the JAX package."""
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "ensure_built", lambda quiet=True: False)
    assert pnative.get_lib() is None
    flow = _flow(2)
    path = str(tmp_path / "f.flo")
    pnative.write_flo_native(path, flow)
    np.testing.assert_array_equal(pnative.read_flo_native(path), flow)
    np.testing.assert_array_equal(pnative.flow_to_color_native(flow),
                                  flow_to_color(flow))
    img = _frames(1)[0]
    ppm = str(tmp_path / "f.ppm")
    save_image(ppm, img)
    np.testing.assert_array_equal(pnative.load_image_native(ppm), img)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        pnative.FrameStream([ppm])


def test_failed_build_is_reported(monkeypatch, tmp_path, capsys):
    """A compiler that fails: ``ensure_built`` returns False, keeps the
    compiler's output and prints it with ``quiet=False``."""
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setenv("CXX", "false")
    assert pnative.ensure_built(quiet=False) is False
    assert "false" in capsys.readouterr().out
    assert pnative.ensure_built() is False and pnative.variant is None
    assert pnative.get_lib() is None


def _fresh_build(monkeypatch, tmp_path):
    """The module as a new process finds it, building into ``tmp_path``."""
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "build")
    for name, value in (("_opened", False), ("_lib", None),
                        ("variant", None), ("build_log", "")):
        monkeypatch.setattr(pnative, name, value)


def test_build_without_png_and_jpeg(monkeypatch, tmp_path):
    """Where the full build fails (no libpng or libjpeg) the second build
    leaves the two decoders out: .flo, PPM, the colour wheel and a PPM
    ``FrameStream`` serve, and a PNG path raises an error that says why."""
    if pnative.get_lib() is None:
        pytest.skip("no C++ compiler here")
    flow = _flow(3)
    full_color = pnative.flow_to_color_native(flow)
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(pnative, "VARIANTS", pnative.VARIANTS[1:])
    assert pnative.ensure_built() and pnative.variant == "no_png_jpeg"
    img = _frames(1)[0]
    ppm, png = str(tmp_path / "f.ppm"), str(tmp_path / "f.png")
    save_image(ppm, img)
    save_image(png, img)
    np.testing.assert_array_equal(pnative.load_image_native(ppm), img)
    with pytest.raises(IOError, match="no decoder"):
        pnative.load_image_native(png)
    np.testing.assert_array_equal(pnative.flow_to_color_native(flow),
                                  full_color)
    stream = pnative.FrameStream([ppm, ppm, png], max_pixels=32 * 48)
    np.testing.assert_array_equal(next(stream), img)
    np.testing.assert_array_equal(next(stream), img)
    with pytest.raises(IOError, match="no decoder"):
        next(stream)
    stream.close()
