"""ctypes bindings for the port's native runtime library (port of
``flowonthego_tpu/io/native.py``).

Fast .flo I/O, PNG/JPEG/PPM decode to float32 BGR, flow colorization and
a threaded frame-stream prefetcher, from the port's own copy of the
framework-free C++ sources (``flowonthego_tpu_torch/native/src``).  The
library is compiled with ``g++`` at first use into
``flowonthego_tpu_torch/build/``, named by a hash of its sources and
flags, without ``-march=native`` (a library built on one host loads on
another).  On a machine without Pillow this library is how PNG and JPEG
frames reach the port.  On a host without libpng and libjpeg a second
build leaves those two decoders out (:data:`VARIANTS`; :data:`variant`
says which build loaded), so that PPM frames still stream there.

Where no build compiles and loads (no compiler) the four functions fall
back to the pure-Python ``io``
implementations and :class:`FrameStream` raises, as in the JAX package:
this is host I/O with a Python twin, not a device path.
``ensure_built(quiet=False)`` prints the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[1]
SRC_DIR = PACKAGE_DIR / "native" / "src"
BUILD_DIR = PACKAGE_DIR / "build"
SOURCES = ("flowio.cpp", "stream.cpp")
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
# The builds, tried in order: (name, extra compile flags, libraries).  The
# second leaves the PNG and JPEG decoders out, for a host without libpng
# and libjpeg (their headers to compile, their shared objects to load):
# .flo, PPM, the colour wheel and FrameStream over PPM frames still serve
# there, and a PNG or JPEG path raises an IOError that says so.
VARIANTS = (
    ("full", (), ("-lpng", "-ljpeg", "-lz", "-lpthread")),
    ("no_png_jpeg", ("-DFLOWIO_NO_PNG", "-DFLOWIO_NO_JPEG"), ("-lpthread",)),
)
NOT_BUILT = -20     # the C entries' code for a decoder that was left out

_lock = threading.RLock()
_lib: Optional[ctypes.CDLL] = None
_opened = False     # a build and load was attempted in this process
variant: Optional[str] = None   # the name of the build that loaded
build_log = ""      # the compiler's and loader's messages of that attempt


def library_path(name: str = "full") -> pathlib.Path:
    """Where the build ``name`` of :data:`VARIANTS` lies: named by a hash
    of its flags and of the sources."""
    _, defines, libs = next(v for v in VARIANTS if v[0] == name)
    h = hashlib.sha256(" ".join(CXXFLAGS + defines + libs).encode())
    for src in SOURCES:
        h.update(src.encode())
        h.update((SRC_DIR / src).read_bytes())
    return BUILD_DIR / f"libflowio_{name}_{h.hexdigest()[:16]}.so"


def _compile(name: str) -> str:
    """Compile the build ``name`` unless it exists; returns the compiler's
    output ("" for a build that was there)."""
    out = library_path(name)
    if out.exists():
        return ""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return "no C++ compiler (g++) found\n"
    _, defines, libs = next(v for v in VARIANTS if v[0] == name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXXFLAGS, *defines, "-o", str(tmp),
           *(str(SRC_DIR / src) for src in SOURCES), *libs]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        return f"{' '.join(cmd)}\n{e}\n"
    if proc.returncode == 0:
        os.replace(tmp, out)
    elif tmp.exists():
        tmp.unlink()
    return f"{' '.join(cmd)}\n{proc.stdout}"


def _open() -> Optional[ctypes.CDLL]:
    """Build (if missing) and load the first of :data:`VARIANTS` that
    compiles and loads here; once per process."""
    global _lib, _opened, variant, build_log
    with _lock:
        if _opened:
            return _lib
        _opened = True
        log = []
        for name, _, _ in VARIANTS:
            log.append(_compile(name))
            path = library_path(name)
            if not path.exists():
                continue
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except OSError as e:
                # built on another host, or its libraries are not here
                log.append(f"{path.name} does not load: {e}\n")
                continue
            variant = name
            break
        build_log = "".join(log)
        return _lib


def ensure_built(quiet: bool = True) -> bool:
    """Build the library if missing.  Returns True if it is available (as
    which build: :data:`variant`); ``quiet=False`` prints the compiler's
    and the loader's messages.  A failed attempt is not repeated in this
    process."""
    ok = _open() is not None
    if not quiet:
        print(build_log or f"{library_path(variant).name}: already built")
    return ok


def get_lib() -> Optional[ctypes.CDLL]:
    return _open() if ensure_built() else None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int_p = ctypes.POINTER(ctypes.c_int)
    f32_p = ctypes.POINTER(ctypes.c_float)
    u8_p = ctypes.POINTER(ctypes.c_uint8)

    lib.flo_read.argtypes = [ctypes.c_char_p, c_int_p, c_int_p, f32_p]
    lib.flo_read.restype = ctypes.c_int
    lib.flo_write.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                              f32_p]
    lib.flo_write.restype = ctypes.c_int
    lib.image_read_bgr32f.argtypes = [ctypes.c_char_p, c_int_p, c_int_p,
                                      f32_p]
    lib.image_read_bgr32f.restype = ctypes.c_int
    lib.flow_to_color_rgb.argtypes = [f32_p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float, u8_p]
    lib.flow_to_color_rgb.restype = None
    lib.stream_open.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.stream_open.restype = ctypes.c_void_p
    lib.stream_next.argtypes = [ctypes.c_void_p, c_int_p, c_int_p, f32_p,
                                ctypes.c_long]
    lib.stream_next.restype = ctypes.c_int
    lib.stream_close.argtypes = [ctypes.c_void_p]
    lib.stream_close.restype = None
    return lib


def _image_error(path, rc: int) -> IOError:
    if rc == NOT_BUILT:
        return IOError(f"image_read({path}): this build of the native "
                       f"library ({variant}) has no decoder for this format "
                       "(libpng/libjpeg are missing on this host); PPM "
                       "frames need neither")
    return IOError(f"image_read({path}) failed: {rc}")


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_flo_native(path: str) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        from .flo import read_flo
        return read_flo(path)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.flo_read(path.encode(), ctypes.byref(w), ctypes.byref(h), None)
    if rc != 0:
        raise IOError(f"flo_read({path}) failed: {rc}")
    out = np.empty((h.value, w.value, 2), np.float32)
    rc = lib.flo_read(path.encode(), ctypes.byref(w), ctypes.byref(h),
                      _f32p(out))
    if rc != 0:
        raise IOError(f"flo_read({path}) failed: {rc}")
    return out


def write_flo_native(path: str, flow: np.ndarray) -> None:
    lib = get_lib()
    if lib is None:
        from .flo import write_flo
        return write_flo(path, flow)
    flow = np.ascontiguousarray(flow, np.float32)
    h, w = flow.shape[:2]
    rc = lib.flo_write(path.encode(), w, h, _f32p(flow))
    if rc != 0:
        raise IOError(f"flo_write({path}) failed: {rc}")


def load_image_native(path: str) -> np.ndarray:
    """float32 BGR [H, W, 3], 0..255 — cv::imread-compatible numerics."""
    lib = get_lib()
    if lib is None:
        from .images import load_image
        return load_image(path)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.image_read_bgr32f(path.encode(), ctypes.byref(w),
                               ctypes.byref(h), None)
    if rc != 0:
        raise _image_error(path, rc)
    out = np.empty((h.value, w.value, 3), np.float32)
    rc = lib.image_read_bgr32f(path.encode(), ctypes.byref(w),
                               ctypes.byref(h), _f32p(out))
    if rc != 0:
        raise _image_error(path, rc)
    return out


def flow_to_color_native(flow: np.ndarray,
                         max_motion: float = 0.0) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        from .color import flow_to_color
        return flow_to_color(flow, max_motion or None)
    flow = np.ascontiguousarray(flow, np.float32)
    h, w = flow.shape[:2]
    out = np.empty((h, w, 3), np.uint8)
    lib.flow_to_color_rgb(_f32p(flow), w, h, float(max_motion),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


class FrameStream:
    """Iterate decoded frames (float32 BGR [H, W, 3] numpy arrays, in the
    order of ``paths``) with background prefetch by native threads;
    ``stream_flow(FrameStream(paths), cfg)`` runs them on the card."""

    def __init__(self, paths: Sequence[str], n_threads: int = 2,
                 read_ahead: int = 8, max_pixels: int = 4096 * 2176):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(*[os.fspath(p).encode()
                                               for p in paths])
        self._handle = lib.stream_open(arr, len(paths), n_threads, read_ahead)
        self._buf = np.empty(max_pixels * 3, np.float32)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        w, h = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.stream_next(self._handle, ctypes.byref(w),
                                   ctypes.byref(h), _f32p(self._buf),
                                   self._buf.size)
        if rc == -99:
            raise StopIteration
        if rc == NOT_BUILT:
            raise _image_error("a frame of the stream", rc)
        if rc != 0:
            raise IOError(f"stream_next failed: {rc}")
        n = h.value * w.value * 3
        return self._buf[:n].reshape(h.value, w.value, 3).copy()

    def close(self):
        if self._handle:
            self._lib.stream_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
