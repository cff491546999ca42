"""Build and load the port's hand-written CUDA kernels.

Each ``flowonthego_tpu_torch/csrc/*.cu`` compiles with its own ``nvcc``,
all started together, and one more ``nvcc`` links the objects into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library is built at first use into ``flowonthego_tpu_torch/build/``,
named by a hash of the flags and of every source and header
(``csrc/*.cu``, ``csrc/*.cuh``), so a fresh checkout builds everything
from its own sources and an edited source or header builds anew.

There is no fallback: if ``nvcc`` is missing or the build fails, this
raises.  Callers reach this module only for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

# sm_90a: Hopper with its architecture-specific features.  --fmad=false
# keeps a*b+c as two roundings, as the plain PyTorch versions compute it,
# so kernel and plain version differ only by summation order.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# Every C entry returns cudaGetLastError() after its launch.
SIGNATURES = {
    "fot_pool2x2_f32": [_P, _P, _I, _I, _I, _F, _I, _P],
    "fot_pool2x2_u8": [_P, _P, _I, _I, _I, _F, _I, _P],
    "fot_dis_gn": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                   _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _I, _F, _F,
                   _P, _P, _P, _I, _P],
    "fot_varref_fused": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                         _F, _F, _I, _P, _P, _P],
    "fot_varref_tiled": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                         _F, _F, _P, _P, _P, _P],
    "fot_varref_cluster": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F,
                           _F, _F, _I, _I, _I, _P, _P, _P],
    "fot_empty_launch": [_P],
    "fot_warp": [_P, _L, _L, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "fot_level": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "fot_extract": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                    _P, _P, _P, _P, _P],
    "fot_densify": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                    _I, _I, _I, _I, _I, _I, _L, _P, _P],
    "fot_derivs": [_P, _L, _L, _P, _L, _L, _I, _I, _I, _I, _P, _P],
    "fot_fb_merge": [_P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                     _I, _I, _I, _I, _P, _P, _P, _P],
    "fot_dis_ref": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _L, _P, _P, _P,
                    _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                    _F,
                    _F, _F, _F, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P,
                    _P, _P],
}

_lock = threading.Lock()
_library = None


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


def _cuda_home():
    from torch.utils import cpp_extension
    return cpp_extension.CUDA_HOME


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under the CUDA toolkit's home."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = _cuda_home()
        cand = os.path.join(home, "bin", "nvcc") if home else None
        if cand and os.path.isfile(cand):
            nvcc = cand
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (not on PATH, no CUDA toolkit home): the CUDA "
            f"kernels in {CSRC_DIR} cannot be built.  CUDA tensors need "
            "them; CPU tensors use the plain PyTorch versions.")
    return nvcc


def sources() -> list[pathlib.Path]:
    """The translation units: every ``csrc/*.cu``."""
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(sources() + list(CSRC_DIR.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfot_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands at once; raise with the output of those that fail."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc exited with {proc.returncode}:\n"
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise KernelBuildError("\n".join(failed))


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
    work.mkdir(exist_ok=True)
    try:
        objs = [work / f"{src.stem}.o" for src in sources()]
        _run_all([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                 for src, obj in zip(sources(), objs))
        lib = work / out.name
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
                   *map(str, objs)]])
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.fot_error_string.argtypes = [_I]
            lib.fot_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def check(err: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        msg = load_library().fot_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def stream_handle(x) -> int:
    import torch
    return torch.cuda.current_stream(x.device).cuda_stream


def empty_launch(device) -> None:
    """Launch the kernel that does nothing on ``device``'s current stream
    (the floor under every launch's time)."""
    import torch
    with torch.cuda.device(device):
        check(load_library().fot_empty_launch(
            torch.cuda.current_stream(device).cuda_stream), "empty_launch")
