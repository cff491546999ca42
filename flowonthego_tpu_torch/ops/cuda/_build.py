"""Build and load the port's hand-written CUDA kernels.

All of ``flowonthego_tpu_torch/csrc/*.cu`` compiles with ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library is built at first use into ``flowonthego_tpu_torch/build/``,
named by a hash of the sources and flags, so a fresh checkout builds
everything from its own sources and an edited source builds anew.

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
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Every C entry returns cudaGetLastError() after its launch.
SIGNATURES = {
    "fot_pool2x2_f32": [_P, _P, _I, _I, _I, _F, _I, _P],
    "fot_pool2x2_u8": [_P, _P, _I, _I, _I, _F, _I, _P],
    "fot_dis_gn": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                   _I, _I, _I, _F, _F, _F, _F, _F, _P, _P, _P],
    "fot_varref_fused": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F,
                         _F, _P, _P, _P, _P],
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
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfot_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc exited with {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
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
