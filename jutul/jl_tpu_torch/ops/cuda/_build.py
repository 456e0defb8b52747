"""Build and load the port's CUDA kernels.

The sources are ``jutul/jl_tpu_torch/csrc/*.cu``: CUDA C++ with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library and loaded with ``ctypes``. The library is built at first use into
``jutul/jl_tpu_torch/build/`` under a name keyed on a hash of the sources
and flags, so an edited kernel rebuilds and an unchanged one loads at once.
Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# C entry points (csrc/*.cu): each returns cudaGetLastError() of its launch
_SIGNATURES = {
    "jt_stencil_matvec": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "jt_scalar_jacobi": [_P, _P, _P, _P, _D, _I, _I, _I, _I, _P],
    "jt_scalar_chebyshev": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P],
    "jt_darcy_flux_jacobian": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "jt_scalar_jacobi_phase": [_P, _P, _P, _P, _P, _D, _I, _I, _I, _I, _I,
                               _P],
    "jt_fused_alpha_s": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "jt_fused_omega_update": [_P] * 15 + [_I, _I, _P],
}


@dataclass
class KernelLibrary:
    cdll: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date build was found
    compiler_log: str  # nvcc/ptxas output of the build, "" when reused

    def fn(self, name: str, dtype_suffix: str):
        return getattr(self.cdll, f"{name}_{dtype_suffix}")


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH) — the "
                           "CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libjutul_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> KernelLibrary:
    """The kernel library, built first if no up-to-date build exists.
    Raises on any build or load failure."""
    out = library_path()
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in _sources())]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent process sees all or none
    cdll = ctypes.CDLL(str(out))
    for base, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            f = getattr(cdll, f"{base}_{suffix}")
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    return KernelLibrary(cdll, out, seconds, log)


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


def dtype_suffix(t) -> str:
    if t.dtype == torch.float32:
        return "f32"
    if t.dtype == torch.float64:
        return "f64"
    raise TypeError(f"CUDA kernels take float32/float64, got {t.dtype}")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream
