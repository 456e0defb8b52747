"""Build and load the port's CUDA kernels.

The sources are ``jutul/jl_tpu_torch/csrc/*.cu``: CUDA C++ with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``), one process per
source started together, linked into one shared library and loaded with
``ctypes``. The library is built at first use into
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
    "jt_stencil_matvec_ref": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "jt_scalar_jacobi": [_P, _P, _P, _P, _D, _I, _I, _I, _I, _P],
    "jt_scalar_chebyshev": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P],
    "jt_darcy_flux_jacobian": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "jt_darcy_flux_jacobian_lattice": [_P] * 10 + [_I, _I, _I, _P, _P],
    "jt_fused_alpha_s": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "jt_fused_omega_update": [_P] * 15 + [_I, _I, _P],
    "jt_scalar_sweeps_resident": [_P] * 7 + [_D] + [_I] * 9 + [_P],
    "jt_scalar_chebyshev_resident": [_P] * 8 + [_I] * 9 + [_P],
    "jt_level_resident_props": [_P],
    "jt_scalar_jacobi_slab": [_P] * 5 + [_D] + [_I] * 9 + [_P],
    "jt_scalar_chebyshev_slab": [_P] * 6 + [_I] * 9 + [_P],
}


# entries that also exist with bfloat16 coefficients and float32 vectors
_BF16C = ("jt_stencil_matvec", "jt_scalar_jacobi", "jt_scalar_chebyshev",
          "jt_scalar_sweeps_resident", "jt_scalar_chebyshev_resident",
          "jt_level_resident_props", "jt_scalar_jacobi_slab",
          "jt_scalar_chebyshev_slab")


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


def _compile_and_link(target: Path) -> str:
    """One ``nvcc -c`` per source, all started together, then one link
    into ``target``. Returns the compiler output; raises on any failure."""
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs, procs = [], []
    for src in _sources():
        obj = target.with_name(f"{target.name}.{src.stem}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log, failed = "", []
    for src, proc in zip(_sources(), procs):
        out, _ = proc.communicate()
        log += f"== {src.name}\n{out}"
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    try:
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}:\n{log}")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(target), *(str(o) for o in objs)],
            capture_output=True, text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return log


@functools.cache
def load_library() -> KernelLibrary:
    """The kernel library, built first if no up-to-date build exists.
    Raises on any build or load failure."""
    out = library_path()
    seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        log = _compile_and_link(tmp)
        seconds = time.perf_counter() - t0
        os.replace(tmp, out)  # atomic: a concurrent process sees all or none
    cdll = ctypes.CDLL(str(out))
    for base, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64") + (("bf16c_f32",) if base in _BF16C
                                        else ()):
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
