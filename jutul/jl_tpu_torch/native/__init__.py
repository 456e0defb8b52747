"""Native (C++) host graph routines, loaded with ctypes.

The port's own copy of the JAX package's ``native/`` module: the same
``partitioner.cpp`` (a Metis-style multilevel partitioner, reverse
Cuthill-McKee and the greedy AMG aggregation), built with the JAX package's
flags (``g++ -O3 -march=native -shared -fPIC``) at first use into
``jutul/jl_tpu_torch/build/`` under a name keyed on a hash of the source
and of the target ``-march=native`` resolves to on this host, so a library
built on another host is never loaded. Nothing here runs at import.

Unlike the JAX package, which falls back to numpy when no compiler is
found, a build or load failure raises: the port's results never depend on
whether a compiler happened to be installed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "partitioner.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_P64 = ctypes.POINTER(ctypes.c_int64)
_PD = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.c_int64


def _run(cmd, what):
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300, check=True)
    except FileNotFoundError:
        raise RuntimeError(f"{what}: g++ not found; the native library "
                           "cannot be built") from None
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"{what} failed ({e.returncode}): "
                           f"{e.stderr.strip()}") from None


def library_path() -> Path:
    """Where this host's build of ``partitioner.cpp`` lives."""
    target = _run(["g++", "-march=native", "-Q", "--help=target"],
                  "g++ -march=native -Q --help=target").stdout
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(target.encode())
    return BUILD_DIR / f"libjutul_native_{h.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """The native library, built first if this host has no build of the
    current source. Raises on any build or load failure."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        _run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
             "g++ build of native/partitioner.cpp")
        os.replace(tmp, out)  # atomic: a concurrent process sees all or none
    lib = ctypes.CDLL(str(out))
    lib.jutul_partition.restype = ctypes.c_int
    lib.jutul_partition.argtypes = [_P64, _I64, _I64, _I64, _PD, _P64]
    lib.jutul_rcm.restype = ctypes.c_int
    lib.jutul_rcm.argtypes = [_P64, _I64, _I64, _P64]
    lib.jutul_aggregate.restype = _I64
    lib.jutul_aggregate.argtypes = [_P64, _I64, _I64, _P64]
    return lib


def _int64_table(a, what: str, n_nodes: int, width: int | None = None):
    """``a`` as a C-contiguous int64 (m, width) table of node ids in
    [0, n_nodes); raises on another shape or an id out of range."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.int64))
    if a.ndim != 2 or (width is not None and a.shape[1] != width):
        raise ValueError(f"{what} must be (m, {width or 'S'}), got {a.shape}")
    if a.size and (a.min() < 0 or a.max() >= n_nodes):
        raise IndexError(f"{what} out of range [0, {n_nodes})")
    return a


def native_partition(neighbors, n_cells: int, n_blocks: int,
                     weights=None) -> np.ndarray:
    """Multilevel graph partition of ``n_cells`` nodes joined by the pairs
    ``neighbors`` (m, 2) into ``n_blocks`` blocks of (weighted) equal
    size: (n_cells,) block ids."""
    if n_cells <= 0 or n_blocks <= 0:
        raise ValueError("native_partition: n_cells and n_blocks must be "
                         "positive")
    lib = load_library()
    nb = _int64_table(neighbors, "neighbors", n_cells, 2)
    out = np.zeros(n_cells, dtype=np.int64)
    w = wptr = None
    if weights is not None:
        w = np.ascontiguousarray(np.asarray(weights, dtype=np.float64))
        if w.shape != (n_cells,):
            raise ValueError(f"weights must be ({n_cells},), got {w.shape}")
        wptr = w.ctypes.data_as(_PD)
    rc = lib.jutul_partition(nb.ctypes.data_as(_P64), nb.shape[0], n_cells,
                             n_blocks, wptr, out.ctypes.data_as(_P64))
    if rc != 0:
        raise RuntimeError(f"jutul_partition returned {rc}")
    return out


def native_rcm(neighbors, n_cells: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (new -> old) of the graph."""
    lib = load_library()
    nb = _int64_table(neighbors, "neighbors", n_cells, 2)
    out = np.zeros(n_cells, dtype=np.int64)
    rc = lib.jutul_rcm(nb.ctypes.data_as(_P64), nb.shape[0], n_cells,
                       out.ctypes.data_as(_P64))
    if rc != 0:
        raise RuntimeError(f"jutul_rcm returned {rc}")
    return out


def native_aggregate(ell_cols, n: int) -> np.ndarray:
    """Greedy (Vanek-style) aggregation over an ELL sparsity (n, S):
    (n,) aggregate ids in [0, n_agg), the numpy loop's
    (``linsolve.amg.greedy_aggregate_loop``) own."""
    lib = load_library()
    cols = _int64_table(ell_cols, "ell_cols", n)
    if cols.shape[0] != n:
        raise ValueError(f"ell_cols must have {n} rows, got {cols.shape[0]}")
    out = np.zeros(n, dtype=np.int64)
    n_agg = lib.jutul_aggregate(cols.ctypes.data_as(_P64), n, cols.shape[1],
                                out.ctypes.data_as(_P64))
    if n > 0 and n_agg <= 0:
        raise RuntimeError(f"jutul_aggregate returned {n_agg}")
    return out
