"""The work a kernel function needs, from shapes alone, and the card's
published peaks.

Bytes count every input read once and every output written once, at the
shapes the cell runs, whatever a kernel reads again or pads.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: HBM bandwidth and float32 rate outside the
# tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

STENCIL_TERMS = 7  # the 7-point stencil: the diagonal and six neighbours


def coef_bytes(entry: str) -> int:
    """Bytes of one stored coefficient of a K1 entry (``f32``, ``f64``,
    ``bf16c_f32``)."""
    return {"f32": 4, "f64": 8, "bf16c_f32": 2}[entry]


def spmv_bytes(n_cells: int, entry: str, C: int, K: int) -> int:
    """One block-stencil product y (n, C) = A x (n, K): the coefficients
    (7 blocks of C x K a cell), x read, y written."""
    vec = 8 if entry == "f64" else 4
    return n_cells * (STENCIL_TERMS * C * K * coef_bytes(entry)
                      + (K + C) * vec)


def gmg_level_shapes(L, min_cells: int) -> list:
    """(nz, ny, nx) of every level of the pressure hierarchy on lattice
    ``L``: each level halves the one above per axis, rounding up (odd
    extents are padded), until a level holds at most ``min_cells``."""
    shapes = [tuple(L)]
    while math.prod(shapes[-1]) > min_cells:
        shapes.append(tuple(v if v == 1 else -(-v // 2)
                            for v in shapes[-1]))
    return shapes


def vcycle_bytes(L, min_cells: int, coef_dtype: str | None = None) -> int:
    """One V-cycle's level phases: on every level but the coarsest a
    presmoothing phase that emits the residual (coefficients and b read,
    u and r written) and a postsmoothing phase (coefficients, b and u
    read, u written); on the coarsest one solve phase (coefficients and b
    read, u written). Coefficients are the 7 stencil terms a cell, in
    bfloat16 under ``coef_dtype == "bf16"``; vectors float32."""
    cb = 2 if coef_dtype == "bf16" else 4
    shapes = gmg_level_shapes(L, min_cells)
    total = 0
    for i, shape in enumerate(shapes):
        n = math.prod(shape)
        if i == len(shapes) - 1:
            total += n * (STENCIL_TERMS * cb + 2 * 4)
        else:
            total += 2 * n * (STENCIL_TERMS * cb + 3 * 4)
    return total
