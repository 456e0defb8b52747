"""Small dense block operations.

The blocks of FV Jacobians are tiny (1-4 equations per cell); closed forms
(b <= 3) and pivot-free Gauss-Jordan elimination (larger b) keep their
inversion elementwise over the cell batch, with no LAPACK call (counterpart
of the reference's StaticArrays SMatrix inverses, StaticCSR/ilu0.jl). Port
of the JAX package's ``ops/smallmat.py``.
"""

from __future__ import annotations

import torch


def block_inv(A):
    """Batched inverse of (..., b, b) for small b (closed forms for b <= 3,
    Gauss-Jordan without pivoting for larger: FV diagonal blocks are
    strongly diagonally dominant after assembly)."""
    b = A.shape[-1]
    if b == 1:
        return 1.0 / A
    if b == 2:
        a = A[..., 0, 0]
        bb = A[..., 0, 1]
        c = A[..., 1, 0]
        d = A[..., 1, 1]
        det = a * d - bb * c
        inv_det = 1.0 / det
        out = torch.stack([
            torch.stack([d, -bb], dim=-1),
            torch.stack([-c, a], dim=-1),
        ], dim=-2)
        return out * inv_det[..., None, None]
    if b == 3:
        a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
        a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
        a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
        c00 = a11 * a22 - a12 * a21
        c01 = a02 * a21 - a01 * a22
        c02 = a01 * a12 - a02 * a11
        c10 = a12 * a20 - a10 * a22
        c11 = a00 * a22 - a02 * a20
        c12 = a02 * a10 - a00 * a12
        c20 = a10 * a21 - a11 * a20
        c21 = a01 * a20 - a00 * a21
        c22 = a00 * a11 - a01 * a10
        det = a00 * c00 + a01 * c10 + a02 * c20
        adj = torch.stack([
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ], dim=-2)
        return adj / det[..., None, None]
    eye = torch.eye(b, dtype=A.dtype, device=A.device).expand(A.shape)
    M = torch.cat([A, eye], dim=-1)  # (..., b, 2b)
    rows = torch.arange(b, device=A.device)
    for k in range(b):
        mask = (rows == k)[:, None]
        pivot = M[..., k, :] / M[..., k, k][..., None]
        M = torch.where(mask, pivot[..., None, :], M)
        update = M - M[..., :, k][..., None] * pivot[..., None, :]
        M = torch.where(mask, pivot[..., None, :], update)
    return M[..., :, b:]


def bmm(A, B):
    """Batched small-block matmul (..., i, j) @ (..., j, k) as a
    broadcast-multiply-reduce (the JAX package's order of operations)."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def bmv(A, x):
    """Batched small-block matvec (..., i, j) @ (..., j)."""
    return torch.sum(A * x[..., None, :], dim=-1)


def block_solve(A, x):
    """Solve A y = x for batched small blocks: y = inv(A) @ x."""
    return bmv(block_inv(A), x)
