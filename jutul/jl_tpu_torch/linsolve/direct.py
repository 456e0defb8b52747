"""Direct (dense) linear solve.

Port of the JAX package's ``linsolve/direct.py``. Counterpart of Jutul's
sparse-backslash default (reference: src/linsolve/default.jl:467-477 — used
when no Krylov solver is configured, with a size limit). The BlockELL
Jacobian is written to a dense matrix and solved with
``torch.linalg.solve``, as the JAX package solves in XLA: conformance tests
and small models; large models use linsolve/krylov.py.
"""

from __future__ import annotations

import torch

from ..ops.blockell import BlockELL

DIRECT_SOLVE_LIMIT = 50_000  # unknowns; mirror of the reference's 100k limit


class DirectSolver:
    """Dense LU solve of J du = -r (small systems)."""

    def __init__(self, limit: int = DIRECT_SOLVE_LIMIT):
        self.limit = limit

    def check(self, n_unknowns: int) -> None:
        if n_unknowns > self.limit:
            raise ValueError(
                f"DirectSolver: {n_unknowns} unknowns exceeds limit "
                f"{self.limit}; configure a Krylov solver (GenericKrylov)")

    def solve(self, J, r, rtol=None):
        """Return du with J du = -r; shapes (n, ndof) / (n, neq), or dicts
        of them for a coupled MultiLinearizedSystem (written to one dense
        matrix). ``rtol`` (adaptive forcing) is accepted and ignored: a
        direct solve meets any tolerance."""
        from ..multimodel.core import MultiLinearizedSystem

        if isinstance(J, MultiLinearizedSystem):
            self.check(J.layout.total_dof)
            du = torch.linalg.solve(J.to_dense(), -J.flatten_res(r))
            return J.unflatten_dofs(du), {"solver": "direct",
                                          "iterations": 1}
        if not isinstance(J, BlockELL):
            raise TypeError(
                f"DirectSolver solves the generic engine's BlockELL "
                f"Jacobian, not a {type(J).__name__}: the stencil engine "
                f"takes a StencilKrylovSolver")
        n, _, neq, ndof = J.blocks.shape
        self.check(n * ndof)
        du = torch.linalg.solve(J.to_dense(), -r.reshape(n * neq))
        return du.reshape(n, ndof), {"solver": "direct", "iterations": 1}
