"""LinearizedSystem: the (Jacobian, residual) pair with a solve entry.

Port of the JAX package's ``linsolve/system.py``. Counterpart of the
reference ``LinearizedSystem`` (src/linsolve/default.jl:34 — jac + r + dx
buffers handed to ``linear_solve!``). The Jacobian is a
:class:`~jutul.jl_tpu_torch.ops.blockell.BlockELL` and the solve is
functional: ``solve()`` returns the Newton update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from .direct import DIRECT_SOLVE_LIMIT, DirectSolver


@dataclass
class LinearizedSystem:
    """Jacobian + residual of one Newton iteration.

    ``jac``: BlockELL (n, slots, neq, ndof); ``r``: residual (n, neq).
    """

    jac: Any
    r: Any

    @property
    def n_unknowns(self) -> int:
        n, _, _, ndof = self.jac.blocks.shape
        return n * ndof

    def solve(self, solver=None, rtol=None):
        """Newton update ``du`` with ``J du = -r``; ``solver=None`` picks
        the reference default: a direct solve below the size limit
        (default.jl:467), otherwise ILU(0)-BiCGStab. Returns
        ``(du, stats)``."""
        if solver is None:
            if self.n_unknowns <= DIRECT_SOLVE_LIMIT:
                solver = DirectSolver()
            else:
                from .krylov import GenericKrylov
                from .precond import ILU0Preconditioner

                solver = GenericKrylov(
                    "bicgstab", preconditioner=ILU0Preconditioner())
        return solver.solve(self.jac, self.r, rtol=rtol)
