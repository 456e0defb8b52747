"""CPR: constrained pressure residual two-stage preconditioner.

Port of the JAX package's ``linsolve/cpr.py`` (the reference framework
ships the building blocks, src/linsolve/precond/; downstream JutulDarcy
composes them into CPR, the benchmark solver).

Quasi-IMPES CPR (Wallis):
  stage 1 (pressure): per-cell weights w solve D_c^T w = e_p with D_c the
    diagonal block, decoupling the saturation derivatives locally; the
    scalar pressure operator A_p[i,j] = w_i . J[i,j][:, p] lives on the
    SAME ELL sparsity, and one AMG V-cycle approximates A_p^{-1};
  stage 2 (full system): a global smoother (block ILU(0)) on the corrected
    residual.
The AMG hierarchy's symbolic setup is kept across Newton iterations
(values-only updates, the reference's partial hierarchy update,
amg.jl:165).
"""

from __future__ import annotations

import torch

from ..ops.blockell import BlockELL
from ..ops.smallmat import block_inv
from .amg import AMGPreconditioner
from .precond import ILU0Preconditioner, Preconditioner


class CPRPreconditioner(Preconditioner):
    def __init__(self, pressure_index: int = 0, smoother: Preconditioner
                 | None = None, amg: AMGPreconditioner | None = None):
        self.p = int(pressure_index)
        self.smoother = smoother or ILU0Preconditioner()
        self.amg = amg or AMGPreconditioner(n_cycles=1)

    def update(self, J: BlockELL):
        blocks = J.blocks  # (n, S, neq, ndof)
        Dinv = block_inv(blocks[:, 0])
        # quasi-IMPES weights: w = D^{-T} e_p = row p of D^{-1}
        w = Dinv[:, self.p, :]  # (n, neq)
        # scalar pressure operator: A_p[i,s] = sum_eq w[i,eq]*J[i,s][eq,p]
        Ap_vals = torch.sum(w[:, None, :] * blocks[..., self.p], dim=-1)
        amg_state = self.amg.update(
            BlockELL(J.structure, Ap_vals[..., None, None]))
        smoother_state = self.smoother.update(J)
        return (w, Ap_vals, amg_state, smoother_state)

    def apply(self, state, J: BlockELL, x):
        """x: (n, neq) residual-space vector; returns the (n, ndof)
        update."""
        w, Ap_vals, amg_state, smoother_state = state
        Ap = BlockELL(J.structure, Ap_vals[..., None, None])
        # stage 1: pressure correction
        r_p = torch.sum(w * x, dim=-1)  # (n,)
        dp = self.amg.apply(amg_state, Ap, r_p[:, None])[:, 0]
        du = x.new_zeros((x.shape[0], J.ndof))
        du[:, self.p] = dp
        # stage 2: global smoother on the corrected residual
        r2 = x - J.matvec(du)
        return du + self.smoother.apply(smoother_state, J, r2)
