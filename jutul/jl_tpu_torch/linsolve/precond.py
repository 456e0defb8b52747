"""Preconditioners on BlockELL matrices.

Port of the JAX package's ``linsolve/precond.py``. Counterpart of Jutul's
preconditioner zoo (reference: src/linsolve/precond/ —
``JacobiPreconditioner`` jacobi.jl:5, ``SPAI0Preconditioner`` spai.jl:4,
``ILUZeroPreconditioner`` ilu.jl:4 + src/StaticCSR/ilu0.jl,
``TrivialPreconditioner`` various.jl:1-77; AMG in linsolve/amg.py).

ILU(0) keeps the JAX package's data-parallel form: the Chow–Patel
fixed-point factorization (parallel sweeps over all nonzeros) and iterated
Jacobi triangular solves (a truncated Neumann series), instead of the
reference's sequential factorization and triangular solves — every sweep
is a batch of gathers and small-block products over all cells.

Protocol, as in the JAX package:
  ``state = p.update(J)``      (refactor)
  ``y = p.apply(state, J, x)`` (apply the approximate inverse)
``GroupWisePreconditioner`` applies one of these per submodel of a
MultiModel's coupled system.
"""

from __future__ import annotations

import torch

from ..ops.blockell import BlockELL, ell_matvec
from ..ops.smallmat import block_inv, bmm, bmv


class Preconditioner:
    def update(self, J: BlockELL):
        return ()

    def apply(self, state, J: BlockELL, x):
        raise NotImplementedError


class TrivialPreconditioner(Preconditioner):
    """Identity (reference various.jl TrivialPreconditioner)."""

    def apply(self, state, J, x):
        return x


class JacobiPreconditioner(Preconditioner):
    """Scalar diagonal scaling (reference precond/jacobi.jl:5)."""

    def update(self, J: BlockELL):
        diag = torch.diagonal(J.blocks[:, 0], dim1=-2, dim2=-1)
        return (1.0 / diag,)

    def apply(self, state, J, x):
        (dinv,) = state
        return x * dinv


class BlockJacobiPreconditioner(Preconditioner):
    """Inverted diagonal blocks, batched (the reference's block-diagonal
    scaling path in precond/jacobi.jl for block layouts)."""

    def update(self, J: BlockELL):
        return (block_inv(J.blocks[:, 0]),)

    def apply(self, state, J, x):
        (dinv,) = state
        return bmv(dinv, x)


class SPAI0Preconditioner(Preconditioner):
    """Zeroth-order sparse approximate inverse (reference precond/spai.jl:4):
    the diagonal M minimizing ||I - M A||_F row-wise,
    m_i = a_ii / sum_j a_ij^2, per scalar equation component."""

    def update(self, J: BlockELL):
        b = J.blocks  # (n, S, neq, ndof)
        diag = torch.diagonal(b[:, 0], dim1=-2, dim2=-1)  # (n, neq)
        row_sq = torch.sum(b * b, dim=(1, 3))  # (n, neq)
        return (diag / torch.clamp(row_sq, min=1e-300),)

    def apply(self, state, J, x):
        (m,) = state
        return x * m


class ILU0Preconditioner(Preconditioner):
    """Block ILU(0) via Chow–Patel fixed-point sweeps + iterated triangular
    solves (Chow & Patel, "Fine-grained parallel incomplete LU
    factorization", SISC 2015).

    For two-point FV stencils neighbours i and j share no third stored
    column, so ILU(0) collapses to
      l_ij = a_ij u_jj^{-1} (j < i),  u_ij = a_ij (i < j),
      u_ii = a_ii - sum_{j<i in S(i)} l_ij u_ji,
    leaving the diagonal fixed point, iterated in ``n_factor_sweeps``
    parallel sweeps. Application: z = U^{-1} L^{-1} x by
    ``n_solve_sweeps`` Jacobi sweeps each,
      y <- x - (L - I) y,   z <- D_U^{-1} (y - (U - D_U) z).
    ``update`` gathers the transposed partner of every block
    (``ELLStructure.partner_slots``), which raises on a sparsity pattern
    that is not structurally symmetric."""

    def __init__(self, n_factor_sweeps: int = 5, n_solve_sweeps: int = 6):
        self.n_factor_sweeps = n_factor_sweeps
        self.n_solve_sweeps = n_solve_sweeps

    def update(self, J: BlockELL):
        st = J.structure
        A = J.blocks  # (n, S, b, b)
        n, S, b, _ = A.shape
        dev = A.device
        partner = st._on("partner", dev, st.partner_slots)
        cols = st.cols_t(dev)
        rows = torch.arange(n, device=dev)[:, None]
        lm = (cols < rows)[..., None, None]
        um = (cols > rows)[..., None, None]
        A_T_partner = A.reshape(n * S, b, b)[
            (cols * S + partner).reshape(-1)].reshape(A.shape)

        def diag_at_cols(Dinv):
            return Dinv[cols.reshape(-1)].reshape(n, S, b, b)

        zero = A.new_zeros(())
        Udiag = A[:, 0]
        for _ in range(self.n_factor_sweeps):
            L_off = torch.where(lm, bmm(A, diag_at_cols(block_inv(Udiag))),
                                zero)
            corr = bmm(L_off, A_T_partner)
            Udiag = A[:, 0] - torch.sum(torch.where(lm, corr, zero), dim=1)
        Udiag_inv = block_inv(Udiag)
        L_off = torch.where(lm, bmm(A, diag_at_cols(Udiag_inv)), zero)
        U_off = torch.where(um, A, zero)
        return (L_off, U_off, Udiag_inv)

    def apply(self, state, J: BlockELL, x):
        L_off, U_off, Udiag_inv = state
        st = J.structure
        y = x
        for _ in range(self.n_solve_sweeps):
            y = x - ell_matvec(L_off, st, y)
        z = bmv(Udiag_inv, y)
        for _ in range(self.n_solve_sweeps):
            z = bmv(Udiag_inv, y - ell_matvec(U_off, st, z))
        return z


class GroupWisePreconditioner(Preconditioner):
    """Per-submodel preconditioner for a MultiLinearizedSystem (reference
    precond/various.jl GroupWisePreconditioner): each submodel's diagonal
    BlockELL gets its own inner preconditioner; the couplings are left to
    the outer Krylov iteration (block-Jacobi across models)."""

    def __init__(self, preconditioners):
        # dict name -> Preconditioner, or one prototype applied to all
        self.preconditioners = preconditioners

    def _for(self, name):
        if isinstance(self.preconditioners, dict):
            return self.preconditioners[name]
        return self.preconditioners

    def update(self, J):
        return {name: self._for(name).update(Jd)
                for name, Jd in J.diag.items()}

    def apply(self, state, J, x: dict) -> dict:
        return {name: self._for(name).apply(state[name], J.diag[name],
                                            x[name])
                for name in J.diag}
