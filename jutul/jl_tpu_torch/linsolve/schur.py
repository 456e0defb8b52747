"""Schur-complement group reduction for coupled MultiModel systems.

Port of the JAX package's ``linsolve/schur.py``. Counterpart of the
reference's group elimination (reference: src/linsolve/multimodel.jl:17-160
— eliminate non-main groups from the Krylov solve: ``a -= C E^{-1} b`` with
factorized E, operator applies on the fly, dx back-substitution). Typical
use: wells (a few unknowns each) are eliminated densely while the
reservoir solves iteratively.

The eliminated groups' diagonal systems and their internal couplings form
a small dense E, LU-factorized once per Newton iteration on the system's
device (``torch.linalg.lu_factor``: no host round trip per Krylov
iteration); the reduced operator (A - B E^{-1} C) is applied matrix-free
inside the inner Krylov solver, with two E-solves per product. Every add
whose rows repeat (a wellbore row's perforations) is a fixed-order sum
(the coupling blocks' ``IndexPlan``s).
"""

from __future__ import annotations

import numpy as np
import torch

from ..multimodel.core import MultiLayout, MultiLinearizedSystem
from ..ops.blockell import IndexPlan
from .krylov import GenericKrylov


class SchurComplementSolver:
    """Eliminate ``elim_models`` and solve the reduced main system with the
    inner solver (reference reduction=:schur_apply)."""

    def __init__(self, inner=None, elim_models=None):
        self.inner = inner or GenericKrylov("gmres", rtol=1e-8)
        self.elim_models = elim_models  # names; None = all but the first

    def solve(self, J, r: dict, rtol=None):
        if not isinstance(J, MultiLinearizedSystem):
            return self.inner.solve(J, r, rtol=rtol)
        names = J.layout.names
        elim_set = set(self.elim_models if self.elim_models is not None
                       else names[1:])
        elim = [n for n in names if n in elim_set]
        main = [n for n in names if n not in elim_set]
        if not elim:
            return self.inner.solve(J, r, rtol=rtol)
        like = next(iter(r.values()))

        # --- dense E (eliminated diagonals + intra-eliminated couplings)
        sizes, offs = {}, {}
        ofs = 0
        for n in elim:
            nn, _, neq, ndof = J.diag[n].blocks.shape
            sizes[n] = (nn, neq, ndof)
            offs[n] = ofs
            ofs += nn * neq
        NE = ofs
        E = like.new_zeros((NE, NE))
        for n in elim:
            d = J.diag[n].to_dense()
            o = offs[n]
            E[o:o + d.shape[0], o:o + d.shape[1]] = d
        pos, vals = [], []
        for cb in J.couplings:
            if cb.target in offs and cb.source in offs:
                m, neq_t, ndof_s = cb.blocks.shape
                rr = offs[cb.target] + cb.rows.idx * neq_t
                cc = offs[cb.source] + cb.cols.idx * ndof_s
                pos.append(((rr[:, None, None]
                             + np.arange(neq_t)[None, :, None]) * NE
                            + cc[:, None, None]
                            + np.arange(ndof_s)[None, None, :]).reshape(-1))
                vals.append(cb.blocks.reshape(-1))
        if pos:
            E = IndexPlan(np.concatenate(pos)).add(
                E.reshape(-1), torch.cat(vals), inplace=True).reshape(NE, NE)
        lu, piv = torch.linalg.lu_factor(E)

        def e_solve(b_flat):
            return torch.linalg.lu_solve(lu, piv, b_flat[:, None])[:, 0]

        def flat_elim(d):
            return torch.cat([d[n].reshape(-1) for n in elim])

        def unflat_elim(v):
            return {n: v[offs[n]:offs[n] + sizes[n][0] * sizes[n][2]]
                    .reshape(sizes[n][0], sizes[n][2]) for n in elim}

        def apply_C(x_main):
            """main dofs -> eliminated-row contributions (C x)."""
            y = {n: like.new_zeros(sizes[n][:2]) for n in elim}
            for cb in J.couplings:
                if cb.target in offs and cb.source not in offs:
                    y[cb.target] = cb.rows.add(y[cb.target],
                                               cb.product(x_main[cb.source]),
                                               inplace=True)
            return y

        def apply_B(y_elim):
            """eliminated dofs -> main-row contributions (B y)."""
            out = {n: like.new_zeros((J.diag[n].blocks.shape[0],
                                      J.diag[n].blocks.shape[2]))
                   for n in main}
            for cb in J.couplings:
                if cb.target not in offs and cb.source in offs:
                    out[cb.target] = cb.rows.add(
                        out[cb.target], cb.product(y_elim[cb.source]),
                        inplace=True)
            return out

        # --- reduced system on the main models
        J_main = MultiLinearizedSystem(
            {n: J.diag[n] for n in main},
            [cb for cb in J.couplings
             if cb.target in main and cb.source in main],
            _sub_layout(J, main))

        b_elim = flat_elim(r)
        corr = apply_B(unflat_elim(e_solve(b_elim)))  # B E^{-1} b
        r_red = {n: r[n] - corr[n] for n in main}

        def reduced_matvec(x: dict) -> dict:
            y = J_main.matvec(x)
            by = apply_B(unflat_elim(e_solve(flat_elim(apply_C(x)))))
            return {n: y[n] - by[n] for n in main}

        du_main, stats = self.inner.solve(_OperatorSystem(J_main,
                                                          reduced_matvec),
                                          r_red, rtol=rtol)
        # back-substitution: the solves return du with J du = -r, so the
        # eliminated update solves E du_e = -(r_e + C du_main)
        du_elim = unflat_elim(e_solve(-(b_elim + flat_elim(apply_C(du_main)))))
        return {**du_main, **du_elim}, stats


class _OperatorSystem(MultiLinearizedSystem):
    """MultiLinearizedSystem with an overridden matvec (reduced operator)."""

    def __init__(self, base: MultiLinearizedSystem, matvec):
        super().__init__(base.diag, base.couplings, base.layout)
        self._mv = matvec

    def matvec(self, x: dict) -> dict:
        return self._mv(x)


def _sub_layout(J: MultiLinearizedSystem, names) -> MultiLayout:
    dof_slices, res_slices = {}, {}
    od = orr = 0
    for n in names:
        nn, _, neq, ndof = J.diag[n].blocks.shape
        dof_slices[n] = (slice(od, od + nn * ndof), (nn, ndof))
        res_slices[n] = (slice(orr, orr + nn * neq), (nn, neq))
        od += nn * ndof
        orr += nn * neq
    return MultiLayout(list(names), dof_slices, res_slices, od, orr)
