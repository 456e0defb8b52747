"""Bordered stencil fast path: lattice reservoir + well-model border.

Port of the JAX package's ``ops/stencil_wells.py``. The augmented-graph
well formulation (models/wells.py ``WellGraphMesh``: one wellbore storage
cell per well, perforations as extra faces whose TPFA upwind flux with
trans=WI IS the Peaceman inflow) breaks the pure Cartesian lattice that
``StencilCompiledModel`` requires. This module keeps the fast path by
assembling the coupled system in BORDERED form:

    [ A_rr  A_rw ] [du_r]   [-r_r]      A_rr: 7-point StencilMatrix
    [ A_wr  A_ww ] [du_w] = [-r_w]      A_ww: (nw, neq, ndof) block diag
                                        A_rw/A_wr: one block per perforation

and solving by Schur elimination of the (tiny) well block: the Krylov
space sees only S = A_rr − A_rw A_ww⁻¹ A_wr — the lattice operator plus a
rank-(nw·ndof) correction — preconditioned by the same CPR(GMG) stack as
the well-free lattice; du_w back-substitutes exactly. Reference
counterparts: wells as models coupled through cross-terms
(src/multimodel/crossterm.jl:3-660), Schur-reduced linear systems
(src/linsolve/multimodel.jl:17), TPFA reservoir storage
(src/conservation/conservation.jl:101-484).

Controls stay forces on the wellbore cell: rate control = PhaseSourceTerm,
BHP control = PressureBoundaryCondition, whose dq/du lands in A_ww.

On the card:
- perforations are gathered with indexing and scattered with
  ``index_add`` onto the DISTINCT perforated cells only (perforations
  sharing a cell are first summed by a product with a static 0/1
  membership matrix), so no two atomics meet and every sum has a fixed
  order; per-well sums are products with the static (nw, np) membership
  matrix. Results do not change from run to run, and neither do the
  iteration counts;
- every index tensor is built once, on the model's device, at
  construction;
- the perforations' flux and Jacobian blocks come from one launch of the
  face flux kernel K3 (``_perf_flux``), and the accumulation term of
  lattice and wellbore cells from one batch: per assembly, the border
  adds a few hundred small host ops, not the ~10,000 of per-perforation
  ``torch.func`` jvps;
- the tiny (np, neq, ndof) contractions are written as multiply-and-sum
  (``smallmat.bmv``), in full working precision: no matrix unit, no TF32
  (the JAX package needed ``Precision.HIGHEST`` here, where bf16-rounded
  contractions turned Newton into quasi-Newton).
The JAX package's one-hot and box forms of the Schur correction
(``JUTUL_WELL_CORR``) are TPU layout workarounds and are not ported; the
adjoint's ``bordered_transpose`` waits for the adjoint port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..dtypes import resolve_device
from .cuda import StencilMatvec, darcy_flux_jacobian
from .smallmat import block_inv, bmv
from .stencil import StencilCompiledModel, StencilMatrix


@dataclass
class Perforations:
    """Static perforation index data on one device, memberships in one
    dtype."""

    cell: torch.Tensor  # (np,) reservoir cell of each perforation
    well: torch.Tensor  # (np,) well index (0..nw-1)
    well_cell: torch.Tensor  # (np,) global cell of the perforation's well
    rows: torch.Tensor  # (nu,) the distinct perforated reservoir cells
    row_of: torch.Tensor  # (nu, np) 1 where perforation p lies in rows[u]
    well_of: torch.Tensor  # (nw, np) 1 where perforation p is in well w

    @staticmethod
    def _sum(member, t):
        m = member.reshape(member.shape + (1,) * (t.ndim - 1))
        return torch.sum(m * t[None], dim=1)

    def fold(self, t):
        """(np, ...) -> (nu, ...): per distinct perforated cell."""
        return self._sum(self.row_of, t)

    def wells(self, t):
        """(np, ...) -> (nw, ...): per well."""
        return self._sum(self.well_of, t)


@dataclass
class BorderedStencilMatrix:
    """StencilMatrix + well border: rows/cols nc..nc+nw-1 are wellbores.

    ``J_rb[p]`` is the reservoir-row/well-column block of perforation p,
    ``J_br[p]`` the well-row/reservoir-column block, ``D_ww[w]`` the
    wellbore diagonal block. The perforations' reservoir-diagonal
    contributions live inside ``A.diag`` already.
    """

    A: StencilMatrix
    perfs: Perforations
    J_rb: torch.Tensor  # (np, neq, ndof)
    J_br: torch.Tensor  # (np, neq, ndof)
    D_ww: torch.Tensor  # (nw, neq, ndof)

    @property
    def n(self) -> int:
        return self.A.n + self.D_ww.shape[0]

    def matvec(self, x):
        """x (nc+nw, ndof) -> (nc+nw, neq)."""
        P = self.perfs
        nc = self.A.n
        xr, xw = x[:nc], x[nc:]
        yr = StencilMatvec(self.A)(xr)
        yr = yr.index_add(0, P.rows, P.fold(bmv(self.J_rb, xw[P.well])))
        yw = bmv(self.D_ww, xw) + P.wells(bmv(self.J_br, xr[P.cell]))
        return torch.cat([yr, yw], dim=0)


class _DomainView:
    def __init__(self, domain, mesh):
        self._domain = domain
        self.mesh = mesh

    def __getattr__(self, k):
        return getattr(self._domain, k)


class _BaseModelView:
    """The full WellGraphMesh model with ``domain.mesh`` replaced by the
    base CartesianMesh (only the lattice dims are read through it)."""

    def __init__(self, model, base_mesh):
        self._model = model
        self.domain = _DomainView(model.domain, base_mesh)

    def __getattr__(self, k):
        return getattr(self._model, k)


class _LatticeView:
    """Reservoir-lattice view of a WellGraphMesh CompiledModel: same
    physics/variables, ``n_cells`` = base lattice cells, base mesh dims.
    All states fed through it must be PRE-SLICED to the lattice
    (``BorderedStencilModel._split_state``)."""

    def __init__(self, comp, base_mesh, nc):
        self._comp = comp
        self.n_cells = nc
        self.model = _BaseModelView(comp.model, base_mesh)

    def __getattr__(self, k):
        return getattr(self._comp, k)


class BorderedStencilModel:
    """Structured fast path over a CompiledModel on a WellGraphMesh:
    lattice interior via StencilCompiledModel (with the K3 flux kernel),
    wellbores + perforations as a dense border.

    Drop-in for StencilCompiledModel in the Simulator — ``assemble``
    returns a BorderedStencilMatrix, which ``StencilKrylovSolver`` solves
    by Schur elimination of the wells. ``device`` places the perforation
    index tensors, built here once.
    """

    def __init__(self, comp, device=None):
        from ..meshes.cartesian import CartesianMesh
        from ..models.wells import WellGraphMesh

        mesh = comp.model.domain.mesh
        if not isinstance(mesh, WellGraphMesh):
            raise TypeError("BorderedStencilModel requires a WellGraphMesh")
        if not isinstance(mesh.base, CartesianMesh):
            raise TypeError("WellGraphMesh base must be a CartesianMesh")
        self.comp = comp
        self.mesh = mesh
        self.nc = mesh._nc_base
        self.nw = len(mesh.wells)
        self.nf_base = mesh._nf_base
        self.lattice = StencilCompiledModel(
            _LatticeView(comp, mesh.base, self.nc))
        self.ndof = comp.ndof
        self.neq = comp.neq_total
        if self.lattice.flux_con is None:
            raise NotImplementedError("bordered path needs a flux term")

        perf = mesh._perf  # (np, 2): (reservoir cell, well cell) global
        cell = perf[:, 0].astype(np.int64)
        well = (perf[:, 1] - self.nc).astype(np.int64)
        rows, row_idx = np.unique(cell, return_inverse=True)
        dev = resolve_device(device)
        as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        self._index = dict(cell=as_dev(cell), well=as_dev(well),
                           well_cell=as_dev(perf[:, 1].astype(np.int64)),
                           rows=as_dev(rows))
        self._member = dict(
            row_of=as_dev(np.arange(rows.size)[:, None] == row_idx[None, :]),
            well_of=as_dev(np.arange(self.nw)[:, None] == well[None, :]))
        self._perfs = {}

    @property
    def n_cells(self):
        return self.comp.n_cells  # nc + nw

    def perforations(self, dtype) -> Perforations:
        """The perforation index data with memberships in ``dtype``
        (cast once per dtype)."""
        if dtype not in self._perfs:
            self._perfs[dtype] = Perforations(
                **self._index,
                **{k: v.to(dtype) for k, v in self._member.items()})
        return self._perfs[dtype]

    # -- state plumbing ---------------------------------------------------
    def _split_state(self, state):
        """(reservoir-sliced state, well-sliced state): cell entries split
        at nc, face entries at nf_base, everything else shared. Slices
        are views."""
        from ..core.entities import CELLS, FACES

        res, well = {}, {}
        for k, v in state.items():
            ent = self.comp.cell_entry_entity.get(k)
            cut = self.nc if ent == CELLS else (
                self.nf_base if ent == FACES else None)
            if cut is None:
                res[k] = well[k] = v
            else:
                res[k], well[k] = v[:cut], v[cut:]
        return res, well

    def _perf_face_state(self, state):
        return {k: v[self.nf_base:]
                for k, v in self.comp._face_entries(state).items()}

    # -- perforations -----------------------------------------------------
    def _perf_flux(self, P, state):
        """Perforation fluxes F (np, neq), positive = out of the reservoir
        cell (the TPFA upwind flux with trans=WI = Peaceman inflow), and
        their Jacobian blocks dF/du_res, dF/du_well (np, neq, ndof) — one
        call of the face flux kernel K3 on a (1, 2, np) lattice whose row 0
        holds the perforated cells' dofs and row 1 their wellbores', so
        its np y-faces are the perforations. On the CPU that is K3's plain
        version: ``torch.func.jvp`` of the system's ScalarAssemblyForm flux,
        with JAX's rules for clip, upwind and where."""
        comp = self.comp
        form = self.lattice.form
        prim = comp.model.primary_variables
        U = comp.get_dofs({k: torch.cat([state[k][P.cell],
                                         state[k][P.well_cell]])
                           for k in prim})
        fs = self._perf_face_state(state)
        npf = P.cell.shape[0]
        out = darcy_flux_jacobian(form, U, *(fs[nm] for nm in
                                             form.face_params),
                                  (1, 2, npf), 1)
        neq, ndof = self.neq, self.ndof
        blocks = [out[neq + s * ndof * neq:neq + (s + 1) * ndof * neq]
                  .reshape(ndof, neq, npf).permute(2, 1, 0)
                  for s in (0, 1)]
        return out[:neq].T, blocks[0], blocks[1]

    def _border_jacobian(self, P, JF_l, JF_r, diag, D_ww):
        """Place the perforation blocks: returns (diag', J_rb, J_br,
        D_ww') with the perforations' reservoir-diagonal blocks added into
        ``diag`` (neq, ndof, nc) and their well-diagonal blocks into
        ``D_ww`` (nw, neq, ndof). residual[res] += F, residual[well] -= F."""
        diag = diag.index_add(2, P.rows, P.fold(JF_l).permute(1, 2, 0))
        return diag, JF_r, -JF_l, D_ww - P.wells(JF_r)

    def _apply_force_border(self, diag, D_ww, state, dt, forces):
        """Split state-dependent force Jacobians between the lattice
        diagonal and the well block by (static) cell index — the bordered
        counterpart of StencilCompiledModel._apply_force_diag."""
        dev = diag.device
        as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        for sl, cells, jac in self.comp._force_diagonal_blocks(state, dt,
                                                               forces):
            jac = jac.to(diag.dtype)
            rm = cells < self.nc
            if rm.any():
                diag = diag.clone()
                diag[sl].index_add_(2, as_dev(cells[rm]),
                                    jac[as_dev(np.flatnonzero(rm))]
                                    .permute(1, 2, 0))
            if (~rm).any():
                D_ww = D_ww.clone()
                D_ww[:, sl].index_add_(0, as_dev(cells[~rm] - self.nc),
                                       jac[as_dev(np.flatnonzero(~rm))])
        return diag, D_ww

    # -- assemble ---------------------------------------------------------
    def assemble(self, state, state0, dt, forces=None):
        """(r (nc+nw, neq), BorderedStencilMatrix, secondary-evaluated
        state). Secondaries and the accumulation term are evaluated once
        over all nc+nw cells; the lattice and the wells take slices."""
        comp = self.comp
        nc = self.nc
        state = comp.evaluate_secondaries(state)
        state0 = comp.evaluate_secondaries(state0)
        r_acc, d_acc, U = self.lattice.accumulation(state, state0, dt)
        sr, _ = self._split_state(state)
        sr0, _ = self._split_state(state0)
        r_lat, A_lat = self.lattice.assemble_evaluated(
            sr, sr0, dt, acc=(r_acc[:, :nc], d_acc[..., :nc], U[:nc]))
        P = self.perforations(r_lat.dtype)

        # border: well accumulation + perforation fluxes
        F, JF_l, JF_r = self._perf_flux(P, state)
        r_lat = r_lat.index_add(0, P.rows, P.fold(F))
        r = torch.cat([r_lat, r_acc[:, nc:].T - P.wells(F)], dim=0)
        diag, J_rb, J_br, D_ww = self._border_jacobian(
            P, JF_l, JF_r, A_lat.diag, d_acc[..., nc:].permute(2, 0, 1))
        if forces:
            r = comp._apply_forces(r, state, dt, forces)
            diag, D_ww = self._apply_force_border(diag, D_ww, state, dt,
                                                  forces)
        A = StencilMatrix(A_lat.L, diag, A_lat.plus, A_lat.minus)
        return r, BorderedStencilMatrix(A, P, J_rb, J_br, D_ww), state


def schur_eliminate(B: BorderedStencilMatrix, r, base_mv=None):
    """Reduce the bordered system to the reservoir Krylov space.

    Returns (S_matvec over (nc, ndof) vectors, r_schur (nc, neq),
    back_substitute(du_r) -> du_w). The Schur complement
    S = A_rr − A_rw D⁻¹ A_wr is applied matrix-free with indexed
    gathers and scatters (the JAX package's "gather" form); the well
    blocks are block-diagonal because wellbores only couple through their
    own perforations. ``base_mv`` is the lattice operator (default: K1 on
    ``B.A``)."""
    P = B.perfs
    nc = B.A.n
    rr, rw = r[:nc], r[nc:]
    Dinv = block_inv(B.D_ww)  # (nw, ndof, neq) acting eq-residual -> dof
    mv = base_mv if base_mv is not None else StencilMatvec(B.A)

    def gather_to_wells(xr):
        return P.wells(bmv(B.J_br, xr[P.cell]))  # (nw, neq)

    def s_matvec(xr):
        yw = bmv(Dinv, gather_to_wells(xr))
        out = bmv(B.J_rb, yw[P.well])  # (np, neq)
        return mv(xr).index_add_(0, P.rows, P.fold(-out))

    yw0 = bmv(Dinv, rw)  # D⁻¹ r_w
    r_schur = rr.index_add(0, P.rows, P.fold(-bmv(B.J_rb, yw0[P.well])))

    def back_substitute(du_r):
        return bmv(Dinv, -(rw + gather_to_wells(du_r)))

    return s_matvec, r_schur, back_substitute
