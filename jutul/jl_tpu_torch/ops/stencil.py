"""Structured-grid fast path: stencil assembly, SpMV and GMG-CPR.

Port of the JAX package's ``ops/stencil.py``. For Cartesian meshes the TPFA
sparsity is a 7-point stencil, so the Jacobian is stored per lattice axis
and every operator works by slicing and padding the (nz, ny, nx) lattice;
the CPR pressure stage is geometric multigrid with exact piecewise-constant
Galerkin coarsening (which preserves the 7-point structure exactly).
Counterpart of the reference's hard-coded TPFA assembly path
(src/conservation/conservation.jl:101-484).

The hot operations run through the CUDA kernels of ``ops/cuda``: the
face flux + Jacobian blocks (K3), the block-stencil SpMV (K1), the GMG
level passes (K2 Jacobi/residual and K4 Chebyshev steps, K8–K11 whole
phases)
and, opted in, the fused BiCGStab body (K6/K7). On CPU tensors those
wrappers run their plain PyTorch versions. Well models ride this engine
through ``ops/stencil_wells.py`` (bordered matrix, Schur-eliminated
wellbores), which ``StencilKrylovSolver.solve`` dispatches to. The adjoint
solves with the transposed matrix (``stencil_transpose``: the same
structure) and differentiates ``residual_differentiable``, the residual in
plain torch.

Layout conventions (the JAX package's, so both compare like with like):
- cell fields: (n, ...) with component axes last; Krylov vectors (n, neq);
- lattice views: (nz, ny, nx) trailing;
- the stencil matrix stores, per axis a, the coupling blocks as
  ``plus[a][e, j, f_lat]`` (row = left cell, column = +a neighbour) and
  ``minus[a][e, j, f_lat]`` (row = right cell, column = -a neighbour),
  plus ``diag[e, j, n]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import jvp

from ..models.equations import AccumulationContribution, FaceFluxContribution
from .cuda import ScalarLevel, StencilMatvec, darcy_flux_jacobian_lattice
from .cuda.stencil_kernels import SLAB_MAX_DEPTH
from .cuda.stencil_kernels import AXIS_SLICES

# F.pad widths (x0, x1, y0, y1, z0, z1) placing a face lattice onto the
# cell lattice at the LEFT (_PADS) or RIGHT (_PADS_R) cell of each face
_PADS = {0: (0, 1, 0, 0, 0, 0), 1: (0, 0, 0, 1, 0, 0), 2: (0, 0, 0, 0, 0, 1)}
_PADS_R = {0: (1, 0, 0, 0, 0, 0), 1: (0, 0, 1, 0, 0, 0), 2: (0, 0, 0, 0, 1, 0)}


@dataclass
class StencilMatrix:
    """7-point block stencil matrix on an (nz, ny, nx) lattice."""

    L: tuple  # (nz, ny, nx)
    diag: torch.Tensor  # (neq, ndof, n)
    plus: dict  # axis -> (neq, ndof, *face_lat)
    minus: dict  # axis -> (neq, ndof, *face_lat)

    @property
    def n(self) -> int:
        return int(np.prod(self.L))

    def matvec(self, x):
        """y = A x with x (n, ndof) -> y (n, neq) in plain torch, all
        slicing and padding of the lattice: the JAX package's
        ``StencilMatrix.matvec``, K1's oracle (K1 sums the same seven
        terms per row in another order)."""
        L = self.L
        neq, ndof, _ = self.diag.shape
        xT = x.T  # (ndof, n)
        y = (self.diag * xT[None]).sum(dim=1)  # (neq, n)
        x_lat = xT.reshape((ndof,) + L)
        y_lat = y.reshape((neq,) + L)
        for a in range(3):
            if a not in self.plus:
                continue
            sl_l, sl_r = AXIS_SLICES[a]
            # row L couples to x at the RIGHT cell, row R to the LEFT one
            contrib_l = (self.plus[a]
                         * x_lat[(slice(None),) + sl_r][None]).sum(dim=1)
            y_lat = y_lat + F.pad(contrib_l, _PADS[a])
            contrib_r = (self.minus[a]
                         * x_lat[(slice(None),) + sl_l][None]).sum(dim=1)
            y_lat = y_lat + F.pad(contrib_r, _PADS_R[a])
        return y_lat.reshape(neq, -1).T


def stencil_transpose(A: StencilMatrix) -> StencilMatrix:
    """Aᵀ of a 7-point block stencil is again one: the entry (row L(f),
    column R(f), block B) becomes (row R(f), column L(f), Bᵀ), so ``plus``
    and ``minus`` swap places with their blocks transposed. The adjoint's
    λ-solves therefore run on the forward solver stack (K1, CPR(GMG)).
    Every field is a view; ``StencilMatvec`` packs it."""
    swap = lambda v: v.transpose(0, 1)  # noqa: E731
    return StencilMatrix(A.L, swap(A.diag),
                         {a: swap(v) for a, v in A.minus.items()},
                         {a: swap(v) for a, v in A.plus.items()})


class StencilCompiledModel:
    """Structured fast path over a CompiledModel (CartesianMesh, one
    multi-component ConservationLaw with the TPFA stencil, and a system
    that exposes a ``ScalarAssemblyForm``)."""

    def __init__(self, comp):
        from ..meshes.cartesian import CartesianMesh

        self.comp = comp
        mesh = comp.model.domain.mesh
        if not isinstance(mesh, CartesianMesh):
            raise TypeError("StencilCompiledModel requires a CartesianMesh")
        nx, ny, nz = mesh._dims3()
        self.L = (nz, ny, nx)
        self.ndof = comp.ndof
        self.neq = comp.neq_total
        # face blocks per axis in the global face ordering (x, then y, z)
        sizes = [(nx - 1) * ny * nz if nx > 1 else 0,
                 nx * (ny - 1) * nz if ny > 1 else 0,
                 nx * ny * (nz - 1) if nz > 1 else 0]
        self.face_offsets = [int(v) for v in np.concatenate([[0], np.cumsum(sizes)])]
        self.face_lat = {
            0: (nz, ny, nx - 1) if nx > 1 else None,
            1: (nz, ny - 1, nx) if ny > 1 else None,
            2: (nz - 1, ny, nx) if nz > 1 else None,
        }
        self.acc_cons = []
        self.flux_con = None
        for info, con in comp.contribs:
            if isinstance(con, AccumulationContribution):
                self.acc_cons.append(con)
            elif isinstance(con, FaceFluxContribution):
                if self.flux_con is not None:
                    raise NotImplementedError("one flux contribution only")
                if con.stencil.shape[1] != 2:
                    raise NotImplementedError("TPFA (K=2) stencils only")
                self.flux_con = con
        form_fn = getattr(comp.model.system, "scalar_assembly_form", None)
        self.form = form_fn(comp.model) if form_fn is not None else None
        if self.flux_con is not None and (
                self.form is None or self.form.n_eq != self.neq):
            raise NotImplementedError(
                "the stencil engine assembles fluxes through the system's "
                "ScalarAssemblyForm; this system provides none")

    @property
    def n_cells(self):
        return self.comp.n_cells

    def _axis_face_state(self, face_state, a):
        o0, o1 = self.face_offsets[a], self.face_offsets[a + 1]
        return {k: v[o0:o1] for k, v in face_state.items()}

    def accumulation(self, state, state0, dt):
        """The cell-local accumulation term over every cell the
        (secondary-evaluated) states hold: residual (neq, n) and its
        diagonal (neq, ndof, n), by one ``torch.func.jvp`` per dof over
        the whole cell batch. Returns (r, diag, U) with U the (n, ndof)
        packed dofs."""
        comp = self.comp
        model = comp.model
        U = comp.get_dofs(state)  # (n, ndof)
        cell_state = comp._cell_entries(state)
        cell_state0 = comp._cell_entries(state0)
        params_cell = comp._cell_entries(state, include=("parameter",))
        n = U.shape[0]
        r = U.new_zeros((self.neq, n))
        for con in self.acc_cons:
            r = r + con.fn(model, cell_state, cell_state0, dt).T
        diag = U.new_zeros((self.neq, self.ndof, n))
        for con in self.acc_cons:
            def local_fn(u, _c=con):
                local = dict(params_cell)
                local.update(comp.unpack_dofs(u))
                local = comp._eval_secondaries_local(local)
                return _c.fn(model, local, cell_state0, dt)

            for j in range(self.ndof):
                ej = torch.zeros_like(U)
                ej[:, j] = 1.0
                _, tj = jvp(local_fn, (U,), (ej,))  # (n, neq)
                diag[:, j] += tj.T
        return r, diag, U

    def jacobian(self, state, state0, dt, forces=None) -> StencilMatrix:
        """The StencilMatrix of secondary-evaluated states by the generic
        route of the JAX package's ``StencilCompiledModel.jacobian``: the
        accumulation diagonal of ``accumulation``, then per axis one
        ``torch.func.jvp`` per dof and side through the equation's own
        flux function on the two-cell states of the sliced lattice (the
        secondaries evaluated from the dofs), then the forces' diagonal
        blocks. No kernel: it is the oracle of the fused assembly (K3)
        and, through ``StencilMatrix.matvec``, of K1."""
        comp = self.comp
        model = comp.model
        neq, ndof, n = self.neq, self.ndof, self.n_cells
        _, diag, U = self.accumulation(state, state0, dt)
        plus, minus = {}, {}
        if self.flux_con is not None:
            con = self.flux_con
            params_cell = comp._cell_entries(state, include=("parameter",))
            face_state = comp._face_entries(state)
            diag_lat = diag.reshape((neq, ndof) + self.L)
            U_lat = U.T.reshape((ndof,) + self.L)
            for a in range(3):
                fl = self.face_lat[a]
                if fl is None:
                    continue
                p_l, p_r = self._axis_cell_states(params_cell, a)
                sl_l, sl_r = AXIS_SLICES[a]
                U_l = U_lat[(slice(None),) + sl_l].reshape(ndof, -1).T
                U_r = U_lat[(slice(None),) + sl_r].reshape(ndof, -1).T
                fs = self._axis_face_state(face_state, a)

                def flux(ul, ur, _pl=p_l, _pr=p_r, _fs=fs):
                    ll = dict(_pl)
                    ll.update(comp.unpack_dofs(ul))
                    ll = comp._eval_secondaries_local(ll)
                    rr = dict(_pr)
                    rr.update(comp.unpack_dofs(ur))
                    rr = comp._eval_secondaries_local(rr)
                    local = {k: torch.stack([ll[k], rr[k]], dim=1)
                             for k in ll}
                    return con.fn(model, local, _fs)  # (nf, neq)

                zeros = torch.zeros_like(U_l)
                cols_l, cols_r = [], []
                for j in range(ndof):
                    ej = torch.zeros_like(U_l)
                    ej[:, j] = 1.0
                    cols_l.append(jvp(flux, (U_l, U_r), (ej, zeros))[1])
                    cols_r.append(jvp(flux, (U_l, U_r), (zeros, ej))[1])
                # (neq, ndof, *fl): dF/du_L and dF/du_R
                jl = torch.stack(cols_l).permute(2, 0, 1).reshape(
                    (neq, ndof) + fl)
                jr = torch.stack(cols_r).permute(2, 0, 1).reshape(
                    (neq, ndof) + fl)
                # residual[L] += F: d/du_L on diag(L), d/du_R on plus;
                # residual[R] -= F: d/du_R on diag(R), d/du_L on minus
                diag_lat = diag_lat + F.pad(jl, _PADS[a]) \
                    - F.pad(jr, _PADS_R[a])
                plus[a] = jr.contiguous()
                minus[a] = -jl
            diag = diag_lat.reshape(neq, ndof, n)
        if forces:
            diag = self._apply_force_diag(diag, state, dt, forces)
        return StencilMatrix(self.L, diag, plus, minus)

    def residual(self, state, state0, dt, forces=None):
        """The residual (n, neq) alone, in the dtype of the states it is
        given: ``assemble`` with the Jacobian dropped (the flux kernel
        makes residual and Jacobian blocks in one pass, so there is no
        cheaper form here)."""
        return self.assemble(state, state0, dt, forces)[0]

    def _axis_cell_states(self, cell_state, a):
        """Per-side dicts of cell entries sliced to axis ``a``'s face
        lattice and flattened to (nf_a, ...)."""
        sl_l, sl_r = AXIS_SLICES[a]
        out_l, out_r = {}, {}
        for k, v in cell_state.items():
            comp_shape = tuple(v.shape[1:])
            lat = v.reshape(self.L + comp_shape)
            out_l[k] = lat[sl_l].reshape((-1,) + comp_shape)
            out_r[k] = lat[sl_r].reshape((-1,) + comp_shape)
        return out_l, out_r

    def residual_differentiable(self, state, state0, dt, forces=None):
        """The residual (n, neq) from secondary-evaluated states in plain
        torch operations that autograd differentiates: the port of the JAX
        package's ``StencilCompiledModel.residual``. The accumulation term
        on all cells, then per axis the equation's own flux function on
        the two-cell states of the sliced lattice, added into the lattice
        at each face's left cell and subtracted at its right one, then the
        forces. It launches no kernel: the adjoint pulls cotangents back
        through it (``torch.func.vjp``), while ``residual``/``assemble``
        serve the Newton loop."""
        comp = self.comp
        model = comp.model
        cell_state = comp._cell_entries(state)
        cell_state0 = comp._cell_entries(state0)
        r = None
        for con in self.acc_cons:
            term = con.fn(model, cell_state, cell_state0, dt).T  # (neq, n)
            r = term if r is None else r + term
        if self.flux_con is not None:
            face_state = comp._face_entries(state)
            r_lat = r.reshape((self.neq,) + self.L)
            for a in range(3):
                if self.face_lat[a] is None:
                    continue
                cs_l, cs_r = self._axis_cell_states(cell_state, a)
                local = {k: torch.stack([cs_l[k], cs_r[k]], dim=1)
                         for k in cs_l}
                flux = self.flux_con.fn(model, local,
                                        self._axis_face_state(face_state, a))
                f_lat = flux.T.reshape((self.neq,) + self.face_lat[a])
                r_lat = r_lat + F.pad(f_lat, _PADS[a]) \
                    - F.pad(f_lat, _PADS_R[a])
            r = r_lat.reshape(self.neq, -1)
        r = r.T
        if forces:
            r = comp._apply_forces(r, state, dt, forces)
        return r

    def assemble(self, state, state0, dt, forces=None):
        """Residual (n, neq), StencilMatrix and the secondary-evaluated
        state (see ``assemble_evaluated``)."""
        state = self.comp.evaluate_secondaries(state)
        state0 = self.comp.evaluate_secondaries(state0)
        r, A = self.assemble_evaluated(state, state0, dt, forces)
        return r, A, state

    def assemble_evaluated(self, state, state0, dt, forces=None, acc=None):
        """Residual (n, neq) and StencilMatrix from secondary-evaluated
        states — the fused-form assembly of the JAX package's
        ``_assemble_fused``: the accumulation term in torch, then one
        flux + Jacobian kernel call for the three axes, then the forces'
        residuals and state-dependent diagonal blocks. ``acc``: this lattice's
        ``accumulation`` result when the caller has it already (the
        bordered engine evaluates lattice and wellbore cells at once)."""
        comp = self.comp
        neq, ndof, n = self.neq, self.ndof, self.n_cells
        r, diag, U = acc if acc is not None else self.accumulation(
            state, state0, dt)

        # --- flux + Jacobian blocks: one fused kernel for all axes ---
        plus, minus = {}, {}
        r_lat = r.reshape((neq,) + self.L)
        diag_lat = diag.reshape((neq, ndof) + self.L)
        if self.flux_con is not None:
            face_state = comp._face_entries(state)
            outs = darcy_flux_jacobian_lattice(
                self.form, U,
                [tuple(self._axis_face_state(face_state, a)[nm]
                       for nm in self.form.face_params) for a in range(3)],
                self.L)
            for a in range(3):
                fl = self.face_lat[a]
                if fl is None:
                    continue
                out = outs[a]
                F_a = out[:neq].reshape((neq,) + fl)
                JL = out[neq:neq + ndof * neq].reshape(
                    (ndof, neq) + fl).transpose(0, 1)  # (neq, ndof, *fl)
                JR = out[neq + ndof * neq:].reshape(
                    (ndof, neq) + fl).transpose(0, 1)
                # residual[L] += F, residual[R] -= F; d/du_L lands on
                # diag(L) and minus, d/du_R on diag(R) and plus
                r_lat = r_lat + F.pad(F_a, _PADS[a])
                r_lat = r_lat - F.pad(F_a, _PADS_R[a])
                diag_lat = diag_lat + F.pad(JL, _PADS[a])
                diag_lat = diag_lat - F.pad(JR, _PADS_R[a])
                plus[a] = JR.contiguous()
                minus[a] = -JL
        r2 = r_lat.reshape(neq, n).T.contiguous()
        diag = diag_lat.reshape(neq, ndof, n)
        if forces:
            r2 = comp._apply_forces(r2, state, dt, forces)
            diag = self._apply_force_diag(diag, state, dt, forces)
        return r2, StencilMatrix(self.L, diag, plus, minus)

    def _apply_force_diag(self, diag, state, dt, forces):
        """Add state-dependent force Jacobians (e.g. a pressure BC's
        dq/du) onto the (neq, ndof, n) diagonal; constant sources
        contribute none."""
        for sl, cells, jac in self.comp._force_diagonal_blocks(state, dt,
                                                               forces):
            diag = diag.clone()
            diag[sl].index_add_(2, torch.as_tensor(cells, device=diag.device),
                                jac.to(diag.dtype).permute(1, 2, 0))
        return diag


# ---------------------------------------------------------------------------
# CPR with geometric multigrid on the pressure stencil
# ---------------------------------------------------------------------------
@dataclass
class ScalarStencil:
    L: tuple
    diag: torch.Tensor  # (n,)
    plus: dict  # axis -> face-lattice tensors
    minus: dict

    @property
    def n(self) -> int:
        return int(np.prod(self.L))


def _fold(v, axis, f: int = 2):
    """Sum adjacent groups of ``f`` along ``axis`` (dim must be a
    multiple of f)."""
    sh = list(v.shape)
    n = sh[axis]
    sh[axis:axis + 1] = [n // f, f]
    return v.reshape(sh).sum(dim=axis + 1)


def _padded_L(L, f: int = 2):
    """Lattice dims padded to multiples of ``f``; extent-1 dims stay."""
    return tuple(n if n == 1 else n + (-n) % f for n in L)


def _lat_pad(L, PL):
    """F.pad widths growing lattice ``L`` to ``PL`` at the high ends."""
    return (0, PL[2] - L[2], 0, PL[1] - L[1], 0, PL[0] - L[0])


def _pad_even(A: ScalarStencil, f: int = 2) -> ScalarStencil:
    """Pad lattice dims to multiples of ``f`` with identity rows (diag=1,
    no coupling); dims of extent 1 stay uncoarsened and unpadded."""
    PL = _padded_L(A.L, f)
    if PL == tuple(A.L):
        return A
    pad = _lat_pad(A.L, PL)
    diag = F.pad(A.diag.reshape(A.L), pad, value=1.0)
    plus = {a: F.pad(v, pad) for a, v in A.plus.items()}
    minus = {a: F.pad(v, pad) for a, v in A.minus.items()}
    return ScalarStencil(PL, diag.reshape(-1), plus, minus)


def _coarsen_scalar(A: ScalarStencil, f: int = 2) -> ScalarStencil:
    """Exact piecewise-constant Galerkin ``f``x coarsening of a 7-point
    stencil (stays 7-point: only face-adjacent coarse blocks couple).

    A_c[I, J] = sum_{i in I, j in J} A[i, j]: fine faces interior to a
    block (index % f != f-1 along the axis) fold into the coarse
    diagonal; the block-boundary face layer (index % f == f-1) forms the
    coarse interface couplings.
    """
    A = _pad_even(A, f)
    cL = tuple(max(n // f, 1) if n > 1 else 1 for n in A.L)

    def blocksum_cells(v_lat):
        out = v_lat
        for axis, n in enumerate(A.L):
            if n > 1:
                out = _fold(out, axis, f)
        return out

    def blocksum_transverse(v, ax_lat):
        out = v
        for axis in range(3):
            if axis != ax_lat and A.L[axis] > 1:
                out = _fold(out, axis, f)
        return out

    diag_c = blocksum_cells(A.diag.reshape(A.L))
    plus_c, minus_c = {}, {}
    for a in A.plus:
        ax_lat = 2 - a
        nf = A.plus[a].shape[ax_lat]  # = n-1 along the axis
        sel_ifc = [slice(None)] * 3
        # boundary layer between blocks: one fine-face layer per coarse
        # face, at index f-1, 2f-1, ...
        sel_ifc[ax_lat] = slice(f - 1, None, f)
        p, m = A.plus[a], A.minus[a]
        pi = p[tuple(sel_ifc)]
        # interior faces: everything NOT on the block boundary, folded
        # (padded by one zero layer to n faces) into the diagonal
        mask_sh = [1, 1, 1]
        mask_sh[ax_lat] = nf
        idx = torch.arange(nf, device=p.device).reshape(mask_sh)
        interior = torch.where(idx % f != f - 1, p + m, torch.zeros_like(p))
        pad1 = [0] * 6
        pad1[2 * (2 - ax_lat) + 1] = 1  # n-1 faces -> n cells (face at left)
        interior = F.pad(interior, tuple(pad1))
        diag_c = diag_c + blocksum_cells(interior)
        if pi.shape[ax_lat] == 0:
            continue
        plus_c[a] = blocksum_transverse(pi, ax_lat)
        minus_c[a] = blocksum_transverse(m[tuple(sel_ifc)], ax_lat)
    return ScalarStencil(cL, diag_c.reshape(-1), plus_c, minus_c)


def _prolong_linear(e_lat, fine_L):
    """Trilinear cell-centred prolongation (Wesseling): each fine child
    sits a quarter coarse cell off its parent's centre, so along every
    coarsened axis the child value is 3/4 parent + 1/4 nearest neighbour
    (edge-clamped). With the piecewise-constant restriction the transfer
    orders are 2 + 1 > the operator's order 2, which injection (order 1)
    misses."""
    for axis in range(3):
        n = e_lat.shape[axis]
        if fine_L[axis] == n:  # axis not coarsened
            continue
        lo = e_lat.narrow(axis, 0, 1)
        hi = e_lat.narrow(axis, n - 1, 1)
        e_minus = torch.cat([lo, e_lat.narrow(axis, 0, n - 1)], dim=axis)
        e_plus = torch.cat([e_lat.narrow(axis, 1, n - 1), hi], dim=axis)
        even = 0.75 * e_lat + 0.25 * e_minus
        odd = 0.75 * e_lat + 0.25 * e_plus
        sh = list(e_lat.shape)
        sh[axis] = 2 * n
        e_lat = torch.stack([even, odd], dim=axis + 1).reshape(sh)
    return e_lat


def _cheby_setup(A: ScalarStencil):
    """Per-level Chebyshev data: inverse diagonal + a Gershgorin upper
    bound on lambda_max(D^-1 A) (one coefficient pass, no power
    iteration — a slight overestimate only flattens the polynomial a
    little, while an UNDERestimate would amplify high modes). ``lmax``
    stays a device scalar: nothing here syncs with the host."""
    offs = A.diag.new_zeros(A.L)
    for a in A.plus:
        offs = offs + F.pad(torch.abs(A.plus[a]), _PADS[a])
        offs = offs + F.pad(torch.abs(A.minus[a]), _PADS_R[a])
    dabs = torch.abs(A.diag)
    dsafe = torch.where(dabs > 0, dabs, torch.ones_like(dabs))
    lmax = 1.0 + torch.max(offs.reshape(-1) / dsafe)
    # dead rows never update (dinv = 0), matching the level kernels
    dinv = torch.where(dabs > 0, 1.0 / A.diag, torch.zeros_like(dabs))
    return dinv, lmax


def _cheby_smooth(lv, dinv, lmax, u, b, n_sweep, lower=0.25):
    """Chebyshev smoothing of the level via the shared recurrence
    (linsolve/cheby.py) with the level's residual op — the reference
    the fused ``*_cheby`` level hooks (K4, K9, K11) are held to."""
    from ..linsolve.cheby import chebyshev_recurrence

    return chebyshev_recurrence(
        lambda u_: dinv * lv.residual(u_, b), dinv * b, u, n_sweep,
        lmax, lower)


class GMG:
    """Geometric multigrid V-cycle on a scalar 7-point stencil (the CPR
    pressure stage on structured grids): piecewise-constant restriction,
    injection or trilinear prolongation, coarsening by ``coarsen_factor``
    per axis (2: classical cell-centred multigrid; 4 halves the level
    count for a weaker cycle with half the launches).

    ``prolongation``: "injection" or "linear" (``_prolong_linear``;
    factor 2 only).

    ``coef_dtype``: None/"f32" keep the level coefficients as assembled;
    "bf16" stores what the level kernels (K2, K4, K8–K11) and CPR's
    stage-2 matvec (K1, K=1) read in bfloat16, at half the bytes, widened
    on load with the arithmetic in the vectors' dtype. The hierarchy's Galerkin
    coarsening and the Chebyshev bound stay in full precision. GMG is a
    preconditioner, so this moves iteration counts a little and the
    converged answer not at all.

    ``smoother``: "jacobi" (weighted Jacobi through the K2 level kernel)
    or "chebyshev" (polynomial smoothing on [cheby_lower*lmax, lmax]
    through K4's steps; no dot products). On the levels K8/K9 hold
    (``ScalarLevel``), the hooks ``RESIDENT_HOOKS`` marks — the coarse
    solve — run as one launch of K8 (Jacobi) or K9 (Chebyshev); the
    smoothing phases of levels of at least ``SLAB_MIN_CELLS`` cells (the
    fine and mid levels) as one K10 (Jacobi) or K11 (Chebyshev) launch
    each, ``max(n_smooth, 2)`` applications deep, as the reference's slab
    level.

    ``slab_double_buffer`` (an attribute, default False, set after
    construction as in the JAX package, where it selects the pipelined
    slab kernel B8) changes no route here: B8 and B2 compute one function
    and differ only in when a slab's copies start, and K10's plane rings
    already copy the next plane while the current one is swept — they are
    the double buffer. The flag is kept so that the JAX package's
    settings carry over."""

    def __init__(self, omega: float = 0.8, n_smooth: int = 2,
                 n_coarse_sweeps: int = 40, min_cells: int = 32,
                 max_levels: int = 10, smoother: str = "jacobi",
                 cheby_lower: float = 0.25, prolongation: str = "injection",
                 coef_dtype: str | None = None, coarsen_factor: int = 2):
        self.omega = omega
        self.n_smooth = n_smooth
        self.n_coarse_sweeps = n_coarse_sweeps
        self.min_cells = min_cells
        self.max_levels = max_levels
        if int(coarsen_factor) < 2:
            raise ValueError("coarsen_factor must be >= 2")
        self.coarsen_factor = int(coarsen_factor)
        if prolongation == "linear" and self.coarsen_factor != 2:
            raise ValueError("prolongation='linear' requires "
                             "coarsen_factor=2")
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown smoother {smoother!r}")
        self.smoother = smoother
        self.cheby_lower = cheby_lower
        if prolongation not in ("injection", "linear"):
            raise ValueError(f"unknown prolongation {prolongation!r}")
        self.prolongation = prolongation
        if coef_dtype not in (None, "bf16", "f32"):
            raise ValueError(f"unknown coef_dtype {coef_dtype!r}")
        self.coef_dtype = coef_dtype
        self.slab_double_buffer = False

    def coef_torch_dtype(self):
        """The dtype the level kernels' coefficients are stored in: None
        (as assembled) or ``torch.bfloat16``."""
        return torch.bfloat16 if self.coef_dtype == "bf16" else None

    def hierarchy(self, A: ScalarStencil) -> list:
        ops = [A]
        for _ in range(self.max_levels):
            if ops[-1].n <= self.min_cells:
                break
            ops.append(_coarsen_scalar(ops[-1], self.coarsen_factor))
        return ops

    def matvecs(self, ops: list) -> list:
        """Per-level fused level ops, built once per update."""
        depth = min(max(self.n_smooth, 2), SLAB_MAX_DEPTH)
        return [ScalarLevel(A, coef_dtype=self.coef_torch_dtype(),
                            depth=depth) for A in ops]

    def cheby_data(self, ops: list) -> list | None:
        """Per-level Chebyshev step tables (``chebyshev_steps``, enough
        rows for the longest phase) when the Chebyshev smoother is on:
        every level's lmax stays on the device, and all levels' tables
        come from one batch of elementwise ops."""
        if self.smoother != "chebyshev":
            return None
        from ..linsolve.cheby import chebyshev_steps

        lmax = torch.stack([_cheby_setup(A)[1] for A in ops])
        steps = chebyshev_steps(lmax, self.cheby_lower,
                                max(self.n_smooth, self.n_coarse_sweeps))
        return list(steps.unbind(0))

    def vcycle(self, ops: list, b, level: int = 0, mvs: list | None = None,
               cheb: list | None = None):
        if mvs is None:
            mvs = self.matvecs(ops)
        if cheb is None:
            cheb = self.cheby_data(ops)
        lv = mvs[level]
        last = level == len(ops) - 1
        if cheb is not None:
            if last:
                return lv.sweep_n_cheby(b, cheb[level], self.n_coarse_sweeps)
            u, r = lv.presmooth_residual_cheby(b, cheb[level], self.n_smooth)
        elif last:
            return lv.sweep_n(b, self.omega, self.n_coarse_sweeps)
        else:
            u, r = lv.presmooth_residual(b, self.omega, self.n_smooth)
        # restrict (pw-constant sum) onto the padded lattice
        f = self.coarsen_factor
        L = ops[level].L
        PL = _padded_L(L, f)
        rc = F.pad(r.reshape(L), _lat_pad(L, PL))
        for axis, n in enumerate(PL):
            if n > 1:
                rc = _fold(rc, axis, f)
        ec = self.vcycle(ops, rc.reshape(-1), level + 1, mvs, cheb)
        # prolong: inject the coarse value into each child cell, or
        # interpolate it trilinearly (prolongation="linear", f = 2 only)
        e_lat = ec.reshape(ops[level + 1].L)
        if self.prolongation == "linear":
            e_lat = _prolong_linear(e_lat, PL)
        else:
            for axis, n in enumerate(PL):
                if n > 1:
                    e_lat = torch.repeat_interleave(e_lat, f, dim=axis)
        e_lat = e_lat[: L[0], : L[1], : L[2]]
        u = u + e_lat.reshape(-1)
        if cheb is not None:
            return lv.postsmooth_cheby(u, b, cheb[level], self.n_smooth)
        return lv.postsmooth(u, b, self.omega, self.n_smooth)


@dataclass
class StencilCPRState:
    w: torch.Tensor  # (neq, n) quasi-IMPES row weights
    dinv: torch.Tensor  # (n, ndof, neq) inverse diagonal blocks
    ops: list  # GMG hierarchy of the pressure stencil
    mvs: list  # per-level ScalarLevel ops (K2/K4/K8–K11)
    mv_A: StencilMatvec  # K1 matvec of the full block matrix
    mv_Ap: StencilMatvec  # K1 pressure-COLUMN matvec (K=1): stage 2
    # applies A to a vector that is nonzero only in the pressure dof, so
    # only the p-column coefficient streams need reading
    cheb: list | None = None  # per-level Chebyshev step tables (K4/K9/K11)


class StencilCPR:
    """CPR for the stencil matrix: quasi-IMPES weights + GMG pressure
    stage + block-Jacobi stage 2 (reference CPR practice,
    linsolve/cpr.py on the structured fast path)."""

    def __init__(self, pressure_index: int = 0, gmg: GMG | None = None):
        self.p = pressure_index
        self.gmg = gmg or GMG()

    def update(self, A: StencilMatrix) -> StencilCPRState:
        """Quasi-IMPES weights w = row p of D^{-1}; the scalar pressure
        stencil collapses every coupling block B through
        Ap[i,j] = sum_e w_i[e] * B[e, p]."""
        from .smallmat import block_inv

        neq, ndof, n = A.diag.shape
        if neq != ndof:
            raise NotImplementedError("StencilCPR: square cell blocks only")
        p = self.p
        dinv = block_inv(A.diag.permute(2, 0, 1))  # (n, neq, ndof)
        w = dinv[:, p, :].T  # (neq, n): row p
        w_lat = w.reshape((neq,) + A.L)
        diag_p = torch.sum(w * A.diag[:, p], dim=0)
        plus_p, minus_p = {}, {}
        for a in A.plus:
            sl_l, sl_r = AXIS_SLICES[a]
            plus_p[a] = torch.sum(w_lat[(slice(None),) + sl_l]
                                  * A.plus[a][:, p], dim=0)
            minus_p[a] = torch.sum(w_lat[(slice(None),) + sl_r]
                                   * A.minus[a][:, p], dim=0)
        ops = self.gmg.hierarchy(ScalarStencil(A.L, diag_p, plus_p, minus_p))
        col = StencilMatrix(
            A.L, A.diag[:, p:p + 1, :],
            {a: v[:, p:p + 1] for a, v in A.plus.items()},
            {a: v[:, p:p + 1] for a, v in A.minus.items()})
        # mv_A is the Krylov OPERATOR and stays in full precision; mv_Ap
        # only feeds the stage-2 preconditioner correction, so it may read
        # its coefficients in the GMG's reduced coefficient dtype
        mv_A = StencilMatvec(A)
        if mv_A.coef.dtype != A.diag.dtype:
            raise AssertionError("the Krylov operator's coefficients must "
                                 "never be narrowed")
        return StencilCPRState(
            w, dinv, ops, self.gmg.matvecs(ops), mv_A,
            StencilMatvec(col, coef_dtype=self.gmg.coef_torch_dtype()),
            self.gmg.cheby_data(ops))

    def apply(self, state: StencilCPRState, A: StencilMatrix, x):
        """x (n, neq) residual -> du (n, ndof)."""
        from .smallmat import bmv

        r_p = torch.sum(state.w * x.T, dim=0)
        dp = self.gmg.vcycle(state.ops, r_p, mvs=state.mvs, cheb=state.cheb)
        r2 = x - state.mv_Ap(dp[:, None])
        du = bmv(state.dinv, r2)
        du[:, self.p] += dp
        return du


class StencilKrylovSolver:
    """Linear-solver adapter for the stencil fast path: BiCGStab with
    StencilCPR, vectors in the operators' native (n, neq) layout.

    ``use_fused_body``: True runs BiCGStab on the fused body (K6/K7,
    float32 systems only); None/False the plain chain (the JAX package's
    auto rule: always the chain)."""

    def __init__(self, preconditioner: StencilCPR | None = None,
                 rtol: float = 1e-6, atol: float = 0.0,
                 max_iterations: int = 100,
                 use_fused_body: bool | None = None):
        self.preconditioner = preconditioner or StencilCPR()
        self.rtol = rtol
        self.atol = atol
        self.max_iterations = max_iterations
        self.use_fused_body = use_fused_body

    def solve(self, A, r, rtol=None):
        """``A`` a StencilMatrix, or a BorderedStencilMatrix (well models),
        which is solved by Schur elimination of the wellbore block."""
        from .stencil_wells import BorderedStencilMatrix

        if isinstance(A, BorderedStencilMatrix):
            return self._solve_bordered(A, r, rtol)
        pstate = self.preconditioner.update(A)
        return self._bicgstab(pstate, A, pstate.mv_A, r, rtol)

    def _bicgstab(self, pstate, A, matvec, r, rtol):
        """BiCGStab on ``matvec`` for the lattice system's right-hand side
        ``-r``, through ``resolve_bicgstab``: the plain chain on (n, neq)
        blocks, or the fused body on their flat views (contiguous blocks,
        so flattening copies nothing)."""
        from ..linsolve.krylov import bicgstab, resolve_bicgstab

        fn = resolve_bicgstab(A.diag.dtype, self.use_fused_body)
        b = (-r).to(A.diag.dtype).contiguous()
        kw = dict(maxiter=self.max_iterations,
                  rtol=self.rtol if rtol is None else rtol, atol=self.atol)

        def precond(x):
            return self.preconditioner.apply(pstate, A, x)

        if fn is bicgstab:
            return fn(matvec, b, precond=precond, **kw)
        shape = b.shape
        du, stats = fn(lambda x: matvec(x.view(shape)).reshape(-1),
                       b.view(-1), precond=lambda x: precond(
                           x.view(shape)).reshape(-1), **kw)
        return du.view(shape), stats

    def _solve_bordered(self, B, r, rtol=None):
        """Bordered (well-model) system: Schur-eliminate the wellbore
        block, run the SAME CPR(GMG)-preconditioned BiCGStab on the
        reservoir Schur complement (lattice operator + rank-(nw·ndof)
        perforation correction), back-substitute du_w exactly. The
        preconditioner sees only the lattice StencilMatrix. Counterpart
        of the reference's Schur-reduced well solves
        (src/linsolve/multimodel.jl:17)."""
        from .stencil_wells import schur_eliminate

        pstate = self.preconditioner.update(B.A)
        s_matvec, r_schur, back_substitute = schur_eliminate(
            B, r, base_mv=pstate.mv_A)
        du_r, stats = self._bicgstab(pstate, B.A, s_matvec, r_schur, rtol)
        return torch.cat([du_r, back_substitute(du_r)], dim=0), stats
