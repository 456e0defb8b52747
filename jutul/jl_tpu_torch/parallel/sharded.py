"""SPMD slab-sharded Newton over a ``ShardGroup``.

Port of the JAX package's ``parallel/sharded.py`` (reference:
ext/JutulPartitionedArraysExt/overloads.jl:155-238
``perform_step!(::PArraySimulator)``: per-rank assembly, ghost sync of
primaries, MPI-allreduce convergence, distributed Krylov). Mapping:

  per-rank submodel          -> ONE local extended-slab CompiledModel, run
                                once per shard by ``ShardGroup.run``
  PVector consistent! (halo) -> ``comm.ppermute`` of boundary planes
  mpi_scalar_allreduce       -> ``comm.pmax`` / ``comm.psum``
  distributed Krylov dot     -> psum-reducing ``dot_fn`` in ``bicgstab``
  per-rank preconditioner    -> shard-local block-Jacobi / RAS-ILU(0), or
                                the distributed CPR (global GMG pressure)

The JAX package runs a whole ministep as one ``lax.while_loop`` program;
here the ministep's Newton loop runs eagerly inside the shard body, and
every decision (convergence, divergence, Krylov stop) is taken from
rank-order reduced values that every shard holds bit for bit, so the
shards run in lockstep.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..dtypes import float_type
from ..linsolve.krylov import bicgstab
from ..models.setup import setup_parameters, setup_state
from ..models.system import SimulationModel
from ..ops.assembly import compile_model
from ..ops.blockell import BlockELL, ell_matvec
from ..ops.smallmat import block_inv, bmv
from ..simulator.newton_common import (
    ew_eta,
    newton_accept,
    newton_continue,
    scaled_error_and_residual,
)
from .comm import ShardGroup
from .slab import decompose_slabs, local_face_values, local_to_global_cells


def collect_bc_stacks(forces, n_devices, nph, locate):
    """Per-shard stacks of the state-dependent pressure BCs for the SPMD
    engines. ``locate(global_cells) -> (shards, local_owned_indices)``
    (vectorized). Returns (cells, pb, T, sat) host stacks of shape
    (D, M[, nph]) padded with trans=0 rows (exactly zero contribution), or
    None when there are no BCs."""
    cells_l, pb_l, T_l, sat_l = [], [], [], []
    for f in (forces or {}).values():
        if not (hasattr(f, "pressure") and hasattr(f, "trans")):
            continue
        cells = np.atleast_1d(np.asarray(f.cells)).astype(np.int64)
        ns = cells.shape[0]
        cells_l.append(cells)
        pb_l.append(np.broadcast_to(np.asarray(f.pressure, np.float64),
                                    (ns,)))
        T_l.append(np.broadcast_to(np.asarray(f.trans, np.float64), (ns,)))
        sat = getattr(f, "saturations", None)
        sat_l.append(np.full((ns, nph), 1.0 / nph) if sat is None else
                     np.broadcast_to(np.asarray(sat, np.float64), (ns, nph)))
    if not cells_l:
        return None
    cells = np.concatenate(cells_l)
    pb, T = np.concatenate(pb_l), np.concatenate(T_l)
    sat = np.concatenate(sat_l)
    shard, loc = locate(cells)
    counts = np.bincount(shard, minlength=n_devices)
    M = max(1, int(counts.max()))
    # position of each BC row within its shard, in force order
    order = np.argsort(shard, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.empty_like(order)
    pos[order] = np.arange(order.shape[0]) - starts[shard[order]]
    cells_s = np.zeros((n_devices, M), dtype=np.int32)
    pb_s = np.zeros((n_devices, M))
    T_s = np.zeros((n_devices, M))  # padding rows: trans=0 -> zero effect
    sat_s = np.full((n_devices, M, nph), 1.0 / nph)
    cells_s[shard, pos] = loc
    pb_s[shard, pos] = pb
    T_s[shard, pos] = T
    sat_s[shard, pos] = sat
    return cells_s, pb_s, T_s, sat_s


def bc_force(bc):
    """The shard-local ``PressureBoundaryCondition`` of one shard's stack
    rows (host arrays), or None."""
    if bc is None:
        return None
    from ..models.darcy import PressureBoundaryCondition

    return PressureBoundaryCondition(bc[0], bc[1], bc[2], saturations=bc[3])


def reduce_criteria(comm, model, equations, r_own, own_state, dt):
    """Global convergence criteria of the owned rows: every "max" part is
    pmax-reduced, every "ratio" part is |psum(num)| / psum(den) (one pmax
    and one psum for all of them). Returns (crit, global max |r|)."""
    maxes, ratios, layout = [], [], []
    for info in equations:
        parts = info.eq.convergence_parts(model, info.name,
                                          r_own[:, info.row_slice],
                                          own_state, dt)
        for name, (kind, payload) in parts.items():
            if kind == "max":
                v = payload.reshape(-1)
                layout.append((info.name, name, "max",
                               sum(m.numel() for m in maxes), v.numel()))
                maxes.append(v)
            else:
                num, den = (p.reshape(-1) for p in payload)
                layout.append((info.name, name, "ratio",
                               sum(m.numel() for m in ratios), num.numel()))
                ratios += [num, den]
    maxes.append(torch.amax(torch.abs(r_own)).reshape(1))
    gmax = comm.pmax(torch.cat(maxes))
    gsum = comm.psum(torch.cat(ratios)) if ratios else None
    crit = {info.name: {} for info in equations}
    for eq, name, kind, ofs, n in layout:
        if kind == "max":
            crit[eq][name] = gmax[ofs:ofs + n]
        else:
            crit[eq][name] = torch.abs(gsum[ofs:ofs + n]) / \
                gsum[ofs + n:ofs + 2 * n]
    return crit, gmax[-1]


def psum_dot(comm):
    """The distributed inner product of flat shard-local vectors."""
    return lambda a, b: comm.psum(torch.dot(a, b))


def newton_ministep(comp, model, eval_state, solve, state, tols,
                    min_newton, max_newton, tol_final, max_residual, rtol,
                    forcing, relax):
    """The whole ministep's check-before-solve Newton loop on one shard
    (the JAX package's ``lax.while_loop`` body): ``eval_state(s) ->
    (arrays, crit, rnorm)`` with reduced criteria, ``solve(arrays, eta) ->
    (du, stats)``, the update ``comp.apply_update``. Returns (state, its,
    err, converged, linear its)."""
    def evaluate(s):
        arrays, crit, rnorm = eval_state(s)
        err, rn = scaled_error_and_residual(crit, rnorm, tols,
                                            comp.equations, model)
        bad = (not math.isfinite(rn) or rn > max_residual
               or not math.isfinite(err))
        return arrays, err, bad

    arrays, err, bad = evaluate(state)
    s = dict(state)
    err_prev, omega, it, lin = math.inf, 1.0, 0, 0
    while newton_continue(err, it, bad, min_newton, max_newton):
        eta = (torch.tensor(ew_eta(err, err_prev), dtype=torch.float64)
               if forcing == "ew" else rtol)
        du, stats = solve(arrays, eta)
        omega_new = (relax.select_relaxation_jit(omega, err, err_prev)
                     if relax is not None else omega)
        s = comp.apply_update(s, du, omega_new)
        arrays, err_new, bad = evaluate(s)
        lin += int(stats["iterations"])
        err_prev, err, omega, it = err, err_new, omega_new, it + 1
    conv = newton_accept(err, it, bad, max_newton, tol_final)
    return s, it, err, conv, lin


class DistributedSimulator:
    """Slab-sharded SPMD simulator for Cartesian-mesh models
    (reference counterpart: PArraySimulator, ext interface.jl:2-97).

    Builds one extended-slab local model; per-shard data (parameters,
    dead-face transmissibilities) lives on the group's device, one set per
    shard. States travel as lists of per-shard dicts (``shard_state``,
    ``gather_state``)."""

    def __init__(self, mesh, system, group: ShardGroup,
                 parameters: dict | None = None,
                 data_fields: dict | None = None,
                 local_preconditioner: str = "block_jacobi", gmg=None,
                 dtype=None):
        self.group = group
        self.device = group.device
        self.dtype = dtype or float_type(self.device)
        self.local_preconditioner = local_preconditioner
        if gmg is None:
            from ..ops.stencil import GMG

            gmg = GMG(n_smooth=2, n_coarse_sweeps=12)
        self.gmg = gmg
        D = group.size
        self.n_devices = D
        self.global_mesh = mesh
        self.dec = decompose_slabs(mesh, D)
        dec = self.dec

        from ..core.domains import DataDomain

        gdd = DataDomain(mesh)
        for k, v in (data_fields or {}).items():
            gdd.set(k, v)
        self.global_model = SimulationModel(gdd, system)
        gparams = parameters or setup_parameters(self.global_model)

        ldd = DataDomain(dec.local_mesh)
        self.local_model = SimulationModel(ldd, system)
        self.comp = compile_model(self.local_model)
        self.comp._generic()  # ELL + sum plans, before any shard runs
        self.layout = self.comp.layout

        cell_params, face_params = {}, {}
        l2g = [local_to_global_cells(dec, d) for d in range(D)]
        for name, var in self.global_model.parameters.items():
            ent = var.associated_entity(self.global_model).name()
            g = np.asarray(gparams[name])
            if ent == "Cells":
                cell_params[name] = np.stack([_gather_cells(g, l2g[d])
                                              for d in range(D)])
            elif ent == "Faces":
                stack = np.stack([local_face_values(dec, d, g, mesh, 0.0)
                                  for d in range(D)])
                face_params[name] = stack * dec.face_alive  # dead: zero
            else:
                raise NotImplementedError(ent)
        self.cell_params = cell_params
        self.face_params = face_params
        # edge shards carry dead padding planes with zero parameters: they
        # must not feed the shard-local preconditioner
        self.cell_alive = np.stack([(l2g[d] >= 0).astype(np.float64)
                                    for d in range(D)])
        self.plane = dec.plane_size
        self.n_own = dec.n_own
        self._perm_up = [(i, i + 1) for i in range(D - 1)]
        self._perm_down = [(i + 1, i) for i in range(D - 1)]
        self._shards = {}
        self._cpr_masks = None
        self.last_report = None
        self.last_ministep = None

    # ------------------------------------------------------------------
    def _shard(self, d: int) -> dict:
        """Shard ``d``'s device data (built on first use)."""
        if d not in self._shards:
            dev, dt = self.device, self.dtype
            self._shards[d] = dict(
                cp={k: torch.as_tensor(v[d], device=dev, dtype=dt)
                    for k, v in self.cell_params.items()},
                fp={k: torch.as_tensor(v[d], device=dev, dtype=dt)
                    for k, v in self.face_params.items()},
                alive=torch.as_tensor(self.cell_alive[d], device=dev,
                                      dtype=dt))
        return self._shards[d]

    def initial_state(self, **kw) -> dict:
        """Global state dict (n_cells_global, ...), shard-contiguous."""
        return setup_state(self.global_model, **kw)

    def shard_state(self, state: dict) -> list:
        """Global state -> per-shard dicts of owned tensors on the device
        (slab order is shard-contiguous)."""
        n = self.n_own
        out = []
        for d in range(self.n_devices):
            out.append({k: torch.as_tensor(
                np.array(np.asarray(v)[d * n:(d + 1) * n]),
                device=self.device, dtype=self.dtype)
                for k, v in state.items()
                if k in self.global_model.primary_variables})
        return out

    def gather_state(self, shards: list) -> dict:
        """Per-shard dicts -> global numpy state in mesh order."""
        return {k: np.concatenate([s[k].detach().cpu().numpy()
                                   for s in shards])
                for k in shards[0]}

    # ------------------------------------------------------------------
    def _halo_exchange(self, comm, own):
        """(n_own, ...) owned block -> (n_ext, ...) extended with halos."""
        plane = self.plane
        from_prev = comm.ppermute(own[-plane:], self._perm_up)
        from_next = comm.ppermute(own[:plane], self._perm_down)
        return torch.cat([from_prev, own, from_next])

    def _halo_transpose(self, comm, ext):
        """The exact transpose of ``_halo_exchange``: ghost-plane
        cotangents go back to the shard that owns them."""
        plane, n = self.plane, self.n_own
        own = ext[plane:plane + n].clone()
        back_prev = comm.ppermute(ext[:plane], self._perm_down)
        back_next = comm.ppermute(ext[plane + n:], self._perm_up)
        own[n - plane:] += back_prev
        own[:plane] += back_next
        return own

    def _eval_local(self, comm, sh, state_own, state0_ext, q, bc, dt):
        """This shard's residual, Jacobian and reduced criteria."""
        comp = self.comp
        own = self.dec.own_slice
        state_ext = {k: self._halo_exchange(comm, v)
                     for k, v in state_own.items()}
        full = {**state_ext, **sh["cp"], **sh["fp"]}
        full0 = {**state0_ext, **sh["cp"], **sh["fp"]}
        force = bc_force(bc)
        r, J, full_eval = comp.assemble(
            full, full0, dt,
            forces=None if force is None else {"__bc__": force})
        if q is not None:
            r = r - q  # state-independent cell sources (residual -= q)
        r_own = r[own]
        n_ext = self.dec.n_ext
        own_state = {k: (v[own] if torch.is_tensor(v) and v.ndim
                         and v.shape[0] == n_ext else v)
                     for k, v in full_eval.items()}
        crit, rnorm = reduce_criteria(comm, self.local_model, comp.equations,
                                      r_own, own_state, dt)
        return r_own, J, crit, rnorm

    def _solve_local(self, comm, sh, r_own, J, rtol, max_lin_it):
        """Distributed Krylov solve of this shard's owned rows: psum-dot
        BiCGStab with the configured local preconditioner."""
        comp = self.comp
        own = self.dec.own_slice
        blocks, st = J.blocks, J.structure
        ndof, n_own = comp.ndof, self.n_own

        def matvec(x_flat):
            x_ext = self._halo_exchange(comm, x_flat.reshape(n_own, ndof))
            return ell_matvec(blocks, st, x_ext)[own].reshape(-1)

        # shard-local preconditioner = restricted additive Schwarz across
        # shards (the reference's per-rank ILU(0)/AMG, ext linalg.jl:78)
        if self.local_preconditioner in (None, "block_jacobi"):
            dinv = block_inv(blocks[own.start:own.stop, 0])

            def precond(x_flat):
                return bmv(dinv, x_flat.reshape(n_own, ndof)).reshape(-1)
        else:
            neq, n_ext = comp.neq_total, self.dec.n_ext
            alive = sh["alive"]
            # dead padding rows: zero blocks, identity diagonal
            eye = torch.eye(max(neq, ndof), dtype=blocks.dtype,
                            device=blocks.device)[:neq, :ndof]
            bsane = blocks * alive[:, None, None, None]
            bsane[:, 0] = torch.where(alive[:, None, None] > 0, bsane[:, 0],
                                      eye)
            J_sane = BlockELL(st, bsane)
            if self.local_preconditioner == "cpr":
                precond = self._distributed_cpr(comm, J_sane, matvec)
            else:
                local_M = _make_local_preconditioner(
                    self.local_preconditioner)
                pstate = local_M.update(J_sane)

                def precond(x_flat):
                    x_ext = x_flat.new_zeros((n_ext, neq))
                    x_ext[own] = x_flat.reshape(n_own, neq)
                    return local_M.apply(pstate, J_sane,
                                         x_ext)[own].reshape(-1)

        return bicgstab(matvec, (-r_own).reshape(-1), maxiter=max_lin_it,
                        rtol=rtol, precond=precond, dot_fn=psum_dot(comm))

    # ------------------------------------------------------------------
    def _stencil_masks(self, device, dtype):
        """(7, n_own, S) masks classifying the owned rows' ELL slots by
        lattice offset (diagonal, x-, x+, y-, y+, z-, z+)."""
        if self._cpr_masks is None:
            nx, ny, _nz = self.global_mesh._dims3()
            own = self.dec.own_slice
            cols = np.asarray(self.comp.ell.cols)
            rows = np.arange(cols.shape[0])[:, None]
            off = (cols - rows)[own.start:own.stop]
            masks = []
            for o in (0, -1, 1, -nx, nx, -nx * ny, nx * ny):
                if o == 0:
                    m = np.zeros_like(off, dtype=np.float64)
                    m[:, 0] = 1.0
                else:
                    m = (off == o).astype(np.float64)
                    m[:, 0] = 0.0
                masks.append(m)
            self._cpr_masks = np.stack(masks)
        return torch.as_tensor(self._cpr_masks, device=device, dtype=dtype)

    def _distributed_cpr(self, comm, J_sane, matvec):
        """Distributed CPR: the pressure stage runs the GLOBAL geometric
        multigrid, redundantly on every shard, on an all-gathered 7-point
        pressure stencil; stage 2 is shard-local block-ILU(0) as
        restricted additive Schwarz. Restricting a strong LOCAL pressure
        solve cannot move global pressure modes; gathering the scalar
        stencil (7 coefficients per owned cell, once per Jacobian) and
        V-cycling it globally reproduces the single-device CPR contraction
        (the role HYPRE BoomerAMG plays for the reference's MPI ranks,
        ext/JutulPartitionedArraysExt/linalg.jl:78)."""
        from ..linsolve.precond import ILU0Preconditioner
        from ..ops.stencil import ScalarStencil

        comp = self.comp
        own = self.dec.own_slice
        n_own, ndof, neq, n_ext = (self.n_own, comp.ndof, comp.neq_total,
                                   self.dec.n_ext)
        blocks = J_sane.blocks
        p = 0
        Dinv = block_inv(blocks[:, 0])
        w = Dinv[:, p, :]  # (n_ext, neq) quasi-IMPES weights
        Ap_vals = torch.sum(w[:, None, :] * blocks[..., p], dim=-1)
        masks = self._stencil_masks(blocks.device, blocks.dtype)
        coeff = torch.sum(Ap_vals[own][None] * masks, dim=2).T  # (n_own, 7)
        nx, ny, nz = self.global_mesh._dims3()
        L = (nz, ny, nx)
        g = comm.all_gather(coeff.contiguous())  # (nc, 7), slab order
        glob = {name: g[:, i].reshape(L) for i, name in enumerate(
            ("d", "xm", "xp", "ym", "yp", "zm", "zp"))}
        plus, minus = {}, {}
        if nx > 1:
            plus[0] = glob["xp"][:, :, :-1]
            minus[0] = glob["xm"][:, :, 1:]
        if ny > 1:
            plus[1] = glob["yp"][:, :-1, :]
            minus[1] = glob["ym"][:, 1:, :]
        if nz > 1:
            plus[2] = glob["zp"][:-1, :, :]
            minus[2] = glob["zm"][1:, :, :]
        gmg = self.gmg
        ops = gmg.hierarchy(ScalarStencil(L, glob["d"].reshape(-1), plus,
                                          minus))
        mvs = gmg.matvecs(ops)
        cheb = gmg.cheby_data(ops)  # once per update, not per apply
        ilu = ILU0Preconditioner()
        ist = ilu.update(J_sane)
        my = comm.axis_index()
        w_own = w[own]

        def precond(x_flat):
            x = x_flat.reshape(n_own, neq)
            r_p = torch.sum(w_own * x, dim=-1)
            r_g = comm.all_gather(r_p)
            dp = gmg.vcycle(ops, r_g, mvs=mvs, cheb=cheb)
            du = x.new_zeros((n_own, ndof))
            du[:, p] = dp[my * n_own:(my + 1) * n_own]
            x2 = x - matvec(du.reshape(-1)).reshape(n_own, neq)
            x2_ext = x.new_zeros((n_ext, neq))
            x2_ext[own] = x2
            du2 = ilu.apply(ist, J_sane, x2_ext)[own]
            return (du + du2).reshape(-1)

        return precond

    # ------------------------------------------------------------------
    def stack_cell_sources(self, forces) -> np.ndarray:
        """Dense (D, n_ext, neq) per-shard residual contribution of
        state-independent cell-source forces (``cells`` + ``values``,
        residual -= values; reference: per-rank force application, ext
        overloads.jl:155)."""
        neq = self.comp.neq_total
        nc = self.global_model.number_of_cells()
        qg = np.zeros((nc, neq))
        for name, f in (forces or {}).items():
            if hasattr(f, "pressure") and hasattr(f, "trans"):
                continue  # handled by stack_boundary_conditions
            if not (hasattr(f, "cells") and hasattr(f, "values")):
                raise NotImplementedError(
                    f"force {name!r} ({type(f).__name__}) is not cell-local;"
                    " not supported in the distributed path yet")
            # np.add.at: duplicate completion cells must ACCUMULATE
            np.add.at(qg, np.asarray(f.cells),
                      np.atleast_2d(np.asarray(f.values)))
        return np.stack([_gather_cells(qg, local_to_global_cells(self.dec, d))
                         for d in range(self.n_devices)])

    def stack_boundary_conditions(self, forces):
        """Per-shard stacks for state-dependent pressure BCs (rows remapped
        to shard-local OWNED indices, padded with trans=0 rows)."""
        n, start = self.n_own, self.dec.own_slice.start

        def locate(c):
            return c // n, start + c % n

        return collect_bc_stacks(forces, self.n_devices,
                                 self.comp.neq_total, locate)

    def _force_args(self, forces):
        """Per-shard (q, bc) device/host data of one step's forces."""
        D = self.n_devices
        q = self.stack_cell_sources(forces) if forces else None
        bc = self.stack_boundary_conditions(forces) if forces else None
        out = []
        for d in range(D):
            qd = (None if q is None else
                  torch.as_tensor(q[d], device=self.device, dtype=self.dtype))
            bcd = None if bc is None else tuple(b[d] for b in bc)
            out.append((qd, bcd))
        return out

    # ------------------------------------------------------------------
    def newton_step_fn(self, rtol: float = 1e-8, max_lin_it: int = 200):
        """One Newton iteration on every shard: ``step(state, state0, dt,
        forces=None) -> (new_state, crit, lin_iters, lin_res)``."""
        def step(state, state0, dt, forces=None):
            fargs = self._force_args(forces)

            def body(comm, a):
                s, s0, (q, bc) = a
                sh = self._shard(comm.rank)
                s0_ext = {k: self._halo_exchange(comm, v)
                          for k, v in s0.items()}
                r_own, J, crit, _rn = self._eval_local(comm, sh, s, s0_ext,
                                                       q, bc, dt)
                du, stats = self._solve_local(comm, sh, r_own, J, rtol,
                                              max_lin_it)
                new = self.comp.apply_update(s, du.reshape(self.n_own, -1),
                                             1.0)
                return new, crit, stats["iterations"], stats["residual"]

            outs = self.group.run(body, list(zip(state, state0, fargs)))
            return ([o[0] for o in outs], outs[0][1], outs[0][2],
                    float(outs[0][3]))

        return step

    def ministep_fn(self, tolerances=None, max_newton: int = 15,
                    min_newton: int = 1, tol_factor_final_iteration=1.0,
                    max_residual: float = 1e20, rtol: float = 1e-8,
                    max_lin_it: int = 200, linear_forcing: str = "none",
                    relaxation=None):
        """The whole ministep Newton loop on every shard (the JAX
        package's one-program ministep): ``step(state, state0, dt,
        fargs) -> (state, its, err, converged, lin_its)``."""
        comp = self.comp
        tols = 1e-3 if tolerances is None else tolerances

        def step(state, state0, dt, fargs):
            def body(comm, a):
                s, s0, (q, bc) = a
                sh = self._shard(comm.rank)
                s0_ext = {k: self._halo_exchange(comm, v)
                          for k, v in s0.items()}

                def eval_state(s_own):
                    r_own, J, crit, rnorm = self._eval_local(
                        comm, sh, s_own, s0_ext, q, bc, dt)
                    return (r_own, J), crit, rnorm

                def solve(arrays, eta):
                    du, stats = self._solve_local(comm, sh, arrays[0],
                                                  arrays[1], eta, max_lin_it)
                    return du.reshape(self.n_own, -1), stats

                return newton_ministep(
                    comp, self.local_model, eval_state, solve, s, tols,
                    min_newton, max_newton,
                    float(tol_factor_final_iteration), max_residual, rtol,
                    linear_forcing, relaxation)

            outs = self.group.run(body, list(zip(state, state0, fargs)))
            _s, its, err, conv, lin = outs[0]
            return [o[0] for o in outs], its, err, conv, lin

        return step

    def solve_ministep(self, state, state0, dt, fargs, max_newton: int = 15,
                       tol_cnv: float = 1e-3, **mini_kwargs):
        """One ministep's Newton loop on every shard. Returns (ok, state,
        newton_its, linear_its); non-finite criteria or hitting the
        iteration cap without convergence FAIL the ministep (reference
        failure handling, simulator.jl:779-795) — the caller cuts dt."""
        mini_kwargs.setdefault("tolerances", float(tol_cnv))
        mini_kwargs["max_newton"] = max_newton
        step = self.ministep_fn(**mini_kwargs)
        new_state, its, _err, conv, lin = step(state, state0, dt, fargs)
        return conv, (new_state if conv else list(state)), its, lin

    def solve_timestep(self, state, state0, dT, max_newton: int = 15,
                       tol_cnv: float = 1e-3, forces=None,
                       max_timestep_cuts: int = 5, cut_factor: float = 0.5,
                       growth_factor: float = 2.0, **mini_kwargs):
        """Report step = ministep loop with dt cutting on failure
        (reference: ext overloads.jl:155 + simulator/timesteps.jl:51).
        Returns (state, total Newton iterations); per-ministep detail in
        ``self.last_report``."""
        fargs = self._force_args(forces)
        dT = float(dT)
        t_done, dt, cuts, its_total = 0.0, dT, 0, 0
        minis = []
        cur, prev = list(state), state0
        while t_done < dT * (1 - 1e-12):
            dt_eff = min(dt, dT - t_done)
            t0 = time.perf_counter()
            ok, cur_new, its, lin = self.solve_ministep(
                cur, prev, dt_eff, fargs, max_newton=max_newton,
                tol_cnv=tol_cnv, **mini_kwargs)
            its_total += its
            minis.append({"dt": dt_eff, "success": ok, "iterations": its,
                          "linear_iterations": lin,
                          "wall_time": time.perf_counter() - t0})
            if ok:
                # the last accepted ministep (start, end, dt): an f64
                # re-assembly checks it
                self.last_ministep = (prev, cur_new, dt_eff)
                t_done += dt_eff
                prev = cur = cur_new
                cuts = 0
                dt = min(dt * growth_factor, dT - t_done
                         if t_done < dT else dt)
            else:
                cuts += 1
                if cuts > max_timestep_cuts:
                    raise RuntimeError(
                        f"distributed ministep failed after "
                        f"{max_timestep_cuts} cuts (dt={dt_eff:g})")
                dt = dt_eff * cut_factor
                cur = list(prev)
        self.last_report = {"ministeps": minis, "success": True}
        return cur, its_total

    def simulate(self, state0, timesteps, forces=None, max_newton: int = 15,
                 tol_cnv: float = 1e-3, output_path=None,
                 info_level: int = 0, **mini_kwargs):
        """Schedule-driven distributed simulation mirroring the
        single-device ``Simulator.simulate`` surface: per-step forces
        (constant dict or list of dicts), optional per-step output files.
        Returns (states, reports) with host numpy states in global cell
        order."""
        cur = self.shard_state(state0)
        prev = cur
        states, reports = [], []
        for n, dt in enumerate(timesteps):
            f = forces[n] if isinstance(forces, (list, tuple)) else forces
            t0 = time.perf_counter()
            cur, its = self.solve_timestep(cur, prev, dt,
                                           max_newton=max_newton,
                                           tol_cnv=tol_cnv, forces=f,
                                           **mini_kwargs)
            wall = time.perf_counter() - t0
            prev = cur
            host = self.gather_state(cur)
            rep = {"ministeps": list(self.last_report["ministeps"]),
                   "success": True, "dt": float(dt)}
            states.append(host)
            reports.append(rep)
            if output_path is not None:
                from ..simulator.io import store_output

                store_output(output_path, n, host, rep)
            if info_level >= 0:
                print(f"Step {n + 1}/{len(timesteps)}: dt={float(dt):g} "
                      f"({its} its, {wall:.2f}s, {self.n_devices} shards)")
        return states, reports


def _make_local_preconditioner(spec):
    """The restricted-additive-Schwarz preconditioner of a spec other than
    block-Jacobi and the distributed CPR: 'ilu0' -> Chow-Patel
    block-ILU(0), or any object with update/apply."""
    if spec == "ilu0":
        from ..linsolve.precond import ILU0Preconditioner

        return ILU0Preconditioner()
    if hasattr(spec, "update") and hasattr(spec, "apply"):
        return spec
    raise ValueError(f"unknown local preconditioner {spec!r}")


def _gather_cells(g: np.ndarray, l2g: np.ndarray) -> np.ndarray:
    out = g[np.clip(l2g, 0, g.shape[0] - 1)]
    mask = (l2g >= 0).reshape((-1,) + (1,) * (out.ndim - 1))
    return np.where(mask, out, 0.0)


def simulate_parray(case_or_mesh, system=None, n_devices: int | None = None,
                    device=None, **kwargs):
    """Reference-parity entry point (reference:
    ext/JutulPartitionedArraysExt/interface.jl:145 ``simulate_parray``):
    a ``DistributedSimulator`` over ``n_devices`` thread shards on
    ``device`` (None: the card; default shard count 1)."""
    group = ShardGroup.threads(n_devices or 1, device)
    return DistributedSimulator(case_or_mesh, system, group, **kwargs)
