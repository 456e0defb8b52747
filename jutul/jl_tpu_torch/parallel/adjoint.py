"""Distributed discrete adjoint over the slab decomposition.

Port of the JAX package's ``parallel/adjoint.py`` (reference:
src/ad/gradients.jl:17-284 driven through the PArray machinery,
ext/JutulPartitionedArraysExt/). One backward step runs once per shard
(``ShardGroup.run``):

- the transposed Jacobian operator is written out: rows padded onto the
  extended slab, ``ell_rmatvec`` (a fixed-order sum), then the transposed
  halo exchange, which sends ghost-plane contributions back to their
  owner shard (the JAX package gets this from ``jax.linear_transpose`` of
  its ppermute halo);
- state and parameter cotangents are per-shard ``torch.func.vjp`` pulls
  of the owned-row residual of the EXTENDED slab's dofs and cell
  parameters (no collective inside); the transposed exchange brings the
  contributions a neighbour's residual makes to MY cells home;
- objective gradients assume the sum-objective form (reference
  core_types.jl:1582): ``G = sum over shards of g(owned cells)``.

Gradients with respect to face parameters (Transmissibilities) are summed
over the two adjacent shards on the host: an interface face is assembled
by both (each for its own row).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..linsolve.krylov import bicgstab
from ..models.setup import setup_parameters
from ..ops.blockell import ell_rmatvec
from ..ops.smallmat import block_inv, bmv
from .sharded import psum_dot
from .slab import local_to_global_cells


def _local_face_indices(dec, shard: int, global_mesh) -> np.ndarray:
    """(nf_loc,) global face index per local face; -1 for dead faces."""
    nb_l = dec.local_mesh.neighborship()
    gcell = local_to_global_cells(dec, shard)
    gl = gcell[nb_l[:, 0]]
    gr = gcell[nb_l[:, 1]]
    ok = (gl >= 0) & (gr >= 0)
    gnb = global_mesh.neighborship()
    n_glob = int(np.prod(dec.global_dims))
    key = gnb[:, 0].astype(np.int64) * n_glob + gnb[:, 1]
    order = np.argsort(key)
    key_sorted = key[order]
    out = np.full(nb_l.shape[0], -1, dtype=np.int64)
    q = gl[ok].astype(np.int64) * n_glob + gr[ok]
    pos = np.searchsorted(key_sorted, q)
    hit = key_sorted[np.clip(pos, 0, len(key_sorted) - 1)] == q
    idx = np.flatnonzero(ok)[hit]
    out[idx] = order[pos[hit]]
    return out


class DistributedAdjoint:
    """Adjoint sweeps over a ``DistributedSimulator``'s slab decomposition
    (reference counterpart: adjoints through PArraySimulator ranks)."""

    def __init__(self, dsim, parameters: dict | None = None):
        self.dsim = dsim
        dec = dsim.dec
        D = dsim.n_devices
        gparams = parameters or setup_parameters(dsim.global_model)
        self.global_params = gparams
        # cell parameters: each shard holds its OWNED block (slab order is
        # contiguous); the residual halo-exchanges them, so the pullback
        # returns owned cotangents with the neighbours' contributions
        # already routed home
        self.cp_names, self.fp_names = [], []
        cp_glob = {}
        for name, var in dsim.global_model.parameters.items():
            ent = var.associated_entity(dsim.global_model).name()
            if ent == "Cells":
                cp_glob[name] = np.asarray(gparams[name], dtype=np.float64)
                self.cp_names.append(name)
            elif ent == "Faces":
                self.fp_names.append(name)
            else:
                raise NotImplementedError(ent)
        n = dec.n_own
        self.cp_own = [{k: torch.as_tensor(v[d * n:(d + 1) * n],
                                           device=dsim.device,
                                           dtype=dsim.dtype)
                        for k, v in cp_glob.items()} for d in range(D)]
        self.face_l2g = np.stack([
            _local_face_indices(dec, d, dsim.global_mesh) for d in range(D)
        ])  # (D, nf_loc)

    # ------------------------------------------------------------------
    def _local_residual(self, u_ext, u0_ext, cp_ext, fp, q_own, dt):
        """Owned-row residual of this shard as a function of its EXTENDED
        (halo-filled) dofs and cell parameters: no collective, so its
        pullback gives extended cotangents, which the transposed halo
        routes home."""
        comp = self.dsim.comp
        state = {**comp.unpack_dofs(u_ext), **cp_ext, **fp}
        state0 = {**comp.unpack_dofs(u0_ext), **cp_ext, **fp}
        r = comp.residual(state, state0, dt, None)
        return r[self.dsim.dec.own_slice] - q_own

    def _local_g(self, u_own, cp_own, G, dt, n):
        """Shard-local objective contribution g(owned cells)."""
        comp = self.dsim.comp
        state = comp.evaluate_secondaries({**comp.unpack_dofs(u_own),
                                           **cp_own})
        return G(self.dsim.global_model, state, dt, n, None)

    def _step(self, comm, a, G, n, has_next):
        """One backward step on one shard: rhs, transposed distributed
        solve, parameter cotangents."""
        dsim = self.dsim
        comp = dsim.comp
        dec = dsim.dec
        own = dec.own_slice
        n_own, ndof, neq, n_ext = dec.n_own, comp.ndof, comp.neq_total, \
            dec.n_ext
        u_n, u_prev, u_next, lam_next, q, dt_n, dt_next = a
        sh = dsim._shard(comm.rank)
        cp_own = self.cp_own[comm.rank]
        fp = sh["fp"]
        q_own = q[own]

        def halo(v):
            return dsim._halo_exchange(comm, v)

        def halo_T(ext):
            return dsim._halo_transpose(comm, ext)

        u_n_ext, u_prev_ext = halo(u_n), halo(u_prev)
        cp_ext = {k: halo(v) for k, v in cp_own.items()}
        # rhs = -dG/du_n - (dF_{n+1}/du_n)^T lambda_{n+1}
        g_u, g_cp = torch.func.grad(
            lambda u, cp: self._local_g(u, cp, G, dt_n, n),
            argnums=(0, 1))(u_n, cp_own)
        rhs = -g_u
        if has_next:
            u_next_ext = halo(u_next)
            _, pull0 = torch.func.vjp(
                lambda u0_: self._local_residual(u_next_ext, u0_, cp_ext, fp,
                                                 q_own, dt_next), u_n_ext)
            (du0_bar,) = pull0(lam_next)
            rhs = rhs - halo_T(du0_bar)

        # J_n at (u_n, u_prev) and its transpose
        full = {**comp.unpack_dofs(u_n_ext), **cp_ext, **fp}
        full0 = {**comp.unpack_dofs(u_prev_ext), **cp_ext, **fp}
        _r, J, _fe = comp.assemble(full, full0, dt_n)
        blocks, st = J.blocks, J.structure

        def matvec_T(y_flat):
            y_ext = y_flat.new_zeros((n_ext, neq))
            y_ext[own] = y_flat.reshape(n_own, neq)
            return halo_T(ell_rmatvec(blocks, st, y_ext)).reshape(-1)

        # block-Jacobi on the transposed diagonal
        dinvT = torch.transpose(block_inv(blocks[own.start:own.stop, 0]),
                                1, 2)

        def precond(x_flat):
            return bmv(dinvT, x_flat.reshape(n_own, neq)).reshape(-1)

        lam_flat, stats = bicgstab(matvec_T, rhs.reshape(-1),
                                   maxiter=self.max_lin_it, rtol=self.rtol,
                                   precond=precond, dot_fn=psum_dot(comm))
        lam = lam_flat.reshape(n_own, neq)

        # parameter cotangents: grad_p G += (dF_n/dp)^T lambda + dG/dp
        _, pull = torch.func.vjp(
            lambda cp_, fp_: self._local_residual(u_n_ext, u_prev_ext, cp_,
                                                  fp_, q_own, dt_n),
            cp_ext, fp)
        cp_bar_ext, fp_bar = pull(lam)
        cp_bar = {k: halo_T(v) + g_cp[k] for k, v in cp_bar_ext.items()}
        return lam, cp_bar, fp_bar, stats

    # ------------------------------------------------------------------
    def solve(self, states: list, timesteps, G: Callable, state0: dict,
              forces=None, rtol: float = 1e-10, max_lin_it: int = 400,
              reports: list | None = None):
        """Backward sweep; returns dict of GLOBAL gradient arrays for all
        model parameters (cells in mesh order, faces in global face order).

        ``states`` are the accepted global output states of the forward
        distributed run; ``G(model, state, dt, n, forces)`` must be a sum
        over cells (evaluated per shard on owned cells; constant forces
        only). EXACTNESS REQUIREMENT: states[n] must solve ONE implicit
        step of size dts[n] — pass ``reports`` to have cut ministeps
        detected."""
        if reports is not None:
            for i, rep in enumerate(reports):
                ok_minis = [m for m in rep.get("ministeps", [])
                            if m.get("success", True)]
                if len(ok_minis) > 1:
                    raise ValueError(
                        f"report step {i} used {len(ok_minis)} ministeps; "
                        "expand to ministep states for an exact adjoint.")
        dsim = self.dsim
        comp = dsim.comp
        dec = dsim.dec
        D = dsim.n_devices
        self.rtol = rtol
        self.max_lin_it = max_lin_it
        # per backward step, last step first
        self.lambda_iterations, self.lambda_converged = [], []
        dts = np.atleast_1d(np.asarray(timesteps, dtype=np.float64))
        N = len(states)
        assert N == len(dts)
        if forces and dsim.stack_boundary_conditions(forces) is not None:
            raise NotImplementedError(
                "distributed adjoint with pressure BCs not supported yet")

        def dofs_of(state):
            return [comp.get_dofs(s) for s in dsim.shard_state(state)]

        u0 = dofs_of(state0)
        us = [dofs_of(s) for s in states]
        qs = (dsim.stack_cell_sources(forces) if forces
              else np.zeros((D, dec.n_ext, comp.neq_total)))
        q = [torch.as_tensor(qs[d], device=dsim.device, dtype=dsim.dtype)
             for d in range(D)]
        cp_grad = {k: [0.0] * D for k in self.cp_names}
        fp_grad = {k: np.zeros((D, dec.nf_local)) for k in self.fp_names}
        lam = [torch.zeros_like(u) for u in us[-1]]
        u_next = us[-1]
        for n in range(N - 1, -1, -1):
            has_next = n < N - 1
            u_prev = us[n - 1] if n > 0 else u0
            dt_next = float(dts[n + 1]) if has_next else float(dts[n])
            args = [(us[n][d], u_prev[d], u_next[d], lam[d], q[d],
                     float(dts[n]), dt_next) for d in range(D)]
            outs = dsim.group.run(
                lambda comm, a, _n=n, _h=has_next: self._step(comm, a, G,
                                                              _n, _h),
                args)
            lam = [o[0] for o in outs]
            self.lambda_iterations.append(int(outs[0][3]["iterations"]))
            self.lambda_converged.append(bool(outs[0][3]["converged"]))
            for d, o in enumerate(outs):
                for k in cp_grad:
                    cp_grad[k][d] = cp_grad[k][d] + o[1][k]
                for k in fp_grad:
                    fp_grad[k][d] += o[2][k].detach().cpu().numpy()
            u_next = us[n]

        out = {k: np.concatenate([v.detach().cpu().numpy() for v in parts])
               for k, parts in cp_grad.items()}
        nfg = dsim.global_mesh.number_of_faces()
        for k, v in fp_grad.items():
            g = np.zeros(nfg)
            for d in range(D):
                l2g = self.face_l2g[d]
                okm = l2g >= 0
                np.add.at(g, l2g[okm], v[d][okm])
            out[k] = g
        return out


def solve_adjoint_sensitivities_distributed(
        dsim, states: list, timesteps, G: Callable, state0: dict,
        forces=None, parameters: dict | None = None, **kw):
    """Distributed counterpart of ``solve_adjoint_sensitivities``
    (reference: BASELINE config 5 — dd-partitioned adjoint; the reference
    reuses its PArray machinery, src/ad/gradients.jl:17)."""
    return DistributedAdjoint(dsim, parameters=parameters).solve(
        states, timesteps, G, state0, forces=forces, **kw)
