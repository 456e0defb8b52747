"""Distributed discrete adjoint over GENERAL partitions.

Port of the JAX package's ``parallel/general_adjoint.py`` (reference:
src/ad/gradients.jl:17-284 driven per rank through the PArray machinery,
ext/JutulPartitionedArraysExt/; BASELINE config 5 is "1M-cell adjoint,
dd-partitioned") for the general-partition engine (``general.py``). One
backward report step runs once per shard:

- the lambda solve uses the explicit transpose of the face-block matvec
  (``GeneralDistributedSimulator._system_matvec_T``): face cotangents
  pulled back through the coupling blocks, summed into the read cells in a
  fixed order, and sent home by the transposed halo;
- state and parameter cotangents are per-shard ``torch.func.vjp`` pulls
  of the owned-row residual of EXTENDED (halo-filled) dofs and cell
  parameters (``_local_system(with_jac=False, extended=True)``, which runs
  no collective); their ghost entries are routed home by the explicit
  transposed halo;
- face parameters live on both adjacent shards (each assembles its own
  rows): the global gradient is the shard-sum over the face tables;
- objective gradients assume the sum-objective form (reference
  core_types.jl:1582): G = sum over shards of g(owned cells).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..linsolve.krylov import bicgstab
from ..models.setup import setup_parameters
from ..ops.smallmat import block_inv, bmv
from .sharded import psum_dot


class GeneralDistributedAdjoint:
    """Adjoint sweeps over a ``GeneralDistributedSimulator``'s partition."""

    def __init__(self, dsim, parameters: dict | None = None):
        self.dsim = dsim
        self.global_params = parameters or setup_parameters(
            dsim.global_model)

    # ------------------------------------------------------------------
    def _local_g(self, u_own, cp, G, dt, n, am, g_forces):
        """Shard-local objective over owned alive cells. ``g_forces`` is
        the step's force object: ``G(model, state, dt, n, forces)`` has the
        single-device adjoint's signature."""
        comp = self.dsim.comp
        nom = self.dsim.dec.n_own_max
        state = {**comp.unpack_dofs(u_own),
                 **{k: v[:nom] for k, v in cp.items()}}
        state = comp._eval_secondaries_local(state)
        # mask dead padding rows out of the shard's sum
        state = {k: (v * am if torch.is_tensor(v) and v.ndim == 2
                     else (v * am[:, 0] if torch.is_tensor(v) and v.ndim == 1
                           else v))
                 for k, v in state.items()}
        return G(self.dsim.global_model, state, dt, n, g_forces)

    def _step(self, comm, a, G, n, has_next, g_forces):
        dsim = self.dsim
        comp = dsim.comp
        nom, ndof, neq = dsim.dec.n_own_max, comp.ndof, comp.neq_total
        (u_n, u_prev, u_next, lam_next, (q1, bc1), (q2, bc2), dt_n,
         dt_next) = a
        sh = dsim._shard(comm.rank)
        cp, fp = sh["cp"], sh["fp"]
        am = sh["own_alive"][:, None]
        halo = dsim.halo_fn(comm, sh)

        def halo_T(ext):
            return dsim._halo_transpose(comm, sh, ext)

        def r_fn(u_ext, u0_ext, cp_, fp_, dt_, q_, bc_):
            """The owned-row residual of extended dofs: no collective."""
            return dsim._local_system(
                comm, sh, comp.unpack_dofs(u_ext), comp.unpack_dofs(u0_ext),
                cp_, fp_, q_, dt_, with_jac=False, with_crit=False, bc=bc_,
                extended=True)["r_own"]

        u_n_ext, u_prev_ext = halo(u_n), halo(u_prev)
        # rhs = -dG/du_n - (dF_{n+1}/du_n)^T lambda_{n+1}
        g_u, g_cp = torch.func.grad(
            lambda u, c: self._local_g(u, c, G, dt_n, n, am, g_forces),
            argnums=(0, 1))(u_n, cp)
        rhs = -g_u
        if has_next:
            u_next_ext = halo(u_next)
            _, pull0 = torch.func.vjp(
                lambda u0_: r_fn(u_next_ext, u0_, cp, fp, dt_next, q2, bc2),
                u_n_ext)
            (du0_bar,) = pull0(lam_next)
            rhs = rhs - halo_T(du0_bar)

        # J_n at (u_n, u_prev); transposed distributed solve
        sys = dsim._local_system(
            comm, sh, comp.unpack_dofs(u_n), comp.unpack_dofs(u_prev), cp,
            fp, q1, dt_n, with_jac=True, with_crit=False, bc=bc1)
        matvec_T = dsim._system_matvec_T(comm, sh, sys)
        dinvT = torch.transpose(block_inv(sys["diag_own"]), 1, 2)

        def precond(x_flat):
            return bmv(dinvT, x_flat.reshape(nom, neq)).reshape(-1)

        lam_flat, stats = bicgstab(matvec_T, rhs.reshape(-1),
                                   maxiter=self.max_lin_it, rtol=self.rtol,
                                   precond=precond, dot_fn=psum_dot(comm))
        lam = lam_flat.reshape(nom, neq) * am

        # parameter cotangents: grad_p G += (dF_n/dp)^T lambda + dG/dp.
        # Integer face tables (WENO membership indices) are not
        # differentiable, and the engine's +-1 orientation factors are
        # internal plumbing: close over both, report zeros.
        fp_f = {k: v for k, v in fp.items()
                if v.is_floating_point()
                and not k.startswith("__flux_orient_")}
        fp_i = {k: v for k, v in fp.items() if k not in fp_f}
        _, pull = torch.func.vjp(
            lambda cp_, fpf_: r_fn(u_n_ext, u_prev_ext, cp_,
                                   {**fp_i, **fpf_}, dt_n, q1, bc1), cp, fp_f)
        cp_bar_ext, fp_bar = pull(lam)
        fp_bar = dict(fp_bar)
        for k, v in fp_i.items():
            fp_bar[k] = torch.zeros(v.shape, dtype=lam.dtype,
                                    device=lam.device)
        # route ghost-slot cell cotangents home: the transposed halo
        cp_bar = {k: halo_T(v + g_cp[k]) for k, v in cp_bar_ext.items()}
        return lam, cp_bar, fp_bar, stats

    # ------------------------------------------------------------------
    def solve(self, states: list, timesteps, G: Callable, state0: dict,
              forces=None, rtol: float = 1e-10, max_lin_it: int = 400,
              reports: list | None = None):
        """Backward sweep; returns GLOBAL gradient arrays for all model
        parameters (cells in mesh order, faces in global face order).

        ``states``/``state0`` are GLOBAL states (mesh order).
        ``G(model, state, dt, n, forces)`` must be a sum over cells.
        ``forces`` may be one dict for the whole schedule or a per-step
        list: each backward step then transposes F_n with step-n stacks and
        the F_{n+1} cross term with step-(n+1) stacks.

        EXACTNESS REQUIREMENT (as the single-device adjoint): ``states[n]``
        must satisfy the implicit system F(states[n], states[n-1], dts[n])
        = 0, i.e. the accepted MINISTEP sequence; pass the forward
        ``reports`` to have that checked."""
        if reports is not None:
            for i, rep in enumerate(reports):
                ok_minis = [m for m in rep.get("ministeps", [])
                            if m.get("success", True)]
                if len(ok_minis) > 1:
                    raise ValueError(
                        f"report step {i} was solved in {len(ok_minis)} "
                        "ministeps; per-report-step states do not satisfy "
                        "the one-step implicit system the adjoint "
                        "transposes. Re-run with output_substates / use "
                        "expand_to_ministeps, or pass ministep states.")
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

        def dofs_of(state):
            return [comp.get_dofs(s) for s in dsim.shard_state(state)]

        u0 = dofs_of(state0)
        us = [dofs_of(s) for s in states]
        if isinstance(forces, (list, tuple)):
            if len(forces) != N:
                raise ValueError(
                    f"per-step forces: {len(forces)} entries for {N} steps")
            stacks = [dsim._force_args(f) for f in forces]
        else:
            stacks = [dsim._force_args(forces)] * N

        cp_grad = {k: [0.0] * D for k in dsim.cell_params}
        fp_grad = {k: np.zeros(np.asarray(v).shape)
                   for k, v in dsim.face_params.items()}
        lam = [torch.zeros_like(u) for u in us[-1]]
        u_next = us[-1]
        for n in range(N - 1, -1, -1):
            has_next = n < N - 1
            u_prev = us[n - 1] if n > 0 else u0
            f_n = stacks[n]
            f_nx = stacks[n + 1] if has_next else stacks[n]
            dt_next = float(dts[n + 1]) if has_next else float(dts[n])
            g_forces = forces[n] if isinstance(forces, (list, tuple)) \
                else forces
            args = [(us[n][d], u_prev[d], u_next[d], lam[d], f_n[d],
                     f_nx[d], float(dts[n]), dt_next) for d in range(D)]
            outs = dsim.group.run(
                lambda comm, a, _n=n, _h=has_next, _g=g_forces: self._step(
                    comm, a, G, _n, _h, _g), args)
            lam = [o[0] for o in outs]
            self.lambda_iterations.append(int(outs[0][3]["iterations"]))
            self.lambda_converged.append(bool(outs[0][3]["converged"]))
            for d, o in enumerate(outs):
                for k in cp_grad:
                    cp_grad[k][d] = cp_grad[k][d] + o[1][k]
                for k in fp_grad:
                    fp_grad[k][d] += o[2][k].detach().cpu().numpy()
            u_next = us[n]

        out = {}
        for k, parts in cp_grad.items():
            out[k] = dec.unshard_cells(np.concatenate(
                [v.detach().cpu().numpy() for v in parts]))
        # face gradients: shard-sum over the face tables (the internal
        # __flux_orient_* factors are not model parameters)
        nfg = dsim.mesh.number_of_faces()
        for k, v in fp_grad.items():
            if k.startswith("__flux_orient_"):
                continue
            g = np.zeros((nfg,) + v.shape[2:])
            for d in range(D):
                alive = dec.face_alive[d] > 0
                np.add.at(g, dec.face_g[d][alive], v[d][alive])
            out[k] = g
        return out


def solve_adjoint_sensitivities_general(
        dsim, states: list, timesteps, G: Callable, state0: dict,
        forces=None, parameters: dict | None = None, reports=None, **kw):
    """General-partition counterpart of ``solve_adjoint_sensitivities``
    (reference: src/ad/gradients.jl:17 through the PArray machinery)."""
    return GeneralDistributedAdjoint(dsim, parameters=parameters).solve(
        states, timesteps, G, state0, forces=forces, reports=reports, **kw)
