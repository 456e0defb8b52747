"""Discrete adjoint gradients.

Port of the JAX package's ``adjoint/gradients.py`` (reference:
src/ad/gradients.jl — ``solve_adjoint_sensitivities`` :17,230,
``setup_adjoint_storage`` :108, ``update_sensitivities!`` :483,
``next_lagrange_multiplier!`` :519; src/ad/force_gradients.jl for
``solve_adjoint_forces``).

Backward in time, with F_n the residual of step n and G = Σ_n g_n:

    (dF_n/dx_n)ᵀ λ_n = −(dg_n/dx_n)ᵀ − (dF_{n+1}/dx_n)ᵀ λ_{n+1}
    ∇_p G = Σ_n dg_n/dp + (dF_n/dp)ᵀ λ_n

On either engine, as in the JAX package:
- the generic block-ELL engine (``use_stencil=False``, the default):
  dF_n/dx_n is the compiled model's BlockELL Jacobian
  (``jacobian_blocks``), and each λ-solve is a dense direct solve of its
  transpose (``n·ndof ≤ direct_limit``), a ``GenericKrylov`` on the
  transposed BlockELL (``linear_solver``), or else unpreconditioned
  MGS-GMRES on ``ell_rmatvec``;
- the stencil engine (``use_stencil=True``): the Jacobian the forward
  engine assembles (the three-axis K3, and the per-axis K3 for the
  perforations, on the card); its transpose is again a (bordered) block
  stencil, so each λ-solve runs the forward solver stack,
  CPR(GMG)-BiCGStab on K1 and K2.
(dF_{n+1}/dx_n)ᵀ λ and (dF_n/dp)ᵀ λ are one ``torch.func.vjp`` through
the engine's differentiable residual: plain torch, as the JAX package's
XLA residual, which no Pallas kernel touches (K3 writes into buffers
autograd cannot see, so the vjp never runs through it).

A MultiModel's adjoint (``solve_adjoint_sensitivities_multimodel``, which
both entry points dispatch to) runs the same recursion on the coupled
MultiLinearizedSystem: a dense direct solve of its transpose up to
``direct_limit`` unknowns, else BiCGStab on the transposed product
(``MultiLinearizedSystem.rmatvec``, every repeated-row sum in a fixed
order — the JAX package transposes its matvec with ``jax.linear_transpose``)
with the transposed block-diagonal inverse as preconditioner.

States must be the accepted ministep sequence for the gradient to be
exact (the reference requires it too): use ``expand_to_ministeps`` with
``output_substates=True`` when ministeps were cut.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..dtypes import float_type, resolve_device
from ..models.forces import (
    as_value,
    force_structure,
    force_values,
    with_force_values,
)
from ..models.setup import from_numpy, merge_state
from ..ops.assembly import compile_model
from ..ops.blockell import BlockELL, ell_rmatvec, ell_to_dense, ell_transpose


def _is_multi(model) -> bool:
    from ..multimodel.core import MultiModel

    return isinstance(model, MultiModel)


class AdjointStorage:
    """What an adjoint sweep reuses across calls (reference
    setup_adjoint_storage, gradients.jl:108): the compiled model, the
    engine, the λ-solver and the integer parameters.

    ``device`` (default the CUDA card; with none it raises — pass
    ``device="cpu"`` for the CPU) and ``dtype`` (default
    ``float_type(device)``) place every tensor of the sweep, as in
    ``Simulator``.

    ``use_stencil=False`` (the default, as in the JAX package): the
    generic engine. ``linear_solver`` is None (a direct solve of the
    dense transpose up to ``direct_limit`` unknowns, else MGS-GMRES at
    rtol 1e-10 over 500 iterations) or a ``GenericKrylov`` on the
    transposed BlockELL, whose transpose tables are built here, once
    (``setup_s`` seconds with the ELL structure).
    ``use_stencil=True``: ``linear_solver`` must be a
    ``StencilKrylovSolver`` (None: CPR(GMG(n_smooth=2, n_coarse_sweeps=12,
    min_cells=16384))-BiCGStab at rtol 1e-8, 100 iterations).
    ``lambda_iterations`` and ``lambda_converged`` list each iterative
    λ-solve's iterations and whether it met its tolerance, in the order
    solved."""

    def __init__(self, model, parameters: dict, forces=None,
                 direct_limit: int = 20_000, linear_solver=None,
                 use_stencil: bool = False, device=None, dtype=None):
        from ..linsolve.krylov import GenericKrylov
        from ..models.wells import WellGraphMesh
        from ..ops.stencil import (
            GMG,
            StencilCompiledModel,
            StencilCPR,
            StencilKrylovSolver,
        )
        from ..ops.stencil_wells import BorderedStencilModel

        if _is_multi(model):
            raise TypeError(
                "AdjointStorage holds one model's engine; a MultiModel's "
                "adjoint is solve_adjoint_sensitivities(mm, ...)")
        self.device = resolve_device(device)
        self.dtype = dtype or float_type(self.device)
        self.model = model
        self.comp = compile_model(model)
        self.direct_limit = direct_limit
        self._stencil = None  # None: the generic engine
        self.setup_s = 0.0
        if use_stencil:
            if isinstance(model.domain.mesh, WellGraphMesh):
                self._stencil = BorderedStencilModel(self.comp, self.device)
            else:
                self._stencil = StencilCompiledModel(self.comp)
            if linear_solver is None:
                linear_solver = StencilKrylovSolver(
                    preconditioner=StencilCPR(gmg=GMG(
                        n_smooth=2, n_coarse_sweeps=12, min_cells=16384)),
                    rtol=1e-8, max_iterations=100)
            if not isinstance(linear_solver, StencilKrylovSolver):
                raise TypeError("use_stencil=True needs a "
                                "StencilKrylovSolver (or None for the "
                                "CPR-GMG default)")
        elif linear_solver is not None:
            if not isinstance(linear_solver, GenericKrylov):
                raise TypeError(
                    "use_stencil=False (the generic block-ELL engine) "
                    "needs a GenericKrylov for its λ-solves (or None for "
                    "the direct / MGS-GMRES ones), not a "
                    f"{type(linear_solver).__name__}")
            # the ELL structure and its transpose table (host set-up, which
            # also checks that the pattern is structurally symmetric),
            # built here once and kept out of the sweeps
            t0 = time.perf_counter()
            ell = self.comp.ell
            ell._on("tidx", self.device, ell.transpose_idx)
            self.setup_s = time.perf_counter() - t0
        self.linear_solver = linear_solver
        self.parameters = from_numpy(parameters, self.device, self.dtype)
        # integer parameters are not differentiable: close over them,
        # differentiate the float ones
        self.params_f = {k: v for k, v in self.parameters.items()
                         if v.is_floating_point()}
        self.params_i = {k: v for k, v in self.parameters.items()
                         if k not in self.params_f}
        self.forces = forces
        self.lambda_iterations: list[int] = []
        self.lambda_converged: list[bool] = []

    # -- states from dofs --------------------------------------------------
    def _state(self, u, params):
        return merge_state(self.comp.unpack_dofs(u),
                           {**self.params_i, **params})

    def dofs_of(self, state: dict):
        """(n, ndof) packed primaries of a state of arrays or tensors."""
        prim = self.model.primary_variables
        return self.comp.get_dofs(from_numpy(
            {k: v for k, v in state.items() if k in prim}, self.device,
            self.dtype))

    def residual_from_dofs(self, u, u0, params, dt, forces):
        comp = self.comp
        if self._stencil is None:
            return comp.residual(self._state(u, params),
                                 self._state(u0, params), dt, forces)
        state = comp.evaluate_secondaries(self._state(u, params))
        state0 = comp.evaluate_secondaries(self._state(u0, params))
        return self._stencil.residual_differentiable(state, state0, dt,
                                                     forces)

    def _jac_blocks(self, u, u0, params, dt, forces):
        """The step's Jacobian as the forward engine assembles it: the
        BlockELL blocks (generic) or the (bordered) stencil matrix."""
        with torch.no_grad():
            if self._stencil is not None:
                return self._stencil.assemble(self._state(u, params),
                                              self._state(u0, params), dt,
                                              forces)[1]
            comp = self.comp
            return comp.jacobian_blocks(
                comp.evaluate_secondaries(self._state(u, params)),
                comp.evaluate_secondaries(self._state(u0, params)), dt,
                forces)

    def _vjp_u0_p(self, u, u0, params, dt, forces, lam):
        """(λᵀ dF/du0, λᵀ dF/dp) of the step from ``u0`` to ``u``."""
        _, pull = torch.func.vjp(
            lambda u0_, p_: self.residual_from_dofs(u, u0_, p_, dt, forces),
            u0, params)
        return pull(lam)

    def float_params(self, parameters: dict | None = None) -> dict:
        """Float parameters for a solve call: the storage's own when
        ``parameters`` is None, else the call's values on the storage's
        device (same float/int key split: the integer tables are closed
        over)."""
        if parameters is None:
            return self.params_f
        out = from_numpy({k: v for k, v in parameters.items()
                          if k in self.params_f}, self.device, self.dtype)
        missing = set(self.params_f) - set(out)
        if missing:
            raise KeyError(f"reused AdjointStorage: missing float "
                           f"parameters {sorted(missing)}")
        return out

    # -- transposed solve --------------------------------------------------
    def _record(self, stats):
        self.lambda_iterations.append(int(stats["iterations"]))
        self.lambda_converged.append(bool(stats["converged"]))

    def solve_transposed(self, blocks, rhs):
        """Solve Jᵀ λ = rhs for rhs (n, ndof) -> λ (n, neq). The forward
        solvers solve A du = −r, hence −rhs for them."""
        comp = self.comp
        n, ndof, neq = comp.n_cells, comp.ndof, comp.neq_total
        if self._stencil is not None:
            from ..ops.stencil import stencil_transpose
            from ..ops.stencil_wells import (
                BorderedStencilMatrix,
                bordered_transpose,
            )

            tr = (bordered_transpose
                  if isinstance(blocks, BorderedStencilMatrix)
                  else stencil_transpose)
            lam, stats = self.linear_solver.solve(tr(blocks),
                                                  -rhs.reshape(n, ndof))
            self._record(stats)
            return lam.reshape(n, neq)
        ell = comp.ell
        if self.linear_solver is not None:
            lam, stats = self.linear_solver.solve(
                BlockELL(ell, ell_transpose(blocks, ell)),
                -rhs.reshape(n, ndof))
            self._record(stats)
            return lam.reshape(n, neq)
        if n * ndof <= self.direct_limit:
            lam = torch.linalg.solve(ell_to_dense(blocks, ell).T,
                                     rhs.reshape(-1))
            return lam.reshape(n, neq)
        from ..linsolve.krylov import gmres

        def matvec(x):
            return ell_rmatvec(blocks, ell, x.reshape(n, neq)).reshape(-1)

        # the sequential MGS formulation, as the JAX package's f64 path
        lam, stats = gmres(matvec, rhs.reshape(-1), rtol=1e-10, maxiter=500,
                           orth="mgs")
        self._record(stats)
        return lam.reshape(n, neq)


def setup_adjoint_storage(model, parameters: dict, forces=None,
                          direct_limit: int = 20_000, linear_solver=None,
                          use_stencil: bool = False, device=None,
                          dtype=None) -> AdjointStorage:
    """Reference-named constructor (gradients.jl:108)."""
    return AdjointStorage(model, parameters, forces=forces,
                          direct_limit=direct_limit,
                          linear_solver=linear_solver,
                          use_stencil=use_stencil, device=device,
                          dtype=dtype)


def _sweep(storage, G, us, u0, params, dts, forces_of, include_state0):
    """The backward recursion over the steps ``us`` (dof states) from
    ``u0``; ``forces_of(n)`` gives step n's forces. λ after the last step
    is zero, so the last step's cross term vanishes and is skipped.
    Returns (float-parameter gradients, the state0 cotangent or None)."""
    model, params_i = storage.model, storage.params_i
    comp = storage.comp

    def g_of(u, params_, dt, n, f):
        state = comp.evaluate_secondaries(
            merge_state(comp.unpack_dofs(u), {**params_i, **params_}))
        return G(model, state, dt, n, f)

    grad_g = torch.func.grad(g_of, argnums=(0, 1))
    grad_p = {k: torch.zeros_like(v) for k, v in params.items()}
    lam_next = None
    for n in range(len(us) - 1, -1, -1):
        u_n = us[n]
        u_prev = us[n - 1] if n > 0 else u0
        f_n = forces_of(n)
        gu, gp = grad_g(u_n, params, dts[n], n, f_n)
        rhs = -gu
        if lam_next is not None:
            du0_bar, _ = storage._vjp_u0_p(us[n + 1], u_n, params,
                                           dts[n + 1], forces_of(n + 1),
                                           lam_next)
            rhs = rhs - du0_bar
        blocks = storage._jac_blocks(u_n, u_prev, params, dts[n], f_n)
        lam = storage.solve_transposed(blocks, rhs)
        del blocks  # the Jacobian is freed before the pull-back's graph
        _, dp_bar = storage._vjp_u0_p(u_n, u_prev, params, dts[n], f_n, lam)
        grad_p = {k: grad_p[k] + gp[k] + dp_bar[k] for k in grad_p}
        lam_next = lam
    du0 = None
    if include_state0:
        du0, _ = storage._vjp_u0_p(us[0], u0, params, dts[0], forces_of(0),
                                   lam_next)
    return grad_p, du0


def _gradients_out(storage, grad_p, du0):
    out = {k: v.detach().cpu().numpy() for k, v in grad_p.items()}
    for k, v in storage.params_i.items():  # zero grads for int params
        out[k] = np.zeros(tuple(v.shape))
    if du0 is not None:
        out["state0"] = du0.detach().cpu().numpy()
    return out


def _forces_for(forces, n):
    if isinstance(forces, list):
        return forces[n]
    return forces


def solve_adjoint_sensitivities(
    model_or_case,
    states: list,
    timesteps_or_reports,
    G: Callable,
    parameters: dict | None = None,
    state0: dict | None = None,
    forces=None,
    include_state0: bool = False,
    linear_solver=None,
    storage: AdjointStorage | None = None,
    use_stencil: bool = False,
    device=None,
    dtype=None,
):
    """∇_p G for G = Σ_n g(model, state_n, dt_n, n, forces)
    (reference gradients.jl:17), as a backward host loop over the steps.

    ``states`` are output states (dicts with at least the primaries, numpy
    arrays or tensors) of the accepted step sequence; ``G(model, state, dt,
    step_no, forces)`` returns a 0-d tensor (the reference's sum-objective
    form, core_types.jl:1582) and may ignore the state, which then gives
    a zero gradient. ``model_or_case`` may be a ``JutulCase`` (its
    schedule, forces, state0 and parameters fill what is not given).
    ``storage`` reuses an ``AdjointStorage`` (its device, dtype and
    λ-solver) with this call's ``parameters``; else one is built on
    ``device``/``dtype``.

    Returns a dict of numpy gradients with the parameter shapes (plus
    ``"state0"``, in dof space (n, ndof), when ``include_state0``)."""
    from ..core.case import JutulCase

    if isinstance(model_or_case, JutulCase):
        case = model_or_case
        model = case.model
        parameters = parameters if parameters is not None \
            else case.parameters
        state0 = state0 if state0 is not None else case.state0
        forces = forces if forces is not None else case.forces
        dts = np.atleast_1d(np.asarray(case.dt, dtype=np.float64))
    else:
        model = model_or_case
        dts = np.atleast_1d(np.asarray(timesteps_or_reports,
                                       dtype=np.float64))
    if parameters is None or state0 is None:
        raise ValueError("parameters and state0 are required")
    if _is_multi(model):
        _multimodel_options(include_state0, linear_solver, storage,
                            use_stencil)
        return solve_adjoint_sensitivities_multimodel(
            model, states, dts, G, parameters, state0, forces,
            device=device, dtype=dtype)
    if storage is None:
        storage = AdjointStorage(model, parameters, forces,
                                 linear_solver=linear_solver,
                                 use_stencil=use_stencil, device=device,
                                 dtype=dtype)
    params = storage.float_params(parameters)
    us = [storage.dofs_of(s) for s in states]
    if len(us) != len(dts):
        raise ValueError(f"{len(us)} states for {len(dts)} timesteps")
    grad_p, du0 = _sweep(storage, G, us, storage.dofs_of(state0), params,
                         [float(d) for d in dts],
                         lambda n: _forces_for(forces, n), include_state0)
    return _gradients_out(storage, grad_p, du0)


def solve_adjoint_sensitivities_jit(
    model,
    states: list,
    timesteps,
    G: Callable,
    parameters: dict | None = None,
    state0: dict | None = None,
    forces=None,
    include_state0: bool = False,
    linear_solver=None,
    storage: AdjointStorage | None = None,
    use_stencil: bool = False,
    device=None,
    dtype=None,
):
    """The whole adjoint sweep as the JAX package's one-program sweep
    (its reversed ``lax.scan``, paired with ``simulate_jit(
    jit_output_states=True)``) computes it, on the host loop of
    ``solve_adjoint_sensitivities``: nothing is traced or compiled here,
    so nothing is cached either.

    Same contract as :func:`solve_adjoint_sensitivities` (no JutulCase),
    with the program's semantics: the timesteps are cast to the states'
    dtype, and per-step forces (a list) must share one structure (same
    force names, types, cells and value shapes), else it raises."""
    if parameters is None or state0 is None:
        raise ValueError("parameters and state0 are required")
    if _is_multi(model):
        _multimodel_options(include_state0, linear_solver, storage,
                            use_stencil)
        return solve_adjoint_sensitivities_multimodel(
            model, states, timesteps, G, parameters, state0, forces,
            device=device, dtype=dtype)
    if storage is None:
        storage = AdjointStorage(model, parameters,
                                 linear_solver=linear_solver,
                                 use_stencil=use_stencil, device=device,
                                 dtype=dtype)
    params = storage.float_params(parameters)
    us = [storage.dofs_of(s) for s in states]
    N = len(us)
    dts = np.atleast_1d(np.asarray(timesteps, dtype=np.float64))
    if N != len(dts):
        raise ValueError(f"{N} states for {len(dts)} timesteps")
    if isinstance(forces, (list, tuple)):
        if len(forces) != N:
            raise ValueError(f"per-step forces: {len(forces)} for {N} steps")
        defs = [force_structure(f) for f in forces]
        if any(d != defs[0] for d in defs[1:]):
            raise NotImplementedError(
                "jit adjoint sweep: per-step forces must share one "
                "structure (same force names/types/cells)")
        forces_of = list(forces).__getitem__
    else:
        forces_of = lambda n: forces  # noqa: E731
    dts = torch.as_tensor(dts).to(storage.dtype).tolist()
    grad_p, du0 = _sweep(storage, G, us, storage.dofs_of(state0), params,
                         dts, forces_of, include_state0)
    return _gradients_out(storage, grad_p, du0)


def solve_numerical_sensitivities(model, states, dts, G, parameters,
                                  state0, forces=None, eps_scale: float = 1e-6,
                                  targets=None, device=None, dtype=None,
                                  **sim_kwargs):
    """Finite-difference gradient checker (reference gradients.jl:700):
    re-simulates with each parameter entry perturbed by ± its relative
    step, O(n_params) runs — for tests. ``states`` is unused (the
    signature is the reference's); extra kwargs go to ``simulate``."""
    from ..simulator.simulator import simulate

    dev = resolve_device(device)
    dtype = dtype or float_type(dev)

    def total_objective(params_np: dict) -> float:
        res = simulate(dict(state0), model, dts, forces=forces,
                       parameters=params_np, info_level=-1, device=dev,
                       dtype=dtype, **sim_kwargs)
        tot = 0.0
        for n, st in enumerate(res.states):
            tot += float(G(model, from_numpy(st, dev, dtype), float(dts[n]),
                           n, _forces_for(forces, n)))
        return tot

    grads = {}
    names = targets if targets is not None else list(parameters)
    for name in names:
        base = np.asarray(parameters[name], dtype=np.float64)
        g = np.zeros_like(base)
        it = np.nditer(base, flags=["multi_index"])
        for _ in it:
            ix = it.multi_index
            # relative perturbation: parameters span ~30 orders of
            # magnitude across units (trans ~1e-11)
            h = eps_scale * abs(base[ix]) if base[ix] != 0 else eps_scale
            pp = {k: np.array(v, dtype=np.float64)
                  for k, v in parameters.items()}
            pp[name][ix] = base[ix] + h
            fp = total_objective(pp)
            pm = {k: np.array(v, dtype=np.float64)
                  for k, v in parameters.items()}
            pm[name][ix] = base[ix] - h
            fm = total_objective(pm)
            g[ix] = (fp - fm) / (2 * h)
        grads[name] = g
    return grads


def solve_adjoint_forces(model, states, dts, G, parameters, state0, forces,
                         device=None, dtype=None):
    """Gradient of G with respect to force VALUES (reference:
    src/ad/force_gradients.jl — vectorize_forces + adjoint; here one
    ``torch.func.vjp`` through the force-application path), on the
    default adjoint storage (the generic engine, as the JAX package).

    Returns the structure of ``forces`` (a forces dict for every step, or
    a list with one per step) whose forces are copies holding gradient
    tensors (detached, on the storage's device) in their value fields
    (``JutulForce.value_fields``): the direct term ∂G/∂f plus the
    λ-pullback, summed over the steps for a dict. Integer fields (cells)
    are left as they are."""
    storage = AdjointStorage(model, parameters, forces, device=device,
                             dtype=dtype)
    comp = storage.comp
    params = storage.params_f
    us = [storage.dofs_of(s) for s in states]
    u0 = storage.dofs_of(state0)
    N = len(us)
    dts = np.atleast_1d(np.asarray(dts, dtype=np.float64))

    def g_of(u, vals, f, dt, n):
        state = comp.evaluate_secondaries(storage._state(u, params))
        return G(model, state, dt, n, with_force_values(f, vals))

    grad_g = torch.func.grad(g_of, argnums=(0, 1))
    per_step = isinstance(forces, list)
    grad_f = [None] * N if per_step else None
    lam_next = None
    for n in range(N - 1, -1, -1):
        u_n = us[n]
        u_prev = us[n - 1] if n > 0 else u0
        dt_n = float(dts[n])
        f_n = _forces_for(forces, n)
        vals = [as_value(v, u0) for v in force_values(f_n)]
        gu, gf_direct = grad_g(u_n, vals, f_n, dt_n, n)
        rhs = -gu
        if lam_next is not None:
            du0_bar, _ = storage._vjp_u0_p(us[n + 1], u_n, params,
                                           float(dts[n + 1]),
                                           _forces_for(forces, n + 1),
                                           lam_next)
            rhs = rhs - du0_bar
        blocks = storage._jac_blocks(u_n, u_prev, params, dt_n, f_n)
        lam = storage.solve_transposed(blocks, rhs)
        del blocks
        _, pull = torch.func.vjp(
            lambda v: storage.residual_from_dofs(
                u_n, u_prev, params, dt_n, with_force_values(f_n, v)), vals)
        (df_bar,) = pull(lam)
        step = [(a + b).detach() for a, b in zip(df_bar, gf_direct)]
        if per_step:
            grad_f[n] = with_force_values(f_n, step)
        else:
            grad_f = step if grad_f is None else [
                a + b for a, b in zip(grad_f, step)]
        lam_next = lam
    return grad_f if per_step else with_force_values(forces, grad_f)


def _multimodel_options(include_state0, linear_solver, storage,
                        use_stencil):
    """The MultiModel adjoint has its own λ-solves and no storage or
    state0 gradient (as in the JAX package): refuse those options."""
    given = [name for name, v in (("include_state0", include_state0),
                                  ("linear_solver", linear_solver),
                                  ("storage", storage),
                                  ("use_stencil", use_stencil)) if v]
    if given:
        raise NotImplementedError(
            f"MultiModel adjoint: {', '.join(given)} not supported (the "
            "coupled λ-solves are solve_adjoint_sensitivities_multimodel's "
            "own)")


def solve_adjoint_sensitivities_multimodel(
    mm, states: list, dts, G: Callable, parameters: dict, state0: dict,
    forces=None, direct_limit: int = 20_000, device=None, dtype=None,
):
    """Discrete adjoint of a MultiModel run (reference:
    src/multimodel/gradients.jl:2-160): the backward recursion with the
    coupled MultiLinearizedSystem transposed — densely up to
    ``direct_limit`` unknowns, else by BiCGStab (rtol 1e-10, 1000
    iterations) on the transposed product with the transposed
    block-diagonal inverse as preconditioner.

    ``states``/``state0``/``parameters`` are dicts model-name -> dict
    (numpy arrays or tensors); ``G(mm, state, dt, n, forces)`` sees the
    nested, secondary-evaluated state and returns a 0-d tensor. Returns
    nested numpy gradients for every parameter (zeros for integer ones).
    """
    from ..multimodel.core import compile_multi_model
    from ..linsolve.krylov import bicgstab
    from ..ops.smallmat import block_inv, bmv

    dev = resolve_device(device)
    dtype = dtype or float_type(dev)
    comp = compile_multi_model(mm)
    lay = comp.layout
    params = from_numpy(parameters, dev, dtype)
    params_f = {m: {k: v for k, v in p.items() if v.is_floating_point()}
                for m, p in params.items()}
    params_i = {m: {k: v for k, v in p.items() if not v.is_floating_point()}
                for m, p in params.items()}
    dts = [float(d) for d in np.atleast_1d(np.asarray(dts, np.float64))]

    def dofs_of(state):
        return {m: comp.comps[m].get_dofs(from_numpy(
            {k: v for k, v in state[m].items()
             if k in mm.models[m].primary_variables}, dev, dtype))
            for m in comp.comps}

    def merge_all(u, p):
        return {m: merge_state(comp.comps[m].unpack_dofs(u[m]),
                               {**params_i[m], **p[m]}) for m in comp.comps}

    def residual_from_dofs(u, u0, p, dt, f):
        return comp.residual(merge_all(u, p), merge_all(u0, p), dt, f)

    def g_of(u, p, dt, n):
        return G(mm, comp.evaluate_secondaries(merge_all(u, p)), dt, n,
                 _forces_for(forces, n))

    def transpose_solve(u_n, u_prev, dt_n, f_n, rhs):
        with torch.no_grad():
            _r, J, _fe = comp.assemble(merge_all(u_n, params_f),
                                       merge_all(u_prev, params_f), dt_n,
                                       f_n)
        b = J.flatten_dofs(rhs)
        if lay.total_dof <= direct_limit:
            return J.unflatten_res(torch.linalg.solve(J.to_dense().T, b))
        dinvT = {m: torch.transpose(block_inv(J.diag[m].blocks[:, 0]), 1, 2)
                 for m in lay.names}

        def precond(v):
            x = J.unflatten_res(v)
            return J.flatten_dofs({m: bmv(dinvT[m], x[m])
                                   for m in lay.names})

        lam, _stats = bicgstab(J.rmatvec_flat, b, maxiter=1000, rtol=1e-10,
                               precond=precond)
        return J.unflatten_res(lam)

    grad_g = torch.func.grad(g_of, argnums=(0, 1))
    u0 = dofs_of(state0)
    us = [dofs_of(s) for s in states]
    if len(us) != len(dts):
        raise ValueError(f"{len(us)} states for {len(dts)} timesteps")
    grad_p = {m: {k: torch.zeros_like(v) for k, v in p.items()}
              for m, p in params_f.items()}
    lam_next = None
    for n in range(len(us) - 1, -1, -1):
        u_n = us[n]
        u_prev = us[n - 1] if n > 0 else u0
        f_n = _forces_for(forces, n)
        gu, gp = grad_g(u_n, params_f, dts[n], n)
        rhs = {m: -v for m, v in gu.items()}
        if lam_next is not None:
            _, pull = torch.func.vjp(
                lambda u0_: residual_from_dofs(
                    us[n + 1], u0_, params_f, dts[n + 1],
                    _forces_for(forces, n + 1)), u_n)
            (du0_bar,) = pull(lam_next)
            rhs = {m: rhs[m] - du0_bar[m] for m in rhs}
        lam = transpose_solve(u_n, u_prev, dts[n], f_n, rhs)
        _, pull = torch.func.vjp(
            lambda p_: residual_from_dofs(u_n, u_prev, p_, dts[n], f_n),
            params_f)
        (dp_bar,) = pull(lam)
        grad_p = {m: {k: grad_p[m][k] + gp[m][k] + dp_bar[m][k]
                      for k in grad_p[m]} for m in grad_p}
        lam_next = lam
    out = {m: {k: v.detach().cpu().numpy() for k, v in g.items()}
           for m, g in grad_p.items()}
    for m, p in params_i.items():
        out[m].update({k: np.zeros(tuple(v.shape)) for k, v in p.items()})
    return out


def state_gradient(model, state, G, parameters, dt: float = 1.0,
                   step_no: int = 0, forces=None, device=None, dtype=None):
    """dG/d(primary state) for a single state (reference export
    ``state_gradient``). Returns a dict of per-variable numpy gradients in
    VALUE space."""
    dev = resolve_device(device)
    dtype = dtype or float_type(dev)
    comp = compile_model(model)
    params = from_numpy(parameters, dev, dtype)

    def g_of(prim):
        full = comp.evaluate_secondaries(merge_state(prim, params))
        return G(model, full, dt, step_no, forces)

    prim = from_numpy({k: v for k, v in state.items()
                       if k in model.primary_variables}, dev, dtype)
    grads = torch.func.grad(g_of)(prim)
    return {k: v.detach().cpu().numpy() for k, v in grads.items()}
