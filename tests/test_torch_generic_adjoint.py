"""The port's discrete adjoint on the generic block-ELL engine (the default,
``use_stencil=False``) against the JAX package's, at f64 on the CPU.

The same numpy forward states (one f64 forward of the port's default
engine, tight, one ministep per report step) go to both adjoints. Covered:

- the bench flagship with source-term wells at 8x8x6 (2 report steps of
  1.5 h with the rate ramp): ``solve_transposed`` in its direct branch and
  its Krylov branch (ILU(0)-BiCGStab on the transposed BlockELL, λ at rtol
  1e-14, as bench.py's ``BENCH_ADJ_STENCIL=0`` solver), λ against the JAX
  package's on the same blocks and right-hand side; the Transmissibilities,
  FluidVolume and state0 gradients of ``solve_adjoint_sensitivities``
  (direct branch) against the JAX package's, with ``_jit`` equal to the
  host loop bit for bit;
- the MGS-GMRES branch (``direct_limit=0``) on a transient Poisson case;
- tests/test_torch_generic_adjoint_wells.py has the 10x10x6 well model in
  the direct and Krylov branches, tests/test_torch_force_gradients.py
  ``solve_adjoint_forces`` and ``solve_adjoint_generic``.

The gradients' bar is 1e-9 relative in every branch. The direct branch
cannot be held closer: PyTorch's LAPACK and the one JAX and numpy share
solve the same dense f64 transpose ~2e-11 apart at its condition number
(~5e10), which the sweep turns into gradients ~1e-10 apart (7.8e-11 here,
1.6e-10 on the 10x10x6 well model).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import bench
import chip_smoke
import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu.adjoint import gradients as jgrad
from jutul.jl_tpu_torch.adjoint import gradients as tgrad

TIGHT = dict(tolerances={"mass_conservation/CNV": 1e-8,
                         "mass_conservation/MB": 1e-10},
             max_nonlinear_iterations=40, info_level=-1)
BAR = 1e-9


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def krylov(pkg, rtol=1e-14):
    return pkg.GenericKrylov("bicgstab", pkg.ILU0Preconditioner(), rtol=rtol,
                             max_iterations=2000)


def G_sat(pkg, nc):
    xp = jnp if pkg is jpkg else torch

    def G(model, state, dt, n, forces):
        return dt * xp.sum(state["Saturations"][:, 0] ** 2) / nc
    return G


class AdjointCase:
    """Both packages' model, state0, parameters and per-step forces, and
    the numpy states of one tight f64 forward of the port's default
    engine."""

    def __init__(self, dims, well_models):
        self.nc = int(np.prod(dims))
        jm, _, jst, jpr, jf = bench.build(*dims, gravity=True, wells=True,
                                          well_models=well_models)
        build = (chip_smoke.build_well_flagship if well_models
                 else chip_smoke.build_flagship)
        tm, tst, tpr, tf = build(*dims)
        self.dts = [chip_smoke.ADJ_DT] * 2
        self.j = (jm, jst, jpr, chip_smoke.rate_schedule(jf, 2))
        self.t = (tm, tst, tpr, chip_smoke.rate_schedule(tf, 2))
        res = tpkg.simulate(tst, tm, self.dts, forces=self.t[3],
                            parameters=tpr, device="cpu", **TIGHT)
        assert [len(r["ministeps"]) for r in res.reports] == [1, 1]
        self.states = res.states

    def jax_gradients(self, **kw):
        jm, jst, jpr, jf = self.j
        return jgrad.solve_adjoint_sensitivities(
            jm, self.states, self.dts, G_sat(jpkg, self.nc), parameters=jpr,
            state0=jst, forces=jf, include_state0=True,
            storage=jgrad.AdjointStorage(jm, jpr, **kw))

    def port_gradients(self, storage, jit=False):
        tm, tst, tpr, tf = self.t
        fn = (tgrad.solve_adjoint_sensitivities_jit if jit
              else tgrad.solve_adjoint_sensitivities)
        return fn(tm, self.states, self.dts, G_sat(tpkg, self.nc),
                  parameters=tpr, state0=tst, forces=tf, include_state0=True,
                  storage=storage)


def assert_gradients(got, want, what):
    for k in ("Transmissibilities", "FluidVolume", "state0"):
        assert rel(got[k], want[k]) <= BAR, (what, k, rel(got[k], want[k]))


@pytest.fixture(scope="module")
def flagship():
    return AdjointCase((8, 8, 6), well_models=False)


def _step_system(case, pkg_storage, jax_storage):
    """Step 1's Jacobian in both packages and a seeded right-hand side."""
    jm, _, _, jf = case.j
    ts, js = pkg_storage, jax_storage
    u1, u0 = (ts.dofs_of(case.states[i]) for i in (1, 0))
    ju1, ju0 = (js.comp.get_dofs({k: jnp.asarray(v) for k, v in
                                  case.states[i].items()
                                  if k in jm.primary_variables})
                for i in (1, 0))
    rhs = np.random.default_rng(4).normal(size=tuple(u1.shape))
    tb = ts._jac_blocks(u1, u0, ts.params_f, case.dts[1], case.t[3][1])
    jb = js._jac_blocks(ju1, ju0, js.params_f, case.dts[1], jf[1])
    return tb, jb, rhs


@pytest.mark.parametrize("branch", ["direct", "krylov"])
def test_solve_transposed_matches_jax(flagship, branch):
    tm, _, tpr, _ = flagship.t
    jm, _, jpr, _ = flagship.j
    kw = {"direct": ({}, {}), "krylov": (dict(linear_solver=krylov(tpkg)),
                                         dict(linear_solver=krylov(jpkg)))}
    ts = tgrad.AdjointStorage(tm, tpr, device="cpu", **kw[branch][0])
    js = jgrad.AdjointStorage(jm, jpr, **kw[branch][1])
    tb, jb, rhs = _step_system(flagship, ts, js)
    lam_t = ts.solve_transposed(tb, torch.as_tensor(rhs)).numpy()
    lam_j = np.asarray(js.solve_transposed(jb, jnp.asarray(rhs)))
    assert rel(lam_t, lam_j) <= BAR
    if branch == "krylov":
        assert ts.lambda_converged == [True]
    else:
        assert ts.lambda_iterations == []
    # Jᵀ λ = rhs: the transposed BlockELL's product gives it back
    J = tpkg.BlockELL(ts.comp.ell, tb)
    back = J.rmatvec(torch.as_tensor(lam_t)).numpy()
    assert rel(back, rhs) <= 1e-8


def test_flagship_gradients_match_jax(flagship):
    """The direct branch's gradients; ``_jit`` equals the host loop."""
    tm, _, tpr, _ = flagship.t
    storage = tgrad.AdjointStorage(tm, tpr, device="cpu")
    host = flagship.port_gradients(storage)
    assert_gradients(host, flagship.jax_gradients(), "direct")
    jit = flagship.port_gradients(storage, jit=True)
    for k in host:
        np.testing.assert_array_equal(jit[k], host[k])


def _poisson(pkg, nx):
    model = pkg.SimulationModel(
        pkg.DataDomain(pkg.CartesianMesh((nx,), (1.0,)),
                       poisson_coefficient=1.0),
        pkg.VariablePoissonSystem(time_dependent=True))
    forces = pkg.setup_forces(model, sources=[pkg.PoissonSource(0, 1.0),
                                              pkg.PoissonSource(nx - 1,
                                                                -1.0)])
    params = pkg.setup_parameters(model)
    params["K"] = np.linspace(1.0, 3.0, nx - 1)
    return model, pkg.setup_state(model, U=0.0), params, forces


def test_mgs_branch_matches_jax():
    """The MGS-GMRES branch (``direct_limit=0``) on a transient Poisson
    case of 40 cells, where its unpreconditioned GMRES converges (on the
    8x8x6 flagship it stops at its 500 iterations in both packages,
    unconverged, and their gradients part at 3e-5): the JAX package's
    gradients and the direct branch's."""
    dts = [0.3, 0.7]
    out = {}
    for pkg in (jpkg, tpkg):
        xp = jnp if pkg is jpkg else torch
        kw = {} if pkg is jpkg else dict(device="cpu")
        model, st, pr, f = _poisson(pkg, 40)
        if pkg is jpkg:
            states = [{k: np.asarray(v) for k, v in s.items()}
                      for s in jpkg.simulate(st, model, dts, forces=f,
                                             parameters=pr,
                                             info_level=-1).states]

        def G(model_, state, dt, n, forces_, xp=xp):
            return dt * xp.sum(state["U"] ** 2)

        storage = pkg.AdjointStorage(model, pr, direct_limit=0, **kw)
        out[pkg] = pkg.solve_adjoint_sensitivities(
            model, states, dts, G, parameters=pr, state0=st, forces=f,
            include_state0=True, storage=storage)
        if pkg is tpkg:
            assert storage.lambda_converged == [True] * len(dts)
            direct = tpkg.solve_adjoint_sensitivities(
                model, states, dts, G, parameters=pr, state0=st, forces=f,
                include_state0=True, device="cpu")
    for k in ("K", "state0"):
        assert rel(out[tpkg][k], out[jpkg][k]) <= BAR, k
        assert rel(out[tpkg][k], direct[k]) <= BAR, k
