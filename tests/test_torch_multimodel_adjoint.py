"""The port's MultiModel adjoint (``solve_adjoint_sensitivities`` on a
MultiModel, ``solve_adjoint_sensitivities_multimodel``) against the JAX
package's, on the CPU at f64: the three cases of
tests/test_multimodel_adjoint.py, on the same states (the JAX package's
forward run) and the same G. Gradients within 1e-9 of the JAX package's,
through the dense transposed solve and through the iterative one
(``direct_limit=0``: BiCGStab on the transposed product); the port's
against its own central differences at the JAX test's bars.
"""

import copy
import importlib

import jax.numpy as jnp
import numpy as np
import torch

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu.adjoint.gradients import (
    solve_adjoint_sensitivities_multimodel as jadj_mm,
)
from jutul.jl_tpu.multimodel import core as jmm
from jutul.jl_tpu_torch.adjoint.gradients import (
    solve_adjoint_sensitivities_multimodel as tadj_mm,
)
from jutul.jl_tpu_torch.multimodel import core as tmm

TIGHT = dict(info_level=-1, tolerances={"default": 1e-12},
             max_nonlinear_iterations=20)


class JUCoupling(jmm.CrossTerm):
    symmetric = True

    def value(self, model_t, model_s, lt, ls, dt):
        return jnp.reshape(2.0 * (lt["U"] - ls["U"]), (1,))


class TUCoupling(tpkg.CrossTerm):
    symmetric = True

    def value(self, model_t, model_s, lt, ls, dt):
        return (2.0 * (lt["U"] - ls["U"]))[..., None]


def poisson_case(pkg, nx=3):
    sys = pkg.VariablePoissonSystem(time_dependent=True)

    def mk():
        return pkg.SimulationModel(pkg.DataDomain(
            pkg.CartesianMesh((nx,), (1.0,)), poisson_coefficient=1.0), sys)

    mA, mB = mk(), mk()
    mm = (jmm.MultiModel if pkg is jpkg else tpkg.MultiModel)(
        {"A": mA, "B": mB})
    mm.add_cross_term(JUCoupling() if pkg is jpkg else TUCoupling(),
                      target="A", source="B", equation="poisson",
                      target_cells=[nx - 1], source_cells=[0])
    state0 = {"A": pkg.setup_state(mA, U=0.0), "B": pkg.setup_state(mB, U=0.0)}
    params = {"A": pkg.setup_parameters(mA), "B": pkg.setup_parameters(mB)}
    forces = {"A": pkg.setup_forces(mA, sources=[pkg.PoissonSource(0, 1.0)]),
              "B": pkg.setup_forces(mB, sources=[
                  pkg.PoissonSource(nx - 1, -1.0)])}
    return mm, state0, params, forces


def G_poisson(pkg):
    if pkg is jpkg:
        return lambda mm, s, dt, n, f: dt * (
            jnp.sum(s["A"]["U"] ** 2) + 0.5 * jnp.sum(s["B"]["U"] ** 2))
    return lambda mm, s, dt, n, f: dt * (
        torch.sum(s["A"]["U"] ** 2) + 0.5 * torch.sum(s["B"]["U"] ** 2))


def forward(pkg, mm, state0, params, forces, dts):
    kw = {} if pkg is jpkg else dict(device="cpu")
    res = pkg.Simulator(mm, state0=state0, parameters=params,
                        **kw).simulate(dts, forces=forces, **TIGHT)
    assert all(r["success"] for r in res.reports)
    return res.states


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.max(np.abs(b))
    return np.max(np.abs(a - b)) / scale if scale > 0 else np.max(np.abs(a))


def assert_grads_close(gt, gj, tol=1e-9):
    assert set(gt) == set(gj)
    for m in gj:
        for k in gj[m]:
            assert np.shape(gt[m][k]) == np.shape(gj[m][k]), (m, k)
            assert _rel(gt[m][k], gj[m][k]) <= tol, (m, k)


def test_multimodel_adjoint_vs_jax_and_fd():
    dts = [0.5, 0.5]
    cases = {pkg: poisson_case(pkg) for pkg in (jpkg, tpkg)}
    states = forward(jpkg, *cases[jpkg], dts)
    mm_j, st0_j, pr_j, f_j = cases[jpkg]
    gj = jpkg.solve_adjoint_sensitivities(mm_j, states, dts,
                                          G_poisson(jpkg), parameters=pr_j,
                                          state0=st0_j, forces=f_j)
    mm_t, st0_t, pr_t, f_t = cases[tpkg]
    gt = tpkg.solve_adjoint_sensitivities(mm_t, states, dts,
                                          G_poisson(tpkg), parameters=pr_t,
                                          state0=st0_t, forces=f_t,
                                          device="cpu")
    assert_grads_close(gt, gj)
    # the port's gradient is the derivative of the port's forward
    G = G_poisson(tpkg)

    def total(p):
        sts = forward(tpkg, mm_t, st0_t, p, f_t, dts)
        return sum(float(G(mm_t, tpkg.from_numpy(st, "cpu", torch.float64),
                           dts[i], i, None)) for i, st in enumerate(sts))

    for m in ("A", "B"):
        base = np.asarray(pr_t[m]["K"], dtype=np.float64)
        for i in range(base.size):
            h = 1e-6 * max(abs(base[i]), 1.0)
            pp, pm = copy.deepcopy(pr_t), copy.deepcopy(pr_t)
            pp[m]["K"] = base.copy()
            pp[m]["K"][i] += h
            pm[m]["K"] = base.copy()
            pm[m]["K"][i] -= h
            fd = (total(pp) - total(pm)) / (2 * h)
            assert np.isclose(gt[m]["K"][i], fd, rtol=1e-4, atol=1e-10)


def darcy_case(pkg, trans_L=None, n=3):
    D = importlib.import_module(pkg.__name__ + ".models.darcy")
    DAY, BAR, DARCY = pkg.si_units("day", "bar", "darcy")

    def mk():
        return D.setup_darcy_model(pkg.CartesianMesh((n,), (float(n),)),
                                   D.ImmiscibleFluid(viscosities=(1e-3, 2e-3)),
                                   permeability=1.0 * DARCY, porosity=0.25)

    left, right = mk(), mk()
    mm = (jmm.MultiModel if pkg is jpkg else tpkg.MultiModel)(
        {"L": left, "R": right})
    params = {"L": pkg.setup_parameters(left),
              "R": pkg.setup_parameters(right)}
    if trans_L is not None:
        params["L"]["Transmissibilities"] = np.asarray(trans_L)
    T_conn = float(params["L"]["Transmissibilities"][0])
    mm.add_cross_term(D.DarcyTransferCrossTerm([T_conn]), target="L",
                      source="R", equation="mass_conservation",
                      target_cells=[n - 1], source_cells=[0])
    state0 = {"L": pkg.setup_state(left, Pressure=110 * BAR,
                                   Saturations=[0.4, 0.6]),
              "R": pkg.setup_state(right, Pressure=100 * BAR,
                                   Saturations=[0.3, 0.7])}
    q = np.zeros((1, 2))
    q[0, 0] = 0.01
    forces = {"L": {"src": D.PhaseSourceTerm([0], q)}, "R": None}
    return mm, state0, params, forces, [0.1 * DAY, 0.2 * DAY]


def test_coupled_darcy_adjoint_vs_jax_and_fd():
    """Gradients through a ``DarcyTransferCrossTerm`` (per-connection
    ``conn_data`` in the Jacobian path) against the JAX package's, and one
    transmissibility against the port's central difference (the JAX
    test's bar, rtol 2e-3)."""
    def G(pkg):
        lib = jnp if pkg is jpkg else torch
        return lambda mm, s, dt, n, f: dt * lib.sum(
            (s["R"]["Pressure"] / 1e5) ** 2)

    mm_j, st0_j, pr_j, f_j, dts = darcy_case(jpkg)
    states = forward(jpkg, mm_j, st0_j, pr_j, f_j, dts)
    gj = jpkg.solve_adjoint_sensitivities(mm_j, states, dts, G(jpkg),
                                          parameters=pr_j, state0=st0_j,
                                          forces=f_j)
    mm_t, st0_t, pr_t, f_t, _ = darcy_case(tpkg)
    gt = tpkg.solve_adjoint_sensitivities(mm_t, states, dts, G(tpkg),
                                          parameters=pr_t, state0=st0_t,
                                          forces=f_t, device="cpu")
    assert_grads_close(gt, gj)

    def total(trans_L):
        mm, s0, p, f, _ = darcy_case(tpkg, trans_L)
        sts = forward(tpkg, mm, s0, p, f, dts)
        return sum(float(G(tpkg)(mm, tpkg.from_numpy(st, "cpu",
                                                     torch.float64),
                                 dts[i], i, None))
                   for i, st in enumerate(sts))

    base = np.asarray(pr_t["L"]["Transmissibilities"], dtype=np.float64)
    i = 1  # [0] also seeds the connection's transmissibility
    h = 1e-6 * abs(base[i])
    tp, tm = base.copy(), base.copy()
    tp[i] += h
    tm[i] -= h
    fd = (total(tp) - total(tm)) / (2 * h)
    assert np.isclose(gt["L"]["Transmissibilities"][i], fd, rtol=2e-3)


def test_multimodel_adjoint_iterative_transpose_matches_dense():
    """Past ``direct_limit`` the coupled transpose solve is matrix-free
    (BiCGStab on ``MultiLinearizedSystem.rmatvec``): within the JAX
    test's bar of the dense path, and each path within 1e-9 of the JAX
    package's same path. The transposed product equals
    ``torch.func.vjp`` of the product (the JAX package transposes its
    matvec with ``jax.linear_transpose``)."""
    dts = [0.5, 0.5]
    mm_j, st0_j, pr_j, f_j = poisson_case(jpkg, nx=6)
    states = forward(jpkg, mm_j, st0_j, pr_j, f_j, dts)
    mm_t, st0_t, pr_t, f_t = poisson_case(tpkg, nx=6)
    out = {}
    for limit in (20_000, 0):
        gj = jadj_mm(mm_j, states, dts, G_poisson(jpkg), pr_j, st0_j, f_j,
                     direct_limit=limit)
        gt = tadj_mm(mm_t, states, dts, G_poisson(tpkg), pr_t, st0_t, f_t,
                     direct_limit=limit, device="cpu")
        assert_grads_close(gt, gj)
        out[limit] = gt
    for m in out[0]:
        for k in out[0][m]:
            a, b = out[20_000][m][k], out[0][m][k]
            scale = max(np.abs(a).max(), 1e-30)
            np.testing.assert_allclose(b, a, atol=1e-7 * scale)
    # rmatvec is the transpose of matvec
    cm = tmm.compile_multi_model(mm_t)
    st = tpkg.from_numpy({m: {**states[0][m], **pr_t[m]} for m in pr_t},
                         "cpu", torch.float64)
    _, J, _ = cm.assemble(st, st, 0.5, f_t)
    y = torch.randn(J.layout.total_res, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    x0 = torch.zeros(J.layout.total_dof, dtype=torch.float64)
    _, pull = torch.func.vjp(J.matvec_flat, x0)
    assert torch.allclose(J.rmatvec_flat(y), pull(y)[0], rtol=1e-14,
                          atol=1e-14)
