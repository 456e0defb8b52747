"""The port's optimization harness against the JAX package, on the CPU.

- ``unit_box_bfgs``, ``lbfgsb_optimize`` and ``box_trust_region`` (numpy in
  both packages, the port's a copy) give the JAX package's iterates bit for
  bit — every point ``f_and_g`` is asked for, the returned value and point,
  and the history — on the problems of tests/test_optimization.py:26-62,
  113-124, 196-245 and tests/test_trust_region.py:9-44;
- ``ParameterOptimization.F_and_dF`` on the 5x4x3 Darcy lattice of
  tests/test_adjoint.py:362 (transmissibilities as targets, log-scaled in
  the unit box, an L2 saturation misfit): the gradient matches central
  differences of ``F`` in the unit box (relative 2e-4, as the JAX
  package's own test), and value and gradient match the JAX package's
  ``F_and_dF`` (its generic forward and adjoint) to 1e-6; the forward run
  and the adjoint storage are cached;
- ``JutulCase`` indexing.
"""

import importlib

import numpy as np
import pytest

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from test_torch_adjoint import lattice_case, solver

LBFGS = ("jutul.jl_tpu.adjoint.lbfgs", "jutul.jl_tpu_torch.adjoint.lbfgs")
TR = ("jutul.jl_tpu.adjoint.trust_region",
      "jutul.jl_tpu_torch.adjoint.trust_region")


def _quad(c):
    def fg(x):
        return float(np.sum((x - c) ** 2)), 2 * (x - c)
    return fg


def _rosenbrock(x):
    a, b = x[0] / 0.7, x[1] / 0.49
    f = (1 - a) ** 2 + 100 * (b - a * a) ** 2
    g = np.array([(-2 * (1 - a) - 400 * a * (b - a * a)) / 0.7,
                  200 * (b - a * a) / 0.49])
    return f, g


PROBLEMS = {
    "bfgs_quadratic": (LBFGS, "unit_box_bfgs", _quad(
        np.array([0.3, 0.7, 0.5, 0.9])), np.full(4, 0.1),
        dict(max_iterations=100)),
    "bfgs_active_bounds": (LBFGS, "unit_box_bfgs", _quad(
        np.array([-0.5, 1.5])), np.array([0.5, 0.5]), {}),
    "bfgs_lin_eq": (LBFGS, "unit_box_bfgs", _quad(np.array([0.7, 0.1, 0.4])),
                    np.full(3, 1.0 / 3),
                    dict(lin_eq=(np.ones((1, 3)), np.array([1.0])),
                         grad_tol=1e-10)),
    "bfgs_lin_ineq": (LBFGS, "unit_box_bfgs", _quad(np.array([0.6, 0.6])),
                      np.array([0.1, 0.1]),
                      dict(lin_ineq=(np.ones((1, 2)), np.array([0.5])),
                           grad_tol=1e-10)),
    "bfgs_infeasible_start": (LBFGS, "unit_box_bfgs",
                              lambda x: (np.sum(x ** 2), 2.0 * x),
                              np.array([0.9, 0.9]),
                              dict(lin_eq=(np.ones((1, 2)), np.array([1.0])),
                                   grad_tol=1e-10)),
    "lbfgsb_quadratic": (LBFGS, "lbfgsb_optimize", _quad(
        np.array([0.3, 0.7, -0.2])), np.full(3, 0.5), {}),
    "tr_rosenbrock": (TR, "box_trust_region", _rosenbrock,
                      np.array([0.1, 0.9]),
                      dict(max_iterations=300, grad_tol=1e-10)),
    "tr_active_bounds": (TR, "box_trust_region", _quad(
        np.array([1.5, -0.3, 0.4])), np.full(3, 0.5),
        dict(max_iterations=100)),
    "tr_maximize": (TR, "box_trust_region", _quad(
        np.array([1.5, -0.3, 0.4])), np.full(3, 0.5),
        dict(maximize=True, max_iterations=100)),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_optimizers_match_jax_bit_for_bit(name):
    modules, fn_name, fg, x0, kw = PROBLEMS[name]
    runs = []
    for mod in modules:
        asked = []

        def logged(x):
            asked.append(np.array(x))
            return fg(x)

        fn = getattr(importlib.import_module(mod), fn_name)
        v, x, hist = fn(x0.copy(), logged, **kw)
        runs.append((v, x, hist, asked))
    (vj, xj, hj, aj), (vt, xt, ht, at) = runs
    assert len(at) == len(aj) >= 1
    for a, b in zip(at, aj):
        np.testing.assert_array_equal(a, b)
    assert vt == vj
    np.testing.assert_array_equal(xt, xj)
    assert (ht.values, ht.grad_norms, ht.steps) == (hj.values, hj.grad_norms,
                                                    hj.steps)


def test_infeasible_start_refused_without_repair():
    from jutul.jl_tpu_torch.adjoint.lbfgs import unit_box_bfgs

    with pytest.raises(ValueError, match="infeasible"):
        unit_box_bfgs(np.array([0.9, 0.9]), lambda x: (np.sum(x ** 2), 2 * x),
                      lin_eq=(np.ones((1, 2)), np.array([1.0])),
                      enforce_feasible=False)


# ---------------------------------------------------------------------------
# ParameterOptimization on a Darcy lattice
# ---------------------------------------------------------------------------
TIGHT = dict(tolerances={"mass_conservation": 1e-10},
             max_nonlinear_iterations=30)
DTS = [0.2 * 86400.0, 0.3 * 86400.0]


def _misfit_setup(pkg, obs):
    model, state0, params, forces = lattice_case(pkg)
    case = pkg.JutulCase(model, DTS, forces, state0=state0,
                         parameters=params)
    objectives = importlib.import_module(pkg.__name__
                                         + ".adjoint.objectives")
    opt_mod = importlib.import_module(pkg.__name__ + ".adjoint.optimization")
    G = objectives.l2_misfit_objective({"Saturations": obs})
    kw = dict(TIGHT)
    if pkg is tpkg:
        kw.update(device="cpu", use_stencil=True, linear_solver=solver(tpkg),
                  adjoint_linear_solver=solver(tpkg))
    return opt_mod.setup_parameter_optimization(
        case, G, targets=["Transmissibilities"], **kw)


@pytest.fixture(scope="module")
def optimization():
    """Observations from the port at transmissibilities x1.5; both
    packages' closures at the case's own, and the JAX package's value and
    gradient there."""
    model, state0, params, forces = lattice_case(tpkg)
    truth = dict(params)
    truth["Transmissibilities"] = 1.5 * params["Transmissibilities"]
    res = tpkg.simulate(state0, model, DTS, forces=forces, parameters=truth,
                        use_stencil=True, device="cpu", info_level=-1,
                        linear_solver=solver(tpkg), **TIGHT)
    obs = [s["Saturations"] for s in res.states]
    jopt = _misfit_setup(jpkg, obs)
    topt = _misfit_setup(tpkg, obs)
    x0 = topt.x0()
    np.testing.assert_array_equal(x0, jopt.x0())
    return topt, x0, jopt.F_and_dF(x0)


def test_parameter_optimization_matches_jax(optimization):
    topt, x0, (vj, gj) = optimization
    v, g = topt.F_and_dF(x0)
    assert v > 0 and np.isclose(v, vj, rtol=1e-6, atol=0)
    assert g.shape == x0.shape
    assert np.abs(g - gj).max() <= 1e-6 * np.abs(gj).max()


def test_parameter_optimization_gradient_matches_fd(optimization):
    """Central differences in the unit box on three entries; a repeated
    point reuses the cached forward run, and the adjoint storage is built
    once."""
    topt, x0, _ = optimization
    v0, g0 = topt.F_and_dF(x0)
    runs = topt.evaluations
    assert topt.F(x0) == v0 and topt.evaluations == runs
    storage = topt._adj_storage
    assert storage is not None
    h = 1e-5
    for i in np.argsort(-np.abs(g0))[:3]:
        xp, xm = x0.copy(), x0.copy()
        xp[i] += h
        xm[i] -= h
        fd = (topt.F(xp) - topt.F(xm)) / (2 * h)
        assert np.isclose(g0[i], fd, rtol=2e-4, atol=0), (i, g0[i], fd)
    topt.dF(xp)
    assert topt._adj_storage is storage


def test_jutul_case_indexing():
    model, state0, params, forces = lattice_case(tpkg)
    sched = [forces, forces, forces]
    case = tpkg.JutulCase(model, [1.0, 2.0, 3.0], sched, state0=state0,
                          parameters=params)
    assert len(case) == 3 and case.total_time() == 6.0
    sub = case[1:]
    np.testing.assert_array_equal(sub.dt, [2.0, 3.0])
    assert sub.forces == sched[1:] and sub.state0 is state0
    one = case[2]
    assert len(one) == 1 and one.dt[0] == 3.0 and one.forces == [forces]
    const = tpkg.JutulCase(model, [1.0, 2.0], forces)
    assert const[0].forces is forces
    assert set(const.state0) == set(model.primary_variables)
    assert set(const.parameters) == set(model.parameters)
    with pytest.raises(ValueError, match="forces list length"):
        tpkg.JutulCase(model, [1.0, 2.0], sched)
