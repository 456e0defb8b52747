"""The port's defaults are the JAX package's: with no engine and no solver
argument, ``Simulator``, ``simulate``, ``AdjointStorage``,
``solve_adjoint_sensitivities`` and ``setup_parameter_optimization`` run
the same engine (the generic block-ELL engine) and the same default
solver (``DirectSolver``) as the JAX package, on the CPU at f64.

Cases: the 1-D 12-cell two-phase case of examples/history_match.py and
the bench flagship with source-term wells at 8x8x6. Each asserts the same
engine and default solver class of ``Simulator``; ``simulate`` with its
defaults takes equal Newton counts and ministep dts and reaches states
within 1e-12 relative; ``AdjointStorage(model, params)`` picks the same
λ-solve branch (direct, Krylov or MGS-GMRES).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg

DAY = tpkg.si_unit("day")
BAR = tpkg.si_unit("bar")
DARCY = tpkg.si_unit("darcy")
DT = 6 * 3600.0


def history_match_case(pkg, n=12):
    """examples/history_match.py:38-49's case, in ``pkg``."""
    D = importlib.import_module(pkg.__name__ + ".models.darcy")
    mesh = pkg.CartesianMesh((n,), (float(n),))
    model = D.setup_darcy_model(mesh, D.ImmiscibleFluid(
        viscosities=(1e-3, 2e-3)), permeability=1.0 * DARCY, porosity=0.25)
    state0 = pkg.setup_state(model, Pressure=100 * BAR,
                             Saturations=[0.3, 0.7])
    params = pkg.setup_parameters(model)
    forces = {"src": D.PhaseSourceTerm([0], np.array([[0.02, 0.0]]))}
    return model, state0, params, forces, [0.5 * DAY] * 4


def flagship_case(pkg):
    """The bench flagship with source-term wells at 8x8x6, two 6 h steps."""
    if pkg is jpkg:
        model, _, st, pr, f = bench.build(8, 8, 6, gravity=True, wells=True,
                                          well_models=False)
    else:
        model, st, pr, f = chip_smoke.build_flagship(8, 8, 6)
    return model, st, pr, f, [DT] * 2


CASES = {"history_match_1d": history_match_case, "flagship_8x8x6":
         flagship_case}


def _kw(pkg):
    return {} if pkg is jpkg else dict(device="cpu", dtype=torch.float64)


def _counts(res):
    return [(m["dt"], m["iterations"], m["success"])
            for r in res.reports for m in r["ministeps"]]


def _assert_states(js, ts, tol=1e-12):
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        for k, v in a.items():
            v = np.asarray(v)
            scale = max(float(np.max(np.abs(v))), 1e-300)
            assert np.max(np.abs(np.asarray(b[k]) - v)) <= tol * scale, k


def lambda_branch(storage):
    """Which λ-solve ``solve_transposed`` runs (read off the same
    attributes in both packages)."""
    if storage._stencil is not None:
        return "stencil"
    if storage.linear_solver is not None:
        return "krylov"
    comp = storage.comp
    return ("direct" if comp.n_cells * comp.ndof <= storage.direct_limit
            else "mgs")


@pytest.mark.parametrize("name", sorted(CASES))
def test_simulator_default_engine_and_solver(name):
    out = {}
    for pkg in (jpkg, tpkg):
        model, st, pr, f, dts = CASES[name](pkg)
        sim = pkg.Simulator(model, state0=st, parameters=pr, **_kw(pkg))
        out[pkg] = (sim._stencil is None, type(sim._default_solver()).__name__)
    assert out[tpkg] == out[jpkg] == (True, "DirectSolver")


@pytest.mark.parametrize("name", sorted(CASES))
def test_simulate_default_matches_jax(name):
    out = {}
    for pkg in (jpkg, tpkg):
        model, st, pr, f, dts = CASES[name](pkg)
        out[pkg] = pkg.simulate(st, model, dts, forces=f, parameters=pr,
                                info_level=-1, **_kw(pkg))
    assert all(r["success"] for r in out[tpkg].reports)
    assert _counts(out[tpkg]) == _counts(out[jpkg])
    _assert_states(out[jpkg].states, out[tpkg].states)


@pytest.mark.parametrize("name", sorted(CASES))
def test_adjoint_storage_default_branch(name):
    branches = {}
    for pkg in (jpkg, tpkg):
        model, _, pr, _, _ = CASES[name](pkg)
        storage = pkg.AdjointStorage(model, pr, **_kw(pkg))
        branches[pkg] = lambda_branch(storage)
    assert branches[tpkg] == branches[jpkg] == "direct"


def test_adjoint_and_optimization_defaults_match_jax():
    """``solve_adjoint_sensitivities`` (also in its ``JutulCase`` form) and
    ``setup_parameter_optimization`` with their defaults on the 1-D case:
    the JAX package's gradient on the
    same numpy states, and its ``F_and_dF`` (each package's own forward),
    to 1e-8. Both run direct λ-solves whose dense transposes have a
    condition number of ~5e10 here: PyTorch's LAPACK and the one JAX and
    numpy share solve such a system ~2e-11 apart, which the sweep turns
    into gradients ~1e-9 apart."""
    jm, jst, jpr, jf, dts = history_match_case(jpkg)
    states = [{k: np.asarray(v) for k, v in s.items()} for s in jpkg.simulate(
        jst, jm, dts, forces=jf, parameters=jpr, info_level=-1).states]
    obs = [1.01 * s["Pressure"] for s in states]
    grads, fdf = {}, {}
    for pkg in (jpkg, tpkg):
        xp = jnp if pkg is jpkg else torch
        model, st, pr, f, dts = history_match_case(pkg)

        def G(model_, state, dt, n, forces_, xp=xp):
            d = (state["Pressure"] - xp.asarray(obs[n])) / BAR
            return dt * xp.sum(d * d)

        grads[pkg] = pkg.solve_adjoint_sensitivities(
            model, states, dts, G, parameters=pr, state0=st, forces=f,
            **_kw(pkg))
        opt = pkg.setup_parameter_optimization(
            pkg.JutulCase(model, dts, f, state0=st, parameters=pr), G,
            targets=["Transmissibilities"], **_kw(pkg))
        fdf[pkg] = opt.F_and_dF(opt.x0())
        # the JutulCase form fills parameters, state0, forces and dts
        case_grads = pkg.solve_adjoint_sensitivities(
            pkg.JutulCase(model, dts, f, state0=st, parameters=pr), states,
            None, G, **_kw(pkg))
        for k in ("Transmissibilities", "FluidVolume"):
            np.testing.assert_array_equal(case_grads[k], grads[pkg][k])
    for k in ("Transmissibilities", "FluidVolume"):
        a, b = grads[jpkg][k], grads[tpkg][k]
        assert np.max(np.abs(b - a)) <= 1e-8 * np.max(np.abs(a)), k
    assert abs(fdf[tpkg][0] - fdf[jpkg][0]) <= 1e-8 * abs(fdf[jpkg][0])
    ga, gb = fdf[jpkg][1], fdf[tpkg][1]
    assert np.max(np.abs(gb - ga)) <= 1e-8 * np.max(np.abs(ga))
