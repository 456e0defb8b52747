"""``Simulator(use_stencil=False, device="cpu")`` — the port's generic
block-ELL engine end to end — against the JAX package's default engine,
on the CPU at f64.

Same inputs through both packages; every ministep's Newton and linear
iteration counts and success identical; states within 1e-12 (Pressure
relative, fractions absolute, other fields relative to their max):
- the verify flows: the scalar ODE (X = X0 + q dt), steady Poisson with a
  source pair (|U - U[0]| = [0, 1/3, 2/3]; U - U[0] compared, since only
  a 1e-10 regularization pins the constant) and the ministep machinery
  (max_timestep 0.75 over a 2.0 step: 0.75, 0.75, 0.5);
- the bench flagship with source-term wells at 8x8x6, two 6 h report
  steps with the rate ramp, srcwells' Newton settings, with
  ``DirectSolver`` and with BASELINE.json's CPR(AMG + ILU(0))-GMRES, on the
  eager path and on the schedule path (Eisenstat-Walker forcing);
- the well-graph model (5 well models) at 10x10x6 with CPR-GMRES;
- ``refine_solution`` on the generic engine (the same final max|r| path
  as the stencil engine's refine: it must reach the f64 floor);
- the README quickstart's case at 8x8x4;
- a solver of the other engine raises a TypeError naming the engine.
"""

import importlib

import numpy as np
import pytest
import torch

import bench
import chip_smoke
import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg

DT = 6 * 3600.0


def _counts(res):
    return [(m["iterations"], m["linear_iterations"], m["success"])
            for r in res.reports for m in r["ministeps"]]


def _assert_states(js, ts, tol=1e-12):
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        for k, v in a.items():
            if k == "substates":
                continue
            v = np.asarray(v)
            if k == "Pressure":
                assert np.max(np.abs(b[k] / v - 1)) <= tol, k
            else:  # fractions absolute; other fields relative to their max
                scale = max(1.0, float(np.max(np.abs(v))))
                assert np.max(np.abs(b[k] - v)) <= tol * scale, k


def _run(pkg, model, state0, params, dts, forces, product=False, **cfg):
    kw = {} if pkg is jpkg else dict(device="cpu")
    sim = pkg.Simulator(model, state0=state0, parameters=params,
                        use_stencil=False, **kw)
    run = sim.simulate_jit if product else sim.simulate
    return sim, run(dts, forces=forces, **cfg)


# ---------------------------------------------------------------------------
# the verify flows
# ---------------------------------------------------------------------------
def _scalar(pkg, n=3):
    model = pkg.SimulationModel(pkg.ScalarTestDomain(n),
                                pkg.ScalarTestSystem())
    return model, pkg.setup_state(model, XVar=np.arange(1.0, n + 1.0))


def test_scalar_ode():
    out = {}
    for pkg in (jpkg, tpkg):
        model, st = _scalar(pkg)
        _, out[pkg] = _run(pkg, model, st, None, [0.5],
                           {"f": pkg.ScalarTestForce(2.0)}, info_level=-1)
    assert _counts(out[tpkg]) == _counts(out[jpkg])
    assert np.allclose(out[tpkg].states[0]["XVar"], [2.0, 3.0, 4.0],
                       rtol=0, atol=1e-14)
    _assert_states(out[jpkg].states, out[tpkg].states)


def test_poisson_steady():
    out = {}
    for pkg in (jpkg, tpkg):
        dd = pkg.DataDomain(pkg.CartesianMesh((3, 1), (1.0, 1.0)))
        dd.set("poisson_coefficient", np.ones(3))
        model = pkg.SimulationModel(dd, pkg.VariablePoissonSystem(
            time_dependent=False))
        _, out[pkg] = _run(
            pkg, model, pkg.setup_state(model, U=0.0), None, [1.0],
            {"s": [pkg.PoissonSource(0, 1.0), pkg.PoissonSource(2, -1.0)]},
            info_level=-1)
    U = out[tpkg].states[0]["U"]
    assert np.allclose(np.abs(U - U[0]), [0.0, 1 / 3, 2 / 3], atol=1e-12)
    assert _counts(out[tpkg]) == _counts(out[jpkg])
    # the constant mode is pinned by a 1e-10 regularization only, so each
    # package's dense LU places it ~1e-6 apart (condition ~1e10); the
    # differences, which the sources determine, agree to roundoff
    Uj = np.asarray(out[jpkg].states[0]["U"])
    assert np.max(np.abs((U - U[0]) - (Uj - Uj[0]))) < 1e-12


def test_ministeps():
    out = {}
    for pkg in (jpkg, tpkg):
        model, st = _scalar(pkg, 1)
        _, out[pkg] = _run(pkg, model, st, None, [2.0],
                           {"f": pkg.ScalarTestForce(1.0)},
                           max_timestep=0.75, info_level=-1)
    dts = [m["dt"] for m in out[tpkg].reports[0]["ministeps"]]
    assert dts == [0.75, 0.75, 0.5]
    assert dts == [m["dt"] for m in out[jpkg].reports[0]["ministeps"]]
    assert _counts(out[tpkg]) == _counts(out[jpkg])
    assert abs(out[tpkg].states[0]["XVar"][0] - 3.0) < 1e-14


# ---------------------------------------------------------------------------
# the Darcy flagship and the well-graph model
# ---------------------------------------------------------------------------
def _flagship(pkg, dims=(8, 8, 6), well_models=False):
    if pkg is jpkg:
        model, _, st, pr, f = bench.build(*dims, gravity=True, wells=True,
                                          well_models=well_models)
        return model, st, pr, f
    build = (chip_smoke.build_well_flagship if well_models
             else chip_smoke.build_flagship)
    return build(*dims)


def _solver(pkg, kind):
    if kind == "direct":
        return pkg.DirectSolver()
    return chip_smoke.generic_solver(pkg)


@pytest.mark.parametrize("solver,product", [("direct", False),
                                            ("cpr-gmres", False),
                                            ("cpr-gmres", True)])
def test_flagship_matches_jax(solver, product):
    out = {}
    for pkg in (jpkg, tpkg):
        model, st, pr, f = _flagship(pkg)
        cfg = chip_smoke.generic_config(pkg, _solver(pkg, solver),
                                        product=product)
        _, out[pkg] = _run(pkg, model, st, pr, [DT] * 2,
                           chip_smoke.rate_schedule(f, 2), product, **cfg)
    assert all(r["success"] for r in out[tpkg].reports)
    assert _counts(out[tpkg]) == _counts(out[jpkg])
    _assert_states(out[jpkg].states, out[tpkg].states)


def test_well_graph_matches_jax():
    out = {}
    for pkg in (jpkg, tpkg):
        model, st, pr, f = _flagship(pkg, (10, 10, 6), well_models=True)
        cfg = chip_smoke.generic_config(pkg)
        _, out[pkg] = _run(pkg, model, st, pr, [DT] * 2,
                           chip_smoke.rate_schedule(f, 2), **cfg)
    assert all(r["success"] for r in out[tpkg].reports)
    assert _counts(out[tpkg]) == _counts(out[jpkg])
    _assert_states(out[jpkg].states, out[tpkg].states)


def test_refine_solution_generic():
    model, st, pr, f = _flagship(tpkg)
    sim, res = _run(tpkg, model, st, pr, [DT], f,
                    **chip_smoke.generic_config(tpkg))
    prim = model.primary_variables
    final = {k: res.final_state_device[k] for k in prim}
    start = {k: res.final_ministep_start_state[k] for k in prim}
    solver = tpkg.GenericKrylov("gmres", tpkg.CPRPreconditioner(),
                                rtol=1e-10, max_iterations=200)
    _, info = sim.refine_solution(final, start, res.final_ministep_dt,
                                  forces=f, tol=1e-8, solver=solver)
    hist = info["f64_residual_history"]
    assert info["converged"] and hist[-1] < hist[0]


def test_readme_quickstart_small():
    """README.md's quickstart (64x64x16, 12 steps of 30 days) at 8x8x4 and
    2 steps through ``simulate(..., use_stencil=False)``."""
    out = {}
    for pkg in (jpkg, tpkg):
        D = importlib.import_module(pkg.__name__ + ".models.darcy")
        DAY, BAR, DARCY = pkg.si_units("day", "bar", "darcy")
        mesh = pkg.CartesianMesh((8, 8, 4), (80.0, 80.0, 40.0))
        model = D.setup_darcy_model(mesh, D.ImmiscibleFluid(),
                                    permeability=0.1 * DARCY, porosity=0.25)
        state0 = pkg.setup_state(model, Pressure=200 * BAR,
                                 Saturations=[0.0, 1.0])
        forces = {"sources": D.PhaseSourceTerm([0], np.array([[1.0, 0.0]]))}
        kw = {} if pkg is jpkg else dict(use_stencil=False, device="cpu")
        out[pkg] = pkg.simulate(
            state0, model, [30 * DAY] * 2, forces=forces,
            parameters=pkg.setup_parameters(model),
            linear_solver=pkg.GenericKrylov(
                "gmres", preconditioner=pkg.CPRPreconditioner()),
            info_level=-1, **kw)
    assert all(r["success"] for r in out[tpkg].reports)
    assert _counts(out[tpkg]) == _counts(out[jpkg])
    _assert_states(out[jpkg].states, out[tpkg].states)


def test_mismatched_solver_raises():
    model, st, pr, f = _flagship(tpkg, (4, 4, 3))
    generic = tpkg.Simulator(model, st, pr, use_stencil=False, device="cpu")
    with pytest.raises(TypeError, match="generic block-ELL engine"):
        generic.simulate([DT], forces=f, linear_solver=tpkg.StencilKrylovSolver(),
                         info_level=-1)
    stencil = tpkg.Simulator(model, st, pr, use_stencil=True, device="cpu")
    for solver in (tpkg.GenericKrylov(), tpkg.DirectSolver()):
        with pytest.raises(TypeError, match="stencil engine"):
            stencil.simulate([DT], forces=f, linear_solver=solver,
                             info_level=-1)
    assert isinstance(generic._default_solver(), tpkg.DirectSolver)
