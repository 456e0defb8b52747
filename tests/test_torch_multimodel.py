"""The port's MultiModel (``jutul.jl_tpu_torch.multimodel``) against the
JAX package's, on the CPU at f64: one counterpart per test of
tests/test_multimodel.py (two coupled scalar models relaxing to +-1/3,
reference test/test_systems/multimodel.jl:4-54).

The same inputs go through both packages; each test holds the port to the
JAX package's assertions and to its run: identical Newton and linear
iteration counts and ministep dts, states within 1e-12. Cases: direct,
Krylov and GroupWise equilibrium; the transient sequence; Schur against
direct; the ``groups``/``reduction`` default solver; the
check-before-solve ministep, timestep and schedule against eager; output
variables and per-step output states; refinement; reporting with a
termination criterion; per-step files and a restart; states moving from
the JAX package into the port and back as numpy.
"""

import numpy as np
import pytest
import torch

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu.linsolve import precond as jprec
from jutul.jl_tpu.linsolve import schur as jschur
from jutul.jl_tpu.models import test_systems as jts
from jutul.jl_tpu.multimodel import core as jmm
from jutul.jl_tpu.simulator import reporting as jrep
from jutul.jl_tpu_torch.linsolve import precond as tprec
from jutul.jl_tpu_torch.linsolve import schur as tschur
from jutul.jl_tpu_torch.simulator import io as tio
from jutul.jl_tpu_torch.simulator import reporting as trep

PKGS = (jpkg, tpkg)
TIGHT = dict(info_level=-1, tolerances={"default": 1e-11},
             max_nonlinear_iterations=25)


def build_multi(pkg):
    if pkg is jpkg:
        MultiModel, cross = jmm.MultiModel, jts.ScalarTestCrossTerm
    else:
        MultiModel, cross = tpkg.MultiModel, tpkg.ScalarTestCrossTerm
    sys = pkg.ScalarTestSystem()
    mA = pkg.SimulationModel(pkg.ScalarTestDomain(), sys)
    mB = pkg.SimulationModel(pkg.ScalarTestDomain(), sys)
    mm = MultiModel({"A": mA, "B": mB})
    mm.add_cross_term(cross(), target="A", source="B",
                      equation="test_equation")
    state0 = pkg.setup_state(mm, A=pkg.setup_state(mA, XVar=0.0),
                             B=pkg.setup_state(mB, XVar=0.0))
    forces = pkg.setup_forces(
        mm, A=pkg.setup_forces(mA, sources=pkg.ScalarTestForce(1.0)),
        B=pkg.setup_forces(mB, sources=pkg.ScalarTestForce(-1.0)))
    return mm, state0, forces


def sim_of(pkg, mm, state0, **kw):
    if pkg is tpkg:
        kw["device"] = "cpu"
    return pkg.Simulator(mm, state0=state0, **kw)


def run_both(dts, solver=None, entry="simulate", setup=None, **cfg):
    """(JAX result, port result) of the same MultiModel run."""
    out = {}
    for pkg in PKGS:
        mm, state0, forces = build_multi(pkg)
        if setup is not None:
            setup(mm)
        sim = sim_of(pkg, mm, state0)
        kw = dict(cfg)
        if solver is not None:
            kw["linear_solver"] = solver(pkg)
        out[pkg] = getattr(sim, entry)(dts, forces=forces, **kw)
    return out[jpkg], out[tpkg]


def counts(res):
    return [(m["iterations"], m.get("linear_iterations"), m["success"],
             m["dt"]) for r in res.reports for m in r["ministeps"]]


def X(res, m, step=-1):
    return float(np.asarray(res.states[step][m]["XVar"])[0])


def assert_same(rj, rt, tol=1e-12):
    assert counts(rt) == counts(rj)
    assert len(rt.states) == len(rj.states)
    for sj, st in zip(rj.states, rt.states):
        for m in sj:
            for k, v in sj[m].items():
                v = np.asarray(v)
                scale = max(float(np.max(np.abs(v))), 1e-300)
                assert np.max(np.abs(st[m][k] - v)) <= tol * scale, (m, k)


def test_multimodel_scalar_equilibrium_direct():
    rj, rt = run_both([1.0], info_level=-1)
    assert np.isclose(X(rt, "A"), 1.0 / 3.0, atol=1e-10)
    assert np.isclose(X(rt, "B"), -1.0 / 3.0, atol=1e-10)
    assert_same(rj, rt)


def test_multimodel_refine_solution():
    """Mixed-precision refinement of a MultiModel step: f64 coupled
    residual, f32 coupled-system corrections; the same history as the
    JAX package's."""
    infos = {}
    for pkg in PKGS:
        mm, state0, forces = build_multi(pkg)
        sim = sim_of(pkg, mm, state0)
        res = sim.simulate([1.0], forces=forces, info_level=-1)
        assert res.reports[-1]["success"]
        final = {m: {k: np.asarray(v, dtype=np.float64) + 1e-3
                     for k, v in s.items()
                     if k in mm.models[m].primary_variables}
                 for m, s in res.states[-1].items()}
        st64, info = sim.refine_solution(final, state0, 1.0, forces=forces,
                                         tol=1e-12, max_refine=10)
        assert info["converged"], info
        assert info["f64_residual_history"][0] > 1e-4
        assert info["f64_max_abs_residual"] <= 1e-12
        assert np.isclose(float(np.asarray(st64["A"]["XVar"])[0]),
                          X(res, "A"), atol=1e-9)
        infos[pkg] = info
    assert infos[tpkg]["sweeps"] == infos[jpkg]["sweeps"]
    np.testing.assert_allclose(infos[tpkg]["f64_residual_history"][:2],
                               infos[jpkg]["f64_residual_history"][:2],
                               rtol=1e-6)


def test_multimodel_scalar_equilibrium_krylov():
    rj, rt = run_both([1.0], info_level=-1,
                      solver=lambda p: p.GenericKrylov("gmres", rtol=1e-12))
    assert np.isclose(X(rt, "A"), 1.0 / 3.0, atol=1e-8)
    assert np.isclose(X(rt, "B"), -1.0 / 3.0, atol=1e-8)
    assert_same(rj, rt)


def test_multimodel_groupwise_preconditioner():
    def solver(pkg):
        P = jprec if pkg is jpkg else tprec
        return pkg.GenericKrylov("gmres", rtol=1e-12,
                                 preconditioner=P.GroupWisePreconditioner(
                                     {"A": P.BlockJacobiPreconditioner(),
                                      "B": P.BlockJacobiPreconditioner()}))

    rj, rt = run_both([1.0], info_level=-1, solver=solver)
    assert np.isclose(X(rt, "A"), 1.0 / 3.0, atol=1e-8)
    assert_same(rj, rt)


def test_multimodel_transient_sequence():
    rj, rt = run_both([0.5, 0.5, 1.0], info_level=-1)
    assert len(rt.states) == 3
    XA = np.array([X(rt, "A", i) for i in range(3)])
    XB = np.array([X(rt, "B", i) for i in range(3)])
    assert np.allclose(XA + XB, 0.0, atol=1e-12)  # skew-symmetric coupling
    assert XA[0] < XA[1] < XA[2] < 0.5
    assert_same(rj, rt)


def test_schur_complement_matches_direct():
    """Schur elimination of model B against the coupled direct solve
    (reference linsolve/multimodel.jl:17), in both packages."""
    def schur(pkg):
        S = jschur if pkg is jpkg else tschur
        return S.SchurComplementSolver(
            inner=pkg.GenericKrylov("gmres", rtol=1e-13), elim_models=["B"])

    dj, dt_ = run_both([1.0], info_level=-1)
    sj, st = run_both([1.0], info_level=-1, solver=schur)
    for m in ("A", "B"):
        assert np.isclose(X(st, m), X(dt_, m), atol=1e-10)
    assert_same(sj, st)


def test_reporting_utilities():
    for rec_cls in (jrep.SolveRecorder, trep.SolveRecorder):
        rec = rec_cls()
        rec.update(1.0, 3, True)
        rec.update(0.5, 2, False)
        assert rec.step == 2 and rec.iterations == 5 and rec.failed == 2
    tab = trep.convergence_table({"eq": {"Max": np.array([1e-3])}})
    assert "eq" in tab and "Max" in tab
    assert "50.0%" in trep.progress_bar(0.5)
    out = {}
    for pkg in PKGS:
        mm, state0, forces = build_multi(pkg)
        out[pkg] = sim_of(pkg, mm, state0).simulate(
            [1.0] * 5, forces=forces, info_level=-1,
            termination_criterion=pkg.EndTimeTerminationCriterion(2.0))
    assert len(out[tpkg].states) == 2
    assert_same(out[jpkg], out[tpkg])
    stats = tpkg.report_stats(out[tpkg].reports)
    ref = jpkg.report_stats(out[jpkg].reports)
    clocks = ("wall_time", "time_per_newton")  # host times differ
    assert {k: v for k, v in stats.items() if k not in clocks} == \
        {k: v for k, v in ref.items() if k not in clocks}


def test_multimodel_output_files_and_restart(tmp_path):
    """Per-step files of a MultiModel run (the JAX package's format: one
    key per submodel variable) and a restart from them."""
    mm, state0, forces = build_multi(tpkg)
    path = tmp_path / "out"
    full = sim_of(tpkg, mm, state0).simulate(
        [0.5] * 3, forces=forces, info_level=-1, output_path=str(path))
    stored, _ = tio.load_step(str(path), 1)
    assert set(stored) == {"A", "B"} and "XVar" in stored["A"]
    rest = sim_of(tpkg, mm, state0).simulate(
        [0.5] * 3, forces=forces, info_level=-1, output_path=str(path),
        restart=2)
    assert len(rest.states) == 1
    for m in ("A", "B"):
        assert np.array_equal(rest.states[-1][m]["XVar"],
                              full.states[-1][m]["XVar"])


def test_groups_reduction_schur_default_solver():
    """``MultiModel(groups=..., reduction="schur_apply")`` makes the
    default solver a Schur elimination of every model outside the first
    model's group; the grouped run matches the plain coupled run."""
    def grouped(mm):
        mm.groups = {"A": 1, "B": 2}
        mm.reduction = "schur_apply"

    kw = dict(info_level=-1, tolerances={"default": 1e-12})
    pj, pt = run_both([1.0] * 4, **kw)
    gj, gt = run_both([1.0] * 4, setup=grouped, **kw)
    mm, state0, _ = build_multi(tpkg)
    grouped(mm)
    solver = sim_of(tpkg, mm, state0)._default_solver()
    assert isinstance(solver, tpkg.SchurComplementSolver)
    assert solver.elim_models == ["B"]
    for m in ("A", "B"):
        np.testing.assert_allclose(gt.states[-1][m]["XVar"],
                                   pt.states[-1][m]["XVar"], rtol=1e-9)
    assert_same(gj, gt)


@pytest.mark.parametrize("mode", ["jit_ministep", "jit_timestep",
                                  "simulate_jit"])
def test_multimodel_check_before_solve_paths_match_eager(mode):
    """The check-before-solve ministep, the whole-report-step function and
    the schedule path on a MultiModel: the eager run's states (1e-10) and
    Newton counts, and the JAX package's run of the same path exactly."""
    if mode == "jit_timestep":
        dts, cfg = [1.5], dict(TIGHT, max_timestep=0.4)
    else:
        dts, cfg = [0.2, 0.4, 0.8], dict(TIGHT)
    ej, et = run_both(dts, **cfg)
    if mode == "simulate_jit":
        jj, jt = run_both(dts, entry="simulate_jit", **cfg)
    else:
        jj, jt = run_both(dts, **{mode: True}, **cfg)
    assert all(r["success"] for r in jt.reports)
    for m in ("A", "B"):
        np.testing.assert_allclose(jt.states[-1][m]["XVar"],
                                   et.states[-1][m]["XVar"], rtol=1e-10)
    its = lambda res: [mi["iterations"] for r in res.reports  # noqa: E731
                       for mi in r["ministeps"]]
    if mode == "jit_timestep":
        assert len(jt.reports[0]["ministeps"]) == len(
            et.reports[0]["ministeps"]) >= 4
    else:
        assert sum(its(jt)) == sum(its(et))
    assert its(jt) == its(jj)
    for m in ("A", "B"):
        np.testing.assert_allclose(jt.states[-1][m]["XVar"],
                                   np.asarray(jj.states[-1][m]["XVar"]),
                                   rtol=1e-12)


def test_multimodel_output_variables_option():
    st_all = run_both([1.0], info_level=-1)[1].states
    pj, pt = run_both([1.0], info_level=-1, output_variables="primary")
    for m in ("A", "B"):
        assert set(pt.states[-1][m]) == {"XVar"}
        assert np.allclose(st_all[-1][m]["XVar"], pt.states[-1][m]["XVar"])
    assert_same(pj, pt)


def test_multimodel_simulate_jit_output_states_per_step():
    dts = [0.25, 0.5, 1.0]
    ej, et = run_both(dts, **TIGHT)
    jj, jt = run_both(dts, entry="simulate_jit", jit_output_states=True,
                      **TIGHT)
    assert len(jt.states) == len(dts) == len(et.states)
    for s in range(len(dts)):
        for m in ("A", "B"):
            np.testing.assert_allclose(jt.states[s][m]["XVar"],
                                       et.states[s][m]["XVar"], rtol=1e-10)
            np.testing.assert_allclose(jt.states[s][m]["XVar"],
                                       np.asarray(jj.states[s][m]["XVar"]),
                                       rtol=1e-12)
    _, pt = run_both(dts, entry="simulate_jit", jit_output_states=True,
                     output_variables="primary", **TIGHT)
    for m in ("A", "B"):
        assert set(pt.states[-1][m]) == {"XVar"}
        np.testing.assert_allclose(pt.states[-1][m]["XVar"],
                                   et.states[-1][m]["XVar"], rtol=1e-10)


def test_multimodel_states_move_across():
    """A JAX MultiModel state and parameters move into the port unchanged
    (``from_numpy`` of the dict of per-model dicts) and come back as numpy
    dicts of dicts."""
    mm_j, state0_j, _ = build_multi(jpkg)
    mm_t, _, forces = build_multi(tpkg)
    params = jpkg.setup_parameters(mm_j)
    st = tpkg.from_numpy(state0_j, "cpu", torch.float64)
    assert set(st) == {"A", "B"} and st["A"]["XVar"].dtype == torch.float64
    res = sim_of(tpkg, mm_t, state0_j, parameters=params).simulate(
        [1.0], forces=forces, info_level=-1)
    assert isinstance(res.states[-1]["A"]["XVar"], np.ndarray)
