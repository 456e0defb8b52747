"""The eager simulator's options of the port against the JAX package's, on
the CPU at f64, on examples/history_match.py's 12-cell case (the default
engine, ``DirectSolver``):

- the hooks: ``prepare_step``, ``post_iteration_hook``,
  ``post_ministep_hook`` and ``termination_criterion``
  (``EndTimeTerminationCriterion``) are called in the same sequence with
  the same arguments (the scaled errors to 1e-8 relative or 1e-8 of the
  tolerance, whichever is larger), with the same counts;
- ``cutting_criterion``: a three-argument criterion and
  ``ConvergenceMonitorCuttingCriterion`` over ``nonconverged_equations``
  (four arguments, the scaled residuals) cut the same ministeps;
- the selectors ``LimitByFailedTimestepSelector``,
  ``VariableChangeTimestepSelector`` and ``IterationTimestepSelector``
  give the same ministep dts;
- ``extra_timing``: per-phase timings in every ministep's report, summed
  by ``report_stats`` and split by ``timing_breakdown``;
- output files (``output_path``): each package reads the other's with
  ``read_results`` and ``read_consolidated``; a restart from the stored
  step gives the uninterrupted run's final state bit for bit;
- ``reporting.py``, ``distance_functions.py`` and
  ``convergence_monitors.py``: the same text and numbers on the same
  inputs;
- the schedule path raises for the hooks, and an unknown option raises.
"""

import importlib
import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from test_torch_defaults import history_match_case

KW = {jpkg: {}, tpkg: {"device": "cpu"}}


def _sim(pkg, **cfg):
    model, st, pr, f, dts = history_match_case(pkg)
    sim = pkg.Simulator(model, state0=st, parameters=pr, **KW[pkg])
    return sim, sim.simulate(dts, forces=f, info_level=-1, **cfg)


def _minis(res):
    return [(m["dt"], m["iterations"], m["success"], m.get("failure"))
            for r in res.reports for m in r["ministeps"]]


def _close(a, b, rtol=1e-8, atol=0.0):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= rtol * np.abs(b) + atol)


def test_hooks_match_jax():
    calls = {}
    for pkg in (jpkg, tpkg):
        rec = []

        def prepare(state, dt, it, rec=rec):
            rec.append(("prepare", dt, it))
            return dict(state) if it == 1 else None

        def post_it(state, err, it, rec=rec):
            rec.append(("iteration", it, err))

        def post_mini(state, report, rec=rec):
            rec.append(("ministep", report["dt"], report["iterations"]))

        rep = importlib.import_module(pkg.__name__ + ".simulator.reporting")
        _, res = _sim(pkg, prepare_step=prepare, post_iteration_hook=post_it,
                      post_ministep_hook=post_mini, max_timestep=0.3 * 86400,
                      termination_criterion=rep.EndTimeTerminationCriterion(
                          2 * 0.5 * 86400))
        calls[pkg] = (rec, _minis(res), len(res.states))
    (rj, mj, nj), (rt, mt, nt) = calls[jpkg], calls[tpkg]
    assert nt == nj == 2  # the end time stops the outer loop
    assert mt == mj
    assert [c[:2] for c in rt] == [c[:2] for c in rj]
    for a, b in zip(rt, rj):
        if a[0] == "iteration":
            assert a[1] == b[1]
            _close(a[2], b[2], atol=1e-8)
        else:
            assert a == b


def _cutters(pkg):
    cm = importlib.import_module(pkg.__name__
                                 + ".simulator.convergence_monitors")
    df = importlib.import_module(pkg.__name__ + ".simulator.distance_functions")
    return {
        "three_args": lambda errors, it, max_it: it >= 1 and errors[-1] > 1e-2,
        "monitor": cm.ConvergenceMonitorCuttingCriterion(
            min_iterations=1, max_contraction=0.2, num_violations_cut=0,
            distance_function=df.nonconverged_equations, mapping=sum),
    }


@pytest.mark.parametrize("which", ["three_args", "monitor"])
def test_cutting_criterion_matches_jax(which):
    out = {}
    for pkg in (jpkg, tpkg):
        _, res = _sim(pkg, cutting_criterion=_cutters(pkg)[which],
                      tolerances={"mass_conservation": 1e-9},
                      max_nonlinear_iterations=20)
        out[pkg] = res
    assert _minis(out[tpkg]) == _minis(out[jpkg])
    assert any(m[3] == "cutting_criterion" for m in _minis(out[tpkg]))
    for a, b in zip(out[tpkg].states, out[jpkg].states):
        _close(a["Pressure"], b["Pressure"], 1e-12)


def test_timestep_selectors_match_jax():
    out = {}
    for pkg in (jpkg, tpkg):
        ts = importlib.import_module(pkg.__name__ + ".simulator.timesteps")
        sel = [ts.TimestepSelector(initial_fraction=0.25),
               ts.IterationTimestepSelector(target_iterations=3),
               ts.LimitByFailedTimestepSelector(0.8),
               ts.VariableChangeTimestepSelector("Pressure", 1e5)]
        _, out[pkg] = _sim(pkg, timestep_selectors=sel,
                           max_nonlinear_iterations=4)
    assert _minis(out[tpkg]) == _minis(out[jpkg])
    assert len(_minis(out[tpkg])) > 4


def test_extra_timing():
    _, res = _sim(tpkg, extra_timing=True)
    phases = {"assembly", "convergence", "linear_solve", "update"}
    for r in res.reports:
        for m in r["ministeps"]:
            assert set(m["timings"]) == phases
            assert all(v >= 0.0 for v in m["timings"].values())
    stats = tpkg.report_stats(res.reports)
    assert set(stats["timings"]) == phases
    tb = tpkg.timing_breakdown(res.reports)
    assert abs(sum(tb[k]["fraction"] for k in phases) - 1.0) < 1e-12
    # the same reports print the same summary in both packages
    text = {}
    for pkg in (jpkg, tpkg):
        buf = io.StringIO()
        with redirect_stdout(buf):
            pkg.print_stats(res.reports)
        text[pkg] = buf.getvalue()
    assert text[tpkg] == text[jpkg] and "Timing breakdown" in text[tpkg]


def _same_states(a, b):
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        assert set(sa) == set(sb)
        for k in sa:
            np.testing.assert_array_equal(np.asarray(sa[k]), np.asarray(sb[k]))


def test_output_files_read_by_both_packages(tmp_path):
    runs = {}
    for pkg in (jpkg, tpkg):
        path = tmp_path / pkg.__name__
        _, res = _sim(pkg, output_path=str(path), output_substates=True,
                      max_timestep=0.3 * 86400)
        runs[pkg] = (path, res)
    for writer, reader in ((tpkg, jpkg), (jpkg, tpkg), (tpkg, tpkg)):
        path, res = runs[writer]
        states, reports = reader.read_results(str(path))
        _same_states([{k: v for k, v in s.items() if k != "substates"}
                      for s in states],
                     [{k: v for k, v in s.items() if k != "substates"}
                      for s in res.states])
        _same_states(states[0]["substates"].values(),
                     res.states[0]["substates"])
        assert [len(r["ministeps"]) for r in reports] == [
            len(r["ministeps"]) for r in res.reports]
        assert reader.valid_restart_indices(str(path)) == [0, 1, 2, 3]
    # a consolidated archive written by the port, read by the JAX package
    tio = importlib.import_module("jutul.jl_tpu_torch.simulator.io")
    jio = importlib.import_module("jutul.jl_tpu.simulator.io")
    path, res = runs[tpkg]
    fn = tio.consolidate_results(str(path), delete_steps=True)
    assert tio.valid_restart_indices(str(path)) == []
    states, reports = jio.read_results(str(path))
    states_t, _ = tio.read_consolidated(fn, steps=[1, 3])
    assert len(states) == 4 and len(states_t) == 2
    _same_states([{k: v for k, v in s.items() if k != "substates"}
                  for s in (states[1], states[3])],
                 [{k: v for k, v in s.items() if k != "substates"}
                  for s in states_t])


@pytest.mark.parametrize("restart", [1, True])
def test_restart_matches_uninterrupted_run(tmp_path, restart):
    model, st, pr, f, dts = history_match_case(tpkg)
    path = str(tmp_path / "out")
    full = tpkg.simulate(st, model, dts, forces=f, parameters=pr,
                         device="cpu", info_level=-1, output_path=path)
    if restart is True:  # drop the last step: resume after the third
        (tmp_path / "out" / "jutul_4.npz").unlink()
    res = tpkg.Simulator(model, st, pr, device="cpu").simulate(
        dts, forces=f, info_level=-1, output_path=path, restart=restart)
    assert len(res.states) == (1 if restart is True else 3)
    for k, v in full.states[-1].items():
        np.testing.assert_array_equal(res.states[-1][k], v)


def test_reporting_and_monitors_match_jax():
    rng = np.random.default_rng(2)
    crit = {"mass_conservation": {"CNV": rng.uniform(0, 1e-2, 2),
                                  "MB": rng.uniform(0, 1e-6, 2)}}
    tols = {"mass_conservation": {"CNV": 1e-3, "MB": 1e-7}}
    errs = list(rng.uniform(0.1, 10.0, 8))
    out = {}
    for pkg in (jpkg, tpkg):
        rep = importlib.import_module(pkg.__name__ + ".simulator.reporting")
        df = importlib.import_module(pkg.__name__
                                     + ".simulator.distance_functions")
        cm = importlib.import_module(pkg.__name__
                                     + ".simulator.convergence_monitors")
        c = crit if pkg is jpkg else {e: {k: torch.as_tensor(v)
                                          for k, v in d.items()}
                                      for e, d in crit.items()}
        res = df.get_model_residuals(c, lambda e, k: tols[e][k])
        buf = io.StringIO()
        rep.jutul_message("Title", "text", color="green", stream=buf)
        relax = cm.ConvergenceMonitorRelaxation()
        rec = rep.ProgressRecorder()
        rec.recorder.update(0.5, 3, True)
        rec.recorder.update(0.5, 4, False)
        out[pkg] = (
            rep.convergence_table(c, tols), rep.progress_bar(0.37),
            buf.getvalue(), res,
            df.compute_distance(res), df.compute_distance(
                res, df.nonconverged_equations, sum),
            df.flatten_dict({"a": {"b": 1.0, "c": {"d": 2.0}}}),
            [cm.compute_contraction_factor(errs[:i]) for i in range(9)],
            [cm.detect_oscillation(errs[:i]) for i in range(9)],
            [relax.select_relaxation(0.7, errs[:i]) for i in range(9)],
            [cm.ConvergenceMonitorCuttingCriterion()(errs[:i], i, 10)
             for i in range(9)],
            (rec.recorder.step, rec.recorder.iterations,
             rec.recorder.failed, rec.recorder.time),
            rep.TerminationCriterion()(1.0, 0, None))
    assert out[tpkg] == out[jpkg]


def test_schedule_path_refuses_hooks_and_unknown_options():
    sim, _ = _sim(tpkg)
    _, _, _, f, dts = history_match_case(tpkg)
    hook = lambda state, err, it: None  # noqa: E731
    for kw in (dict(post_iteration_hook=hook),
               dict(post_ministep_hook=lambda state, rep: None)):
        with pytest.raises(ValueError, match="eager path"):
            sim.simulate_jit(dts, forces=f, **kw)
        with pytest.raises(ValueError, match="eager path"):
            sim.simulate(dts, forces=f, jit_timestep=True, **kw)
    with pytest.raises(KeyError):
        sim.simulate(dts, forces=f, not_an_option=1)
    with pytest.raises(ValueError, match="output_path"):
        sim.simulate(dts, forces=f, restart=True)
