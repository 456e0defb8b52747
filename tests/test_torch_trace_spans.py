"""The Newton loop's spans and host reads (``utils/timing.py``) on both
paths.

A tiny bench flagship with its 5 well models (``chip_smoke``'s
``build_well_flagship``), one 6-hour report step of several ministeps,
through the eager loop (``Simulator.simulate``, every ministep's state)
and the schedule path (``lower_schedule``, Eisenstat-Walker forcing, the
report steps' states) on the CPU:

- under ``torch.profiler`` every span appears, nested as the program
  places it, and the ``jt.host_read`` spans number what the run's own
  counts imply;
- a profiler changes no state and no ministep record, bit for bit;
- with no profiler and ``extra_timing`` off no profiler event is made
  and nothing is synchronised;
- ``extra_timing`` fills the same four phase timings on both paths.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from jutul.jl_tpu_torch import Simulator, report_stats
from jutul.jl_tpu_torch.utils import timing

DIMS = (8, 8, 4)
N_STEP = 1
DT = 6 * 3600.0
PATHS = ["eager", "schedule"]
SPANS = ("jt.schedule", "jt.assembly", "jt.convergence", "jt.linear_solve",
         "jt.update", "jt.host_read")


@pytest.fixture(scope="module")
def case():
    return chip_smoke.build_well_flagship(*DIMS)


def _run(case, path, **extra):
    model, state0, params, forces = case
    sim = Simulator(model, state0, params, use_stencil=True, device="cpu")
    sched = chip_smoke.rate_schedule(forces, N_STEP)
    cfg = chip_smoke.sim_config(64, product=path == "schedule")
    cfg.update(extra)
    if path == "schedule":
        run, args, post = sim.lower_schedule(
            [DT] * N_STEP, forces=sched, jit_output_states=True, **cfg)
        return sim, post(*run(*args))
    return sim, sim.simulate([DT] * N_STEP, forces=sched,
                             output_substates=True, **cfg)


def _profiled(case, path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim, res = _run(case, path)
    spans = sorted((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(timing.SPAN_PREFIX))
    return sim, res, spans


def _refuse(*args, **kwargs):
    raise AssertionError("called with tracing off")


@pytest.fixture(scope="module")
def runs(case):
    """Per path: (plain run, profiled run, the profiled run's spans). The
    plain run has no profiler, no extra_timing and no table, and runs with
    every profiler scope, the span object and the device sync refused."""
    out = {}
    for path in PATHS:
        assert not timing.timing_enabled()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.profiler, "record_function", _refuse)
            mp.setattr(torch.autograd.profiler, "record_function", _refuse)
            mp.setattr(torch._C._profiler, "_RecordFunctionFast", _refuse)
            mp.setattr(torch.cuda, "synchronize", _refuse)
            mp.setattr(timing, "_Scope", _refuse)
            plain = _run(case, path)
        sim, res, spans = _profiled(case, path)
        out[path] = (plain, (sim, res), spans)
    return out


def _minis(res):
    return [m for r in res.reports for m in r["ministeps"]]


def _inside(span, outer):
    return any(s <= span[0] and span[1] <= e for s, e, _ in outer)


def _named(spans, name):
    return [s for s in spans if s[2] == name]


@pytest.mark.parametrize("path", PATHS)
def test_spans_nest(runs, path):
    _, (_, res), spans = runs[path]
    assert {s[2] for s in spans} == set(SPANS)
    sched = _named(spans, "jt.schedule")
    assert len(sched) == (1 if path == "eager" else 2)  # run_all, post
    phases = [s for s in spans if s[2] not in ("jt.schedule", "jt.host_read")]
    assert all(_inside(s, sched) for s in phases)
    # the phases follow each other: none holds another
    for a, b in zip(phases, phases[1:]):
        assert a[1] <= b[0], (a, b)
    reads = _named(spans, "jt.host_read")
    assert all(_inside(s, sched) for s in reads)
    minis = _minis(res)
    # the eager loop solves in every iteration it runs, the schedule path
    # in every one but the last
    solves = sum(len(m["errors"]) if path == "eager" else m["iterations"]
                 for m in minis)
    assert len(_named(spans, "jt.linear_solve")) == solves


def _n_criteria(case):
    """Equations x criteria of the case's convergence check: the eager
    loop's scaled error reads each one's maximum."""
    model, state0, params, forces = case
    sim = Simulator(model, state0, params, use_stencil=True, device="cpu")
    full = sim._merge(sim.state0, sim.parameters)
    r, _, full_eval = sim.engine.assemble(full, full, DT, forces)
    crit = sim.compiled.convergence(r, full_eval, DT)
    return sum(len(c) for c in crit.values())


@pytest.mark.parametrize("path", PATHS)
def test_host_reads_counted(case, runs, path):
    """Krylov its + 3 a solve (the tolerance, each loop test, the
    converged flag), the Newton loop's reads, and one a returned array."""
    _, (sim, res), spans = runs[path]
    reads = _named(spans, "jt.host_read")
    minis = _minis(res)
    lin = sum(m["linear_iterations"] for m in minis)
    its = sum(m["iterations"] for m in minis)
    states = [s for st in res.states
              for s in [st] + list(st.get("substates", []))]
    arrays = sum(len([k for k in s if k != "substates"]) for s in states)
    if path == "schedule":
        solves, newton_reads = its, its + len(minis)  # one an assembly
        assert sim.host_reads == newton_reads
    else:
        # every executed iteration solves, then reads max|r| and each
        # criterion's maximum
        assert all("failure" not in m for m in minis)
        solves = sum(len(m["errors"]) for m in minis)
        newton_reads = solves * (1 + _n_criteria(case))
        assert sim.host_reads == 0
    solve_spans = _named(spans, "jt.linear_solve")
    in_solves = [s for s in reads if _inside(s, solve_spans)]
    assert len(in_solves) == lin + 3 * solves
    assert len(reads) == lin + 3 * solves + newton_reads + arrays


def _signature(res):
    return [(m["dt"], m["success"], m["iterations"], m["linear_iterations"],
             list(m["errors"])) for m in _minis(res)]


def _arrays(res):
    return [(k, v) for st in res.states
            for s in [st] + list(st.get("substates", []))
            for k, v in sorted(s.items()) if k != "substates"]


@pytest.mark.parametrize("path", PATHS)
def test_profiler_changes_nothing(runs, path):
    (_, plain), (_, traced), _ = runs[path]
    assert _signature(plain) == _signature(traced)
    a, b = _arrays(plain), _arrays(traced)
    assert [k for k, _ in a] == [k for k, _ in b]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))


@pytest.mark.parametrize("path", PATHS)
def test_off_constructs_nothing(runs, path):
    """No profiler, no extra_timing, no table: a span is a flag check. The
    plain run completed with every scope and sync refused (``runs``)."""
    (_, plain), _, _ = runs[path]
    assert all(r["success"] for r in plain.reports)
    assert all("timings" not in m for m in _minis(plain))


@pytest.mark.parametrize("path", PATHS)
def test_extra_timing_phases(case, runs, path):
    _, res = _run(case, path, extra_timing=True)
    (_, plain), _, _ = runs[path]
    assert _signature(res) == _signature(plain)
    for m in _minis(res):
        assert list(m["timings"]) == list(timing.PHASES)
        assert all(t >= 0.0 for t in m["timings"].values())
    st = report_stats(res.reports)
    assert set(st["timings"]) == set(timing.PHASES)
    assert st["timings"]["assembly"] > 0 and st["timings"]["linear_solve"] > 0


def test_timing_table_keys(case):
    """set_timing_enabled(True) times the spans into the table under their
    hierarchical keys, and the ministeps' phases as extra_timing does."""
    timing.reset_timings()
    timing.set_timing_enabled(True)
    try:
        _, res = _run(case, "schedule")
        table = timing.get_timings()
    finally:
        timing.set_timing_enabled(False)
        timing.reset_timings()
    assert all(list(m["timings"]) == list(timing.PHASES)
               for m in _minis(res))
    for phase in timing.PHASES:
        assert table[f"schedule/{phase}"]["count"] > 0
    assert table["schedule/linear_solve/host_read"]["count"] == sum(
        m["linear_iterations"] for m in _minis(res)) + 3 * table[
        "schedule/linear_solve"]["count"]
