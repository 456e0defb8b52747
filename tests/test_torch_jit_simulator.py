"""The schedule path (``simulate_jit`` / ``lower_schedule`` /
``solve_timestep_jit`` / ``solve_ministep_jit``) of the port against the JAX
package's jitted programs, on the CPU at f64.

The port runs the jitted programs' algorithm on the host: check-before-solve
Newton, Eisenstat-Walker forcing, ``pick_next`` dt selection, bounded cutting,
truncated per-ministep records. The same inputs go through both packages —
the bench flagship (bench.py ``build`` / the port's ``chip_smoke.build_*`` functions)
with the bench's solver and Newton settings and ``GMG(min_cells=64)``:

- source-term wells at (16, 16, 8) and well models at (10, 10, 6) without
  forcing and (8, 8, 6) with it (sizes where the JAX package's three Schur
  forms agree on every count: with forcing they do not at (10, 10, 6), where
  the eighth ministep takes 25, 24 or 26 linear iterations by form and an
  H100's fused multiply-adds give 26 against this CPU's 25; see
  tests/test_torch_wells_simulator.py for the fixed-tolerance case),
  3 report steps of 6 h with the bench's rate ramp, with and without forcing:
  per-ministep ``dt`` (1e-12 relative), ``success``, ``iterations`` and
  ``linear_iterations`` identical. States: without forcing Pressure within
  1e-11 relative and Saturations within 1e-10 absolute; with forcing 1e-9 and
  1e-7 — an Eisenstat-Walker solve stops at a residual up to 0.1 |b|, so the
  two packages' summation orders leave the accepted iterates that far apart
  (the JAX package's own Schur forms end 2e-8 apart in saturation at
  (8, 8, 6)) while every count agrees;
- the small pieces (forcing, loop predicates, relaxation) exactly.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import bench
import chip_smoke

DT = 6 * 3600.0
TOLS = {"mass_conservation/CNV": 1e-3, "mass_conservation/MB": 1e-6}
STATE_TOL = {"none": (1e-11, 1e-10), "ew": (1e-9, 1e-7)}  # (P rel, S abs)


def _pkgs():
    import jutul.jl_tpu as jpkg
    import jutul.jl_tpu_torch as tpkg

    return jpkg, tpkg


def _config(pkg, forcing="ew", **kw):
    """bench.py run_product's settings (bench.py:533-601) at a small
    hierarchy."""
    st = importlib.import_module(pkg.__name__ + ".ops.stencil")
    solver = st.StencilKrylovSolver(
        preconditioner=st.StencilCPR(gmg=st.GMG(
            n_smooth=2, n_coarse_sweeps=12, min_cells=64)),
        rtol=1e-3, max_iterations=25)
    cfg = dict(
        linear_solver=solver, tolerances=TOLS, max_nonlinear_iterations=12,
        tol_factor_final_iteration=10.0, jit_report_capacity=16,
        linear_forcing=forcing,
        timestep_selectors=[pkg.TimestepSelector(initial_fraction=0.25),
                            pkg.IterationTimestepSelector(target_iterations=6)],
        output_variables="primary", info_level=-1)
    cfg.update(kw)
    return cfg


def _cases(dims, well_models):
    """(JAX simulator, its forces), (port simulator, its forces)."""
    jpkg, tpkg = _pkgs()
    jm, _, js, jp, jf = bench.build(*dims, gravity=True, wells=True,
                                    well_models=well_models)
    build = chip_smoke.build_well_flagship if well_models \
        else chip_smoke.build_flagship
    tm, ts, tp, tf = build(*dims)
    return ((jpkg.Simulator(jm, state0=js, parameters=jp, use_stencil=True),
             jf),
            (tpkg.Simulator(tm, ts, tp, use_stencil=True, device="cpu"), tf))


def _records(reports):
    return [[(m["success"], m["iterations"], m["linear_iterations"])
             for m in r["ministeps"]] + [r["success"]] for r in reports]


def _dts(reports):
    return [m["dt"] for r in reports for m in r["ministeps"]]


def _assert_states(ts, js, forcing):
    p_rel, s_abs = STATE_TOL[forcing]
    np.testing.assert_allclose(ts["Pressure"], np.asarray(js["Pressure"]),
                               rtol=p_rel, atol=0)
    np.testing.assert_allclose(ts["Saturations"],
                               np.asarray(js["Saturations"]), rtol=0,
                               atol=s_abs)


# ---------------------------------------------------------------------------
# the small pieces, exactly
# ---------------------------------------------------------------------------
ERRS = [0.0, 1e-30, 0.3, 1.0, 1.0000001, 7.5, 1e12, 1e200, math.inf,
        math.nan]


@pytest.mark.parametrize("err_prev", ERRS)
def test_ew_eta_matches_reference(err_prev):
    import jax.numpy as jnp

    from jutul.jl_tpu.simulator import newton_common as jn
    from jutul.jl_tpu_torch.simulator import newton_common as tn

    assert (tn.EW_GAMMA, tn.EW_ETA_MIN, tn.EW_ETA_MAX) == \
        (jn.EW_GAMMA, jn.EW_ETA_MIN, jn.EW_ETA_MAX)
    for err in ERRS:
        want = float(jn.ew_eta(jnp.float64(err), jnp.float64(err_prev)))
        got = tn.ew_eta(err, err_prev)
        assert got == want or (math.isnan(got) and math.isnan(want)), \
            (err, err_prev, got, want)
    assert tn.ew_eta(0.5, math.inf) == 0.1  # the first iteration


@pytest.mark.parametrize("bad", [False, True])
@pytest.mark.parametrize("it", [0, 1, 2, 11, 12])
def test_newton_predicates_match_reference(it, bad):
    import jax.numpy as jnp

    from jutul.jl_tpu.simulator import newton_common as jn
    from jutul.jl_tpu_torch.simulator import newton_common as tn

    for err in ERRS:
        for min_it in (0, 1, 2):
            want = bool(jn.newton_continue(jnp.float64(err), jnp.int32(it),
                                           jnp.asarray(bad), min_it, 12))
            assert tn.newton_continue(err, it, bad, min_it, 12) is want, \
                (err, it, bad, min_it)
        for tol_final in (1.0, 10.0):
            want = bool(jn.newton_accept(jnp.float64(err), jnp.int32(it),
                                         jnp.asarray(bad), 12, tol_final))
            assert tn.newton_accept(err, it, bad, 12, tol_final) is want, \
                (err, it, bad, tol_final)


@pytest.mark.parametrize("name,kw", [
    ("NonLinearRelaxation", {}), ("NoRelaxation", {}),
    ("SimpleRelaxation", {}),
    ("SimpleRelaxation", dict(tol=0.1, w_min=0.5, dw_decrease=0.3,
                              dw_increase=0.2))])
def test_select_relaxation_jit_matches_reference(name, kw):
    import jax.numpy as jnp

    from jutul.jl_tpu.simulator import relaxation as jr
    from jutul.jl_tpu_torch.simulator import relaxation as tr

    jrel, trel = getattr(jr, name)(**kw), getattr(tr, name)(**kw)
    for omega in (1.0, 0.9, 0.5, 0.25):
        for err in ERRS[:-2]:
            for err_prev in ERRS:  # incl. inf (first iteration), 0, equal
                want = float(jrel.select_relaxation_jit(
                    jnp.float64(omega), jnp.float64(err),
                    jnp.float64(err_prev)))
                got = trel.select_relaxation_jit(omega, err, err_prev)
                assert got == want, (omega, err, err_prev, got, want)


# ---------------------------------------------------------------------------
# faults checked first: a per-call rtol reaches both BiCGStab bodies and the
# bordered solve, and a forcing tolerance forms rtol * |b| in double
# ---------------------------------------------------------------------------
def _tridiag(n, dtype):
    g = torch.Generator().manual_seed(5)
    d = 2.5 + torch.rand(n, generator=g, dtype=torch.float64)
    b = torch.randn(n, generator=g, dtype=torch.float64)

    def matvec(x):
        y = d.to(x.dtype) * x
        y[1:] -= x[:-1]
        y[:-1] -= x[1:]
        return y

    return matvec, b.to(dtype)


@pytest.mark.parametrize("body", ["chain", "fused"])
def test_per_call_rtol_reaches_both_bicgstab_bodies(body):
    from jutul.jl_tpu_torch.linsolve.krylov import resolve_bicgstab

    fn = resolve_bicgstab(torch.float32, body == "fused")
    matvec, b = _tridiag(400, torch.float32)
    its = [fn(matvec, b, maxiter=100, rtol=rtol)[1]["iterations"]
           for rtol in (1e-1, 1e-3, torch.tensor(1e-1, dtype=torch.float64),
                        torch.tensor(1e-5, dtype=torch.float64))]
    assert its[0] == its[2] < its[1] < its[3]


def test_forcing_tolerance_is_formed_in_double():
    """At float32 the JAX loop's ``rtol * |b|`` with a traced float64 eta is
    a float64 product, with a Python rtol a float32 one; so does the port
    (0-d float64 tensor / Python float). The last bit shows at
    ``rtol = 1 - 2^-53``: in double the tolerance sits below ``|r0| = |b|``
    and the loop runs, rounded to float32 it equals ``|b|`` and it does
    not."""
    import jax.numpy as jnp

    from jutul.jl_tpu.linsolve.krylov import bicgstab as jb
    from jutul.jl_tpu_torch.linsolve.krylov import bicgstab as tb

    _, b = _tridiag(50, torch.float32)
    jmatvec = lambda x: 2.0 * x  # noqa: E731
    below_one = float(np.nextafter(1.0, 0.0))
    for rtol in (1.0, below_one):
        jits = [int(jb(jmatvec, jnp.asarray(b.numpy()), maxiter=3,
                       rtol=r)[1]["iterations"])
                for r in (rtol, jnp.float64(rtol))]
        tits = [tb(lambda x: 2.0 * x, b, maxiter=3, rtol=r)[1]["iterations"]
                for r in (rtol, torch.tensor(rtol, dtype=torch.float64))]
        assert tits == jits == ([0, 0] if rtol == 1.0 else [0, 1])


def test_per_call_rtol_reaches_the_bordered_solve():
    _, tpkg = _pkgs()
    from jutul.jl_tpu_torch.models.setup import merge_state

    tm, ts, tp, tf = chip_smoke.build_well_flagship(6, 6, 4)
    sim = tpkg.Simulator(tm, ts, tp, use_stencil=True, device="cpu")
    full = merge_state(sim.state0, sim.parameters)
    r, B, _ = sim._stencil.assemble(full, full, DT, tf)
    solver = _config(tpkg)["linear_solver"]
    its = [solver.solve(B, r, rtol=rtol)[1]["iterations"]
           for rtol in (None, 1e-1, torch.tensor(1e-1, dtype=torch.float64),
                        1e-8)]
    assert its[1] == its[2] < its[0] < its[3]


# ---------------------------------------------------------------------------
# one ministep
# ---------------------------------------------------------------------------
def test_solve_ministep_jit_matches_reference():
    jpkg, tpkg = _pkgs()
    (jsim, jf), (tsim, tf) = _cases((16, 16, 8), False)
    jcfg = jpkg.simulator_config(**_config(jpkg))
    tcfg = tpkg.simulator_config(**_config(tpkg))
    jsim._solver = jcfg["linear_solver"]
    jok, jst, jstats = jsim.solve_ministep_jit(jsim.state0, 0.25 * DT, jf,
                                               jcfg)
    tok, tst, tstats = tsim.solve_ministep_jit(tsim.state0, 0.25 * DT, tf,
                                               tcfg)
    assert tok and jok
    assert (tstats["iterations"], tstats["linear_iterations"]) == \
        (jstats["iterations"], jstats["linear_iterations"])
    assert tstats["errors"][0] == pytest.approx(jstats["errors"][0],
                                                rel=1e-6)
    _assert_states({k: v.numpy() for k, v in tst.items()}, jst, "ew")
    # one host read per assembly: the start state's and one per solve
    assert tsim.host_reads == tstats["iterations"] + 1
    # the dispatch of solve_ministep on jit_ministep
    tcfg["jit_ministep"] = True
    tok2, _, tstats2 = tsim.solve_ministep(tsim.state0, 0.25 * DT, tf, tcfg)
    assert tok2 and tstats2["iterations"] == tstats["iterations"]


# ---------------------------------------------------------------------------
# whole schedules
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module",
                params=[("src", "ew"), ("src", "none"), ("wells", "ew"),
                        ("wells", "none")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def schedule_runs(request):
    jpkg, tpkg = _pkgs()
    case, forcing = request.param
    dims, wm = ((16, 16, 8), False) if case == "src" else \
        ((8, 8, 6) if forcing == "ew" else (10, 10, 6), True)
    (jsim, jf), (tsim, tf) = _cases(dims, wm)
    jres = jsim.simulate_jit([DT] * 3, forces=chip_smoke.rate_schedule(jf, 3),
                             **_config(jpkg, forcing))
    run, args, post = tsim.lower_schedule(
        [DT] * 3, forces=chip_smoke.rate_schedule(tf, 3),
        **_config(tpkg, forcing))
    tres = post(*run(*args))
    return forcing, jres, tres, tsim


def test_schedule_records_identical(schedule_runs):
    _, jres, tres, _ = schedule_runs
    assert all(r["success"] for r in tres.reports) and len(tres.reports) == 3
    assert _records(tres.reports) == _records(jres.reports)
    np.testing.assert_allclose(_dts(tres.reports), _dts(jres.reports),
                               rtol=1e-12, atol=0)


def test_schedule_final_state_matches(schedule_runs):
    forcing, jres, tres, _ = schedule_runs
    assert len(tres.states) == len(jres.states) == 1  # final state only
    assert set(tres.states[0]) == {"Pressure", "Saturations"}
    _assert_states(tres.states[0], jres.states[0], forcing)


def test_schedule_keeps_the_last_accepted_ministep(schedule_runs):
    forcing, jres, tres, tsim = schedule_runs
    assert tres.final_ministep_dt == pytest.approx(jres.final_ministep_dt,
                                                   rel=1e-12)
    assert tres.final_ministep_dt == _dts(tres.reports)[-1]
    _assert_states({k: v.numpy() for k, v in
                    tres.final_ministep_start_state.items()},
                   jres.final_ministep_start_state, forcing)
    _assert_states({k: v.numpy() for k, v in
                    tres.final_state_device.items()},
                   jres.final_state_device, forcing)
    # one host read per Newton assembly: one per solve + one per ministep
    st = _pkgs()[1].report_stats(tres.reports)
    assert tsim.host_reads == st["newtons"] + st["ministeps"]


@pytest.fixture(scope="module")
def small_case():
    return _cases((8, 8, 4), False)


@pytest.mark.parametrize("what,kw,dts", [
    # a report step too long for 4 Newtons: cut, then recover
    ("cut", dict(max_nonlinear_iterations=4, tol_factor_final_iteration=1.0),
     [4 * DT, DT]),
    # cuts exhausted: the schedule dies and later steps stay empty
    ("abort", dict(max_nonlinear_iterations=2, max_timestep_cuts=1,
                   tol_factor_final_iteration=1.0), [40 * DT, DT, DT]),
    # more ministeps than record slots: same truncated totals
    ("overflow", dict(jit_report_capacity=2), [DT, DT]),
])
def test_cut_abort_and_overflow_match_reference(small_case, what, kw, dts,
                                                capsys):
    jpkg, tpkg = _pkgs()
    (jsim, jf), (tsim, tf) = small_case
    jres = jsim.simulate_jit(dts, forces=jf, **_config(jpkg, **kw))
    tres = tsim.simulate_jit(dts, forces=tf, **_config(tpkg, **kw))
    assert _records(tres.reports) == _records(jres.reports)
    np.testing.assert_allclose(_dts(tres.reports), _dts(jres.reports),
                               rtol=1e-12, atol=0)
    jst, tst = jpkg.report_stats(jres.reports), tpkg.report_stats(tres.reports)
    for k in ("ministeps", "newtons", "failed_ministeps", "wasted_newtons",
              "linear_iterations"):
        assert tst[k] == jst[k], k
    _assert_states(tres.states[-1], jres.states[-1], "ew")
    minis = [m for r in tres.reports for m in r["ministeps"]]
    if what == "cut":
        assert any(not m["success"] for m in minis)
        assert all(r["success"] for r in tres.reports)
    elif what == "abort":
        assert [r["success"] for r in tres.reports] == [False] * 3
        assert [len(r["ministeps"]) for r in tres.reports] == [2, 0, 0]
        # nothing accepted: the state is the start state
        np.testing.assert_array_equal(tres.states[-1]["Pressure"],
                                      tsim.state0["Pressure"].numpy())
    else:
        assert all(len(r["ministeps"]) == 2 for r in tres.reports)
        assert "jit_report_capacity=2" in capsys.readouterr().err


def test_jit_output_states_and_jit_timestep(small_case):
    """One state per report step, equal to ``simulate(jit_timestep=True)``'s
    (the same ministeps through the same functions) and to the JAX
    package's stacked states."""
    jpkg, tpkg = _pkgs()
    (jsim, jf), (tsim, tf) = small_case
    forces = chip_smoke.rate_schedule(tf, 3)
    jres = jsim.simulate_jit([DT] * 3,
                             forces=chip_smoke.rate_schedule(jf, 3),
                             **_config(jpkg, jit_output_states=True))
    tres = tsim.simulate_jit([DT] * 3, forces=forces,
                             **_config(tpkg, jit_output_states=True))
    assert len(tres.states) == len(jres.states) == 3
    for ts, js in zip(tres.states, jres.states):
        _assert_states(ts, js, "ew")
    state0 = dict(tsim.state0)
    eres = tsim.simulate([DT] * 3, forces=forces,
                         **_config(tpkg, jit_timestep=True))
    tsim.state0 = state0
    assert _records(eres.reports) == _records(tres.reports)
    for es, ts in zip(eres.states, tres.states):
        for k in ts:
            np.testing.assert_array_equal(es[k], ts[k])
    assert all(m["wall_time_is_amortized"] for r in eres.reports
               for m in r["ministeps"])


def test_schedule_path_refuses_what_the_reference_refuses(small_case):
    jpkg, tpkg = _pkgs()
    (jsim, jf), (tsim, tf) = small_case
    cells = tf["wells"].cells
    changed = [tf, {"wells": type(tf["wells"])(cells[:-1],
                                               tf["wells"].values[:-1])}]
    jchanged = [jf, {"wells": type(jf["wells"])(
        jf["wells"].cells[:-1], np.asarray(jf["wells"].values)[:-1])}]
    with pytest.raises(NotImplementedError, match="share one structure"):
        jsim.simulate_jit([DT] * 2, forces=jchanged, **_config(jpkg))
    with pytest.raises(NotImplementedError, match="share one structure"):
        tsim.simulate_jit([DT] * 2, forces=changed, **_config(tpkg))
    # the eager path accepts a changing structure
    state0 = dict(tsim.state0)
    assert len(tsim.simulate([DT / 4] * 2, forces=changed,
                             **_config(tpkg)).reports) == 2
    tsim.state0 = state0
    with pytest.raises(ValueError, match="2 entries for 3"):
        tsim.simulate_jit([DT] * 3, forces=changed, **_config(tpkg))
    hook = lambda state, dt, it: None  # noqa: E731
    for call in (
            lambda: tsim.simulate_jit([DT], forces=tf,
                                      **_config(tpkg, prepare_step=hook)),
            lambda: tsim.simulate([DT], forces=tf, **_config(
                tpkg, prepare_step=hook, jit_timestep=True)),
            lambda: tsim.solve_ministep_jit(
                tsim.state0, DT, tf, tpkg.simulator_config(
                    **_config(tpkg, prepare_step=hook)))):
        with pytest.raises(ValueError, match="prepare_step"):
            call()
    with pytest.raises(ValueError, match="prepare_step"):
        jsim.solve_ministep_jit(jsim.state0, DT, jf, jpkg.simulator_config(
            **_config(jpkg, prepare_step=hook)))
    with pytest.raises(ValueError):
        tpkg.simulator_config(linear_forcing="sometimes")
