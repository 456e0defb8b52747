"""The bench flagship's 5 wells as coupled one-cell models
(``chip_smoke.build_well_multimodel``: ``setup_well_multimodel`` with
``DarcyTransferCrossTerm`` perforations) in the port against the JAX
package, on the CPU at f64, at 8x8x6 with the rate ramp over two 6 h
report steps and ``chip_smoke.multimodel_config`` (srcwells' Newton
settings; CPR-GMRES through GroupWise behind a Schur elimination of the
wells):

- the eager path (the schedule path under Eisenstat-Walker forcing:
  tests/test_torch_well_multimodel_ew.py): every ministep's Newton and
  linear iterations, success and dt equal to the JAX package's, states
  within 1e-12;
- against the port's augmented-graph run (``WellGraphMesh``, the generic
  engine) of the same wells, both solved tightly: states within rtol 1e-6
  (the JAX package's own bar, tests/test_wells.py);
- ``chip_smoke.multimodel_engine_check`` (the card phase's check) at this
  size: residual and J v of the two formulations within 1e-12;
- the tolerance lookup on the MultiModel's ``"model.eq"`` names equals the
  JAX package's, for the bench's keys, the per-model keys and a default.
"""

import numpy as np

import chip_smoke
import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu.multimodel.core import compile_multi_model as jcompile
from jutul.jl_tpu.simulator.newton_common import tolerance_for as jtol
from jutul.jl_tpu_torch.multimodel.core import compile_multi_model as tcompile
from jutul.jl_tpu_torch.simulator.newton_common import tolerance_for as ttol

DIMS = chip_smoke.WELL_SMALL_EW
DT = chip_smoke.DT


def run_well_multimodel(pkg, product):
    """The 8x8x6 well MultiModel through ``pkg`` (eager, or with
    ``product`` the schedule path with EW forcing)."""
    mm, st, pr, f = chip_smoke.build_well_multimodel(*DIMS, pkg)
    kw = {} if pkg is jpkg else dict(device="cpu")
    sim = pkg.Simulator(mm, state0=st, parameters=pr, **kw)
    run = sim.simulate_jit if product else sim.simulate
    return run([DT] * 2, forces=chip_smoke.rate_schedule(f, 2),
               **chip_smoke.multimodel_config(pkg, product=product))


def ministeps(res):
    return [(m["iterations"], m["linear_iterations"], m["success"], m["dt"])
            for r in res.reports for m in r["ministeps"]]


def assert_matches_jax(product):
    rj = run_well_multimodel(jpkg, product)
    rt = run_well_multimodel(tpkg, product)
    assert all(r["success"] for r in rt.reports)
    assert ministeps(rt) == ministeps(rj)
    for sj, st in zip(rj.states, rt.states):
        for m in sj:
            assert np.max(np.abs(st[m]["Pressure"]
                                 / np.asarray(sj[m]["Pressure"]) - 1)) \
                <= 1e-12, m
            assert np.max(np.abs(st[m]["Saturations"]
                                 - np.asarray(sj[m]["Saturations"]))) \
                <= 1e-12, m


def test_well_multimodel_matches_jax():
    assert_matches_jax(product=False)


def test_well_multimodel_matches_well_graph():
    """The two formulations of the same wells, each solved tightly with
    the dense direct solve: the JAX package's bar (rtol 1e-6)."""
    tight = dict(info_level=-1, tolerances={"default": 1e-10},
                 max_nonlinear_iterations=30,
                 linear_solver=tpkg.DirectSolver())
    mm, st, pr, f = chip_smoke.build_well_multimodel(*DIMS)
    sm = tpkg.Simulator(mm, st, pr, device="cpu").simulate(
        [DT] * 2, forces=chip_smoke.rate_schedule(f, 2), **tight)
    model, st_g, pr_g, f_g = chip_smoke.build_well_flagship(*DIMS)
    sg = tpkg.Simulator(model, st_g, pr_g, device="cpu").simulate(
        [DT] * 2, forces=chip_smoke.rate_schedule(f_g, 2), **tight)
    order = ("reservoir",) + chip_smoke.WELL_NAMES
    for a, b in zip(sm.states, sg.states):
        p = np.concatenate([a[m]["Pressure"] for m in order])
        s = np.concatenate([a[m]["Saturations"] for m in order])
        np.testing.assert_allclose(p, b["Pressure"], rtol=1e-6)
        np.testing.assert_allclose(s, b["Saturations"], atol=1e-6)


def test_engine_check_small():
    """The full-size card check at 8x8x6 on the CPU: at the initial state
    (a tie at each well's first perforation, which the check perturbs)
    and at a seeded perturbation of it."""
    case_mm = chip_smoke.build_well_multimodel(*DIMS)
    case_g = chip_smoke.build_well_flagship(*DIMS)
    f_mm = chip_smoke.rate_schedule(case_mm[3], 2)[-1]
    f_g = chip_smoke.rate_schedule(case_g[3], 2)[-1]
    st0 = case_mm[1]
    out = chip_smoke.multimodel_engine_check(case_mm, case_g, st0, st0, DT,
                                             f_mm, f_g, "cpu")
    assert out["perturbed_for_ties"] == 5
    assert out["residual_rel"] <= 1e-12 and out["jv_rel"] <= 1e-12
    rng = np.random.default_rng(3)
    st1 = {m: {**s, "Pressure": np.asarray(s["Pressure"]) * (
        1.0 + 1e-4 * rng.standard_normal(np.shape(s["Pressure"])))}
        for m, s in st0.items()}
    out = chip_smoke.multimodel_engine_check(case_mm, case_g, st1, st0, DT,
                                             f_mm, f_g, "cpu")
    assert out["perturbed_for_ties"] == 0
    assert out["residual_rel"] <= 1e-12 and out["jv_rel"] <= 1e-12


def test_tolerance_lookup_matches_jax():
    mm_j = chip_smoke.build_well_multimodel(*DIMS, jpkg)[0]
    mm_t = chip_smoke.build_well_multimodel(*DIMS, tpkg)[0]
    cj, ct = jcompile(mm_j), tcompile(mm_t)
    assert [e.name for e in ct.equations] == [e.name for e in cj.equations]
    bench_keys = chip_smoke.sim_config(64)["tolerances"]
    cases = [bench_keys, chip_smoke.multimodel_config()["tolerances"],
             {"default": 1e-7}, {"CNV": 1e-2}, {}]
    for tols in cases:
        for e in ct.equations:
            for crit in ("CNV", "MB"):
                assert ttol(e.name, crit, tols, ct.equations, mm_t) == \
                    jtol(e.name, crit, tols, cj.equations, mm_j), \
                    (e.name, crit, tols)
    # the bench's bare keys do not reach the MultiModel's names: the
    # equation's declared default applies, in both packages
    assert ttol("reservoir.mass_conservation", "MB", bench_keys,
                ct.equations, mm_t) == 1e-3
