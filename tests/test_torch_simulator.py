"""The port's slice end to end against the JAX package.

The bench flagship with source-term wells at (16, 16, 8), gravity on, two
6-hour report steps with the bench's rate ramp, through
``Simulator(use_stencil=True).simulate`` in both packages on the CPU at
f64 — the JAX package eager (jitted iteration), the port through its
kernels' plain versions — with the bench's solver and Newton settings and
``GMG(min_cells=64)``. Ministep, Newton and linear-iteration counts must
be identical; the final Pressure within rtol 1e-10 and Saturations within
atol 1e-10.
"""

import numpy as np
import pytest
import torch

import bench
import chip_smoke

DIMS = (16, 16, 8)
N_STEP = 2
DT = 6 * 3600.0
TOLS = {"mass_conservation/CNV": 1e-3, "mass_conservation/MB": 1e-6}


def _config(pkg):
    sel = [pkg.TimestepSelector(initial_fraction=0.25),
           pkg.IterationTimestepSelector(target_iterations=6)]
    solver = pkg_solver(pkg)
    return dict(linear_solver=solver, tolerances=TOLS,
                max_nonlinear_iterations=12, tol_factor_final_iteration=10.0,
                timestep_selectors=sel, output_variables="primary",
                info_level=-1)


def pkg_solver(pkg):
    mod = pkg.__name__ + ".ops.stencil"
    import importlib

    st = importlib.import_module(mod)
    return st.StencilKrylovSolver(
        preconditioner=st.StencilCPR(gmg=st.GMG(
            n_smooth=2, n_coarse_sweeps=12, min_cells=64)),
        rtol=1e-3, max_iterations=25)


def _counts(reports):
    minis = [m for r in reports for m in r["ministeps"]]
    return (len(minis), [m["iterations"] for m in minis],
            [m["linear_iterations"] for m in minis],
            [m["success"] for m in minis])


@pytest.fixture(scope="module")
def runs():
    import jutul.jl_tpu as jpkg
    import jutul.jl_tpu_torch as tpkg

    jmodel, _, jstate, jparams, jforces = bench.build(
        *DIMS, gravity=True, wells=True, well_models=False)
    jsim = jpkg.Simulator(jmodel, state0=jstate, parameters=jparams,
                          use_stencil=True)
    jres = jsim.simulate([DT] * N_STEP,
                         forces=chip_smoke.rate_schedule(jforces, N_STEP),
                         **_config(jpkg))

    tmodel, tstate, tparams, tforces = chip_smoke.build_flagship(*DIMS)
    tsim = tpkg.Simulator(tmodel, tstate, tparams, use_stencil=True,
                           device="cpu")
    tres = tsim.simulate([DT] * N_STEP,
                         forces=chip_smoke.rate_schedule(tforces, N_STEP),
                         **_config(tpkg))
    return jres, tres


def test_counts_identical(runs):
    jres, tres = runs
    assert all(r["success"] for r in tres.reports)
    assert _counts(tres.reports) == _counts(jres.reports)


@pytest.mark.parametrize("step", range(N_STEP))
def test_states_match(runs, step):
    jres, tres = runs
    js, ts = jres.states[step], tres.states[step]
    assert set(ts) == set(js) == {"Pressure", "Saturations"}
    np.testing.assert_allclose(ts["Pressure"], js["Pressure"], rtol=1e-10,
                               atol=0)
    np.testing.assert_allclose(ts["Saturations"], js["Saturations"],
                               rtol=0, atol=1e-10)


def test_final_ministep_recorded(runs):
    _, tres = runs
    assert tres.final_ministep_dt > 0
    for d in (tres.final_state_device, tres.final_ministep_start_state):
        assert d["Pressure"].dtype == torch.float64
        assert bool(torch.isfinite(d["Pressure"]).all())
    np.testing.assert_array_equal(tres.final_state_device["Pressure"].numpy(),
                                  tres.states[-1]["Pressure"])
