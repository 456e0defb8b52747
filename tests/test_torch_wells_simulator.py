"""The well-model slice end to end against the JAX package.

The bench flagship with its 5 well models (4 rate injectors, 1 BHP
producer; bench.py ``build(..., well_models=True)``, the port's
``chip_smoke.build_well_flagship``) at (10, 10, 6), gravity on, two 6-hour
report steps with the bench's rate ramp, through
``Simulator(use_stencil=True).simulate`` in both packages on the CPU at
f64 — the JAX package eager (jitted iteration), the port through its
kernels' plain versions — with the bench's solver and Newton settings and
``GMG(min_cells=64)``, for both smoothers. Ministep, Newton and
linear-iteration counts must be identical; Pressure within rtol 1e-10 and
Saturations within atol 1e-10, wellbore cells included.

Why (10, 10, 6): on this case the JAX package agrees with itself. Its
three Schur-correction forms, which differ only in summation order, give
identical counts and states within 1e-12 here. At (16, 16, 8) they do not:
with the Jacobi smoother, the second ministep takes 53, 57 or 54 linear
iterations depending on the form, because the rtol-1e-3 Krylov solves
amplify roundoff until a saturation lands on or off a clip bound, where
the Jacobian jumps. There, counts are not a property of the method.
"""

import importlib

import numpy as np
import pytest
import torch

import bench
import chip_smoke

DIMS = (10, 10, 6)
N_STEP = 2
DT = 6 * 3600.0
TOLS = {"mass_conservation/CNV": 1e-3, "mass_conservation/MB": 1e-6}


def _config(pkg, smoother):
    st = importlib.import_module(pkg.__name__ + ".ops.stencil")
    solver = st.StencilKrylovSolver(
        preconditioner=st.StencilCPR(gmg=st.GMG(
            n_smooth=2, n_coarse_sweeps=12, min_cells=64, smoother=smoother)),
        rtol=1e-3, max_iterations=25)
    sel = [pkg.TimestepSelector(initial_fraction=0.25),
           pkg.IterationTimestepSelector(target_iterations=6)]
    return dict(linear_solver=solver, tolerances=TOLS,
                max_nonlinear_iterations=12, tol_factor_final_iteration=10.0,
                timestep_selectors=sel, output_variables="primary",
                info_level=-1)


def _counts(reports):
    minis = [m for r in reports for m in r["ministeps"]]
    return (len(minis), [m["iterations"] for m in minis],
            [m["linear_iterations"] for m in minis],
            [m["success"] for m in minis])


@pytest.fixture(scope="module", params=["jacobi", "chebyshev"])
def runs(request):
    import jutul.jl_tpu as jpkg
    import jutul.jl_tpu_torch as tpkg

    smoother = request.param
    jmodel, _, jstate, jparams, jforces = bench.build(
        *DIMS, gravity=True, wells=True, well_models=True)
    jsim = jpkg.Simulator(jmodel, state0=jstate, parameters=jparams,
                          use_stencil=True)
    jres = jsim.simulate([DT] * N_STEP,
                         forces=chip_smoke.rate_schedule(jforces, N_STEP),
                         **_config(jpkg, smoother))

    tmodel, tstate, tparams, tforces = chip_smoke.build_well_flagship(*DIMS)
    tsim = tpkg.Simulator(tmodel, tstate, tparams, use_stencil=True)
    tres = tsim.simulate([DT] * N_STEP,
                         forces=chip_smoke.rate_schedule(tforces, N_STEP),
                         **_config(tpkg, smoother))
    tres.wells = tmodel.domain.mesh.wells
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
    n = int(np.prod(DIMS)) + 5  # lattice + 5 wellbore cells
    assert ts["Pressure"].shape == (n,)
    np.testing.assert_allclose(ts["Pressure"], js["Pressure"], rtol=1e-10,
                               atol=0)
    np.testing.assert_allclose(ts["Saturations"], js["Saturations"],
                               rtol=0, atol=1e-10)


def test_wells_act_as_wells(runs):
    """Injector wellbores stay water filled above their lowest completion
    pressure; the producer's wellbore sits below all its completions."""
    _, tres = runs
    p, s = tres.states[-1]["Pressure"], tres.states[-1]["Saturations"]
    nc = int(np.prod(DIMS))
    for i, w in enumerate(tres.wells):
        if w.name.startswith("inj"):
            assert p[nc + i] > p[w.cells].min()
            assert s[nc + i, 0] > 0.99
        else:
            assert p[nc + i] < p[w.cells].min()
    assert torch.is_tensor(tres.final_state_device["Pressure"])
