"""``Simulator.refine_solution`` of the port: mixed-precision refinement of
one accepted float32 ministep to the float64 residual floor, on the CPU.

A float32 run of the bench flagship through the port's schedule path gives
the accepted ministep ``(final, start, dt)``; as numpy arrays it goes through
the port's ``refine_solution`` and the JAX package's, with the bench's
correction solver (bench.py:418-424: ``rtol=0``, 60 iterations) at
``GMG(min_cells=64)``. Held to: convergence to ``tol=1e-9``, a history
strictly better than the float32 start, the reference's ``info`` keys, the
same number of sweeps as the JAX package and a final max|r| within a factor
10 of its (the float32 correction solves differ in rounding; compared on the
source-term case). The well-model
case carries a BHP producer, so the pressure rebasing shifts a force's
absolute pressure (``shift_pressure_datum``).
"""

import importlib

import numpy as np
import pytest
import torch

import bench
import chip_smoke

DT = 6 * 3600.0
TOL = 1e-9
INFO_KEYS = {"f64_residual_history", "f64_max_abs_residual", "sweeps",
             "restored_best_state", "f64_polish_sweeps", "budget_exhausted",
             "converged"}


def _solver(pkg, rtol=0.0):
    st = importlib.import_module(pkg.__name__ + ".ops.stencil")
    return st.StencilKrylovSolver(
        preconditioner=st.StencilCPR(gmg=st.GMG(
            n_smooth=2, n_coarse_sweeps=12, min_cells=64)),
        rtol=rtol, max_iterations=60)


@pytest.fixture(scope="module", params=[("src", (6, 6, 4)),
                                        ("wells", (8, 8, 4))],
                ids=lambda p: p[0])
def refined(request):
    import jutul.jl_tpu as jpkg
    import jutul.jl_tpu_torch as tpkg

    case, dims = request.param
    wm = case == "wells"
    build = chip_smoke.build_well_flagship if wm else chip_smoke.build_flagship
    tm, ts, tp, tf = build(*dims)
    tsim = tpkg.Simulator(tm, ts, tp, use_stencil=True, device="cpu",
                          dtype=torch.float32)
    res = tsim.simulate_jit(
        [DT], forces=tf, linear_solver=_solver(tpkg, 1e-3),
        linear_forcing="ew", max_nonlinear_iterations=12,
        tol_factor_final_iteration=10.0,
        tolerances={"mass_conservation/CNV": 1e-3,
                    "mass_conservation/MB": 1e-6},
        timestep_selectors=[tpkg.TimestepSelector(initial_fraction=0.25),
                            tpkg.IterationTimestepSelector(
                                target_iterations=6)],
        output_variables="primary", info_level=-1)
    assert res.reports[0]["success"]
    # the triple as numpy, as it would come from either package's SimResult
    final = {k: v.numpy() for k, v in res.final_state_device.items()}
    start = {k: v.numpy() for k, v in res.final_ministep_start_state.items()}
    dt = res.final_ministep_dt
    assert final["Pressure"].dtype == np.float32

    st64, info = tsim.refine_solution(final, start, dt, forces=tf, tol=TOL,
                                      solver=_solver(tpkg),
                                      f64_solver=_solver(tpkg, 1e-6))
    if wm:  # the reference comparison runs on the source-term case only
        return case, tsim, (final, start, dt, tf), st64, info, None
    jm, _, js, jp, jf = bench.build(*dims, gravity=True, wells=True,
                                    well_models=wm)
    # float32 parameters, as the port's float32 simulator holds them (and
    # as the bench builds its simulator): both refine against the same
    # rounded parameters widened to float64
    jp = {k: (np.asarray(v, np.float32)
              if np.issubdtype(np.asarray(v).dtype, np.floating) else v)
          for k, v in jp.items()}
    jsim = jpkg.Simulator(jm, state0=js, parameters=jp, use_stencil=True)
    _, jinfo = jsim.refine_solution(final, start, dt, forces=jf, tol=TOL,
                                    solver=_solver(jpkg),
                                    f64_solver=_solver(jpkg, 1e-6))
    return case, tsim, (final, start, dt, tf), st64, info, jinfo


def test_refinement_converges_from_the_f32_step(refined):
    _, _, _, st64, info, _ = refined
    hist = info["f64_residual_history"]
    assert set(info) == INFO_KEYS
    assert info["converged"] and info["f64_max_abs_residual"] <= TOL
    assert all(h < hist[0] for h in hist[1:]) and len(hist) >= 2
    assert info["sweeps"] == len(hist) - 1
    assert not info["budget_exhausted"]
    assert all(v.dtype == torch.float64 for v in st64.values())


def test_refinement_matches_reference(refined):
    case, _, _, _, info, jinfo = refined
    if jinfo is None:
        # the well-model case is held to the port's own conditions: the
        # rebased f32 corrections alone must reach the tolerance or hand
        # over to the polish, never stall
        assert case == "wells" and info["converged"]
        return
    assert set(jinfo) == set(info)
    assert info["sweeps"] == jinfo["sweeps"]
    assert info["f64_polish_sweeps"] == jinfo["f64_polish_sweeps"]
    # both start from the same f64 residual of the same f32 step
    assert info["f64_residual_history"][0] == pytest.approx(
        jinfo["f64_residual_history"][0], rel=1e-9)
    ratio = info["f64_max_abs_residual"] / jinfo["f64_max_abs_residual"]
    assert 0.1 <= ratio <= 10.0


def test_refined_state_solves_the_f64_system(refined):
    """The returned state's residual, re-assembled in float64 apart from
    ``refine_solution``, is the reported one."""
    from jutul.jl_tpu_torch.models.setup import from_numpy, merge_state

    _, tsim, (_, start, dt, tf), st64, info, _ = refined
    pr = from_numpy(tsim.parameters, "cpu", torch.float64)
    r = tsim._stencil.residual(
        merge_state(st64, pr),
        merge_state(from_numpy(start, "cpu", torch.float64), pr), dt, tf)
    assert float(r.abs().max()) == pytest.approx(
        info["f64_max_abs_residual"], rel=1e-12)
    # integer parameter tables keep their dtype through the casts
    assert all(pr[k].dtype == v.dtype for k, v in tsim.parameters.items()
               if not v.is_floating_point())


def test_phase0_f64_budget_and_device_argument(refined):
    case, tsim, (final, start, dt, tf), _, info, _ = refined
    _, polished = tsim.refine_solution(
        final, start, dt, forces=tf, tol=TOL, solver=_solver(
            importlib.import_module("jutul.jl_tpu_torch")),
        f64_solver=_solver(importlib.import_module("jutul.jl_tpu_torch"),
                           1e-6), phase0="f64")
    assert polished["converged"]
    assert polished["f64_polish_sweeps"] == polished["sweeps"] >= 1
    _, cut = tsim.refine_solution(final, start, dt, forces=tf, tol=0.0,
                                  time_budget_s=0.0)
    assert cut["budget_exhausted"] and cut["sweeps"] == 0
    assert cut["f64_residual_history"] == info["f64_residual_history"][:1]
    _, same = tsim.refine_solution(final, start, dt, forces=tf, tol=1.0,
                                   solve_device="cpu")
    assert same["converged"] and same["sweeps"] == 0
    with pytest.raises(ValueError, match="solve_device"):
        tsim.refine_solution(final, start, dt, forces=tf,
                             solve_device="meta")


def test_rebasing_shifts_the_forces_absolute_pressure(refined):
    case, _, (final, _, _, tf), _, _, _ = refined
    if case != "wells":
        assert all(f.shift_pressure_datum(1e7) is f for f in tf.values())
        return
    p_ref = float(np.mean(final["Pressure"].astype(np.float64)))
    shifted = tf["bhp"].shift_pressure_datum(p_ref)
    assert shifted.pressure == pytest.approx(tf["bhp"].pressure - p_ref)
    assert abs(shifted.pressure) < 0.05 * tf["bhp"].pressure
    assert tf["rate"].shift_pressure_datum(p_ref) is tf["rate"]
