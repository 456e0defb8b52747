"""The port's stencil adjoint on well models against the JAX package, at f64
on the CPU: the bordered engine (``bordered_transpose`` λ-solves through the
Schur-eliminated CPR(GMG)-BiCGStab, ``BorderedStencilModel.
residual_differentiable`` pull-backs).

- tests/test_stencil_wells.py:179's case (a 5x4x3 lattice, a two-completion
  rate injector, a BHP producer): gradients (Transmissibilities, including
  the perforations' well indices, FluidVolume, state0) equal the JAX
  package's ``use_stencil=True`` adjoint to 1e-9 relative and its generic
  adjoint to 1e-6;
- the bench's well flagship at 8x8x6 (``chip_smoke.build_well_flagship``
  and bench.py ``build(..., well_models=True)``) over 2 report steps of
  1.5 h with the per-step rate ramp: the same against the JAX package's
  ``use_stencil=True`` adjoint (its ``_jit`` sweep) and generic adjoint,
  and the port's ``_jit`` (per-step forces of one structure) equals its
  host loop.

The forward states are the JAX package's, at tight tolerances, handed to
both adjoints as numpy arrays; the λ-solves run at rtol 1e-14 (see
tests/test_torch_adjoint.py).
"""

import numpy as np
import pytest

import bench
import chip_smoke
import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu.ops.stencil import GMG, StencilCPR, StencilKrylovSolver
from test_torch_adjoint import (
    AGAINST,
    GradientCase,
    check_gradients,
    numpy_states,
    wells_case,
)

DAY = tpkg.si_unit("day")


@pytest.fixture(scope="module")
def wells():
    jcase, tcase = wells_case(jpkg), wells_case(tpkg)
    jm, js0, jp, jf = jcase
    dts = [0.1 * DAY, 0.2 * DAY]
    states, reports = jpkg.Simulator(jm, state0=js0, parameters=jp).simulate(
        dts, forces=jf, info_level=-1, tolerances={"default": 1e-11},
        max_nonlinear_iterations=30)
    assert all(r["success"] for r in reports)
    case = GradientCase(jcase, tcase, numpy_states(states), dts)
    # the lattice faces and the 3 perforations
    assert case.gradients("port_host")["Transmissibilities"].shape == (
        jm.domain.mesh._nf_base + 3,)
    return case


@pytest.fixture(scope="module")
def flagship():
    """Per-step forces (the rate ramp) through the host loop and _jit."""
    dims = (8, 8, 6)
    jm, _, js0, jp, jf = bench.build(*dims, gravity=True, wells=True,
                                     well_models=True)
    tm, ts0, tp, tf = chip_smoke.build_well_flagship(*dims)
    dts = [1.5 * 3600.0] * 2
    jsched = chip_smoke.rate_schedule(jf, 2)
    tsched = chip_smoke.rate_schedule(tf, 2)
    fwd = StencilKrylovSolver(preconditioner=StencilCPR(gmg=GMG(
        n_smooth=2, n_coarse_sweeps=12, min_cells=64)), rtol=1e-12,
        max_iterations=300)
    states, reports = jpkg.Simulator(jm, state0=js0, parameters=jp,
                                     use_stencil=True).simulate(
        dts, forces=jsched, info_level=-1, linear_solver=fwd,
        tolerances={"mass_conservation/CNV": 1e-9,
                    "mass_conservation/MB": 1e-11},
        max_nonlinear_iterations=30)
    assert [len(r["ministeps"]) for r in reports] == [1, 1]
    case = GradientCase((jm, js0, jp, jsched), (tm, ts0, tp, tsched),
                        numpy_states(states), dts,
                        G_scale=int(np.prod(dims)), min_cells=64,
                        jax_sweep="jit")
    g = case.gradients("port_host")["Transmissibilities"]
    assert np.all(np.isfinite(g)) and np.abs(g).max() > 0
    return case


@pytest.mark.parametrize("case", ["wells", "flagship"])
@pytest.mark.parametrize("against", sorted(AGAINST))
def test_gradients_match_jax(case, against, request):
    """``against``: the JAX package's use_stencil=True adjoint (1e-9), its
    generic adjoint (1e-6), or the port's _jit (the host loop exactly)."""
    check_gradients(request.getfixturevalue(case), against)
