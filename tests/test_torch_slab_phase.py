"""B8's route (``GMG.slab_double_buffer``: the JAX package's double-buffered
slab level) against the JAX package, on the CPU. The port runs it on K10
(``scalar_jacobi_slab``), as it runs B2: the two compute one function.

- K10's plain version, through the launches of ``phase_chunks`` and through
  the level hooks of the level a flagged GMG builds, against the JAX
  package's double-buffered slab level (B8,
  ``PallasSlabFusedScalarLevel(double_buffer=True)`` in interpret mode) on
  tests/test_pallas.py's seeded (8, 8, 16) stencil, for every hook: to 1e-6
  (float32) and 1e-12 (float64) of the largest value — the same sweeps,
  sums in another order;
- a V-cycle with ``slab_double_buffer`` routes every level and hook as one
  without it and equals it exactly;
- the 10x10x6 well-model slice with Jacobi GMG and ``slab_double_buffer``
  at float64: the same ministep, Newton and linear-iteration counts as the
  JAX package's run of that case (whose CPU GMG runs XLA levels whatever
  the flag), states within 1e-10.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu.ops.pallas.stencil_kernels import PallasSlabFusedScalarLevel
from jutul.jl_tpu.ops.stencil import ScalarStencil as JScalarStencil
from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK
from jutul.jl_tpu_torch.ops.stencil import GMG, ScalarStencil

L = (8, 8, 16)
TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _stencil(dtype):
    """tests/test_pallas.py ``test_slab_double_buffered_pipeline``'s
    stencil and vectors (seed 14)."""
    n = int(np.prod(L))
    rng = np.random.default_rng(14)
    diag = (np.full(n, 6.0) + rng.uniform(0, 1, n)).astype(dtype)
    fs = {0: (8, 8, 15), 1: (8, 7, 16), 2: (7, 8, 16)}
    plus = {a: -np.abs(rng.normal(size=s)).astype(dtype)
            for a, s in fs.items()}
    minus = {a: -np.abs(rng.normal(size=s)).astype(dtype)
             for a, s in fs.items()}
    b = rng.normal(size=n).astype(dtype)
    u0 = rng.normal(size=n).astype(dtype)
    return diag, plus, minus, b, u0


def _port(diag, plus, minus):
    t = torch.from_numpy
    return ScalarStencil(L, t(diag), {a: t(v) for a, v in plus.items()},
                         {a: t(v) for a, v in minus.items()})


def _close(got, ref, dtype, what):
    ref = np.asarray(ref)
    err = np.abs(got.numpy() - ref).max()
    assert err <= TOL[dtype] * np.abs(ref).max(), (what, err)


def _k10_phase(coef, b, u, n_sweep, residual, depth=2):
    """A phase as K10's launches (``phase_chunks``), on CPU tensors."""
    r = None
    for k, _, res in SK.phase_chunks(n_sweep, u is None, residual, depth):
        u, r = SK.scalar_jacobi_slab(coef, b, u, 0.8, k, res, L)
    return u, r


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_phase_hooks_match_jax_slab_level(dtype):
    diag, plus, minus, b, u0 = _stencil(dtype)
    j = jnp.asarray
    jlv = PallasSlabFusedScalarLevel(
        JScalarStencil(L, j(diag), {a: j(v) for a, v in plus.items()},
                       {a: j(v) for a, v in minus.items()}),
        n_smooth=2, double_buffer=True, interpret=True,
        vmem_budget=128 * 1024)
    assert jlv.tz < L[0], "the budget should force several z-slabs"
    gmg = GMG(n_smooth=2)
    gmg.slab_double_buffer = True
    lv, = gmg.matvecs([_port(diag, plus, minus)])
    bt, ut = torch.from_numpy(b), torch.from_numpy(u0)
    before = SK.scalar_jacobi_slab.launches
    ju, jr = jlv.presmooth_residual(j(b), 0.8, 2)
    jpost = jlv.postsmooth(j(u0), j(b), 0.8, 2)
    jsweep = jlv.sweep_n(j(b), 0.8, 5)
    for u, r, post, sweep in (
            (*lv.presmooth_residual(bt, 0.8, 2), lv.postsmooth(ut, bt, 0.8, 2),
             lv.sweep_n(bt, 0.8, 5)),
            (*_k10_phase(lv.coef, bt, None, 2, True),
             _k10_phase(lv.coef, bt, ut, 2, False)[0],
             _k10_phase(lv.coef, bt, None, 5, False)[0])):
        _close(u, ju, dtype, "presmooth u")
        _close(r, jr, dtype, "presmooth r")
        _close(post, jpost, dtype, "postsmooth")
        _close(sweep, jsweep, dtype, "sweep_n")
    # CPU tensors run the plain version, which counts no launch
    assert SK.scalar_jacobi_slab.launches == before


@pytest.mark.parametrize("n_sweep,residual", [(1, False), (2, True),
                                              (5, False), (4, True)])
def test_phase_plain_is_the_k2_chain(n_sweep, residual):
    """One Jacobi phase's plain version (K8's and K10's), from zero and
    from u, is K2's sweep loop, exactly, and so is K10's wrapper on CPU
    tensors, which takes every depth there (the card refuses more than
    ``SLAB_MAX_DEPTH`` applications a launch)."""
    diag, plus, minus, b, u0 = _stencil(np.float64)
    ref = SK.ScalarLevel(_port(diag, plus, minus))
    bt, ut = torch.from_numpy(b), torch.from_numpy(u0)
    for u in (None, ut):
        want = ref.sweep_n(bt, 0.8, n_sweep) if u is None else \
            ref.postsmooth(u, bt, 0.8, n_sweep)
        for fn in (SK.scalar_jacobi_phase_plain, SK.scalar_jacobi_slab):
            got_u, got_r = fn(ref.coef, bt, u, 0.8, n_sweep, residual, L)
            assert torch.equal(got_u, want)
            if residual:
                assert torch.equal(got_r, ref.residual(want, bt))
            else:
                assert got_r is None


HOOKS = ("presmooth_residual", "postsmooth", "sweep_n",
         "presmooth_residual_cheby", "postsmooth_cheby", "sweep_n_cheby")


def test_vcycle_with_phase_kernel_equals_k2_chain(monkeypatch):
    """``slab_double_buffer`` changes no route (here with every level a
    slab level, as the flagship's fine level is) and no value."""
    monkeypatch.setattr(SK, "SLAB_MIN_CELLS", 0)
    rng = np.random.default_rng(3)
    L3 = (8, 12, 16)
    n = int(np.prod(L3))
    fs = {0: (8, 12, 15), 1: (8, 11, 16), 2: (7, 12, 16)}
    A = ScalarStencil(
        L3, torch.from_numpy(6.0 + rng.uniform(0, 1, n)),
        {a: torch.from_numpy(-np.abs(rng.normal(size=s))) for a, s in fs.items()},
        {a: torch.from_numpy(-np.abs(rng.normal(size=s))) for a, s in fs.items()})
    b = torch.from_numpy(rng.normal(size=n))
    out, routes = [], []
    for flag in (False, True):
        gmg = GMG(n_smooth=2, n_coarse_sweeps=12, min_cells=64)
        gmg.slab_double_buffer = flag
        ops = gmg.hierarchy(A)
        mvs = gmg.matvecs(ops)
        assert len(ops) == 3
        routes.append([[lv.route(h, b) for h in HOOKS] for lv in mvs])
        out.append(gmg.vcycle(ops, b, mvs=mvs))
    assert routes[0] == routes[1]
    assert routes[0][0][:2] == ["slab"] * 2
    chain = GMG(n_smooth=2, n_coarse_sweeps=12, min_cells=64)
    ops = chain.hierarchy(A)
    want = chain.vcycle(ops, b, mvs=[
        SK.ScalarLevel(o, resident=False, slab=False) for o in ops])
    assert torch.equal(out[0], out[1]) and torch.equal(out[1], want)


DIMS = (10, 10, 6)
N_STEP = 2
DT = 6 * 3600.0


def _config(pkg):
    st = importlib.import_module(pkg.__name__ + ".ops.stencil")
    gmg = st.GMG(n_smooth=2, n_coarse_sweeps=12, min_cells=64)
    gmg.slab_double_buffer = True
    return dict(
        linear_solver=st.StencilKrylovSolver(
            preconditioner=st.StencilCPR(gmg=gmg), rtol=1e-3,
            max_iterations=25),
        tolerances={"mass_conservation/CNV": 1e-3,
                    "mass_conservation/MB": 1e-6},
        max_nonlinear_iterations=12, tol_factor_final_iteration=10.0,
        timestep_selectors=[pkg.TimestepSelector(initial_fraction=0.25),
                            pkg.IterationTimestepSelector(
                                target_iterations=6)],
        output_variables="primary", info_level=-1)


def _counts(reports):
    minis = [m for r in reports for m in r["ministeps"]]
    return [(m["iterations"], m["linear_iterations"], m["success"])
            for m in minis]


def test_well_slice_jacobi_phase_kernel_matches_jax():
    import jutul.jl_tpu as jpkg

    jmodel, _, jstate, jparams, jforces = bench.build(
        *DIMS, gravity=True, wells=True, well_models=True)
    jres = jpkg.Simulator(jmodel, state0=jstate, parameters=jparams,
                          use_stencil=True).simulate(
        [DT] * N_STEP, forces=chip_smoke.rate_schedule(jforces, N_STEP),
        **_config(jpkg))
    tmodel, tstate, tparams, tforces = chip_smoke.build_well_flagship(*DIMS)
    tres = tpkg.Simulator(tmodel, tstate, tparams, use_stencil=True,
                          device="cpu").simulate(
        [DT] * N_STEP, forces=chip_smoke.rate_schedule(tforces, N_STEP),
        **_config(tpkg))
    assert all(r["success"] for r in tres.reports)
    assert _counts(tres.reports) == _counts(jres.reports)
    for js, ts in zip(jres.states, tres.states):
        np.testing.assert_allclose(ts["Pressure"], js["Pressure"],
                                   rtol=1e-10, atol=0)
        np.testing.assert_allclose(ts["Saturations"], js["Saturations"],
                                   rtol=0, atol=1e-10)
