"""The port's fused BiCGStab body (K6/K7 plain versions, ``bicgstab_fused``,
``StencilKrylovSolver(use_fused_body=True)``) against the JAX package's
(ops/pallas/krylov_kernels.py in interpret mode), float32 on the CPU.

Both packages get the same float32 inputs, made with numpy from a seed (the
stencil systems are assembled by the JAX package and carried over).
Tolerances: the kernels' formulas to rtol 1e-5 (1e-4 for the values that
pass through two dot products), as tests/test_fused_krylov.py holds the JAX
kernels; whole solves to identical iteration counts, x within 5e-4 and
du within 1e-4 of max |du| — float32 sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu.ops.pallas import krylov_kernels as JK
from jutul.jl_tpu_torch.linsolve.krylov import bicgstab, resolve_bicgstab
from jutul.jl_tpu_torch.ops.cuda import krylov_kernels as TK
from jutul.jl_tpu_torch.ops.stencil import (
    GMG,
    StencilCPR,
    StencilKrylovSolver,
    StencilMatrix,
)

f32 = np.float32


def _t(a):
    return torch.from_numpy(np.array(a, dtype=f32))


def _random_system(n, seed):
    """tests/test_fused_krylov.py ``_random_system``: SPD, well
    conditioned, float32."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)) * 0.1
    A = A @ A.T + n * np.eye(n)
    x_true = rng.normal(size=n)
    return A.astype(f32), (A @ x_true).astype(f32), x_true


def test_fused_alpha_s_matches_jax():
    rng = np.random.default_rng(1)
    rhat, r, v = (rng.normal(size=1000).astype(f32) for _ in range(3))
    rho = f32(0.7)
    s_j, a_j = JK.fused_alpha_s(*map(jnp.asarray, (rhat, r, v, rho)),
                                interpret=True)
    s_t, a_t = TK.fused_alpha_s(*map(_t, (rhat, r, v, rho)))
    assert s_t.dtype == torch.float32 and a_t.ndim == 0
    np.testing.assert_allclose(float(a_t), float(a_j), rtol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=1e-6)


def test_fused_omega_update_matches_jax():
    rng = np.random.default_rng(2)
    vecs = [rng.normal(size=700).astype(f32) for _ in range(8)]
    rho, alpha = f32(0.9), f32(0.4)
    out_j = JK.fused_omega_update(*map(jnp.asarray, vecs), jnp.asarray(rho),
                                  jnp.asarray(alpha), interpret=True)
    out_t = TK.fused_omega_update(*map(_t, vecs), _t(rho), _t(alpha))
    names = ("x", "r", "p", "omega", "rho", "res2")
    tols = (1e-5, 1e-5, 1e-4, 1e-5, 1e-4, 1e-4)
    for name, tol, a, b in zip(names, tols, out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=tol, err_msg=name)


def test_fused_guards_are_the_reference_tiny():
    """A zero denominator divides by 1e-30 (krylov_kernels.py _TINY),
    not by finfo.tiny as the unfused chain does."""
    z = torch.zeros(5, dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32)
    _, alpha = TK.fused_alpha_s(z, z + 1, z, one)
    assert float(alpha) == pytest.approx(1e30, rel=1e-6)


@pytest.mark.parametrize("precond", [False, True])
def test_bicgstab_fused_matches_jax(precond):
    A, b, x_true = _random_system(200, seed=4)
    d = f32(1.0 / 200.0)
    kw = dict(rtol=1e-6, maxiter=200)
    x_j, st_j = JK.bicgstab_fused(
        lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
        precond=(lambda z: d * z) if precond else None, interpret=True, **kw)
    At = _t(A)
    x_t, st_t = TK.bicgstab_fused(
        lambda x: At @ x, _t(b), precond=(lambda z: d * z) if precond
        else None, **kw)
    assert st_t["converged"] and bool(st_j["converged"])
    assert st_t["iterations"] == int(st_j["iterations"]) > 1
    assert x_t.dtype == torch.float32
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=5e-4,
                               atol=5e-4)
    np.testing.assert_allclose(x_t.numpy(), x_true, rtol=2e-3, atol=2e-3)


def test_resolve_bicgstab():
    assert resolve_bicgstab(torch.float64, None) is bicgstab
    assert resolve_bicgstab(torch.float32, None) is bicgstab
    assert resolve_bicgstab(torch.float32, False) is bicgstab
    assert resolve_bicgstab(torch.float32, True) is TK.bicgstab_fused
    with pytest.raises(ValueError, match="float32"):
        resolve_bicgstab(torch.float64, True)


def _solvers(pkg_stencil, fused, rtol=1e-5, **gmg):
    return pkg_stencil.StencilKrylovSolver(
        preconditioner=pkg_stencil.StencilCPR(gmg=pkg_stencil.GMG(
            n_smooth=2, **gmg)), rtol=rtol, max_iterations=80,
        use_fused_body=fused)


def _to_port(Aj):
    """The JAX package's StencilMatrix as the port's, float32."""
    return StencilMatrix(tuple(Aj.L), _t(Aj.diag),
                         {a: _t(v) for a, v in Aj.plus.items()},
                         {a: _t(v) for a, v in Aj.minus.items()})


@pytest.fixture(scope="module")
def lattice_system():
    """tests/test_fused_krylov.py's flagship stencil Jacobian (8x8x4,
    perturbed pressure), assembled by the JAX package, float32."""
    from jutul.jl_tpu import (
        CartesianMesh,
        compile_model,
        setup_parameters,
        setup_state,
    )
    from jutul.jl_tpu.models.darcy import ImmiscibleFluid, setup_darcy_model
    from jutul.jl_tpu.models.setup import merge_state
    from jutul.jl_tpu.ops.stencil import StencilCompiledModel

    nx = ny = 8
    nz = 4
    nc = nx * ny * nz
    rng = np.random.default_rng(0)
    mesh = CartesianMesh((nx, ny, nz), (100.0, 100.0, 10.0))
    model = setup_darcy_model(
        mesh, ImmiscibleFluid(viscosities=(1e-3, 2e-3)),
        permeability=rng.lognormal(0.0, 1.0, nc) * 1e-13,
        porosity=0.25, gravity=True)
    sw = rng.uniform(0.2, 0.8, nc)
    state0 = setup_state(model, Pressure=200e5,
                         Saturations=np.stack([sw, 1 - sw], axis=1))
    params = setup_parameters(model)
    comp = compile_model(model)
    sc = StencilCompiledModel(comp)
    st = {k: jnp.asarray(v, jnp.float32) for k, v in state0.items()}
    pr = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    full = comp.evaluate_secondaries(merge_state(st, pr))
    st2 = dict(st)
    st2["Pressure"] = st["Pressure"] * (1 + 1e-3 * rng.normal(size=nc)
                                        ).astype(np.float32)
    full2 = comp.evaluate_secondaries(merge_state(st2, pr))
    r2, A2, _ = sc.assemble(full2, full, 3600.0)
    A32 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), A2)
    return A32, jnp.asarray(r2, jnp.float32)


def _check_solves(du_t, st_t, du_j, st_j):
    assert st_t["converged"] and bool(st_j["converged"])
    assert st_t["iterations"] == int(st_j["iterations"]) > 1
    du_j = np.asarray(du_j)
    assert du_t.shape == du_j.shape and du_t.dtype == torch.float32
    scale = np.abs(du_j).max()
    assert np.abs(du_t.numpy() - du_j).max() <= 1e-4 * scale


def test_stencil_solver_fused_matches_jax(lattice_system):
    import jutul.jl_tpu.ops.stencil as JS
    import jutul.jl_tpu_torch.ops.stencil as TS

    A32, r32 = lattice_system
    du_j, st_j = _solvers(JS, True, use_pallas=False).solve(A32, r32)
    solver = _solvers(TS, True)
    du_t, st_t = solver.solve(_to_port(A32), _t(r32))
    _check_solves(du_t, st_t, du_j, st_j)
    # the plain chain in the port agrees with its fused body, too
    du_p, st_p = _solvers(TS, None).solve(_to_port(A32), _t(r32))
    assert st_p["iterations"] == st_t["iterations"]
    assert (du_p - du_t).abs().max() <= 1e-4 * du_p.abs().max()


def test_bordered_solver_fused_matches_jax():
    """The bordered (Schur-eliminated wells) branch on the 10x10x6 well
    flagship's Jacobian, assembled by the JAX package at float64 and cast
    to float32 there; the port's matrix carries the same values.

    The float32 Schur system amplifies roundoff: the two packages' residual
    histories part by up to 10x mid-solve (their plain chains too), so the
    solve runs to rtol 1e-6, where both have converged to their common
    answer — the residuals there sit 2x either side of the tolerance."""
    import jutul.jl_tpu.ops.stencil as JS
    import jutul.jl_tpu_torch.ops.stencil as TS
    from jutul.jl_tpu.ops.assembly import compile_model as jcompile
    from jutul.jl_tpu.models.setup import merge_state as jmerge
    from jutul.jl_tpu.ops.stencil_wells import BorderedStencilModel as JB
    from jutul.jl_tpu_torch.models.setup import merge_state as tmerge
    from jutul.jl_tpu_torch.ops.stencil_wells import (
        BorderedStencilMatrix,
        BorderedStencilModel,
    )

    dims = (10, 10, 6)
    jm, _, js, jp, jf = bench.build(*dims, gravity=True, wells=True,
                                    well_models=True)
    rng = np.random.default_rng(7)
    st = {k: np.asarray(v) for k, v in js.items()}
    st["Pressure"] = st["Pressure"] * (1 + 1e-3 * rng.normal(
        size=st["Pressure"].shape))
    to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    rj, Bj, _ = JB(jcompile(jm)).assemble(
        jmerge(to_j(st), to_j(jp)), jmerge(to_j(js), to_j(jp)), 3600.0, jf)
    B32 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32)
                                 if jnp.issubdtype(jnp.asarray(x).dtype,
                                                   jnp.floating) else x, Bj)
    r32 = jnp.asarray(rj, jnp.float32)

    tm, ts, tp, _ = chip_smoke.build_well_flagship(*dims)
    eng = BorderedStencilModel(tpkg.compile_model(tm), "cpu")
    full = tmerge(tpkg.from_numpy(ts, "cpu", torch.float32),
                  tpkg.from_numpy(tp, "cpu", torch.float32))
    _, Bt, _ = eng.assemble(full, full, 3600.0, chip_smoke.build_well_flagship(
        *dims)[3])  # float32 perforation memberships
    Bt32 = BorderedStencilMatrix(_to_port(B32.A), Bt.perfs, _t(B32.J_rb),
                                 _t(B32.J_br), _t(B32.D_ww))

    kw = dict(rtol=1e-6, n_coarse_sweeps=12, min_cells=64)
    du_j, st_j = _solvers(JS, True, use_pallas=False, **kw).solve(B32, r32)
    du_t, st_t = _solvers(TS, True, **kw).solve(Bt32, _t(r32))
    assert du_t.shape == (int(np.prod(dims)) + 5, 2)
    _check_solves(du_t, st_t, du_j, st_j)


def test_fused_body_refuses_float64(lattice_system):
    A32, r32 = lattice_system
    A64 = StencilMatrix(A32.L, _t(A32.diag).double(),
                        {a: _t(v).double() for a, v in A32.plus.items()},
                        {a: _t(v).double() for a, v in A32.minus.items()})
    solver = StencilKrylovSolver(preconditioner=StencilCPR(gmg=GMG()),
                                 use_fused_body=True)
    with pytest.raises(ValueError, match="float32"):
        solver.solve(A64, _t(r32).double())
