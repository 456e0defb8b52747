"""bfloat16 coefficient streaming (``GMG(coef_dtype="bf16")``) and the GMG
constructor's ``coarsen_factor`` / ``prolongation``, against the JAX package
on the CPU.

With ``coef_dtype=bfloat16`` the JAX kernels store their coefficient lattice
in bfloat16 and widen it to the vector dtype on load; the arithmetic is
unchanged. The port's kernels do the same, and on the CPU each wrapper runs
its plain version, so here:

- each plain version (K1, K2, K4, K10) with bfloat16 coefficients against the
  JAX interpret-mode kernel with ``coef_dtype=jnp.bfloat16`` on the same
  inputs: 1e-6 of the largest value at float32 vectors (the same arithmetic
  on the same rounded coefficients, sums in another order);
- each plain version with bfloat16 coefficients equals itself on the
  pre-rounded, widened coefficients: exactly (float32 and float64 vectors);
- the CPR(GMG(coef_dtype="bf16")) solve against the JAX solver with its
  kernels on (tests/test_pallas.py's case): same iteration count, ``du``
  within 1e-5; it differs from the full-precision run; the Krylov
  operator's coefficients are never narrowed;
- ``GMG(coarsen_factor=4)`` and ``GMG(prolongation="linear")`` V-cycles
  against the JAX ``GMG.vcycle`` on a ragged lattice at float64: 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jutul.jl_tpu.ops import stencil as jst
from jutul.jl_tpu.ops.pallas import PallasStencilMatvec
from jutul.jl_tpu.ops.pallas.stencil_kernels import (
    PallasFusedScalarLevel,
    PallasSlabFusedScalarLevel,
)
from jutul.jl_tpu_torch.linsolve.cheby import chebyshev_steps
from jutul.jl_tpu_torch.ops import stencil as tst
from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK

L = (8, 8, 16)  # several z-slabs at a 128 KiB budget
OMEGA, LOWER = 0.8, 0.25
BF16 = torch.bfloat16


def _close(got, ref, what, tol=1e-6):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype == np.float32, what
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (what, err)


def _scalar(L_, seed, dtype=np.float32, dead=()):
    """Seeded pressure-like scalar stencil as numpy arrays + two vectors."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = L_
    n = nz * ny * nx
    fs = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    diag = (np.full(n, 6.0) + rng.uniform(0, 1, n)).astype(dtype)
    diag[list(dead)] = 0.0
    plus = {a: -np.abs(rng.normal(size=s)).astype(dtype) for a, s in fs.items()}
    minus = {a: -np.abs(rng.normal(size=s)).astype(dtype)
             for a, s in fs.items()}
    return (diag, plus, minus, rng.normal(size=n).astype(dtype),
            rng.normal(size=n).astype(dtype))


def _both(L_, diag, plus, minus):
    j, t = jnp.asarray, torch.from_numpy
    return (jst.ScalarStencil(L_, j(diag), {a: j(v) for a, v in plus.items()},
                              {a: j(v) for a, v in minus.items()}),
            tst.ScalarStencil(L_, t(diag), {a: t(v) for a, v in plus.items()},
                              {a: t(v) for a, v in minus.items()}))


@pytest.fixture(scope="module")
def level():
    diag, plus, minus, b, u = _scalar(L, 13)
    A_j, A_t = _both(L, diag, plus, minus)
    return A_j, A_t, b, u


# ---------------------------------------------------------------------------
# plain versions against the JAX kernels with coef_dtype=bfloat16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("C,K", [(2, 2), (2, 1), (1, 1)])
def test_k1_bf16_matches_jax_kernel(C, K):
    rng = np.random.default_rng(3)
    L_ = (4, 5, 6)
    nz, ny, nx = L_
    n = nz * ny * nx
    fs = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    diag = f32(C, K, n)
    plus = {a: f32(C, K, *s) for a, s in fs.items()}
    minus = {a: f32(C, K, *s) for a, s in fs.items()}
    x = f32(n, K)
    j, t = jnp.asarray, torch.from_numpy
    jmv = PallasStencilMatvec(
        jst.StencilMatrix(L_, j(diag), {a: j(v) for a, v in plus.items()},
                          {a: j(v) for a, v in minus.items()}),
        interpret=True, coef_dtype=jnp.bfloat16)
    assert jmv.coeffs.dtype == jnp.bfloat16
    mv = SK.StencilMatvec(
        tst.StencilMatrix(L_, t(diag), {a: t(v) for a, v in plus.items()},
                          {a: t(v) for a, v in minus.items()}),
        coef_dtype=BF16)
    assert mv.coef.dtype == BF16 and mv.coef.shape == (7, C * K, n)
    before = (SK.stencil_matvec.launches, SK.stencil_matvec.launches_bf16c)
    y = mv(t(x))
    _close(y, jmv(j(x)), "K1 bf16")
    # CPU tensors run the plain version, which counts no launch
    assert (SK.stencil_matvec.launches,
            SK.stencil_matvec.launches_bf16c) == before
    # the rounding is really there: the full-precision product differs
    full = SK.StencilMatvec(tst.StencilMatrix(
        L_, t(diag), {a: t(v) for a, v in plus.items()},
        {a: t(v) for a, v in minus.items()}))(t(x))
    assert not torch.equal(y, full)
    np.testing.assert_allclose(y.numpy(), full.numpy(), rtol=0, atol=0.2)


def test_k2_bf16_matches_jax_whole_level_kernel(level):
    """B3/B4 with bfloat16 coefficients (``PallasFusedScalarLevel``)."""
    A_j, A_t, b, u = level
    jlv = PallasFusedScalarLevel(A_j, interpret=True, coef_dtype=jnp.bfloat16)
    lv = SK.ScalarLevel(A_t, coef_dtype=BF16)
    assert lv.coef.dtype == BF16
    j, t = jnp.asarray, torch.from_numpy
    uu, rr = lv.presmooth_residual(t(b), OMEGA, 2)
    ju, jr = jlv.presmooth_residual(j(b), OMEGA, 2)
    _close(uu, ju, "presmooth u")
    _close(rr, jr, "presmooth r")
    _close(lv.postsmooth(t(u), t(b), OMEGA, 2),
           jlv.postsmooth(j(u), j(b), OMEGA, 2), "postsmooth")
    _close(lv.sweep_n(t(b), OMEGA, 12), jlv.sweep_n(j(b), OMEGA, 12),
           "sweep_n")
    _close(lv.residual(t(u), t(b)), jlv.residual(j(u), j(b)), "residual")
    _close(lv.smooth(t(u), t(b), OMEGA), jlv.smooth(j(u), j(b), OMEGA),
           "smooth")


@pytest.mark.parametrize("double_buffer", [False, True])
def test_k2_k5_bf16_match_jax_slab_kernel(level, double_buffer, monkeypatch):
    """B2 (the K2 chain at this size) and, with ``double_buffer``, B8 with
    bfloat16 coefficients (``PallasSlabFusedScalarLevel``), through the
    level a GMG with ``slab_double_buffer`` builds. B8's route is K10's:
    with every level a slab level, as the flagship's fine level is, its
    phases go through K10's wrapper."""
    A_j, A_t, b, u = level
    jlv = PallasSlabFusedScalarLevel(
        A_j, n_smooth=2, interpret=True, vmem_budget=128 * 1024,
        coef_dtype=jnp.bfloat16, double_buffer=double_buffer)
    assert jlv.tz < L[0], "the budget should force several z-slabs"
    calls = []
    if double_buffer:
        monkeypatch.setattr(SK, "SLAB_MIN_CELLS", 0)
        real = SK.scalar_jacobi_slab
        monkeypatch.setattr(SK, "scalar_jacobi_slab", lambda *a, **k: (
            calls.append(a[4]), real(*a, **k))[1])
    gmg = tst.GMG(n_smooth=2, coef_dtype="bf16")
    gmg.slab_double_buffer = double_buffer
    lv, = gmg.matvecs([A_t])
    assert lv.coef.dtype == BF16
    j, t = jnp.asarray, torch.from_numpy
    uu, rr = lv.presmooth_residual(t(b), OMEGA, 2)
    ju, jr = jlv.presmooth_residual(j(b), OMEGA, 2)
    _close(uu, ju, "presmooth u")
    _close(rr, jr, "presmooth r")
    _close(lv.postsmooth(t(u), t(b), OMEGA, 2),
           jlv.postsmooth(j(u), j(b), OMEGA, 2), "postsmooth")
    _close(lv.sweep_n(t(b), OMEGA, 5), jlv.sweep_n(j(b), OMEGA, 5),
           "sweep_n")
    # the two V-cycle hooks are one K10 call each (sweep_n: K8's, the
    # level fits it)
    assert calls == ([2, 2] if double_buffer else [])


@pytest.mark.parametrize("kernel", ["B6", "B7"])
def test_k4_bf16_matches_jax_chebyshev_kernels(level, kernel):
    """The two Chebyshev calls with bfloat16 coefficients. The eigenvalue
    bound comes from the full-precision stencil in both packages."""
    A_j, A_t, b, u = level
    if kernel == "B6":
        jlv = PallasFusedScalarLevel(A_j, interpret=True,
                                     coef_dtype=jnp.bfloat16)
    else:
        jlv = PallasSlabFusedScalarLevel(
            A_j, n_smooth=2, interpret=True, vmem_budget=128 * 1024,
            coef_dtype=jnp.bfloat16)
    lv = SK.ScalarLevel(A_t, coef_dtype=BF16)
    _, lmax_j = jst._cheby_setup(A_j)
    _, lmax_t = tst._cheby_setup(A_t)
    j, t = jnp.asarray, torch.from_numpy
    steps = chebyshev_steps(lmax_t, LOWER, 2)
    uu, rr = lv.presmooth_residual_cheby(t(b), steps, 2)
    ju, jr = jlv.presmooth_residual_cheby(j(b), lmax_j, 2, LOWER)
    _close(uu, ju, "presmooth u")
    _close(rr, jr, "presmooth r", tol=2e-6)
    _close(lv.postsmooth_cheby(t(u), t(b), steps, 2),
           jlv.postsmooth_cheby(j(u), j(b), lmax_j, 2, LOWER), "postsmooth")
    if kernel == "B6":
        steps12 = chebyshev_steps(lmax_t, LOWER, 12)
        _close(lv.sweep_n_cheby(t(b), steps12, 12),
               jlv.sweep_n_cheby(j(b), lmax_j, 12, LOWER), "sweep_n", 2e-6)


# ---------------------------------------------------------------------------
# bfloat16 coefficients == the same call on pre-rounded, widened ones
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_versions_equal_their_pre_rounded_run(dtype):
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    L_ = (5, 7, 9)
    diag, plus, minus, b, u = _scalar(L_, 4, np_dt, dead=(0, 17, 200))
    _, A_t = _both(L_, diag, plus, minus)
    c16 = SK.ScalarLevel(A_t, coef_dtype=BF16).coef
    wide = c16.to(dtype)
    assert c16.dtype == BF16 and not torch.equal(wide,
                                                 SK.ScalarLevel(A_t).coef)
    b, u = torch.from_numpy(b), torch.from_numpy(u)
    d = torch.from_numpy(np.random.default_rng(5).normal(
        size=b.shape[0]).astype(np_dt))
    for mode in (SK.MODE_INIT, SK.MODE_RESIDUAL, SK.MODE_SMOOTH):
        got = SK.scalar_jacobi(c16, b, u, OMEGA, mode, L_)
        assert got.dtype == dtype
        assert torch.equal(got, SK.scalar_jacobi(wide, b, u, OMEGA, mode, L_))
    # dinv comes from the WIDENED diagonal: dead rows stay dead
    assert float(SK.scalar_jacobi(c16, b, u, OMEGA, SK.MODE_INIT, L_)[17]) \
        == 0.0
    for u0, n_sweep, res in ((None, 2, True), (u, 3, False), (None, 5, False)):
        got = SK.scalar_jacobi_slab(c16, b, u0, OMEGA, n_sweep, res, L_)
        want = SK.scalar_jacobi_slab(wide, b, u0, OMEGA, n_sweep, res, L_)
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) == (want[1] is None) == (not res)
        if res:
            assert torch.equal(got[1], want[1])
    steps = chebyshev_steps(torch.tensor(1.9, dtype=dtype), LOWER, 4)
    for mode, k in ((SK.CHEB_ZERO, 0), (SK.CHEB_FIRST, 0), (SK.CHEB_STEP, 3)):
        got = SK.scalar_chebyshev(c16, b, u, d, steps, k, mode, L_)
        want = SK.scalar_chebyshev(wide, b, u, d, steps, k, mode, L_)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    x = torch.stack([b, u], dim=1)
    col = c16.reshape(7, 1, -1).expand(7, 2, -1).contiguous()  # C=2, K=1
    assert torch.equal(SK.stencil_matvec(col, b[:, None], L_, 2, 1),
                       SK.stencil_matvec(col.to(dtype), b[:, None], L_, 2, 1))
    blk = torch.cat([col, col.flip(1)], dim=1)  # C=K=2
    assert torch.equal(SK.stencil_matvec(blk, x, L_, 2, 2),
                       SK.stencil_matvec(blk.to(dtype), x, L_, 2, 2))


# ---------------------------------------------------------------------------
# the CPR solve
# ---------------------------------------------------------------------------
def _block_matrix():
    """tests/test_pallas.py ``test_cpr_bf16_preconditioner_converges``'s
    matrix (seed 5, strongly diagonally dominant) and right-hand side."""
    L_ = (4, 8, 8)
    nz, ny, nx = L_
    n = nz * ny * nx
    rng = np.random.default_rng(5)
    diag = rng.normal(size=(2, 2, n))
    fs = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    plus, minus = {}, {}
    for a, s in fs.items():
        plus[a] = rng.normal(size=(2, 2) + s).astype(np.float32)
        minus[a] = rng.normal(size=(2, 2) + s).astype(np.float32)
    for c in range(2):
        diag[c, c] = np.abs(diag[c, c]) + 12.0
    r = np.random.default_rng(7).normal(size=(n, 2)).astype(np.float32)
    return L_, diag.astype(np.float32), plus, minus, r


def test_cpr_bf16_solve_matches_jax():
    L_, diag, plus, minus, r = _block_matrix()
    j, t = jnp.asarray, torch.from_numpy
    A_j = jst.StencilMatrix(L_, j(diag), {a: j(v) for a, v in plus.items()},
                            {a: j(v) for a, v in minus.items()})
    A_t = tst.StencilMatrix(L_, t(diag), {a: t(v) for a, v in plus.items()},
                            {a: t(v) for a, v in minus.items()})

    def jsolve(coef_dtype):
        s = jst.StencilKrylovSolver(
            preconditioner=jst.StencilCPR(gmg=jst.GMG(
                min_cells=64, use_pallas=True, coef_dtype=coef_dtype)),
            rtol=1e-8, max_iterations=60, use_fused_body=False)
        du, stats = s.solve(A_j, j(r))
        return np.asarray(du), int(stats["iterations"])

    def tsolve(coef_dtype):
        cpr = tst.StencilCPR(gmg=tst.GMG(min_cells=64, coef_dtype=coef_dtype))
        s = tst.StencilKrylovSolver(preconditioner=cpr, rtol=1e-8,
                                    max_iterations=60)
        du, stats = s.solve(A_t, t(r))
        return du.numpy(), stats["iterations"], cpr.update(A_t)

    jdu16, jits16 = jsolve("bf16")
    du16, its16, pst16 = tsolve("bf16")
    du32, its32, pst32 = tsolve(None)
    duf32, itsf32, _ = tsolve("f32")
    assert its16 == jits16
    np.testing.assert_allclose(du16, jdu16, rtol=0, atol=1e-5)
    assert not np.array_equal(du16, du32), "the narrow path did not run"
    np.testing.assert_allclose(du16, du32, rtol=1e-3, atol=1e-5)
    assert np.array_equal(duf32, du32) and itsf32 == its32  # "f32" == None
    # what is narrowed: the level kernels' and the stage-2 matvec's
    # coefficients; never the Krylov operator's, nor the hierarchy
    assert pst16.mv_A.coef.dtype == torch.float32
    assert pst16.mv_Ap.coef.dtype == BF16
    assert all(lv.coef.dtype == BF16 for lv in pst16.mvs)
    assert pst32.mv_Ap.coef.dtype == torch.float32
    assert all(lv.coef.dtype == torch.float32 for lv in pst32.mvs)
    for o16, o32 in zip(pst16.ops, pst32.ops):
        assert o16.diag.dtype == torch.float32
        assert torch.equal(o16.diag, o32.diag)


def test_bf16_leaves_chebyshev_bound_in_full_precision():
    diag, plus, minus, _, _ = _scalar(L, 13)
    _, A_t = _both(L, diag, plus, minus)
    out = []
    for cd in (None, "bf16"):
        gmg = tst.GMG(min_cells=64, smoother="chebyshev", coef_dtype=cd)
        out.append(gmg.cheby_data(gmg.hierarchy(A_t)))
    assert all(torch.equal(a, b) for a, b in zip(*out))


# ---------------------------------------------------------------------------
# coarsen_factor and prolongation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(coarsen_factor=4),
                                dict(prolongation="linear"),
                                dict(coarsen_factor=3),
                                dict(prolongation="linear",
                                     smoother="chebyshev")],
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_vcycle_matches_jax(kw):
    """Ragged lattice (no extent a multiple of the factor), float64, XLA
    levels on the JAX side."""
    L_ = (5, 11, 18)
    diag, plus, minus, b, _ = _scalar(L_, 9, np.float64)
    A_j, A_t = _both(L_, diag, plus, minus)
    common = dict(n_smooth=2, n_coarse_sweeps=12, min_cells=8)
    jg = jst.GMG(use_pallas=False, **common, **kw)
    tg = tst.GMG(**common, **kw)
    jops, tops = jg.hierarchy(A_j), tg.hierarchy(A_t)
    assert [tuple(o.L) for o in tops] == [tuple(o.L) for o in jops]
    assert len(tops) >= 2
    for to, jo in zip(tops, jops):
        np.testing.assert_allclose(to.diag.numpy(), np.asarray(jo.diag),
                                   rtol=1e-13)
    want = np.asarray(jg.vcycle(jops, jnp.asarray(b)))
    got = tg.vcycle(tops, torch.from_numpy(b), mvs=tg.matvecs(tops),
                    cheb=tg.cheby_data(tops)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("kw,msg", [
    (dict(coarsen_factor=1), "coarsen_factor must be >= 2"),
    (dict(prolongation="linear", coarsen_factor=4), "requires"),
    (dict(prolongation="cubic"), "unknown prolongation"),
    (dict(coef_dtype="fp8"), "unknown coef_dtype")])
def test_gmg_validation_matches_jax(kw, msg):
    with pytest.raises(ValueError, match=msg):
        jst.GMG(**kw)
    with pytest.raises(ValueError, match=msg):
        tst.GMG(**kw)
