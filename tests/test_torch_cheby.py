"""The Chebyshev GMG smoother: kernel K4's plain version, its level hooks
and the GMG/CPR built on them, against the JAX package — its XLA
recurrence (``_cheby_smooth`` with ``XLAScalarLevel``) and its Pallas
kernels in interpret mode: ``_kernel_sweeps_cheby`` (B6, whole level,
``PallasFusedScalarLevel``) and ``_kernel_slab_sweeps_cheby`` (B7,
deep-halo slabs, ``PallasSlabFusedScalarLevel``).

Tolerance: rtol 1e-12 against the largest magnitude of each result, at
f64 — interpret mode is exact on the CPU, so only the summation order
differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jutul.jl_tpu.ops import stencil as jst
from jutul.jl_tpu.ops.pallas.stencil_kernels import (
    PallasFusedScalarLevel,
    PallasSlabFusedScalarLevel,
    XLAScalarLevel,
)
from jutul.jl_tpu_torch.linsolve.cheby import chebyshev_steps
from jutul.jl_tpu_torch.ops import stencil as tst
from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as K

RTOL = 1e-12
LOWER = 0.25
L_LEVEL = (8, 8, 16)  # several slabs at a 128 KiB budget (as for K2)


def assert_close(actual, desired, rtol=RTOL, what=""):
    actual, desired = np.asarray(actual), np.asarray(desired)
    assert actual.shape == desired.shape, what
    scale = max(np.abs(desired).max(), 1e-300)
    err = np.abs(actual - desired).max()
    assert err <= rtol * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def _scalar_arrays(L, seed, dead=()):
    """A pressure-like scalar stencil (not diagonally dominant, so the
    Gershgorin bound is above 2); rows in ``dead`` have diag 0."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(L))
    nz, ny, nx = L
    shapes = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    plus = {a: -np.abs(rng.normal(size=s)) for a, s in shapes.items()
            if all(s)}
    minus = {a: -np.abs(rng.normal(size=v.shape)) for a, v in plus.items()}
    diag = np.full(n, 4.0) + rng.uniform(0, 1, n)
    diag[list(dead)] = 0.0
    return diag, plus, minus


def _stencils(L, seed, dead=()):
    diag, plus, minus = _scalar_arrays(L, seed, dead)
    A_j = jst.ScalarStencil(L, jnp.asarray(diag),
                            {a: jnp.asarray(v) for a, v in plus.items()},
                            {a: jnp.asarray(v) for a, v in minus.items()})
    A_t = tst.ScalarStencil(L, torch.as_tensor(diag),
                            {a: torch.as_tensor(v) for a, v in plus.items()},
                            {a: torch.as_tensor(v) for a, v in minus.items()})
    return A_j, A_t


@pytest.fixture(scope="module")
def level():
    A_j, A_t = _stencils(L_LEVEL, seed=21)
    rng = np.random.default_rng(22)
    n = A_t.n
    b, u = rng.normal(size=n), rng.normal(size=n)
    dinv_j, lmax_j = jst._cheby_setup(A_j)
    dinv_t, lmax_t = tst._cheby_setup(A_t)
    return A_j, K.ScalarLevel(A_t), b, u, dinv_j, lmax_j, (dinv_t, lmax_t)


def test_cheby_setup_matches_jax():
    """Gershgorin lmax and dinv, with dead rows (diag 0 -> dinv 0)."""
    L = (5, 6, 10)
    A_j, A_t = _stencils(L, seed=3, dead=(0, 17, 299))
    dinv_j, lmax_j = jst._cheby_setup(A_j)
    dinv_t, lmax_t = tst._cheby_setup(A_t)
    assert lmax_t.ndim == 0 and lmax_t.dtype == torch.float64
    assert_close(lmax_t.numpy(), lmax_j, what="lmax")
    assert_close(dinv_t.numpy(), dinv_j, what="dinv")
    assert float(dinv_t[17]) == 0.0
    assert float(lmax_t) > 2.0


def test_chebyshev_steps_follow_the_recurrence():
    """The table's rows are the recurrence's scalars, for several levels
    at once."""
    lmax = torch.tensor([2.5, 1.75], dtype=torch.float64)
    steps = chebyshev_steps(lmax, LOWER, 5)
    assert steps.shape == (2, 5, 2)
    for i, lm in enumerate((2.5, 1.75)):
        lmin = LOWER * lm
        theta, delta = 0.5 * (lm + lmin), 0.5 * (lm - lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        assert float(steps[i, 0, 0]) == theta and float(steps[i, 0, 1]) == 0
        for k in range(1, 5):
            rho_new = 1.0 / (2.0 * sigma - rho)
            assert float(steps[i, k, 0]) == rho_new * rho
            assert float(steps[i, k, 1]) == 2.0 * rho_new / delta
            rho = rho_new


@pytest.mark.parametrize("n_sweep", [2, 12])
def test_k4_hooks_match_xla_recurrence(level, n_sweep):
    """K4's plain multi-step hooks == the JAX package's XLA recurrence
    (``_cheby_smooth``) == the port's own recurrence."""
    A_j, lv, b, u, dinv_j, lmax_j, (dinv_t, lmax_t) = level
    xla = XLAScalarLevel(A_j)
    bj, uj = jnp.asarray(b), jnp.asarray(u)
    bt, ut = torch.as_tensor(b), torch.as_tensor(u)
    steps = chebyshev_steps(lmax_t, LOWER, n_sweep)
    ref0 = jst._cheby_smooth(xla, dinv_j, lmax_j, None, bj, n_sweep, LOWER)
    ref1 = jst._cheby_smooth(xla, dinv_j, lmax_j, uj, bj, n_sweep, LOWER)
    assert_close(lv.sweep_n_cheby(bt, steps, n_sweep).numpy(), ref0,
                 what="sweep_n_cheby")
    assert_close(lv.postsmooth_cheby(ut, bt, steps, n_sweep).numpy(), ref1,
                 what="postsmooth_cheby")
    u_t, r_t = lv.presmooth_residual_cheby(bt, steps, n_sweep)
    assert_close(u_t.numpy(), ref0, what="presmooth u")
    assert_close(r_t.numpy(), xla.residual(ref0, bj), what="presmooth r")
    assert_close(tst._cheby_smooth(lv, dinv_t, lmax_t, ut, bt, n_sweep,
                                   LOWER).numpy(), ref1, what="port recurrence")


@pytest.mark.parametrize("n_sweep", [2, 12])
def test_k4_hooks_match_pallas_b6(level, n_sweep):
    """B6 ``_kernel_sweeps_cheby`` (whole level, interpret mode)."""
    A_j, lv, b, u, _, lmax_j, (_, lmax_t) = level
    pal = PallasFusedScalarLevel(A_j, interpret=True)
    bj, uj = jnp.asarray(b), jnp.asarray(u)
    bt, ut = torch.as_tensor(b), torch.as_tensor(u)
    steps = chebyshev_steps(lmax_t, LOWER, n_sweep)
    assert_close(lv.sweep_n_cheby(bt, steps, n_sweep).numpy(),
                 pal.sweep_n_cheby(bj, lmax_j, n_sweep, LOWER),
                 what="sweep_n_cheby")
    assert_close(lv.postsmooth_cheby(ut, bt, steps, n_sweep).numpy(),
                 pal.postsmooth_cheby(uj, bj, lmax_j, n_sweep, LOWER),
                 what="postsmooth_cheby")
    u_p, r_p = pal.presmooth_residual_cheby(bj, lmax_j, n_sweep, LOWER)
    u_t, r_t = lv.presmooth_residual_cheby(bt, steps, n_sweep)
    assert_close(u_t.numpy(), u_p, what="presmooth u")
    assert_close(r_t.numpy(), r_p, what="presmooth r")


def test_k4_hooks_match_pallas_b7(level):
    """B7 ``_kernel_slab_sweeps_cheby`` (deep-halo slabs, interpret mode)
    at the V-cycle's n_smooth = 2 (its halo depth; B7 has no
    ``sweep_n_cheby``)."""
    A_j, lv, b, u, _, lmax_j, (_, lmax_t) = level
    pal = PallasSlabFusedScalarLevel(A_j, n_smooth=2, interpret=True,
                                     vmem_budget=128 * 1024)
    assert pal.tz < L_LEVEL[0], "budget should force several slabs"
    bj, uj = jnp.asarray(b), jnp.asarray(u)
    bt, ut = torch.as_tensor(b), torch.as_tensor(u)
    steps = chebyshev_steps(lmax_t, LOWER, 2)
    assert_close(lv.postsmooth_cheby(ut, bt, steps, 2).numpy(),
                 pal.postsmooth_cheby(uj, bj, lmax_j, 2, LOWER),
                 what="postsmooth_cheby")
    u_p, r_p = pal.presmooth_residual_cheby(bj, lmax_j, 2, LOWER)
    u_t, r_t = lv.presmooth_residual_cheby(bt, steps, 2)
    assert_close(u_t.numpy(), u_p, what="presmooth u")
    assert_close(r_t.numpy(), r_p, what="presmooth r")


def test_k4_single_steps():
    """Each mode of the plain version against its formula, with a dead
    row (dinv 0)."""
    L = (3, 4, 5)
    A_j, A_t = _stencils(L, seed=9, dead=(7,))
    lv = K.ScalarLevel(A_t)
    rng = np.random.default_rng(10)
    b, u, d = (torch.as_tensor(rng.normal(size=A_t.n)) for _ in range(3))
    steps = chebyshev_steps(tst._cheby_setup(A_t)[1], LOWER, 3)
    diag = A_t.diag
    dinv = torch.where(diag != 0, 1.0 / diag, torch.zeros_like(diag))
    res = b - torch.as_tensor(np.asarray(A_j.matvec(jnp.asarray(u.numpy()))))
    u0, d0 = K.scalar_chebyshev(lv.coef, b, None, None, steps, 0,
                                K.CHEB_ZERO, L)
    assert_close(d0.numpy(), ((dinv * b) / steps[0, 0]).numpy())
    assert u0 is d0
    u1, d1 = K.scalar_chebyshev(lv.coef, b, u, None, steps, 0, K.CHEB_FIRST,
                                L)
    assert_close(d1.numpy(), ((dinv * res) / steps[0, 0]).numpy())
    assert_close(u1.numpy(), (u + d1).numpy())
    u2, d2 = K.scalar_chebyshev(lv.coef, b, u, d, steps, 2, K.CHEB_STEP, L)
    assert_close(d2.numpy(),
                 (steps[2, 0] * d + steps[2, 1] * (dinv * res)).numpy())
    # a dead row's first step is zero, so its direction stays zero
    assert float(d0[7]) == float(d1[7]) == 0.0 and float(u1[7]) == float(u[7])


def test_gmg_vcycle_chebyshev_matches_jax():
    L = (5, 6, 10)  # odd nz exercises _pad_even
    A_j, A_t = _stencils(L, seed=4)
    g_j = jst.GMG(n_smooth=2, n_coarse_sweeps=6, min_cells=16,
                  smoother="chebyshev")
    g_t = tst.GMG(n_smooth=2, n_coarse_sweeps=6, min_cells=16,
                  smoother="chebyshev")
    ops_j, ops_t = g_j.hierarchy(A_j), g_t.hierarchy(A_t)
    assert len(ops_t) == len(ops_j) >= 3
    cheb = g_t.cheby_data(ops_t)
    assert [tuple(c.shape) for c in cheb] == [(6, 2)] * len(ops_t)
    b = np.random.default_rng(5).normal(size=A_j.n)
    assert_close(g_t.vcycle(ops_t, torch.as_tensor(b)).numpy(),
                 g_j.vcycle(ops_j, jnp.asarray(b)), rtol=1e-11, what="vcycle")


def test_cpr_chebyshev_matches_jax():
    from jutul.jl_tpu.ops.stencil import StencilCPR as JCPR

    L = (4, 8, 8)
    rng = np.random.default_rng(7)
    n = int(np.prod(L))
    shapes = {0: (4, 8, 7), 1: (4, 7, 8), 2: (3, 8, 8)}
    diag = rng.normal(size=(2, 2, n)) + 8.0 * np.eye(2)[:, :, None]
    plus = {a: rng.normal(size=(2, 2) + s) for a, s in shapes.items()}
    minus = {a: rng.normal(size=(2, 2) + s) for a, s in shapes.items()}
    conv = lambda f, d: {a: f(v) for a, v in d.items()}  # noqa: E731
    A_j = jst.StencilMatrix(L, jnp.asarray(diag), conv(jnp.asarray, plus),
                            conv(jnp.asarray, minus))
    A_t = tst.StencilMatrix(L, torch.as_tensor(diag),
                            conv(torch.as_tensor, plus),
                            conv(torch.as_tensor, minus))
    x = rng.normal(size=(n, 2))
    cj = JCPR(gmg=jst.GMG(n_smooth=2, n_coarse_sweeps=4, min_cells=64,
                          use_pallas=False, smoother="chebyshev"))
    ct = tst.StencilCPR(gmg=tst.GMG(n_smooth=2, n_coarse_sweeps=4,
                                    min_cells=64, smoother="chebyshev"))
    sj, stt = cj.update(A_j), ct.update(A_t)
    assert len(stt.cheb) == len(stt.ops) == len(sj.ops)
    assert_close(ct.apply(stt, A_t, torch.as_tensor(x)).numpy(),
                 cj.apply(sj, A_j, jnp.asarray(x)), rtol=1e-11, what="apply")


def test_gmg_rejects_unknown_smoother():
    for mod in (jst, tst):
        with pytest.raises(ValueError, match="unknown smoother"):
            mod.GMG(smoother="gauss-seidel")
    assert tst.GMG().cheby_data([]) is None


def test_k4_wrapper_refuses_devices_without_a_kernel():
    L = (2, 2, 2)
    meta = lambda *s: torch.zeros(*s, device="meta")  # noqa: E731
    with pytest.raises(RuntimeError, match="no kernel"):
        K.scalar_chebyshev(meta(7, 1, 8), meta(8), meta(8), meta(8),
                           meta(3, 2), 1, K.CHEB_STEP, L)
