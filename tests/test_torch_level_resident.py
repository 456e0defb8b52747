"""K8 ``scalar_sweeps_resident`` and K9 ``scalar_chebyshev_resident`` (a
whole GMG level's Jacobi / Chebyshev phase in one launch) on the CPU:
their plain versions against the TPU kernels they replace, B3
``_kernel_sweeps`` and B6 ``_kernel_sweeps_cheby`` in interpret mode
(``PallasFusedScalarLevel``), with float32, float64 and bfloat16
coefficients; the routing of GMG levels (``resident_plan``) as a pure
function of the lattice, dtypes and card properties; and the V-cycle with
that routing against the JAX package's.

Tolerances: max |port - JAX| <= 1e-12 (float64) / 1e-5 (float32, also
with bfloat16 coefficients) of the largest value — the same arithmetic,
sums in another order over up to 12 sweeps and a residual.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jutul.jl_tpu.ops import stencil as jst
from jutul.jl_tpu.ops.pallas.stencil_kernels import PallasFusedScalarLevel
from jutul.jl_tpu_torch.linsolve.cheby import chebyshev_steps
from jutul.jl_tpu_torch.ops import stencil as tst
from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK

OMEGA, LOWER = 0.8, 0.25
TOL = {np.float64: 1e-12, np.float32: 1e-5}
# (n_sweep, from u, residual): each sweep count from zero and from u, with
# and without the residual, two cases on each lattice (each case is one
# compilation of the interpret-mode kernel, ~1 s)
CASES = {(3, 5, 7): [(1, False, True), (12, True, False)],
         (4, 6, 8): [(2, False, False), (1, True, True)],
         (2, 1, 9): [(12, False, True), (2, True, False)]}


def _close(got, ref, tol, what):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), (what, err)


def _level(L, dtype, seed=0, dead=True):
    """A pressure-like scalar stencil (with ``dead``, one row with a zero
    diagonal) in both packages, a right-hand side and a start vector."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = L
    n = nz * ny * nx
    fs = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    diag = (np.full(n, 4.0) + rng.uniform(0, 1, n)).astype(dtype)
    if dead:
        diag[n // 2] = 0.0
    plus = {a: -np.abs(rng.normal(size=s)).astype(dtype)
            for a, s in fs.items() if all(s)}
    minus = {a: -np.abs(rng.normal(size=v.shape)).astype(dtype)
             for a, v in plus.items()}
    j, t = jnp.asarray, torch.from_numpy
    A_j = jst.ScalarStencil(L, j(diag), {a: j(v) for a, v in plus.items()},
                            {a: j(v) for a, v in minus.items()})
    A_t = tst.ScalarStencil(L, t(diag), {a: t(v) for a, v in plus.items()},
                            {a: t(v) for a, v in minus.items()})
    return (A_j, A_t, rng.normal(size=n).astype(dtype),
            rng.normal(size=n).astype(dtype))


def _b3_b6(A_j, b, u0, n_sweep, residual, cheby, coef_dtype=None):
    """The interpret-mode TPU kernel's (u, r or None)."""
    lv = PallasFusedScalarLevel(A_j, interpret=True, coef_dtype=coef_dtype)
    u0 = None if u0 is None else jnp.asarray(u0)
    if cheby:
        _, lmax = jst._cheby_setup(A_j)
        y = lv._call_cheby(jnp.asarray(b), u0, lmax, n_sweep, LOWER,
                           residual, u0 is None)
    else:
        y = lv._call(jnp.asarray(b), u0, n_sweep, OMEGA, residual, u0 is None)
    return y[0], (y[1] if residual else None)


def _port(A_t, b, u0, n_sweep, residual, cheby, coef_dtype=None):
    """K8's / K9's (u, r or None) through the wrapper (the plain version on
    CPU tensors)."""
    coef = SK.embed(A_t, coef_dtype)[2]
    L = tuple(A_t.L)
    b = torch.from_numpy(b)
    u0 = None if u0 is None else torch.from_numpy(u0)
    if cheby:
        steps = chebyshev_steps(tst._cheby_setup(A_t)[1], LOWER, n_sweep)
        return SK.scalar_chebyshev_resident(coef, b, u0, steps, n_sweep,
                                            residual, L)
    return SK.scalar_sweeps_resident(coef, b, u0, OMEGA, n_sweep, residual,
                                     L)


@pytest.mark.parametrize("cheby", [False, True], ids=["k8", "k9"])
@pytest.mark.parametrize("L", list(CASES))
def test_plain_matches_tpu_kernel_f64(L, cheby):
    A_j, A_t, b, u = _level(L, np.float64, seed=sum(L))
    for n_sweep, from_u, residual in CASES[L]:
        u0 = u if from_u else None
        got = _port(A_t, b, u0, n_sweep, residual, cheby)
        want = _b3_b6(A_j, b, u0, n_sweep, residual, cheby)
        for g, w, name in zip(got, want, "ur"):
            assert (g is None) == (w is None)
            if w is not None:
                _close(g, w, TOL[np.float64],
                       (L, n_sweep, from_u, residual, name))


@pytest.mark.parametrize("cheby", [False, True], ids=["k8", "k9"])
def test_plain_matches_tpu_kernel_f32(cheby):
    L = (4, 6, 8)
    A_j, A_t, b, u = _level(L, np.float32, seed=3)
    for n_sweep, from_u, residual in ((12, False, True), (2, True, False)):
        u0 = u if from_u else None
        got = _port(A_t, b, u0, n_sweep, residual, cheby)
        want = _b3_b6(A_j, b, u0, n_sweep, residual, cheby)
        for g, w in zip(got, want):
            if w is not None:
                _close(g, w, TOL[np.float32], (n_sweep, from_u, residual))


@pytest.mark.parametrize("cheby", [False, True], ids=["k8", "k9"])
def test_bf16_coefficients_match_tpu_kernel(cheby):
    """bfloat16 coefficients widened on load, float32 vectors, against the
    interpret-mode kernel with ``coef_dtype=bfloat16``; and equal to the
    plain version on the pre-rounded, widened coefficients."""
    L = (3, 5, 7)
    A_j, A_t, b, u = _level(L, np.float32, seed=5)
    for n_sweep, from_u, residual in ((12, True, True),):
        u0 = u if from_u else None
        got = _port(A_t, b, u0, n_sweep, residual, cheby, torch.bfloat16)
        want = _b3_b6(A_j, b, u0, n_sweep, residual, cheby, jnp.bfloat16)
        for g, w in zip(got, want):
            if w is not None:
                _close(g, w, TOL[np.float32], (n_sweep, from_u, residual))
    c16 = SK.embed(A_t, torch.bfloat16)[2]
    bt, ut = torch.from_numpy(b), torch.from_numpy(u)
    steps = chebyshev_steps(torch.tensor(2.5), LOWER, 12)
    for c in (c16, c16.to(torch.float32)):
        if cheby:
            out = SK.scalar_chebyshev_resident(c, bt, ut, steps, 12, True, L)
        else:
            out = SK.scalar_sweeps_resident(c, bt, ut, OMEGA, 12, True, L)
        if c.dtype == torch.bfloat16:
            ref = out
        else:
            assert all(torch.equal(g, w) for g, w in zip(out, ref))


# ---------------------------------------------------------------------------
# routing: resident_plan is a pure function of (L, dtypes, card properties)
# ---------------------------------------------------------------------------
H100 = SK.H100_PROPS
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16


def _forms(levels, dtype=F32, coef=None, props=H100):
    return [(SK.resident_plan(L, dtype, coef, props) or (None,))[0]
            for L in levels]


def test_flagship_hierarchy_routes_none_grid_cluster():
    levels = [(64, 64, 256), (32, 32, 128), (16, 16, 64)]
    assert _forms(levels) == [None, "grid", "cluster"]
    assert _forms(levels, F64) == [None, "grid", "cluster"]
    assert _forms(levels, F32, BF16) == [None, "grid", "cluster"]
    # the CUDA entries take bfloat16 coefficients with float32 vectors only
    assert _forms(levels, F64, BF16) == [None, None, None]
    assert SK.resident_plan((32, 32, 128), F32, None, H100) == \
        ("grid", 128, 512, 1024)
    assert SK.resident_plan((16, 16, 64), F32, None, H100) == \
        ("cluster", 16, 512, 1024)
    # a card that schedules no 16-CTA cluster: two planes a CTA exceed a
    # CTA's 1,024 cells, so the grid form
    h8 = dict(H100, max_cluster=8)
    assert SK.resident_plan((16, 16, 64), F32, None, h8) == \
        ("grid", 128, 64, 128)
    assert SK.resident_plan((16, 8, 64), F32, None, h8) == \
        ("cluster", 8, 512, 1024)
    # no co-resident grid: the mid level keeps its chain
    assert _forms(levels, props=dict(H100, grid_ctas_per_sm=0)) == \
        [None, None, "cluster"]


def test_default_min_cells_hierarchy_routes_every_coarse_level():
    """GMG's default min_cells=32 (the slab engine's global GMG without a
    ``gmg``): the flagship's pressure lattice down to 32 cells."""
    levels = [(64, 64, 256)]
    while int(np.prod(levels[-1])) > 32:
        levels.append(tuple(v // 2 for v in levels[-1]))
    assert levels[-1] == (2, 2, 8) and len(levels) == 6
    assert _forms(levels) == [None, "grid"] + ["cluster"] * 4


@pytest.mark.parametrize("dtype", [F32, F64])
def test_forced_form_capacity(dtype):
    """One plane over each form's capacity: no plan (the wrapper raises on
    the card); the cluster form needs whole planes on at most 16 CTAs, the
    grid form at most one chunk of 2 x threads cells on each SM."""
    cap = SK.RESIDENT_CELLS * SK.RESIDENT_THREADS
    plane = 1024
    nz = SK.RESIDENT_MAX_CLUSTER * (cap // plane)
    L = (nz, 16, 64)
    assert SK.resident_plan(L, dtype, None, H100, "cluster")[0] == "cluster"
    assert SK.resident_plan((nz + 1, 16, 64), dtype, None, H100,
                            "cluster") is None
    nz = H100["sms"] * cap // plane
    assert SK.resident_plan((nz, 16, 64), dtype, None, H100,
                            "grid")[0] == "grid"
    assert SK.resident_plan((nz + 1, 16, 64), dtype, None, H100,
                            "grid") is None
    with pytest.raises(ValueError):
        SK.resident_plan(L, dtype, None, H100, "slab")


def test_levels_route_to_k8_k9_whatever_phase_kernel_says(monkeypatch):
    """A routed level runs each hook that RESIDENT_HOOKS marks as one K8/K9
    call, with or without GMG.slab_double_buffer (B8's flag, which routes
    nothing apart): by default the coarse solve (sweep_n) in the cluster
    form, every other hook on its chain; with every hook marked, all six;
    ``resident=False`` and unmarked hooks keep the chains."""
    calls = []
    for name in ("scalar_sweeps_resident", "scalar_chebyshev_resident",
                 "scalar_jacobi_slab", "scalar_jacobi",
                 "scalar_chebyshev"):
        real = getattr(SK, name)
        monkeypatch.setattr(SK, name, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    _, A_t, b, u = _level((4, 6, 8), np.float64)
    bt, ut = torch.from_numpy(b), torch.from_numpy(u)
    steps = chebyshev_steps(torch.tensor(2.5, dtype=F64), LOWER, 12)

    def hooks(lv):
        out = []
        for hook in (lambda: lv.presmooth_residual(bt, OMEGA, 2),
                     lambda: lv.postsmooth(ut, bt, OMEGA, 2),
                     lambda: lv.sweep_n(bt, OMEGA, 12),
                     lambda: lv.presmooth_residual_cheby(bt, steps, 2),
                     lambda: lv.postsmooth_cheby(ut, bt, steps, 2),
                     lambda: lv.sweep_n_cheby(bt, steps, 12)):
            calls.clear()
            hook()
            out.append(list(calls))
        return out

    def flagged(flag):
        """The level a GMG with ``slab_double_buffer = flag`` builds."""
        gmg = tst.GMG(n_smooth=2)
        gmg.slab_double_buffer = flag
        return gmg.matvecs([A_t])[0]

    jacobi_chain = ["scalar_jacobi"] * 3
    for flag in (False, True):
        lv = flagged(flag)
        assert lv.plan(bt) == ("cluster", 4, 32, 48)
        got = hooks(lv)
        assert got[2] == ["scalar_sweeps_resident"]
        assert got[5] == ["scalar_chebyshev_resident"]
        assert got[0] == jacobi_chain
        assert got[3] == ["scalar_chebyshev"] * 2 + ["scalar_jacobi"]
    chain = hooks(SK.ScalarLevel(A_t, resident=False))
    assert chain[2] == ["scalar_jacobi"] * 12
    assert chain[5] == ["scalar_chebyshev"] * 12
    monkeypatch.setattr(SK, "RESIDENT_HOOKS", {
        f: dict.fromkeys(h, True) for f, h in SK.RESIDENT_HOOKS.items()})
    for flag in (False, True):
        assert hooks(flagged(flag)) == \
            [["scalar_sweeps_resident"]] * 3 + \
            [["scalar_chebyshev_resident"]] * 3


@pytest.fixture(scope="module")
def hierarchy():
    """A ragged lattice's GMG hierarchy in both packages (float64, no zero
    diagonal: the JAX package's XLA levels take none) and a right-hand
    side."""
    A_j, A_t, b, _ = _level((6, 9, 12), np.float64, seed=7, dead=False)
    g = dict(n_smooth=2, n_coarse_sweeps=12, min_cells=16)
    return (jst.GMG(use_pallas=False, **g).hierarchy(A_j),
            tst.GMG(**g).hierarchy(A_t), b)


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_vcycle_with_routing_matches_jax(hierarchy, smoother, monkeypatch):
    """The V-cycle's levels through K8/K9 (plain versions) against the JAX
    package's GMG.vcycle (XLA levels) at float64."""
    jops, tops, b = hierarchy
    common = dict(n_smooth=2, n_coarse_sweeps=12, min_cells=16,
                  smoother=smoother)
    jg, tg = jst.GMG(use_pallas=False, **common), tst.GMG(**common)
    mvs = tg.matvecs(tops)
    bt = torch.from_numpy(b)
    assert [lv.plan(bt)[0] for lv in mvs] == ["cluster"] * 4
    # every hook through K8/K9 (the coarse solve alone by default)
    monkeypatch.setattr(SK, "RESIDENT_HOOKS", {
        f: dict.fromkeys(h, True) for f, h in SK.RESIDENT_HOOKS.items()})
    want = np.asarray(jax.jit(lambda v: jg.vcycle(jops, v))(jnp.asarray(b)))
    got = tg.vcycle(tops, bt, mvs=mvs, cheb=tg.cheby_data(tops))
    _close(got, want, TOL[np.float64], smoother)
