"""K10 ``scalar_jacobi_slab`` (a whole Jacobi smoothing phase of a large
GMG level in one launch) on the CPU, against the JAX package.

- The K10-routed hooks of ``ScalarLevel`` (the plain version on CPU
  tensors) against the TPU kernel they replace, B2 ``_kernel_slab_sweeps``
  (``PallasSlabFusedScalarLevel(double_buffer=False)`` in interpret mode,
  several z-slabs) on tests/test_pallas.py's seeded (8, 8, 16) stencil,
  every hook, ``n_smooth`` 2 and 3: to 1e-6 (float32) and 1e-12 (float64)
  of the largest value (of b for the residual) — the same sweeps, sums in
  another order;
- the flagship's GMG hierarchy routes its Jacobi phases to K10 and its
  V-cycle Chebyshev phases to K11 on the fine and mid levels (the
  reference runs B2, or B8 under ``double_buffer``, or B7 on the fine level
  and B3 or B6 on the mid) and the coarse solve to K8's or K9's cluster
  form; ``GMG.slab_double_buffer`` changes no route;
- a V-cycle with K10 routing equals the chains exactly and the JAX
  V-cycle to the tolerances above;
- ``chip_smoke.level_launches_per_vcycle`` gives the routing's launches;
- ``slab_plan``'s tiles fit a CTA, and ``phase_chunks`` cuts a phase as
  the JAX slab level chunks ``sweep_n``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jutul.jl_tpu.ops import stencil as jst
from jutul.jl_tpu.ops.pallas.stencil_kernels import PallasSlabFusedScalarLevel
from jutul.jl_tpu_torch.ops import cuda as kernels
from jutul.jl_tpu_torch.ops import stencil as tst
from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK

L = (8, 8, 16)
OMEGA = 0.8
TOL = {np.float32: 1e-6, np.float64: 1e-12}
H100 = SK.H100_PROPS
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
FLAGSHIP = [(64, 64, 256), (32, 32, 128), (16, 16, 64)]  # (nz, ny, nx)


def _stencil(dtype, L=L, seed=14):
    """tests/test_pallas.py ``test_slab_double_buffered_pipeline``'s
    stencil and vectors (seed 14) in both packages."""
    n = int(np.prod(L))
    nz, ny, nx = L
    rng = np.random.default_rng(seed)
    diag = (np.full(n, 6.0) + rng.uniform(0, 1, n)).astype(dtype)
    fs = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    plus = {a: -np.abs(rng.normal(size=s)).astype(dtype)
            for a, s in fs.items()}
    minus = {a: -np.abs(rng.normal(size=s)).astype(dtype)
             for a, s in fs.items()}
    b = rng.normal(size=n).astype(dtype)
    u0 = rng.normal(size=n).astype(dtype)
    j, t = jnp.asarray, torch.from_numpy
    A_j = jst.ScalarStencil(L, j(diag), {a: j(v) for a, v in plus.items()},
                            {a: j(v) for a, v in minus.items()})
    A_t = tst.ScalarStencil(L, t(diag), {a: t(v) for a, v in plus.items()},
                            {a: t(v) for a, v in minus.items()})
    return A_j, A_t, b, u0


def _close(got, ref, dtype, what, scale=None):
    """max |got - ref| <= TOL of the largest value of ``ref`` (or of
    ``scale``: a residual b - A u is a difference of terms as large as b,
    whose roundoff its own smaller values do not bound)."""
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype, what
    err = np.abs(got - ref).max()
    top = np.abs(ref if scale is None else scale).max()
    assert err <= TOL[dtype] * top, (what, err)


@pytest.fixture
def slab_calls(monkeypatch):
    """Every level of any size is a slab level; records K10's calls as
    (sweeps, from zero, residual)."""
    monkeypatch.setattr(SK, "SLAB_MIN_CELLS", 0)
    calls = []
    real = SK.scalar_jacobi_slab

    def spy(coef, b, u, omega, n_sweep, res, L_, plan=None):
        calls.append((n_sweep, u is None, res))
        return real(coef, b, u, omega, n_sweep, res, L_, plan)
    monkeypatch.setattr(SK, "scalar_jacobi_slab", spy)
    return calls


@pytest.mark.parametrize("n_smooth", [2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_slab_hooks_match_jax_b2(dtype, n_smooth, slab_calls):
    A_j, A_t, b, u0 = _stencil(dtype)
    j = jnp.asarray
    jlv = PallasSlabFusedScalarLevel(A_j, n_smooth=n_smooth,
                                     double_buffer=False, interpret=True,
                                     vmem_budget=128 * 1024)
    assert jlv.tz < L[0], "the budget should force several z-slabs"
    depth = max(n_smooth, 2)
    # resident=False: K8 would hold this small level's coarse solve
    lv = SK.ScalarLevel(A_t, resident=False, depth=depth)
    bt, ut = torch.from_numpy(b), torch.from_numpy(u0)
    assert [lv.route(h, bt) for h in ("presmooth_residual", "postsmooth",
                                      "sweep_n")] == ["slab"] * 3
    before = kernels.scalar_jacobi_slab.launches
    u, r = lv.presmooth_residual(bt, OMEGA, n_smooth)
    ju, jr = jlv.presmooth_residual(j(b), OMEGA, n_smooth)
    _close(u, ju, dtype, "presmooth u")
    _close(r, jr, dtype, "presmooth r", scale=b)
    _close(lv.postsmooth(ut, bt, OMEGA, n_smooth),
           jlv.postsmooth(j(u0), j(b), OMEGA, n_smooth), dtype, "postsmooth")
    _close(lv.sweep_n(bt, OMEGA, 7), jlv.sweep_n(j(b), OMEGA, 7), dtype,
           "sweep_n")
    # one launch per V-cycle hook, sweep_n chunked to the halo depth as
    # the reference chunks it: depth + 1 sweeps from zero, then depth
    assert slab_calls[:2] == [(n_smooth, True, True),
                              (n_smooth, False, False)]
    assert slab_calls[2:] == list(SK.phase_chunks(7, True, False, depth))
    assert sum(k for k, _, _ in slab_calls[2:]) == 7
    # CPU tensors run the plain version, which counts no launch
    assert kernels.scalar_jacobi_slab.launches == before


@pytest.mark.parametrize("dtype,coef", [(F32, None), (F64, None),
                                        (F32, BF16)])
def test_flagship_hierarchy_routes_k10_k8_k5(dtype, coef):
    """The fine and mid levels (at least SLAB_MIN_CELLS cells) run their
    Jacobi phases on K10 — the reference gives the fine level its slab
    kernel (B2, or B8) and the mid level, whose streams fit VMEM, B3; K10
    measured faster there than K8's grid form — and their V-cycle
    Chebyshev phases on K11 (B7 on the fine level, B6 on the mid), but not
    ``sweep_n_cheby`` (no slab route: d cannot cross launches). The coarse
    level runs its solve on K8's or K9's cluster form; ``slab=False`` keeps
    the chains; nothing routes to a kernel of its own for B8."""
    jac = ("presmooth_residual", "postsmooth", "sweep_n")

    def routes(L_, hooks, **kw):
        return [SK.level_route(L_, h, dtype, coef, H100, **kw)
                for h in hooks]
    fine, mid, coarse = FLAGSHIP
    for L_ in (fine, mid):
        assert int(np.prod(L_)) >= SK.SLAB_MIN_CELLS
        assert routes(L_, jac) == ["slab"] * 3
        assert routes(L_, jac, depth=3) == ["slab"] * 3
        assert routes(L_, jac, slab=False) == ["chain"] * 3
        assert routes(L_, [h + "_cheby" for h in jac]) == \
            ["slab", "slab", "chain"]
        assert routes(L_, [h + "_cheby" for h in jac], slab=False) == \
            ["chain"] * 3
    assert int(np.prod(coarse)) < SK.SLAB_MIN_CELLS
    assert routes(coarse, ["sweep_n"]) == ["resident"]
    assert routes(coarse, ["sweep_n_cheby"]) == ["resident"]
    assert routes(coarse, ["sweep_n"], resident=False) == ["chain"]
    # the CUDA entries take bfloat16 coefficients with float32 vectors only
    assert SK.level_route(fine, "postsmooth", F64, BF16, H100) == "chain"


def test_gmg_levels_take_the_reference_depth():
    """``GMG.matvecs`` sizes K10's launches as the reference sizes its
    slab halo: ``max(n_smooth, 2)`` applications, at most
    ``SLAB_MAX_DEPTH``."""
    _, A_t, _, _ = _stencil(np.float64)
    for n_smooth, depth in ((1, 2), (2, 2), (3, 3), (6, SK.SLAB_MAX_DEPTH)):
        g = tst.GMG(n_smooth=n_smooth, n_coarse_sweeps=4, min_cells=64)
        assert [lv.depth for lv in g.matvecs(g.hierarchy(A_t))] == \
            [depth] * 3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_vcycle_with_k10_equals_chain_and_jax(dtype, monkeypatch):
    A_j, A_t, b, _ = _stencil(dtype, L=(6, 9, 12), seed=7)
    common = dict(n_smooth=2, n_coarse_sweeps=12, min_cells=16)
    jg, tg = jst.GMG(use_pallas=False, **common), tst.GMG(**common)
    jops, tops = jg.hierarchy(A_j), tg.hierarchy(A_t)
    bt = torch.from_numpy(b)
    chain = tg.vcycle(tops, bt, mvs=[
        SK.ScalarLevel(A, resident=False, slab=False) for A in tops])
    monkeypatch.setattr(SK, "SLAB_MIN_CELLS", 90)
    mvs = tg.matvecs(tops)
    assert [int(np.prod(A.L)) >= 90 for A in tops] == [True, True, False,
                                                       False]
    assert [lv.route("presmooth_residual", bt) for lv in mvs[:2]] == \
        ["slab"] * 2
    got = tg.vcycle(tops, bt, mvs=mvs)
    assert torch.equal(got, chain)
    want = np.asarray(jax.jit(lambda v: jg.vcycle(jops, v))(jnp.asarray(b)))
    _close(got, want, dtype, "vcycle")


def test_level_launches_per_vcycle():
    """Per linear iteration (two V-cycles) on the flagship's hierarchy:
    the Jacobi slices 10 launches (K10 8, K8 2) and their bf16 forms
    alike, with B8's flag as without it (it changes no route,
    ``test_b8_flag_routes_as_the_default``); the Chebyshev slices 10 (K11
    8, K9 2), no K4 step and no K2 pass."""
    def per_lin(smoother, coef_dtype=None):
        got = chip_smoke.level_launches_per_vcycle(
            FLAGSHIP[0], smoother, coef_dtype, props=H100)
        return {k: 2 * v for k, v in got.items() if v}
    K8, K9, K10 = (chip_smoke.K8, chip_smoke.K9, chip_smoke.K10)
    assert per_lin("jacobi") == {K10: 8, K8: 2}
    assert per_lin("jacobi", "bf16") == {K10 + "_bf16c": 8,
                                         K8 + "_bf16c": 2}
    K11 = chip_smoke.K11
    assert per_lin("chebyshev") == {K11: 8, K9: 2}
    assert per_lin("chebyshev", "bf16") == {K11 + "_bf16c": 8,
                                            K9 + "_bf16c": 2}


HOOKS = ("presmooth_residual", "postsmooth", "sweep_n",
         "presmooth_residual_cheby", "postsmooth_cheby", "sweep_n_cheby")


@pytest.mark.parametrize("dtype,coef", [(F32, None), (F64, None),
                                        (F32, BF16)])
def test_b8_flag_routes_as_the_default(dtype, coef):
    """On the flagship's three level shapes, under the H100's properties,
    the levels a GMG with ``slab_double_buffer`` builds take the same route
    for every hook as a GMG's without it — the pure ``level_route`` — and
    none a route of its own: the fine and mid Jacobi hooks K10, their
    V-cycle Chebyshev hooks K11, the coarse solve K8/K9."""
    like = torch.empty(0, dtype=dtype)
    want = {FLAGSHIP[0]: ["slab", "slab", "slab", "slab", "slab", "chain"],
            FLAGSHIP[1]: ["slab", "slab", "slab", "slab", "slab", "chain"],
            FLAGSHIP[2]: ["chain", "chain", "resident", "chain", "chain",
                          "resident"]}
    for L_ in FLAGSHIP:
        nz, ny, nx = L_
        A = tst.ScalarStencil(
            L_, torch.ones(nz * ny * nx, dtype=dtype),
            {0: torch.zeros(nz, ny, nx - 1, dtype=dtype),
             1: torch.zeros(nz, ny - 1, nx, dtype=dtype),
             2: torch.zeros(nz - 1, ny, nx, dtype=dtype)},
            {0: torch.zeros(nz, ny, nx - 1, dtype=dtype),
             1: torch.zeros(nz, ny - 1, nx, dtype=dtype),
             2: torch.zeros(nz - 1, ny, nx, dtype=dtype)})
        routes = []
        for flag in (False, True):
            g = tst.GMG(n_smooth=2, coef_dtype="bf16" if coef else None)
            g.slab_double_buffer = flag
            lv, = g.matvecs([A])
            routes.append([lv.route(h, like) for h in HOOKS])
        pure = [SK.level_route(L_, h, dtype, coef, H100) for h in HOOKS]
        assert routes[0] == routes[1] == pure == want[L_], L_


def test_slab_plan_tiles_fit():
    """Each planned tile fits a CTA's threads and shared memory; no tile
    for more than SLAB_MAX_DEPTH applications or bfloat16 coefficients
    with float64 vectors; an nx that is not a multiple of V runs V = 1."""
    for L_ in FLAGSHIP[:2] + [(9, 13, 37), (5, 1, 16), (1, 8, 32)]:
        nz, ny, nx = L_
        for dtype, coef in ((F32, None), (F64, None), (F32, BF16)):
            for napp in range(SK.SLAB_MAX_DEPTH + 1):
                for from_u in (False, True):
                    plan = SK.slab_plan(L_, dtype, coef, napp, from_u, H100)
                    if plan is None:
                        # 4 applications of the fine level at float64: the
                        # thinnest band's ring of 6 stages exceeds 227 KB
                        assert (L_, dtype, napp) == (FLAGSHIP[0], F64, 4)
                        continue
                    vec, ox, oy, tz = plan
                    assert vec == SK.slab_vec(nx, dtype) and nx % vec == 0
                    assert ox % vec == 0
                    _, _, tx, ty = SK.slab_tile(L_, napp, vec, ox, oy)
                    assert tx % vec == 0
                    size = 8 if dtype == F64 else 4
                    csize = 2 if coef == BF16 else size
                    assert tx // vec * ty <= SK.SLAB_THREADS
                    assert SK.slab_smem(tx * ty, napp, csize, size,
                                        from_u) <= SK.SLAB_MAX_SMEM
                    assert 1 <= tz <= nz
    assert SK.slab_vec(37, F32) == 1 and SK.slab_vec(6, F64) == 2
    assert SK.slab_plan(L, F32, None, SK.SLAB_MAX_DEPTH + 1, True) is None
    assert SK.slab_plan(L, F64, BF16, 2, True) is None
    # a tile's halo: napp rows, and napp columns rounded up to V, where
    # the tile does not cover its axis
    assert SK.slab_tile((64, 64, 256), 2, 4, 64, 16) == (4, 4, 72, 20)
    assert SK.slab_tile((64, 64, 256), 3, 2, 256, 64) == (1, 1, 256, 64)
    assert SK.slab_tile((9, 13, 37), 3, 1, 20, 13) == (2, 1, 26, 13)


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_phase_chunks_and_plain_equal_the_k2_chain(depth):
    """``phase_chunks`` cuts every phase into launches of at most
    ``depth`` applications with all the sweeps, the residual last; K10's
    plain version on CPU tensors equals the K2 chain exactly."""
    for n_sweep in range(1, 9):
        for zero in (True, False):
            for res in (False, True):
                chunks = SK.phase_chunks(n_sweep, zero, res, depth)
                assert sum(k for k, _, _ in chunks) == n_sweep
                assert [z for _, z, _ in chunks] == \
                    [zero] + [False] * (len(chunks) - 1)
                assert [r for _, _, r in chunks] == \
                    [False] * (len(chunks) - 1) + [res]
                for k, z, r in chunks:
                    assert 0 <= (k - z) + r <= depth
    _, A_t, b, u0 = _stencil(np.float64)
    ref = SK.ScalarLevel(A_t, resident=False, slab=False)
    bt, ut = torch.from_numpy(b), torch.from_numpy(u0)
    for u in (None, ut):
        got_u, got_r = SK.scalar_jacobi_slab(ref.coef, bt, u, OMEGA, depth,
                                             True, L)
        want = ref.sweep_n(bt, OMEGA, depth) if u is None else \
            ref.postsmooth(u, bt, OMEGA, depth)
        assert torch.equal(got_u, want)
        assert torch.equal(got_r, ref.residual(want, bt))
