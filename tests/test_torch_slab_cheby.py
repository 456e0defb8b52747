"""K11 ``scalar_chebyshev_slab`` (a whole Chebyshev smoothing phase of a
large GMG level in one launch) on the CPU, against the JAX package.

- The K11-routed Chebyshev hooks of ``ScalarLevel`` (the plain version on
  CPU tensors) against the TPU kernel they replace, B7
  ``_kernel_slab_sweeps_cheby`` (``PallasSlabFusedScalarLevel`` in
  interpret mode, several z-slabs) on tests/test_pallas.py's seeded
  (8, 8, 16) stencil, ``n_smooth`` 2 and 3: to 1e-6 (float32) and 1e-12
  (float64) of the largest value (of b for the residual) — the same steps,
  sums in another order;
- the flagship's GMG hierarchy routes its V-cycle Chebyshev hooks to K11
  on the fine and mid levels, its coarse solve to K9, and a Chebyshev
  phase deeper than the level's depth to the K4 chain;
- ``chip_smoke.level_launches_per_vcycle`` gives K11 4 and K9 1 launches a
  V-cycle;
- a Chebyshev V-cycle with K11 routing equals the chains exactly and the
  JAX V-cycle to the tolerances above;
- ``slab_plan``'s K11 tiles fit a CTA; a bfloat16 call equals the call on
  the widened coefficients bit for bit; the wrapper refuses a phase over
  ``SLAB_MAX_DEPTH`` applications.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_slab_sweeps import FLAGSHIP, H100, L, TOL, _close, _stencil

import chip_smoke
from jutul.jl_tpu.ops import stencil as jst
from jutul.jl_tpu.ops.pallas.stencil_kernels import PallasSlabFusedScalarLevel
from jutul.jl_tpu_torch.linsolve.cheby import chebyshev_steps
from jutul.jl_tpu_torch.ops import cuda as kernels
from jutul.jl_tpu_torch.ops import stencil as tst
from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK

LOWER = 0.25
F32, F64, BF16 = torch.float32, torch.float64, torch.bfloat16
CHEBY_HOOKS = ("presmooth_residual_cheby", "postsmooth_cheby")


@pytest.fixture
def k11_calls(monkeypatch):
    """Every level of any size is a slab level; records K11's calls as
    (steps, from zero, residual) and the K4 chain's steps."""
    monkeypatch.setattr(SK, "SLAB_MIN_CELLS", 0)
    calls = {"k11": [], "k4": 0}
    real, real_k4 = SK.scalar_chebyshev_slab, SK.scalar_chebyshev

    def spy(coef, b, u, steps, n_sweep, res, L_, plan=None):
        calls["k11"].append((n_sweep, u is None, res))
        return real(coef, b, u, steps, n_sweep, res, L_, plan)

    def spy_k4(*a, **k):
        calls["k4"] += 1
        return real_k4(*a, **k)
    monkeypatch.setattr(SK, "scalar_chebyshev_slab", spy)
    monkeypatch.setattr(SK, "scalar_chebyshev", spy_k4)
    return calls


@pytest.mark.parametrize("n_smooth", [2, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k11_hooks_match_jax_b7(dtype, n_smooth, k11_calls):
    A_j, A_t, b, u0 = _stencil(dtype, seed=18)
    j = jnp.asarray
    jlv = PallasSlabFusedScalarLevel(A_j, n_smooth=n_smooth, interpret=True,
                                     vmem_budget=128 * 1024)
    assert jlv.tz < L[0], "the budget should force several z-slabs"
    # resident=False: K9 would hold this small level
    lv = SK.ScalarLevel(A_t, resident=False, depth=max(n_smooth, 2))
    bt, ut = torch.from_numpy(b), torch.from_numpy(u0)
    assert [lv.route(h, bt) for h in CHEBY_HOOKS] == ["slab"] * 2
    lmax_j = jst._cheby_setup(A_j)[1]
    steps = chebyshev_steps(tst._cheby_setup(A_t)[1], LOWER, n_smooth)
    before = kernels.scalar_chebyshev_slab.launches
    u, r = lv.presmooth_residual_cheby(bt, steps, n_smooth)
    ju, jr = jlv.presmooth_residual_cheby(j(b), lmax_j, n_smooth, LOWER)
    _close(u, ju, dtype, "presmooth u")
    _close(r, jr, dtype, "presmooth r", scale=b)
    _close(lv.postsmooth_cheby(ut, bt, steps, n_smooth),
           jlv.postsmooth_cheby(j(u0), j(b), lmax_j, n_smooth, LOWER), dtype,
           "postsmooth")
    # one K11 launch per hook and no K4 step
    assert k11_calls == {"k11": [(n_smooth, True, True),
                                 (n_smooth, False, False)], "k4": 0}
    # CPU tensors run the plain version, which counts no launch
    assert kernels.scalar_chebyshev_slab.launches == before


@pytest.mark.parametrize("dtype,coef", [(F32, None), (F64, None),
                                        (F32, BF16)])
def test_flagship_hierarchy_routes_k11_k9(dtype, coef):
    """The fine and mid levels route presmooth+residual and postsmooth to
    K11 (the reference gives the fine level B7 and the mid level B6), the
    coarse solve to K9's cluster form; ``sweep_n_cheby`` on a large level,
    whatever its depth, keeps the K4 chain, as the reference's slab level
    has no such hook."""
    fine, mid, coarse = FLAGSHIP
    for L_ in (fine, mid):
        for depth in (2, 3):
            assert [SK.level_route(L_, h, dtype, coef, H100, depth=depth)
                    for h in CHEBY_HOOKS] == ["slab"] * 2
        assert SK.level_route(L_, "sweep_n_cheby", dtype, coef, H100) == \
            "chain"
    assert SK.level_route(coarse, "sweep_n_cheby", dtype, coef, H100) == \
        "resident"
    assert [SK.level_route(coarse, h, dtype, coef, H100)
            for h in CHEBY_HOOKS] == ["chain"] * 2


def test_a_phase_deeper_than_the_depth_keeps_the_k4_chain(k11_calls):
    """On a K11-routed level, a phase of more applications than the
    level's depth runs as K4 steps and K2's residual (d cannot cross
    launches), with the chain's values; within the depth, one K11 call."""
    _, A_t, b, u0 = _stencil(np.float64, seed=19)
    lv = SK.ScalarLevel(A_t, resident=False, depth=2)
    chain = SK.ScalarLevel(A_t, resident=False, slab=False)
    bt, ut = torch.from_numpy(b), torch.from_numpy(u0)
    steps = chebyshev_steps(tst._cheby_setup(A_t)[1], LOWER, 6)
    for n_sweep, k11, k4 in ((2, [(2, True, True)], 0), (3, [], 3)):
        k11_calls["k11"].clear()
        k11_calls["k4"] = 0
        got = lv.presmooth_residual_cheby(bt, steps, n_sweep)
        assert (k11_calls["k11"], k11_calls["k4"]) == (k11, k4)
        want = chain.presmooth_residual_cheby(bt, steps, n_sweep)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    k11_calls["k11"].clear()
    lv.sweep_n_cheby(bt, steps, 2)
    lv.postsmooth_cheby(ut, bt, steps, 3)
    assert k11_calls["k11"] == []


@pytest.mark.parametrize("coef_dtype", [None, "bf16"])
def test_level_launches_per_vcycle_chebyshev(coef_dtype):
    """One V-cycle of the flagship's Chebyshev hierarchy: K11 4 (the fine
    and mid levels' two phases), K9 1 (the coarse solve), no K4 step and no
    K2 pass."""
    sfx = "_bf16c" if coef_dtype else ""
    got = chip_smoke.level_launches_per_vcycle(
        FLAGSHIP[0], "chebyshev", coef_dtype, props=H100)
    assert {k: v for k, v in got.items() if v} == {
        chip_smoke.K11 + sfx: 4, chip_smoke.K9 + sfx: 1}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_vcycle_with_k11_equals_chain_and_jax(dtype, monkeypatch):
    A_j, A_t, b, _ = _stencil(dtype, L=(6, 9, 12), seed=7)
    common = dict(n_smooth=2, n_coarse_sweeps=12, min_cells=16,
                  smoother="chebyshev")
    jg, tg = jst.GMG(use_pallas=False, **common), tst.GMG(**common)
    jops, tops = jg.hierarchy(A_j), tg.hierarchy(A_t)
    bt = torch.from_numpy(b)
    cheb = tg.cheby_data(tops)
    chain = tg.vcycle(tops, bt, mvs=[
        SK.ScalarLevel(A, resident=False, slab=False) for A in tops],
        cheb=cheb)
    monkeypatch.setattr(SK, "SLAB_MIN_CELLS", 90)
    mvs = tg.matvecs(tops)
    assert [int(np.prod(A.L)) >= 90 for A in tops] == [True, True, False,
                                                       False]
    assert [lv.route(h, bt) for lv in mvs[:2] for h in CHEBY_HOOKS] == \
        ["slab"] * 4
    got = tg.vcycle(tops, bt, mvs=mvs, cheb=cheb)
    assert torch.equal(got, chain)
    want = np.asarray(jax.jit(lambda v: jg.vcycle(jops, v))(jnp.asarray(b)))
    _close(got, want, dtype, "vcycle")


def test_k11_slab_plan_tiles_fit():
    """Each K11 tile fits a CTA's threads and shared memory, which holds
    K10's rings and the step scalars (d lives in registers)."""
    for L_ in FLAGSHIP[:2] + [(9, 13, 37), (5, 1, 16), (1, 8, 32)]:
        nz, ny, nx = L_
        for dtype, coef in ((F32, None), (F64, None), (F32, BF16)):
            size = 8 if dtype == F64 else 4
            csize = 2 if coef == BF16 else size
            for napp in range(SK.SLAB_MAX_DEPTH + 1):
                for from_u in (False, True):
                    plan = SK.slab_plan(L_, dtype, coef, napp, from_u, H100,
                                        cheby=True)
                    if plan is None:
                        # as for K10: the fine level's thinnest band at 4
                        # float64 applications exceeds 227 KB
                        assert (L_, dtype, napp) == (FLAGSHIP[0], F64, 4)
                        continue
                    vec, ox, oy, tz = plan
                    assert vec == SK.slab_vec(nx, dtype) and ox % vec == 0
                    _, _, tx, ty = SK.slab_tile(L_, napp, vec, ox, oy)
                    assert tx // vec * ty <= SK.SLAB_THREADS
                    smem = SK.slab_smem(tx * ty, napp, csize, size, from_u,
                                        cheby=True)
                    assert smem == SK.slab_smem(
                        tx * ty, napp, csize, size, from_u) + \
                        -(-2 * (SK.SLAB_MAX_DEPTH + 1) * size // 16) * 16
                    assert smem <= SK.SLAB_MAX_SMEM
                    assert 1 <= tz <= nz


def test_k11_bf16_equals_widened_and_refuses_deep_phases():
    """bfloat16 coefficients equal the same call on their widened copy
    bit for bit (the coefficient is widened where it is read); a phase over
    SLAB_MAX_DEPTH applications, or of no step, raises on the CPU as on
    the card."""
    _, A_t, b, u0 = _stencil(np.float32, seed=20)
    c16 = SK.ScalarLevel(A_t, coef_dtype=BF16).coef
    bt, ut = torch.from_numpy(b), torch.from_numpy(u0)
    steps = chebyshev_steps(tst._cheby_setup(A_t)[1].float(), LOWER, 6)
    for u in (None, ut):
        for n_sweep in (1, 2, 3):
            for res in (False, True):
                got = SK.scalar_chebyshev_slab(c16, bt, u, steps, n_sweep,
                                               res, L)
                want = SK.scalar_chebyshev_slab(c16.float(), bt, u, steps,
                                                n_sweep, res, L)
                assert all((g is None and w is None) or torch.equal(g, w)
                           for g, w in zip(got, want))
    with pytest.raises(ValueError, match="applications"):
        SK.scalar_chebyshev_slab(c16, bt, ut, steps, SK.SLAB_MAX_DEPTH,
                                 True, L)
    with pytest.raises(ValueError, match="applications"):
        SK.scalar_chebyshev_slab(c16, bt, None, steps,
                                 SK.SLAB_MAX_DEPTH + 2, False, L)
    with pytest.raises(ValueError, match="applications"):
        SK.scalar_chebyshev_slab(c16, bt, ut, steps, 0, True, L)
