"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips without a CUDA card (decided in a
fixture, not at import). On a machine with one — and without JAX, which
tests/conftest.py imports — run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: max |kernel - plain| / max |plain| <= 1e-4 in float32 and
1e-12 in float64 — the kernels evaluate the same formulas in another
order (and with fused multiply-adds).
"""

import pytest
import torch

from jutul.jl_tpu_torch import compile_model, from_numpy
from jutul.jl_tpu_torch.models.setup import merge_state
from jutul.jl_tpu_torch.ops import cuda as kernels
from jutul.jl_tpu_torch.ops.cuda import assembly_kernels as AK
from jutul.jl_tpu_torch.ops.cuda import stencil_kernels as SK
from jutul.jl_tpu_torch.ops.stencil import (
    ScalarStencil,
    StencilCompiledModel,
    StencilMatrix,
)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.float64: 1e-12}
DTYPES = [torch.float32, torch.float64]
L = (6, 10, 12)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b):
    """max |a - b| relative to max |b| (absolute where b is all zero)."""
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


def _random_matrix(C, K, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    nz, ny, nx = L
    n = nz * ny * nx
    shapes = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=dtype).to(dev)  # noqa: E731
    return (rnd(C, K, n), {a: rnd(C, K, *s) for a, s in shapes.items()},
            {a: rnd(C, K, *s) for a, s in shapes.items()})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,K", [(2, 2), (2, 1), (1, 1)])
def test_k1_matches_plain(dev, dtype, C, K):
    diag, plus, minus = _random_matrix(C, K, dtype, dev)
    mv = SK.StencilMatvec(StencilMatrix(L, diag, plus, minus))
    x = torch.randn(mv.coef.shape[-1], K, dtype=dtype, device=dev)
    before = SK.stencil_matvec.launches
    y = mv(x)
    assert SK.stencil_matvec.launches == before + 1
    assert _rel(y, SK.stencil_matvec_plain(mv.coef, x, L, C, K)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_matches_plain(dev, dtype):
    diag, plus, minus = _random_matrix(1, 1, dtype, dev, seed=1)
    A = ScalarStencil(L, diag.reshape(-1).abs() + 6.0,
                      {a: v[0, 0] for a, v in plus.items()},
                      {a: v[0, 0] for a, v in minus.items()})
    lv = SK.ScalarLevel(A)
    n = A.n
    b = torch.randn(n, dtype=dtype, device=dev)
    u = torch.randn(n, dtype=dtype, device=dev)
    for mode in (SK.MODE_INIT, SK.MODE_RESIDUAL, SK.MODE_SMOOTH):
        got = SK.scalar_jacobi(lv.coef, b, u, 0.8, mode, L)
        ref = SK.scalar_jacobi_plain(lv.coef, b, u, 0.8, mode, L)
        assert _rel(got, ref) <= TOL[dtype], mode
    u12 = lv.sweep_n(b, 0.8, 12)
    ref = SK.scalar_jacobi_plain(lv.coef, b, None, 0.8, SK.MODE_INIT, L)
    for _ in range(11):
        ref = SK.scalar_jacobi_plain(lv.coef, b, ref, 0.8, SK.MODE_SMOOTH, L)
    assert _rel(u12, ref) <= TOL[dtype]


def _cheby_plain(lv, b, u, steps, n_sweep):
    """n_sweep Chebyshev steps through K4's plain version."""
    mode = SK.CHEB_ZERO if u is None else SK.CHEB_FIRST
    u, d = SK.scalar_chebyshev_plain(lv.coef, b, u, None, steps, 0, mode, L)
    for k in range(1, n_sweep):
        u, d = SK.scalar_chebyshev_plain(lv.coef, b, u, d, steps, k,
                                         SK.CHEB_STEP, L)
    return u


@pytest.mark.parametrize("dtype", DTYPES)
def test_k4_matches_plain(dev, dtype):
    from jutul.jl_tpu_torch.linsolve.cheby import chebyshev_steps
    from jutul.jl_tpu_torch.ops.stencil import _cheby_setup

    diag, plus, minus = _random_matrix(1, 1, dtype, dev, seed=2)
    A = ScalarStencil(L, diag.reshape(-1).abs() + 4.0,
                      {a: -v[0, 0].abs() for a, v in plus.items()},
                      {a: -v[0, 0].abs() for a, v in minus.items()})
    lv = SK.ScalarLevel(A)
    steps = chebyshev_steps(_cheby_setup(A)[1], 0.25, 12)
    n = A.n
    b = torch.randn(n, dtype=dtype, device=dev)
    u = torch.randn(n, dtype=dtype, device=dev)
    d = torch.randn(n, dtype=dtype, device=dev)
    for mode, k in ((SK.CHEB_ZERO, 0), (SK.CHEB_FIRST, 0), (SK.CHEB_STEP, 1),
                    (SK.CHEB_STEP, 11)):
        before = SK.scalar_chebyshev.launches
        got = SK.scalar_chebyshev(lv.coef, b, u, d, steps, k, mode, L)
        assert SK.scalar_chebyshev.launches == before + 1
        ref = SK.scalar_chebyshev_plain(lv.coef, b, u, d, steps, k, mode, L)
        for g, r in zip(got, ref):
            assert _rel(g, r) <= TOL[dtype], (mode, k)
    for n_sweep in (2, 12):
        assert _rel(lv.sweep_n_cheby(b, steps, n_sweep),
                    _cheby_plain(lv, b, None, steps, n_sweep)) <= TOL[dtype]
        assert _rel(lv.postsmooth_cheby(u, b, steps, n_sweep),
                    _cheby_plain(lv, b, u, steps, n_sweep)) <= TOL[dtype]
    with pytest.raises(ValueError):  # beyond the step table
        SK.scalar_chebyshev(lv.coef, b, u, d, steps, 12, SK.CHEB_STEP, L)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k3_matches_plain_with_bound_cells(dev, dtype):
    import chip_smoke

    model, state, params, _ = chip_smoke.build_flagship(*L[::-1])
    s = state["Saturations"].copy()
    s[::7] = (0.0, 1.0)  # saturations on both bounds of the clip
    s[::5] = (1.0, 0.0)
    state = {**state, "Saturations": s}
    sc = StencilCompiledModel(compile_model(model))
    full = sc.comp.evaluate_secondaries(merge_state(
        from_numpy(state, dev, dtype), from_numpy(params, dev, dtype)))
    U = sc.comp.get_dofs(full).contiguous()
    faces = sc.comp._face_entries(full)
    for a in range(3):
        fs = sc._axis_face_state(faces, a)
        args = (sc.form, U, *(fs[nm] for nm in sc.form.face_params), sc.L, a)
        got = AK.darcy_flux_jacobian(*args)
        ref = AK.darcy_flux_jacobian_plain(*args)
        for q in range(10):
            assert _rel(got[q], ref[q]) <= TOL[dtype], (a, q)


def test_wrappers_raise_on_mismatch(dev):
    diag, plus, minus = _random_matrix(2, 2, torch.float64, dev)
    mv = SK.StencilMatvec(StencilMatrix(L, diag, plus, minus))
    with pytest.raises(ValueError):
        mv(torch.zeros(mv.coef.shape[-1], 2, dtype=torch.float32, device=dev))
    with pytest.raises(ValueError):
        mv(torch.zeros(5, 2, dtype=torch.float64, device=dev))


def test_launch_counters_reset(dev):
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    test_k1_matches_plain(dev, torch.float32, 2, 2)
    assert kernels.launch_counts() == {
        "stencil_matvec": 1, "scalar_jacobi": 0, "darcy_flux_jacobian": 0,
        "scalar_chebyshev": 0}
