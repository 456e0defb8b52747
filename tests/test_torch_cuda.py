"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips without a CUDA card (decided in a
fixture, not at import). On a machine with one — and without JAX, which
tests/conftest.py imports — run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: max |kernel - plain| / max |plain| <= 1e-4 in float32 and
1e-12 in float64 — the kernels evaluate the same formulas in another
order (and with fused multiply-adds).
"""

import numpy as np
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
    lv = SK.ScalarLevel(A, resident=False, slab=False)  # the K2 chain
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
    lv = SK.ScalarLevel(A, resident=False, slab=False)  # the K4 chain
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


@pytest.mark.parametrize("coef_dtype", [torch.float32, torch.float64,
                                        torch.bfloat16])
def test_b8_route_runs_k10_bitwise_the_k2_chain(dev, coef_dtype):
    """B8's route (``GMG.slab_double_buffer``) on the flagship's hierarchy
    shape: every level and hook routes as without the flag; on the fine
    and mid levels every Jacobi hook (1-3 sweeps, sweep_n at 12) is the K10
    launches of ``phase_chunks``, equal to the K2 chain bit for bit and
    within TOL of the plain version."""
    from jutul.jl_tpu_torch.ops.stencil import GMG

    vec = torch.float64 if coef_dtype == torch.float64 else torch.float32
    g = torch.Generator().manual_seed(6)
    L_ = (64, 64, 256)
    nz, ny, nx = L_
    n = nz * ny * nx
    shapes = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=vec)  # noqa: E731
    A = ScalarStencil(L_, (rnd(n).abs() + 6.0).to(dev),
                      {a: -rnd(*s).abs().to(dev) for a, s in shapes.items()},
                      {a: -rnd(*s).abs().to(dev) for a, s in shapes.items()})
    cd = "bf16" if coef_dtype == torch.bfloat16 else None
    counter = "launches_bf16c" if cd else "launches"
    mvs = {}
    for flag in (False, True):
        gmg = GMG(n_smooth=2, n_coarse_sweeps=12, min_cells=16384,
                  coef_dtype=cd)
        gmg.slab_double_buffer = flag
        ops = gmg.hierarchy(A)
        mvs[flag] = gmg.matvecs(ops)
    hooks = ("presmooth_residual", "postsmooth", "sweep_n")
    for lv0, lv in zip(mvs[False], mvs[True]):
        b = torch.randn(lv.coef.shape[-1], generator=g,
                        dtype=vec).to(dev)
        assert [lv.route(h, b) for h in hooks] == \
            [lv0.route(h, b) for h in hooks]
    assert [lv.route("postsmooth", b) for lv in mvs[True]] == \
        ["slab", "slab", "chain"]
    for op, lv in zip(ops[:2], mvs[True][:2]):
        m = op.n
        b, u = rnd(m).to(dev), rnd(m).to(dev)
        chain = SK.ScalarLevel(op, coef_dtype=gmg.coef_torch_dtype(),
                               resident=False, slab=False)
        cases = [(u0, k, res) for u0 in (None, u) for k in (1, 2, 3)
                 for res in (False, True)] + [(None, 12, False)]
        for u0, k, res in cases:
            if u0 is None:
                call = (lambda l_: l_.presmooth_residual(b, 0.8, k)) if res \
                    else (lambda l_: (l_.sweep_n(b, 0.8, k), None))
            elif res:
                continue  # no hook sweeps from u and then takes r
            else:
                call = lambda l_: (l_.postsmooth(u, b, 0.8, k), None)  # noqa: E731
            before = getattr(SK.scalar_jacobi_slab, counter)
            got = call(lv)
            assert getattr(SK.scalar_jacobi_slab, counter) == before + len(
                SK.phase_chunks(k, u0 is None, res, lv.depth))
            want = call(chain)
            plain = SK.scalar_jacobi_slab_plain(lv.coef, b, u0, 0.8, k, res,
                                                op.L)
            for gv, wv, pv in zip(got, want, plain):
                assert (gv is None) == (wv is None)
                if wv is not None:
                    assert torch.equal(gv, wv), (op.L, u0 is None, k, res)
                    assert _rel(gv, pv) <= TOL[vec]


def _k2_chain(coef, b, u, omega, n_sweep, residual, L_):
    """The phase as a chain of K2 launches (the arithmetic K8 and K10
    keep)."""
    if u is None:
        u = SK.scalar_jacobi(coef, b, None, omega, SK.MODE_INIT, L_)
        n_sweep -= 1
    for _ in range(n_sweep):
        u = SK.scalar_jacobi(coef, b, u, omega, SK.MODE_SMOOTH, L_)
    r = SK.scalar_jacobi(coef, b, u, 0.0, SK.MODE_RESIDUAL, L_) \
        if residual else None
    return u, r


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims", [(37, 13, 9), (63, 15, 4)])
def test_k3_lattice_equals_per_axis_bitwise(dev, dtype, dims):
    """The three-axis launch against three per-axis launches, bit for bit,
    at ragged extents with saturations exactly on 0 and 1; and against
    the plain version within TOL."""
    import chip_smoke

    model, state, params, _ = chip_smoke.build_flagship(*dims)
    s = state["Saturations"].copy()
    s[::7] = (0.0, 1.0)
    s[::5] = (1.0, 0.0)
    state = {**state, "Saturations": s}
    sc = StencilCompiledModel(compile_model(model))
    full = sc.comp.evaluate_secondaries(merge_state(
        from_numpy(state, dev, dtype), from_numpy(params, dev, dtype)))
    U = sc.comp.get_dofs(full).contiguous()
    faces = sc.comp._face_entries(full)
    fps = [tuple(sc._axis_face_state(faces, a)[nm]
                 for nm in sc.form.face_params) for a in range(3)]
    before = AK.darcy_flux_jacobian_lattice.launches
    got = AK.darcy_flux_jacobian_lattice(sc.form, U, fps, sc.L)
    assert AK.darcy_flux_jacobian_lattice.launches == before + 1
    ref = AK.darcy_flux_jacobian_lattice_plain(sc.form, U, fps, sc.L)
    for a in range(3):
        per_axis = AK.darcy_flux_jacobian(sc.form, U, *fps[a], sc.L, a)
        assert torch.equal(got[a], per_axis), a
        for q in range(10):
            assert _rel(got[a][q], ref[a][q]) <= TOL[dtype], (a, q)


def _krylov_vectors(n, dtype, dev, count, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(n, generator=g, dtype=dtype).to(dev)
            for _ in range(count)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [700, 300_001])
def test_k6_k7_match_plain_and_repeat_bitwise(dev, dtype, n):
    from jutul.jl_tpu_torch.ops.cuda import krylov_kernels as KK

    rhat, r, v = _krylov_vectors(n, dtype, dev, 3, seed=4)
    rho = torch.tensor(0.7, dtype=dtype, device=dev)
    before = KK.fused_alpha_s.launches
    s, alpha = KK.fused_alpha_s(rhat, r, v, rho)
    assert KK.fused_alpha_s.launches == before + 1
    s_p, alpha_p = KK.fused_alpha_s_plain(rhat, r, v, rho)
    assert _rel(s, s_p) <= TOL[dtype] and _rel(alpha, alpha_p) <= TOL[dtype]
    s2, alpha2 = KK.fused_alpha_s(rhat, r, v, rho)
    assert torch.equal(s, s2) and torch.equal(alpha, alpha2)

    vecs = _krylov_vectors(n, dtype, dev, 8, seed=5)
    args = (*vecs, rho, alpha)
    before = KK.fused_omega_update.launches
    got = KK.fused_omega_update(*args)
    assert KK.fused_omega_update.launches == before + 1
    ref = KK.fused_omega_update_plain(*args)
    for name, g, w in zip(("x", "r", "p", "omega", "rho", "res2"), got, ref):
        assert g.ndim == w.ndim and _rel(g, w) <= TOL[dtype], name
    again = KK.fused_omega_update(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_launch_counters_reset(dev):
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    test_k1_matches_plain(dev, torch.float32, 2, 2)
    assert kernels.launch_counts() == {
        "stencil_matvec": 1, "scalar_jacobi": 0, "darcy_flux_jacobian": 0,
        "darcy_flux_jacobian_lattice": 0, "scalar_chebyshev": 0,
        "fused_alpha_s": 0, "fused_omega_update": 0,
        "scalar_sweeps_resident": 0, "scalar_chebyshev_resident": 0,
        "stencil_matvec_bf16c": 0, "scalar_jacobi_bf16c": 0,
        "scalar_chebyshev_bf16c": 0, "scalar_sweeps_resident_bf16c": 0,
        "scalar_chebyshev_resident_bf16c": 0,
        "scalar_jacobi_slab": 0, "scalar_jacobi_slab_bf16c": 0,
        "scalar_chebyshev_slab": 0, "scalar_chebyshev_slab_bf16c": 0}


# ---------------------------------------------------------------------------
# bfloat16 coefficients: each entry on c.to(bfloat16) equals the float32
# entry on c.to(bfloat16).to(float32) bit for bit (the coefficient is widened
# at its load and nothing else changes), at ragged extents with an odd cell
# count, and stays within TOL of its plain version
# ---------------------------------------------------------------------------
RAGGED = [(9, 13, 37), (16, 16, 64), (5, 7, 3)]


def _scalar_coef(L_, dev, seed):
    g = torch.Generator().manual_seed(seed)
    nz, ny, nx = L_
    n = nz * ny * nx
    shapes = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    d = rnd(n).abs() + 6.0
    d[::11] = 0.0  # dead rows: dinv = 0 from the widened diagonal
    A = ScalarStencil(L_, d.to(dev),
                      {a: -rnd(*s).abs().to(dev) for a, s in shapes.items()},
                      {a: -rnd(*s).abs().to(dev) for a, s in shapes.items()})
    c16 = SK.ScalarLevel(A, coef_dtype=torch.bfloat16).coef
    assert c16.dtype == torch.bfloat16
    return c16, c16.to(torch.float32), rnd(n).to(dev), rnd(n).to(dev), \
        rnd(n).to(dev)


@pytest.mark.parametrize("L_", RAGGED)
@pytest.mark.parametrize("C,K", [(2, 1), (2, 2), (1, 1), (3, 2)])
def test_k1_bf16_coefficients_bitwise(dev, L_, C, K):
    g = torch.Generator().manual_seed(11)
    nz, ny, nx = L_
    n = nz * ny * nx
    shapes = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    rnd = lambda *s: torch.randn(*s, generator=g).to(dev)  # noqa: E731
    M = StencilMatrix(L_, rnd(C, K, n),
                      {a: rnd(C, K, *s) for a, s in shapes.items()},
                      {a: rnd(C, K, *s) for a, s in shapes.items()})
    mv16 = SK.StencilMatvec(M, coef_dtype=torch.bfloat16)
    x = rnd(n, K)
    before = SK.stencil_matvec.launches_bf16c, SK.stencil_matvec.launches
    y16 = mv16(x)
    assert (SK.stencil_matvec.launches_bf16c, SK.stencil_matvec.launches) \
        == (before[0] + 1, before[1])
    y32 = SK.stencil_matvec(mv16.coef.to(torch.float32), x, L_, C, K)
    assert y16.dtype == torch.float32 and torch.equal(y16, y32)
    assert _rel(y16, SK.stencil_matvec_plain(mv16.coef, x, L_, C, K)) \
        <= TOL[torch.float32]


@pytest.mark.parametrize("L_", RAGGED)
def test_k2_bf16_coefficients_bitwise(dev, L_):
    c16, c32, b, u, _ = _scalar_coef(L_, dev, 12)
    for mode in (SK.MODE_INIT, SK.MODE_RESIDUAL, SK.MODE_SMOOTH):
        before = SK.scalar_jacobi.launches_bf16c
        got = SK.scalar_jacobi(c16, b, u, 0.8, mode, L_)
        assert SK.scalar_jacobi.launches_bf16c == before + 1
        assert torch.equal(got, SK.scalar_jacobi(c32, b, u, 0.8, mode, L_))
        assert _rel(got, SK.scalar_jacobi_plain(c16, b, u, 0.8, mode, L_)) \
            <= TOL[torch.float32], mode


@pytest.mark.parametrize("L_", RAGGED)
def test_k4_bf16_coefficients_bitwise(dev, L_):
    from jutul.jl_tpu_torch.linsolve.cheby import chebyshev_steps

    c16, c32, b, u, d = _scalar_coef(L_, dev, 13)
    steps = chebyshev_steps(torch.tensor(1.9, device=dev), 0.25, 12)
    for mode, k in ((SK.CHEB_ZERO, 0), (SK.CHEB_FIRST, 0), (SK.CHEB_STEP, 1),
                    (SK.CHEB_STEP, 11)):
        before = SK.scalar_chebyshev.launches_bf16c
        got = SK.scalar_chebyshev(c16, b, u, d, steps, k, mode, L_)
        assert SK.scalar_chebyshev.launches_bf16c == before + 1
        want = SK.scalar_chebyshev(c32, b, u, d, steps, k, mode, L_)
        ref = SK.scalar_chebyshev_plain(c16, b, u, d, steps, k, mode, L_)
        for gv, wv, rv in zip(got, want, ref):
            assert torch.equal(gv, wv), (mode, k)
            assert _rel(gv, rv) <= TOL[torch.float32], (mode, k)


def test_bf16_coefficients_refuse_float64_vectors(dev):
    c16, _, b, u, _ = _scalar_coef((5, 7, 3), dev, 15)
    with pytest.raises(TypeError):
        SK.scalar_jacobi(c16, b.double(), u.double(), 0.8, SK.MODE_SMOOTH,
                         (5, 7, 3))
    with pytest.raises(TypeError):
        SK.scalar_jacobi_slab(c16, b.double(), u.double(), 0.8, 2, False,
                              (5, 7, 3))


@pytest.mark.parametrize("coef_dtype", [None, "bf16"])
def test_schedule_path_on_the_card_matches_the_cpu(dev, coef_dtype):
    """``simulate_jit`` with Eisenstat-Walker forcing on the well flagship
    at 8x8x6 (``chip_smoke.WELL_SMALL_EW`` says why not 10x10x6): on the
    card (kernels) against the CPU (plain versions).
    float64 with full-precision coefficients: identical counts, states
    within 1e-9. bfloat16 coefficients take float32 vectors on the card, so
    that run is float32 and held to success and the launch counters."""
    import chip_smoke
    from jutul.jl_tpu_torch import Simulator

    model, state0, params, forces = chip_smoke.build_well_flagship(
        *chip_smoke.WELL_SMALL_EW)
    dtype = torch.float64 if coef_dtype is None else torch.float32
    runs = {}
    for device in (dev, "cpu"):
        sim = Simulator(model, state0, params, use_stencil=True,
                        device=device, dtype=dtype)
        kernels.reset_launch_counts()
        res = sim.simulate_jit(
            [chip_smoke.DT] * 2, forces=chip_smoke.rate_schedule(forces, 2),
            **chip_smoke.sim_config(64, coef_dtype=coef_dtype, product=True))
        assert all(r["success"] for r in res.reports)
        runs[device] = (res, kernels.launch_counts())
    (gres, gcount), (cres, ccount) = runs[dev], runs["cpu"]
    assert not any(ccount.values())  # plain versions count no launch
    if coef_dtype == "bf16":
        assert gcount["scalar_jacobi_bf16c"] and \
            gcount["stencil_matvec_bf16c"] and not gcount["scalar_jacobi"]
        return
    assert gcount["scalar_jacobi"] and not gcount["scalar_jacobi_bf16c"]
    rec = lambda r: [(m["iterations"], m["linear_iterations"], m["success"])  # noqa: E731
                     for s in r.reports for m in s["ministeps"]]
    assert rec(gres) == rec(cres)
    g, c = gres.states[-1], cres.states[-1]
    assert float(abs(g["Pressure"] / c["Pressure"] - 1).max()) <= 1e-9
    assert float(abs(g["Saturations"] - c["Saturations"]).max()) <= 1e-9


@pytest.mark.parametrize("dtype", DTYPES)
def test_k1_on_the_transposed_operator(dev, dtype):
    """The adjoint's λ-solve operator: ``stencil_transpose`` gives views,
    which ``embed`` packs; K1 on it against its plain version, and the dot
    identity <x, A y> = <Aᵀx, y> through K1 (sums in float64)."""
    from jutul.jl_tpu_torch.ops.stencil import stencil_transpose

    diag, plus, minus = _random_matrix(2, 2, dtype, dev, seed=4)
    A = StencilMatrix(L, diag, plus, minus)
    At = stencil_transpose(A)
    assert not At.diag.is_contiguous()
    mv, mv_t = SK.StencilMatvec(A), SK.StencilMatvec(At)
    assert mv_t.coef.is_contiguous()
    x = torch.randn(A.n, 2, dtype=dtype, device=dev)
    y = torch.randn(A.n, 2, dtype=dtype, device=dev)
    aty = mv_t(x)
    assert _rel(aty, SK.stencil_matvec_plain(mv_t.coef, x, L, 2, 2)) \
        <= TOL[dtype]
    lhs = float(torch.sum((x * mv(y)).double()))
    rhs = float(torch.sum((aty * y).double()))
    assert abs(lhs - rhs) <= {torch.float32: 1e-5,
                              torch.float64: 1e-12}[dtype] * abs(lhs)


# ---------------------------------------------------------------------------
# K1 against its original mapping (``stencil_matvec_reference``), bit for
# bit: the redesigned kernel keeps each output's fused multiply-add chain,
# so it equals the old one exactly at every (C, K), dtype and lattice — V
# cells per thread (nx = 64; nx = 130 at f64's V = 2), one (nx = 37, 3,
# 129, and 130 at f32's V = 4), the run-time body (C, K) = (3, 2), and an x
# that starts one element into its storage (unaligned: V = 1 or the
# run-time body)
# ---------------------------------------------------------------------------
K1_LATTICES = RAGGED + [(7, 3, 130), (3, 5, 129)]


def _block_matrix(L_, C, K, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    nz, ny, nx = L_
    n = nz * ny * nx
    shapes = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    rnd = lambda *s: torch.randn(  # noqa: E731
        *s, generator=g, dtype=dtype).to(dev)
    return StencilMatrix(L_, rnd(C, K, n),
                         {a: rnd(C, K, *s) for a, s in shapes.items()},
                         {a: rnd(C, K, *s) for a, s in shapes.items()})


def _unaligned(x):
    """``x``'s values in a tensor that starts one element into its
    storage."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,K", [(2, 1), (2, 2), (1, 1), (3, 2)])
@pytest.mark.parametrize("L_", K1_LATTICES)
def test_k1_equals_original_mapping_bitwise(dev, dtype, L_, C, K):
    mv = SK.StencilMatvec(_block_matrix(L_, C, K, dtype, dev, seed=21))
    x = torch.randn(mv.coef.shape[-1], K, dtype=dtype, device=dev)
    before = SK.stencil_matvec.launches
    y = mv(x)
    ref = SK.stencil_matvec_reference(mv.coef, x, L_, C, K)
    # the reference entry counts no launch
    assert SK.stencil_matvec.launches == before + 1
    assert torch.equal(y, ref)
    assert torch.equal(mv(_unaligned(x)), ref)
    assert _rel(y, SK.stencil_matvec_plain(mv.coef, x, L_, C, K)) \
        <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L_", K1_LATTICES)
def test_k1_transposed_equals_original_mapping_bitwise(dev, dtype, L_):
    from jutul.jl_tpu_torch.ops.stencil import stencil_transpose

    mv_t = SK.StencilMatvec(stencil_transpose(
        _block_matrix(L_, 2, 2, dtype, dev, seed=22)))
    x = torch.randn(mv_t.coef.shape[-1], 2, dtype=dtype, device=dev)
    assert torch.equal(mv_t(x), SK.stencil_matvec_reference(
        mv_t.coef, x, L_, 2, 2))


def test_k1_counts_launches_by_shape_and_refuses_2_31_cells(dev):
    """Each launch also counts under its (entry, C, K); a lattice beyond
    the kernel's 32-bit cell indices raises before anything launches."""
    from jutul.jl_tpu_torch.ops.cuda import reset_launch_counts

    L_ = (3, 4, 8)
    mv = SK.StencilMatvec(_block_matrix(L_, 2, 1, torch.float32, dev,
                                        seed=23))
    x = torch.randn(mv.coef.shape[-1], 1, device=dev)
    reset_launch_counts()
    mv(x)
    mv(x)
    assert SK.stencil_matvec.launches_by_shape == {("f32", 2, 1): 2}
    with pytest.raises(ValueError, match="indexes at most"):
        SK.stencil_matvec(mv.coef, x, (2 ** 11, 2 ** 10, 2 ** 10), 2, 1)
    assert SK.stencil_matvec.launches == 2


def test_adjoint_on_the_card_matches_the_cpu(dev):
    """The stencil adjoint (``solve_adjoint_sensitivities_jit``) of the well
    flagship at 8x8x6 in float64 on the same numpy states: on the card (K1,
    K8 λ-solves, K3 Jacobians) against the CPU (plain versions), within
    1e-9; K3 launches once per step on each entry."""
    import chip_smoke
    from jutul.jl_tpu_torch import solve_adjoint_sensitivities_jit

    model, state0, params, forces = chip_smoke.build_well_flagship(
        *chip_smoke.WELL_SMALL_EW)
    sched = chip_smoke.rate_schedule(forces, 2)
    dts = [chip_smoke.ADJ_DT] * 2
    states = chip_smoke._fd_forward((model, state0, params, sched), params,
                                    dts, "cpu")
    _, lam = chip_smoke.adjoint_solvers(lam_rtol=1e-14, lam_its=1000)
    G = chip_smoke.sat_objective(model.domain.mesh._nc_base)
    grads = {}
    for device in (dev, "cpu"):
        kernels.reset_launch_counts()
        grads[device] = solve_adjoint_sensitivities_jit(
            model, states, dts, G, parameters=params, state0=state0,
            forces=sched, linear_solver=lam, include_state0=True,
            use_stencil=True, device=device, dtype=torch.float64)
        counts = kernels.launch_counts()
        if device == dev:
            assert counts["darcy_flux_jacobian_lattice"] == 2
            assert counts["darcy_flux_jacobian"] == 2
            # the λ-solves' GMG at 8x8x6 is one level: its coarse solve
            # is one K8 launch
            assert counts["stencil_matvec"] and \
                counts["scalar_sweeps_resident"]
        else:
            assert not any(counts.values())
    for k in ("Transmissibilities", "FluidVolume", "state0"):
        g, c = grads[dev][k], grads["cpu"][k]
        assert abs(g - c).max() <= 1e-9 * abs(c).max(), k


def _generic_flagship(dims=(8, 8, 6)):
    import chip_smoke

    return chip_smoke.build_flagship(*dims)


def test_generic_assemble_and_cpr_gmres_match_cpu(dev):
    """The generic block-ELL engine at 8x8x6 in float64: ``assemble`` on
    the card against the CPU within 1e-12, and one CPR(AMG + ILU(0))-GMRES
    solve of that system: the same iteration count, du within 1e-9; no
    kernel of ops/cuda launches (the generic path has none)."""
    import chip_smoke
    from jutul.jl_tpu_torch import BlockELL, GenericKrylov

    model, state0, params, forces = _generic_flagship()
    comp = compile_model(model)
    out = {}
    kernels.reset_launch_counts()
    for device in (dev, "cpu"):
        st = merge_state(from_numpy(state0, device, torch.float64),
                         from_numpy(params, device, torch.float64))
        r, J, _ = comp.assemble(st, st, 3600.0, forces)
        assert isinstance(J, BlockELL)
        solver = chip_smoke.generic_solver()
        solver.rtol = 1e-8
        du, stats = solver.solve(J, r)
        out[device] = (r.cpu(), J.blocks.cpu(), du.cpu(), stats["iterations"])
    assert not any(kernels.launch_counts().values())
    g, c = out[dev], out["cpu"]
    assert _rel(g[0], c[0]) <= 1e-12 and _rel(g[1], c[1]) <= 1e-12
    assert g[3] == c[3]
    assert _rel(g[2], c[2]) <= 1e-9
    assert isinstance(solver, GenericKrylov)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpr_update_and_assemble_repeat_bitwise(dev, dtype):
    """CPR ``update`` (quasi-IMPES weights, the AMG Galerkin sums, ILU(0))
    and the generic ``assemble`` twice on the same input give equal bits:
    every repeated-destination sum runs in a fixed order."""
    from jutul.jl_tpu_torch import CPRPreconditioner

    model, state0, params, forces = _generic_flagship((12, 10, 6))
    comp = compile_model(model)
    st = merge_state(from_numpy(state0, dev, dtype),
                     from_numpy(params, dev, dtype))
    r1, J1, _ = comp.assemble(st, st, 3600.0, forces)
    r2, J2, _ = comp.assemble(st, st, 3600.0, forces)
    assert torch.equal(r1, r2) and torch.equal(J1.blocks, J2.blocks)
    cpr = CPRPreconditioner()
    s1, s2 = cpr.update(J1), cpr.update(J1)
    flat = lambda s: [t for t in torch.utils._pytree.tree_leaves(s)  # noqa: E731
                      if torch.is_tensor(t)]
    assert all(torch.equal(a, b) for a, b in zip(flat(s1), flat(s2)))
    x = torch.randn(r1.shape, dtype=dtype, device=dev)
    assert torch.equal(cpr.apply(s1, J1, x), cpr.apply(s2, J1, x))


def _generic_adjoint_case():
    """The 8x8x6 source-term flagship, 2 steps of 1.5 h with the rate
    ramp, its states from one tight f64 CPU forward of the generic
    engine, and G = dt Σ S_w² / nc."""
    import chip_smoke
    from jutul.jl_tpu_torch import simulate

    model, state0, params, forces = _generic_flagship()
    sched = chip_smoke.rate_schedule(forces, 2)
    dts = [chip_smoke.ADJ_DT] * 2
    states = simulate(state0, model, dts, forces=sched, parameters=params,
                      device="cpu", info_level=-1, max_nonlinear_iterations=40,
                      tolerances={"mass_conservation/CNV": 1e-8,
                                  "mass_conservation/MB": 1e-10}).states
    G = chip_smoke.sat_objective(model.number_of_cells())
    return model, state0, params, sched, dts, states, G


def _ilu_bicgstab(rtol):
    from jutul.jl_tpu_torch import GenericKrylov, ILU0Preconditioner

    return GenericKrylov("bicgstab", ILU0Preconditioner(), rtol=rtol,
                         max_iterations=2000)


@pytest.mark.parametrize("dtype", DTYPES)
def test_generic_adjoint_sweeps_repeat_bitwise(dev, dtype):
    """Two sweeps of the generic adjoint (ILU(0)-BiCGStab λ-solves) on the
    card give equal bits and equal λ-iteration counts, and launch no
    kernel of ops/cuda: every sum of the residual's pull-back and of the
    transposed solve runs in a fixed order."""
    from jutul.jl_tpu_torch import (
        AdjointStorage,
        solve_adjoint_sensitivities_jit,
    )

    model, state0, params, sched, dts, states, G = _generic_adjoint_case()
    storage = AdjointStorage(model, params, linear_solver=_ilu_bicgstab(
        1e-6 if dtype == torch.float32 else 1e-10), device=dev, dtype=dtype)
    kernels.reset_launch_counts()
    runs = [solve_adjoint_sensitivities_jit(
        model, states, dts, G, parameters=params, state0=state0,
        forces=sched, include_state0=True, storage=storage)
        for _ in range(2)]
    assert not any(kernels.launch_counts().values())
    its = storage.lambda_iterations
    assert its[:2] == its[2:]
    for k in runs[0]:
        assert np.array_equal(runs[0][k], runs[1][k]), k
        assert np.all(np.isfinite(runs[0][k])), k


@pytest.mark.parametrize("branch", ["direct", "krylov"])
def test_generic_adjoint_matches_cpu(dev, branch):
    """The generic adjoint at 8x8x6 in float64 on the card against the
    CPU, λ at rtol 1e-14 in the Krylov branch: gradients within 1e-9."""
    from jutul.jl_tpu_torch import solve_adjoint_sensitivities_jit

    model, state0, params, sched, dts, states, G = _generic_adjoint_case()
    grads = {}
    for device in (dev, "cpu"):
        kw = {} if branch == "direct" else dict(
            linear_solver=_ilu_bicgstab(1e-14))
        grads[device] = solve_adjoint_sensitivities_jit(
            model, states, dts, G, parameters=params, state0=state0,
            forces=sched, include_state0=True, device=device,
            dtype=torch.float64, **kw)
    for k in ("Transmissibilities", "FluidVolume", "state0"):
        g, c = grads[dev][k], grads["cpu"][k]
        assert abs(g - c).max() <= 1e-9 * abs(c).max(), k


def _well_multimodel_run(device, product):
    import chip_smoke
    from jutul.jl_tpu_torch import Simulator

    mm, state0, params, forces = chip_smoke.build_well_multimodel(
        *chip_smoke.WELL_SMALL_EW)
    sim = Simulator(mm, state0, params, device=device, dtype=torch.float64)
    run = sim.simulate_jit if product else sim.simulate
    res = run([chip_smoke.DT] * 2, forces=chip_smoke.rate_schedule(forces, 2),
              **chip_smoke.multimodel_config(product=product))
    counts = [(m["iterations"], m["linear_iterations"], m["success"])
              for r in res.reports for m in r["ministeps"]]
    return counts, res.states


@pytest.mark.parametrize("product", [False, True])
def test_well_multimodel_on_the_card_matches_the_cpu(dev, product):
    """The well MultiModel (Schur-eliminated wells, CPR-GMRES through
    GroupWise) at 8x8x6 in float64, eager and on the schedule path: the
    card's counts equal the CPU's and its states lie within 1e-12; no
    kernel of ops/cuda launches (the MultiModel assembles through the
    generic engine)."""
    kernels.reset_launch_counts()
    cg, sg = _well_multimodel_run(dev, product)
    assert not any(kernels.launch_counts().values())
    cc, sc = _well_multimodel_run("cpu", product)
    assert cg == cc
    for a, b in zip(sg, sc):
        for m in b:
            assert np.max(np.abs(a[m]["Pressure"] / b[m]["Pressure"] - 1)) \
                <= 1e-12, m
            assert np.max(np.abs(a[m]["Saturations"]
                                 - b[m]["Saturations"])) <= 1e-12, m


def test_well_multimodel_repeats_bitwise(dev):
    """Two card runs of the well MultiModel give equal counts and equal
    bits: every add whose rows repeat (a wellbore row's perforations, in
    the residual, the Jacobian and the Schur operator) is a fixed-order
    sum."""
    runs = [_well_multimodel_run(dev, True) for _ in range(2)]
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        for m in a:
            for k in a[m]:
                assert np.array_equal(a[m][k], b[m][k]), (m, k)


# ---------------------------------------------------------------------------
# the transport slice (WENO / NFVM on an UnstructuredMesh)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheme", ["spu", "weno", "avgmpfa", "ntpfa"])
def test_transport_on_the_card_matches_the_cpu(dev, scheme):
    """chip_smoke's transport cross-check case at 24x20 in float64 with
    its Krylov solver: the card's counts equal the CPU's, its states lie
    within 1e-9 of them, and a second card run repeats the bits; no kernel
    of ops/cuda launches."""
    import chip_smoke
    from jutul.jl_tpu_torch import Simulator

    model, state0, params, dts = chip_smoke.transport_cross_case(scheme)
    key = next(iter(model.primary_variables))
    runs = []
    kernels.reset_launch_counts()
    for d in (dev, dev, "cpu"):
        sim = Simulator(model, state0, params, use_stencil=False, device=d,
                        dtype=torch.float64)
        res = sim.simulate(dts, info_level=-1, linear_solver=chip_smoke
                           .small_transport_solver(scheme))
        assert all(r["success"] for r in res.reports)
        runs.append(([(m["iterations"], m["linear_iterations"])
                      for r in res.reports for m in r["ministeps"]],
                     [s[key] for s in res.states]))
    assert not any(kernels.launch_counts().values())
    assert runs[0][0] == runs[1][0] == runs[2][0]
    for a, b, c in zip(runs[0][1], runs[1][1], runs[2][1]):
        assert np.array_equal(a, b)
        assert np.max(np.abs(a - c)) <= 1e-9


def test_transport_tables_repeat_bitwise_on_the_card(dev):
    """The batched WENO and NFVM table functions give equal bits when run
    twice, and the card's residual assembled from either build repeats its
    bits."""
    import chip_smoke
    from jutul.jl_tpu_torch.discretization.nfvm import nfvm_discretize
    from jutul.jl_tpu_torch.discretization.weno import weno_discretize

    mesh = chip_smoke.perturbed_quad_mesh(48, 40)
    geo = mesh.tpfv_geometry()
    perm = chip_smoke.nfvm_permeability(geo.n_cells)
    for build in (lambda: weno_discretize(geo),
                  lambda: nfvm_discretize(geo, perm)):
        a, b = build(), build()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    rs = []
    for _ in range(2):
        model, state0, params = chip_smoke.build_transport(48, 40, "weno",
                                                           mesh=mesh)
        comp = compile_model(model)
        full = merge_state(from_numpy(state0, dev, torch.float64),
                           from_numpy(params, dev, torch.float64))
        r, J, _ = comp.assemble(full, full, 1e-3)
        rs.append((r, J.blocks))
    assert torch.equal(rs[0][0], rs[1][0])
    assert torch.equal(rs[0][1], rs[1][1])


# ---------------------------------------------------------------------------
# the meshes slice (extruded layers, trajectory wells, coarse, cut fault)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["layers", "coarse", "fault"])
def test_layered_reservoir_on_the_card_matches_the_cpu(dev, kind):
    """chip_smoke's layered reservoir at 8x8x4 (its coarse model at 16
    blocks, its cut-fault mesh) in float64 with CPR-GMRES: the card's
    counts equal the CPU's, its states lie within 1e-12 of them, a second
    card run repeats the bits; no kernel of ops/cuda launches."""
    import chip_smoke
    from jutul.jl_tpu_torch import Simulator

    case = chip_smoke.layered_reservoir(*chip_smoke.LAYER_SMALL,
                                        fault=kind == "fault")
    model, state0, params, forces = (case[k] for k in (
        "model", "state0", "params", "forces"))
    if kind == "coarse":
        model, state0, params, forces, _ = chip_smoke.coarse_reservoir(case,
                                                                       16)
    runs = []
    kernels.reset_launch_counts()
    for d in (dev, dev, "cpu"):
        sim = Simulator(model, state0, params, use_stencil=False, device=d,
                        dtype=torch.float64)
        res = sim.simulate([chip_smoke.DT] * 2,
                           forces=chip_smoke.rate_schedule(forces, 2),
                           **chip_smoke.generic_config())
        assert all(r["success"] for r in res.reports)
        runs.append(([(m["iterations"], m["linear_iterations"])
                      for r in res.reports for m in r["ministeps"]],
                     res.states))
    assert not any(kernels.launch_counts().values())
    assert runs[0][0] == runs[1][0] == runs[2][0]
    for a, b, c in zip(runs[0][1], runs[1][1], runs[2][1]):
        for k in ("Pressure", "Saturations"):
            assert np.array_equal(a[k], b[k])
            assert np.max(np.abs(a[k] - c[k]) / np.maximum(
                np.abs(c[k]), 1.0)) <= 1e-12


def test_stencil_jacobian_oracle_on_the_card(dev):
    """K1 on the fused assembly's matrix against the generic
    ``StencilCompiledModel.jacobian``'s plain ``matvec``, in float64."""
    import chip_smoke

    model, state0, params, _ = chip_smoke.build_flagship(12, 10, 8)
    comp = compile_model(model)
    sc = StencilCompiledModel(comp)
    full = comp.evaluate_secondaries(merge_state(
        from_numpy(state0, dev, torch.float64),
        from_numpy(params, dev, torch.float64)))
    _, A, _ = sc.assemble(full, full, chip_smoke.DT)
    x = torch.randn((A.n, 2), device=dev, dtype=torch.float64)
    assert _rel(SK.StencilMatvec(A)(x),
                sc.jacobian(full, full, chip_smoke.DT).matvec(x)) <= 1e-12


@pytest.mark.parametrize("halo_mode", ["all_to_all", "ppermute"])
def test_general_dd_on_the_card_matches_the_cpu(dev, halo_mode):
    """chip_smoke's dryrun case over ``ShardGroup.threads(4)`` on the card
    in float64 (distributed CPR, Chebyshev): the card's counts equal the
    CPU's, its states lie within 1e-12 of them, a second card run repeats
    the bits; no kernel of ops/cuda launches."""
    import chip_smoke
    import jutul.jl_tpu_torch as tp

    c = chip_smoke.dryrun_case(tp, 4)
    runs = []
    kernels.reset_launch_counts()
    for d in (dev, dev, "cpu"):
        dsim = tp.GeneralDistributedSimulator(
            c["wmesh"], c["model"].system, tp.ShardGroup.threads(4, d),
            partition=c["part"], parameters=c["params"],
            data_fields=c["data_fields"], halo_mode=halo_mode,
            dtype=torch.float64)
        states, reps = dsim.simulate(
            c["state0"], c["dts"], forces=c["forces"], tolerances=c["tols"],
            max_newton=40, preconditioner="cpr", cpr_smoother="chebyshev",
            info_level=-1)
        runs.append((chip_smoke._counts(reps), states))
    assert not any(kernels.launch_counts().values())
    assert runs[0][0] == runs[1][0] == runs[2][0]
    for a, b, cpu in zip(runs[0][1], runs[1][1], runs[2][1]):
        for k in ("Pressure", "Saturations"):
            assert np.array_equal(a[k], b[k])
            assert chip_smoke._state_rel({k: a[k]}, {k: cpu[k]}) <= 1e-12


def test_slab_dd_cpr_launches_k2_and_matches_the_cpu(dev):
    """The slab engine's distributed CPR on the card (4 slabs, float64):
    the global GMG V-cycle launches K2 from every shard thread; ministep
    and Newton counts equal the CPU's, linear its within 2 per Newton (a
    BiCGStab stop near its tolerance sees the devices' roundoff: 100
    against 99 here), states within 1e-12; the slab adjoint's gradients
    card against CPU within 1e-9 (λ-solves at rtol 1e-13)."""
    import chip_smoke
    import jutul.jl_tpu_torch as tp

    out = []
    for d in (dev, "cpu"):
        mesh, system, df, init, forces = chip_smoke.slab_case(tp)
        kernels.reset_launch_counts()
        dsim = tp.DistributedSimulator(
            mesh, system, tp.ShardGroup.threads(4, d), data_fields=df,
            local_preconditioner="cpr", dtype=torch.float64)
        states, reps = dsim.simulate(dsim.initial_state(**init), [4320.0],
                                     forces=forces, tol_cnv=1e-10,
                                     max_newton=30, info_level=-1)
        launches = kernels.launch_counts()
        grads = tp.solve_adjoint_sensitivities_distributed(
            dsim, states, [4320.0], chip_smoke.pressure_objective(1e7),
            dsim.initial_state(**init), forces=forces, rtol=1e-13,
            max_lin_it=2000)
        out.append((chip_smoke._counts(reps), states[-1], launches, grads))
    (cg, sg, lg, gg), (cc, sc, lc, gc) = out
    assert lg["scalar_jacobi"] > 0 and not any(lc.values())
    assert [n for n, _ in cg] == [n for n, _ in cc]
    assert all(abs(a[1] - b[1]) <= 2 * a[0] for a, b in zip(cg, cc))
    assert chip_smoke._state_rel(sg, sc) <= 1e-12
    for k in gc:
        assert chip_smoke._grad_rel({k: gg[k]}, {k: gc[k]}) <= 1e-9, k


def test_distributed_multimodel_on_the_card_matches_the_cpu(dev):
    """dryrun_multichip's distributed MultiModel (``coupled_dd_case`` with
    the leaky fault and the Schur-eliminated wells) over
    ``ShardGroup.threads(8)`` on the card in float64: ministep and Newton
    counts equal the CPU's, linear its within 2 per Newton, states within
    1e-12 of the CPU's, the replicated wells equal bit for bit on every
    shard after every ministep; no kernel of ops/cuda launches."""
    import chip_smoke
    import jutul.jl_tpu_torch as tp

    c = chip_smoke.coupled_dd_case(tp, fault=True, schur=True)
    part = tp.GreedyGraphPartitioner().partition(
        c["mm"]["reservoir"].domain.mesh.neighborship(), c["nc"], 8)
    runs = []
    for d in (dev, "cpu"):
        kernels.reset_launch_counts()
        _dmm, states, reps, seen = chip_smoke._dd_mm_run(
            c, tp.ShardGroup.threads(8, d), part)
        assert seen and not any(seen), seen
        assert not any(kernels.launch_counts().values())
        runs.append((chip_smoke._counts(reps), states))
    (cg, sg), (cc, sc) = runs
    assert [n for n, _ in cg] == [n for n, _ in cc]
    assert all(abs(a - b) <= 2 * n for (n, a), (_n, b) in zip(cg, cc))
    for a, cpu in zip(sg, sc):
        assert chip_smoke._mm_rel(a, cpu) <= 1e-12


# ---------------------------------------------------------------------------
# K8 / K9: a whole level's Jacobi / Chebyshev phase in one launch, in both
# forms, equal to the K2 / K4 chains bit for bit
# ---------------------------------------------------------------------------
def _k2_chain_level(coef, b, u, n_sweep, residual, L_):
    return _k2_chain(coef, b, u, 0.8, n_sweep, residual, L_)


def _k4_chain(coef, b, u, steps, n_sweep, residual, L_):
    mode = SK.CHEB_ZERO if u is None else SK.CHEB_FIRST
    u, d = SK.scalar_chebyshev(coef, b, u, None, steps, 0, mode, L_)
    for k in range(1, n_sweep):
        u, d = SK.scalar_chebyshev(coef, b, u, d, steps, k, SK.CHEB_STEP, L_)
    r = SK.scalar_jacobi(coef, b, u, 0.0, SK.MODE_RESIDUAL, L_) \
        if residual else None
    return u, r


RESIDENT_L = [(16, 16, 64), (9, 13, 37), (5, 7, 3), (17, 3, 4)]


@pytest.mark.parametrize("coef_dtype", [torch.float32, torch.float64,
                                        torch.bfloat16])
@pytest.mark.parametrize("L_", RESIDENT_L)
def test_k8_k9_equal_the_chains_bitwise_in_both_forms(dev, L_, coef_dtype):
    """1 to 12 sweeps (odd counts too), from zero and from u, with and
    without the residual, in the cluster and the grid form (forced through
    the wrapper), at ragged extents: K8 equal to the K2 chain and K9 to the
    K4 chain (and K2's residual) bit for bit, one launch each, and within
    TOL of the plain versions."""
    from jutul.jl_tpu_torch.linsolve.cheby import chebyshev_steps

    c16, c32, b, u, _ = _scalar_coef(L_, dev, seed=sum(L_))
    vec = torch.float64 if coef_dtype == torch.float64 else torch.float32
    coef = {torch.bfloat16: c16, torch.float32: c32,
            torch.float64: c32.double()}[coef_dtype]
    b, u = b.to(vec), u.to(vec)
    steps = chebyshev_steps(torch.tensor(2.5, dtype=vec, device=dev), 0.25,
                            12)
    counter = "launches_bf16c" if coef_dtype == torch.bfloat16 \
        else "launches"
    for form in ("cluster", "grid"):
        for u0 in (None, u):
            for n_sweep in (1, 2, 3, 5, 12):
                for res in (False, True):
                    case = (form, u0 is None, n_sweep, res)
                    for wrapper, call, chain, plain in (
                            (SK.scalar_sweeps_resident,
                             lambda: SK.scalar_sweeps_resident(
                                 coef, b, u0, 0.8, n_sweep, res, L_, form),
                             lambda: _k2_chain_level(coef, b, u0, n_sweep,
                                                     res, L_),
                             lambda: SK.scalar_sweeps_resident_plain(
                                 coef, b, u0, 0.8, n_sweep, res, L_)),
                            (SK.scalar_chebyshev_resident,
                             lambda: SK.scalar_chebyshev_resident(
                                 coef, b, u0, steps, n_sweep, res, L_, form),
                             lambda: _k4_chain(coef, b, u0, steps, n_sweep,
                                               res, L_),
                             lambda: SK.scalar_chebyshev_resident_plain(
                                 coef, b, u0, steps, n_sweep, res, L_))):
                        before = getattr(wrapper, counter)
                        got = call()
                        assert getattr(wrapper, counter) == before + 1
                        for g, w, p in zip(got, chain(), plain()):
                            assert (g is None) == (w is None), case
                            if w is not None:
                                assert torch.equal(g, w), case
                                assert _rel(g, p) <= TOL[vec], case


@pytest.mark.parametrize("dtype", DTYPES)
def test_k8_k9_refuse_a_lattice_over_each_forms_capacity(dev, dtype):
    """One plane over the cluster form's 16 CTAs of whole planes, and over
    the grid form's one chunk of 2 x threads cells on each SM: the wrapper
    raises and launches nothing."""
    props = SK.device_props(torch.device(dev), dtype)
    cap = SK.RESIDENT_CELLS * SK.RESIDENT_THREADS
    plane = 1024
    too_big = {"cluster": props["max_cluster"] * (cap // plane) + 1,
               "grid": props["sms"] * cap // plane + 1}
    for form, nz in too_big.items():
        L_ = (nz, 16, 64)
        assert SK.resident_plan(L_, dtype, None, props, form) is None
        assert SK.resident_plan((nz - 1, 16, 64), dtype, None, props,
                                form) is not None
        n = nz * plane
        coef = torch.zeros(7, 1, n, dtype=dtype, device=dev)
        b = torch.zeros(n, dtype=dtype, device=dev)
        steps = torch.ones(12, 2, dtype=dtype, device=dev)
        before = (SK.scalar_sweeps_resident.launches,
                  SK.scalar_chebyshev_resident.launches)
        with pytest.raises(ValueError, match="capacity"):
            SK.scalar_sweeps_resident(coef, b, None, 0.8, 2, True, L_, form)
        with pytest.raises(ValueError, match="capacity"):
            SK.scalar_chebyshev_resident(coef, b, None, steps, 2, True, L_,
                                         form)
        assert (SK.scalar_sweeps_resident.launches,
                SK.scalar_chebyshev_resident.launches) == before


# K10: the flagship's fine and mid GMG levels ((nz, ny, nx)) and ragged
# lattices (nx not a multiple of V, ny = 1, nz = 1, nz below a chunk)
SLAB_L = [(64, 64, 256), (32, 32, 128), (9, 13, 37), (5, 1, 16),
          (1, 8, 32), (3, 40, 20)]


def _slab_tiles(L_, dtype, coef_dtype, napp, from_u, cheby=False):
    """The planner's tile (None) and pinned ones of several tiles along x
    and y and z-chunks of 1 and 2 planes (halos on every side), each at
    the type's V and at V = 1, where they fit (K11's shared memory with
    ``cheby``)."""
    nz, ny, nx = L_
    out = [None]
    size = 8 if dtype == torch.float64 else 4
    csize = 2 if coef_dtype == torch.bfloat16 else size
    for vec in sorted({SK.slab_vec(nx, dtype), 1}):
        for ox, oy, tz in ((vec * max(1, nx // (3 * vec)),
                            max(1, ny // 3), 1),
                           (nx, max(1, ny // 2), 2)):
            _, _, tx, ty = SK.slab_tile(L_, napp, vec, ox, oy)
            if tx // vec * ty <= SK.SLAB_THREADS and SK.slab_smem(
                    tx * ty, napp, csize, size, from_u, cheby) <= \
                    SK.SLAB_MAX_SMEM:
                out.append((vec, ox, oy, tz))
    return out


@pytest.mark.parametrize("coef_dtype", [torch.float32, torch.float64,
                                        torch.bfloat16])
@pytest.mark.parametrize("L_", SLAB_L)
def test_k10_equals_the_k2_chain_bitwise(dev, L_, coef_dtype):
    """1-4 stencil applications, from zero and from u, with and without the
    residual, under the planner's tile and pinned ones: K10 equal to the
    K2 chain bit for bit, one launch each, and within TOL of its plain
    version."""
    c16, c32, b, u, _ = _scalar_coef(L_, dev, seed=sum(L_))
    vec = torch.float64 if coef_dtype == torch.float64 else torch.float32
    coef = {torch.bfloat16: c16, torch.float32: c32,
            torch.float64: c32.double()}[coef_dtype]
    b, u = b.to(vec), u.to(vec)
    counter = "launches_bf16c" if coef_dtype == torch.bfloat16 \
        else "launches"
    for u0 in (None, u):
        for n_sweep in (1, 2, 3, 4):
            for res in (False, True):
                napp = SK._phase_depth(u0, n_sweep, res)
                if napp > SK.SLAB_MAX_DEPTH:
                    continue
                want = _k2_chain_level(coef, b, u0, n_sweep, res, L_)
                plain = SK.scalar_jacobi_slab_plain(coef, b, u0, 0.8,
                                                    n_sweep, res, L_)
                for plan in _slab_tiles(L_, vec, coef_dtype, napp,
                                        u0 is not None):
                    case = (u0 is None, n_sweep, res, plan)
                    if plan is None and SK.slab_plan(
                            L_, vec, coef.dtype, napp, u0 is not None) \
                            is None:
                        continue  # no tile holds it (4 f64 applications)
                    before = getattr(SK.scalar_jacobi_slab, counter)
                    got = SK.scalar_jacobi_slab(coef, b, u0, 0.8, n_sweep,
                                                res, L_, plan)
                    assert getattr(SK.scalar_jacobi_slab, counter) == \
                        before + 1
                    for g, w, p in zip(got, want, plain):
                        assert (g is None) == (w is None), case
                        if w is not None:
                            assert torch.equal(g, w), case
                            assert _rel(g, p) <= TOL[vec], case


def test_k10_refuses_what_it_cannot_run(dev):
    """More than SLAB_MAX_DEPTH applications, or a tile the kernel cannot
    run: the wrapper raises and counts no launch."""
    L_ = (4, 8, 16)
    coef = torch.zeros(7, 1, 512, device=dev)
    b = torch.zeros(512, device=dev)
    before = SK.scalar_jacobi_slab.launches
    with pytest.raises(ValueError, match="applications"):
        SK.scalar_jacobi_slab(coef, b, b, 0.8, SK.SLAB_MAX_DEPTH + 1,
                              False, L_)
    # pinned tiles the kernel's launcher refuses: own columns not a
    # multiple of V, an empty z-chunk
    for plan in ((4, 6, 8, 1), (4, 16, 8, 0)):
        with pytest.raises(RuntimeError, match="launch failed"):
            SK.scalar_jacobi_slab(coef, b, None, 0.8, 2, True, L_, plan)
    assert SK.scalar_jacobi_slab.launches == before


@pytest.mark.parametrize("coef_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L_", [(32, 32, 128), (9, 13, 37)])
def test_k10_takes_unaligned_vectors(dev, L_, coef_dtype):
    """b or u starting one element into its storage: the wrapper's
    alignment test drops to one cell a thread, and K10 still equals the K2
    chain bit for bit."""
    c16, c32, b, u, _ = _scalar_coef(L_, dev, seed=sum(L_) + 1)
    coef = c16 if coef_dtype == torch.bfloat16 else c32
    for u0 in (None, u):
        want = _k2_chain_level(coef, b, u0, 2, True, L_)
        for bb, uu in ((_unaligned(b), u0),
                       (b, None if u0 is None else _unaligned(u0))):
            got = SK.scalar_jacobi_slab(coef, bb, uu, 0.8, 2, True, L_)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


def test_gmg_routes_the_fine_and_mid_levels_to_k10(dev):
    """The flagship's fine and mid level shapes: a Jacobi V-cycle's
    smoothing phases there are one K10 launch each (4 a V-cycle), the
    coarse solve one K8 launch, and no K2 pass; the result equals the
    chains' bit for bit."""
    from jutul.jl_tpu_torch.ops.stencil import GMG

    g = torch.Generator().manual_seed(5)
    L_ = (64, 64, 256)
    nz, ny, nx = L_
    n = nz * ny * nx
    shapes = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    A = ScalarStencil(L_, (rnd(n).abs() + 6.0).to(dev),
                      {a: -rnd(*s).abs().to(dev) for a, s in shapes.items()},
                      {a: -rnd(*s).abs().to(dev) for a, s in shapes.items()})
    b = rnd(n).to(dev)
    gmg = GMG(n_smooth=2, n_coarse_sweeps=12, min_cells=16384)
    ops = gmg.hierarchy(A)
    assert [o.L for o in ops] == [(64, 64, 256), (32, 32, 128),
                                  (16, 16, 64)]
    mvs = gmg.matvecs(ops)
    assert [lv.route("postsmooth", b) for lv in mvs[:2]] == ["slab"] * 2
    chains = [SK.ScalarLevel(o, resident=False, slab=False) for o in ops]
    kernels.reset_launch_counts()
    got = gmg.vcycle(ops, b, mvs=mvs)
    counts = kernels.launch_counts()
    want = gmg.vcycle(ops, b, mvs=chains)
    assert torch.equal(got, want)
    assert (counts["scalar_jacobi_slab"], counts["scalar_sweeps_resident"],
            counts["scalar_jacobi"]) == (4, 1, 0), counts


# ---------------------------------------------------------------------------
# K11: a whole Chebyshev phase of a large level in one launch, equal to the
# K4 chain (and K2's residual) bit for bit
# ---------------------------------------------------------------------------
def _slab_steps(vec, dev):
    from jutul.jl_tpu_torch.linsolve.cheby import chebyshev_steps

    return chebyshev_steps(torch.tensor(2.5, dtype=vec, device=dev), 0.25,
                           SK.SLAB_MAX_DEPTH + 1)


@pytest.mark.parametrize("coef_dtype", [torch.float32, torch.float64,
                                        torch.bfloat16])
@pytest.mark.parametrize("L_", SLAB_L)
def test_k11_equals_the_k4_chain_bitwise(dev, L_, coef_dtype):
    """1-5 steps (at most SLAB_MAX_DEPTH applications), from zero and from
    u, with and without the residual, under the planner's tile and pinned
    ones: K11 equal to the K4 chain and K2's residual bit for bit, one
    launch each, and within TOL of its plain version."""
    c16, c32, b, u, _ = _scalar_coef(L_, dev, seed=sum(L_) + 2)
    vec = torch.float64 if coef_dtype == torch.float64 else torch.float32
    coef = {torch.bfloat16: c16, torch.float32: c32,
            torch.float64: c32.double()}[coef_dtype]
    b, u = b.to(vec), u.to(vec)
    steps = _slab_steps(vec, dev)
    counter = "launches_bf16c" if coef_dtype == torch.bfloat16 \
        else "launches"
    for u0 in (None, u):
        for n_sweep in (1, 2, 3, 4, 5):
            for res in (False, True):
                napp = SK._phase_depth(u0, n_sweep, res)
                if napp > SK.SLAB_MAX_DEPTH:
                    continue
                want = _k4_chain(coef, b, u0, steps, n_sweep, res, L_)
                plain = SK.scalar_chebyshev_slab_plain(coef, b, u0, steps,
                                                       n_sweep, res, L_)
                for plan in _slab_tiles(L_, vec, coef_dtype, napp,
                                        u0 is not None, cheby=True):
                    case = (u0 is None, n_sweep, res, plan)
                    if plan is None and SK.slab_plan(
                            L_, vec, coef.dtype, napp, u0 is not None,
                            cheby=True) is None:
                        continue  # no tile holds it (4 f64 applications)
                    before = getattr(SK.scalar_chebyshev_slab, counter)
                    got = SK.scalar_chebyshev_slab(coef, b, u0, steps,
                                                   n_sweep, res, L_, plan)
                    assert getattr(SK.scalar_chebyshev_slab, counter) == \
                        before + 1
                    for g, w, p in zip(got, want, plain):
                        assert (g is None) == (w is None), case
                        if w is not None:
                            assert torch.equal(g, w), case
                            assert _rel(g, p) <= TOL[vec], case


def test_k11_refuses_what_it_cannot_run(dev):
    """More than SLAB_MAX_DEPTH applications, no step, a step table shorter
    than the phase, or a tile the kernel cannot run: the wrapper raises and
    counts no launch."""
    L_ = (4, 8, 16)
    coef = torch.zeros(7, 1, 512, device=dev)
    b = torch.zeros(512, device=dev)
    steps = _slab_steps(torch.float32, dev)
    before = SK.scalar_chebyshev_slab.launches
    with pytest.raises(ValueError, match="applications"):
        SK.scalar_chebyshev_slab(coef, b, b, steps, SK.SLAB_MAX_DEPTH + 1,
                                 False, L_)
    with pytest.raises(ValueError, match="applications"):
        SK.scalar_chebyshev_slab(coef, b, b, steps, 0, True, L_)
    with pytest.raises(ValueError, match="steps"):
        SK.scalar_chebyshev_slab(coef, b, b, steps[:2], 3, False, L_)
    for plan in ((4, 6, 8, 1), (4, 16, 8, 0)):
        with pytest.raises(RuntimeError, match="launch failed"):
            SK.scalar_chebyshev_slab(coef, b, None, steps, 2, True, L_,
                                     plan)
    assert SK.scalar_chebyshev_slab.launches == before


@pytest.mark.parametrize("coef_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L_", [(64, 64, 256), (32, 32, 128), (9, 13, 37)])
def test_k11_takes_unaligned_vectors(dev, L_, coef_dtype):
    """b or u starting one element into its storage: the wrapper's
    alignment test drops to one cell a thread, and K11 still equals the K4
    chain and K2's residual bit for bit."""
    c16, c32, b, u, _ = _scalar_coef(L_, dev, seed=sum(L_) + 3)
    coef = c16 if coef_dtype == torch.bfloat16 else c32
    steps = _slab_steps(torch.float32, dev)
    for u0 in (None, u):
        want = _k4_chain(coef, b, u0, steps, 2, u0 is None, L_)
        for bb, uu in ((_unaligned(b), u0),
                       (b, None if u0 is None else _unaligned(u0))):
            got = SK.scalar_chebyshev_slab(coef, bb, uu, steps, 2,
                                           u0 is None, L_)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if w is not None:
                    assert torch.equal(g, w)


def test_gmg_routes_the_fine_and_mid_chebyshev_hooks_to_k11(dev):
    """The flagship's hierarchy with the Chebyshev smoother: a V-cycle's
    smoothing phases on the fine and mid levels are one K11 launch each (4
    a V-cycle), the coarse solve one K9 launch, and neither a K4 step nor
    a K2 pass; the result equals the chains' bit for bit."""
    from jutul.jl_tpu_torch.ops.stencil import GMG

    g = torch.Generator().manual_seed(6)
    L_ = (64, 64, 256)
    nz, ny, nx = L_
    n = nz * ny * nx
    shapes = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    A = ScalarStencil(L_, (rnd(n).abs() + 6.0).to(dev),
                      {a: -rnd(*s).abs().to(dev) for a, s in shapes.items()},
                      {a: -rnd(*s).abs().to(dev) for a, s in shapes.items()})
    b = rnd(n).to(dev)
    gmg = GMG(n_smooth=2, n_coarse_sweeps=12, min_cells=16384,
              smoother="chebyshev")
    ops = gmg.hierarchy(A)
    mvs, cheb = gmg.matvecs(ops), gmg.cheby_data(ops)
    assert [lv.route(h, b) for lv in mvs[:2] for h in (
        "presmooth_residual_cheby", "postsmooth_cheby")] == ["slab"] * 4
    chains = [SK.ScalarLevel(o, resident=False, slab=False) for o in ops]
    kernels.reset_launch_counts()
    got = gmg.vcycle(ops, b, mvs=mvs, cheb=cheb)
    counts = kernels.launch_counts()
    want = gmg.vcycle(ops, b, mvs=chains, cheb=cheb)
    assert torch.equal(got, want)
    assert (counts["scalar_chebyshev_slab"],
            counts["scalar_chebyshev_resident"], counts["scalar_chebyshev"],
            counts["scalar_jacobi"]) == (4, 1, 0, 0), counts


def test_gmg_routes_the_coarse_solve_to_k8_k9(dev):
    """The flagship's pressure hierarchy shape, cut to its two lower levels
    (the mid level in the grid form, the coarse one in the cluster form):
    a V-cycle launches K8 (Jacobi) or K9 (Chebyshev) once, for the coarse
    solve, and its values equal those of the chains bit for bit."""
    from jutul.jl_tpu_torch.ops.stencil import GMG

    g = torch.Generator().manual_seed(4)
    L_ = (32, 32, 128)
    nz, ny, nx = L_
    n = nz * ny * nx
    shapes = {0: (nz, ny, nx - 1), 1: (nz, ny - 1, nx), 2: (nz - 1, ny, nx)}
    rnd = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    A = ScalarStencil(L_, (rnd(n).abs() + 6.0).to(dev),
                      {a: -rnd(*s).abs().to(dev) for a, s in shapes.items()},
                      {a: -rnd(*s).abs().to(dev) for a, s in shapes.items()})
    b = rnd(n).to(dev)
    for smoother in ("jacobi", "chebyshev"):
        gmg = GMG(n_smooth=2, n_coarse_sweeps=12, min_cells=16384,
                  smoother=smoother)
        ops = gmg.hierarchy(A)
        assert [o.L for o in ops] == [(32, 32, 128), (16, 16, 64)]
        mvs, cheb = gmg.matvecs(ops), gmg.cheby_data(ops)
        assert [lv.plan(b)[0] for lv in mvs] == ["grid", "cluster"]
        chains = [SK.ScalarLevel(o, resident=False, slab=False)
                  for o in ops]
        kernels.reset_launch_counts()
        got = gmg.vcycle(ops, b, mvs=mvs, cheb=cheb)
        counts = kernels.launch_counts()
        want = gmg.vcycle(ops, b, mvs=chains, cheb=cheb)
        assert torch.equal(got, want)
        k = "scalar_chebyshev_resident" if smoother == "chebyshev" \
            else "scalar_sweeps_resident"
        assert counts[k] == 1, counts
