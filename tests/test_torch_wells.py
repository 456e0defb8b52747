"""The port's well models against the JAX package, at f64 on the CPU.

The case is tests/test_stencil_wells.py's ``_case`` (a 6x5x4 lattice, one
two-completion rate injector and one BHP producer, gravity on), built
through each package's own API from the same numpy arrays. Covered:
``setup_well_graph_model``'s parameters, ``PressureBoundaryCondition``,
the lattice engine's state-dependent force diagonal, the bordered
residual and matrix, the Schur elimination, one bordered linear solve and
the Simulator's dispatch to the bordered engine.

Tolerance: max error <= 1e-12 x the largest magnitude of each result —
the two packages evaluate the same formulas with other summation orders.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu.models.setup import merge_state as jmerge
from jutul.jl_tpu.ops.assembly import compile_model as jcompile
from jutul.jl_tpu_torch.models.setup import merge_state as tmerge

RTOL = 1e-12
DT = 0.5 * 86400.0
PKGS = ("jutul.jl_tpu", "jutul.jl_tpu_torch")


def assert_close(actual, desired, rtol=RTOL, what=""):
    actual, desired = np.asarray(actual), np.asarray(desired)
    assert actual.shape == desired.shape, (what, actual.shape, desired.shape)
    scale = max(np.abs(desired).max(), 1e-300)
    err = np.abs(actual - desired).max()
    assert err <= rtol * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def _case(pkg_name, nx=6, ny=5, nz=4, seed=0):
    """tests/test_stencil_wells.py ``_case`` through package ``pkg_name``."""
    pkg = importlib.import_module(pkg_name)
    darcy = importlib.import_module(pkg_name + ".models.darcy")
    wells_mod = importlib.import_module(pkg_name + ".models.wells")
    BAR, DARCY = pkg.si_unit("bar"), pkg.si_unit("darcy")
    mesh = pkg.CartesianMesh((nx, ny, nz), (60.0, 50.0, 20.0))
    fluid = darcy.ImmiscibleFluid(viscosities=(1e-3, 2e-3))
    nc = nx * ny * nz
    rng = np.random.default_rng(seed)
    perm = rng.lognormal(0.0, 1.0, nc) * 0.2 * DARCY

    def cell(ix, iy, iz):
        return (iz * ny + iy) * nx + ix

    wells = [wells_mod.WellSpec("inj", [cell(0, 0, 0), cell(0, 0, 1)],
                                WI=[2e-12, 3e-12], volume=0.5),
             wells_mod.WellSpec("prod", [cell(nx - 1, ny - 1, nz - 1)],
                                WI=4e-12, volume=0.5)]
    model, wmesh, params = wells_mod.setup_well_graph_model(
        mesh, fluid, wells, permeability=perm, porosity=0.25, gravity=True)
    sw = rng.uniform(0.25, 0.75, mesh.number_of_cells() + len(wells))
    state0 = pkg.setup_state(model, Pressure=150.0 * BAR,
                             Saturations=np.stack([sw, 1 - sw], 1))
    forces = {
        "rate": darcy.PhaseSourceTerm([wmesh.well_cells["inj"]],
                                      np.array([[0.05, 0.0]])),
        "bhp": darcy.PressureBoundaryCondition(
            [wmesh.well_cells["prod"]], 120.0 * BAR, 1e-11,
            saturations=[0.5, 0.5]),
    }
    return model, wmesh, params, state0, forces


def _perturbed(state0, seed=3):
    """state0 with pressure perturbed and some saturations on both clip
    bounds (the port must follow JAX's derivative rule there)."""
    rng = np.random.default_rng(seed)
    st = {k: np.asarray(v) for k, v in state0.items()}
    n = st["Pressure"].shape[0]
    st["Pressure"] = st["Pressure"] * (1.0 + 0.01 * rng.normal(size=n))
    s = st["Saturations"].copy()
    s[::7] = (1.0, 0.0)
    s[::11] = (0.0, 1.0)
    st["Saturations"] = s
    return st


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in PKGS}


@pytest.fixture(scope="module")
def assembled(cases):
    """(r, B) of both packages' bordered engines on the same state."""
    from jutul.jl_tpu.ops.stencil_wells import BorderedStencilModel as JB
    from jutul.jl_tpu_torch.ops.stencil_wells import BorderedStencilModel

    jm, _, jp, js0, jf = cases["jutul.jl_tpu"]
    tm, _, tp, ts0, tf = cases["jutul.jl_tpu_torch"]
    st = _perturbed(js0)
    to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    jeng = JB(jcompile(jm))
    rj, Bj = jax.jit(lambda s, s0: jeng.assemble(s, s0, DT, jf)[:2])(
        jmerge(to_j(st), to_j(jp)), jmerge(to_j(js0), to_j(jp)))
    eng = BorderedStencilModel(tpkg.compile_model(tm), "cpu")
    rt, Bt, _ = eng.assemble(
        tmerge(tpkg.from_numpy(st, "cpu"), tpkg.from_numpy(tp, "cpu")),
        tmerge(tpkg.from_numpy(ts0, "cpu"), tpkg.from_numpy(tp, "cpu")), DT, tf)
    return (rj, Bj), (rt, Bt), eng


def test_well_graph_model_parameters(cases):
    jm, jw, jp, js0, _ = cases["jutul.jl_tpu"]
    tm, tw, tp, ts0, _ = cases["jutul.jl_tpu_torch"]
    assert tm.number_of_cells() == jm.number_of_cells() == 6 * 5 * 4 + 2
    assert tw.well_cells == jw.well_cells
    np.testing.assert_array_equal(tw._perf, np.asarray(jw._perf))
    assert set(tp) == set(jp)
    for k in jp:
        assert_close(tp[k], jp[k], what=k)
    sl = tw.well_face_slice
    np.testing.assert_array_equal(tp["Transmissibilities"][sl],
                                  [2e-12, 3e-12, 4e-12])
    np.testing.assert_array_equal(tp["GravityPotentialDifference"][sl], 0.0)
    for k in js0:
        np.testing.assert_array_equal(ts0[k], np.asarray(js0[k]))


def test_pressure_bc_apply_and_diagonal_jacobian(cases):
    """PressureBoundaryCondition on reservoir cells with mixed in- and
    outflow (the inflow branch takes kr(s_in)/mu)."""
    from jutul.jl_tpu.models.darcy import PressureBoundaryCondition as JBC

    jm, _, jp, js0, _ = cases["jutul.jl_tpu"]
    tm, _, tp, _, _ = cases["jutul.jl_tpu_torch"]
    st = _perturbed(js0, seed=5)
    cells = [0, 3, 17, 42, 119]
    pb = 150e5 * np.array([0.99, 1.01, 0.995, 1.02, 1.0])
    T = np.array([1e-12, 2e-12, 3e-12, 4e-12, 5e-12])
    s_in = [[0.3, 0.7]] * 5
    fj = JBC(cells, pb, T, saturations=s_in)
    ft = tpkg.PressureBoundaryCondition(cells, pb, T, saturations=s_in)
    jc, tc = jcompile(jm), tpkg.compile_model(tm)
    to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    sj = jc.evaluate_secondaries(jmerge(to_j(st), to_j(jp)))
    stt = tc.evaluate_secondaries(tmerge(tpkg.from_numpy(st, "cpu"),
                                         tpkg.from_numpy(tp, "cpu")))
    eq_j = jm.equations["mass_conservation"]
    eq_t = tm.equations["mass_conservation"]
    r0 = np.random.default_rng(1).normal(size=(tc.n_cells, 2))
    rj = fj.apply(jm, eq_j, "mass_conservation", jnp.asarray(r0), sj, DT)
    rt = ft.apply(tm, eq_t, "mass_conservation", torch.as_tensor(r0), stt, DT)
    assert_close(rt.numpy() - r0, np.asarray(rj) - r0, what="apply")
    cj, jac_j = fj.diagonal_jacobian(jm, eq_j, "mass_conservation", jc, sj, DT)
    ct, jac_t = ft.diagonal_jacobian(tm, eq_t, "mass_conservation", tc, stt,
                                     DT)
    np.testing.assert_array_equal(ct, np.asarray(cj))
    assert_close(jac_t.numpy(), jac_j, what="diagonal_jacobian")
    # the shifted datum moves the boundary pressure only
    assert np.allclose(ft.shift_pressure_datum(1e5).pressure, pb - 1e5)


def test_lattice_assembly_with_pressure_bc_matches_jax():
    """A lattice-only model with a PressureBoundaryCondition on boundary
    cells: the residual AND the diagonal, which must carry the BC's dq/du
    (StencilCompiledModel._apply_force_diag), match JAX
    StencilCompiledModel.assemble."""
    import jutul.jl_tpu as jpkg
    from jutul.jl_tpu.models.darcy import PressureBoundaryCondition as JBC
    from jutul.jl_tpu.models.darcy import setup_darcy_model as jdarcy
    from jutul.jl_tpu.ops.stencil import StencilCompiledModel as JSC
    from jutul.jl_tpu_torch.ops.stencil import StencilCompiledModel

    dims = (5, 4, 3)
    nc = int(np.prod(dims))
    rng = np.random.default_rng(11)
    perm = rng.lognormal(0.0, 1.0, nc) * 1e-13
    sw = rng.uniform(0.2, 0.8, nc)
    sw[::5] = 1.0  # on the clip bound
    p = 150e5 * (1.0 + 0.01 * rng.normal(size=nc))
    cells = np.arange(0, nc, dims[0])  # the x = 0 boundary column
    pb = 150e5 * (1.0 + 0.02 * rng.normal(size=cells.size))
    T = rng.uniform(1e-12, 5e-12, cells.size)
    out = {}
    for name, pkg, darcy_fn, BC, SC in (
            ("jax", jpkg, jdarcy, JBC, JSC),
            ("torch", tpkg, tpkg.setup_darcy_model,
             tpkg.PressureBoundaryCondition, StencilCompiledModel)):
        fluid = importlib.import_module(
            pkg.__name__ + ".models.darcy").ImmiscibleFluid(
            viscosities=(1e-3, 2e-3))
        model = darcy_fn(pkg.CartesianMesh(dims, (50.0, 40.0, 15.0)), fluid,
                         permeability=perm, porosity=0.25, gravity=True)
        state = pkg.setup_state(model, Pressure=p,
                                Saturations=np.stack([sw, 1 - sw], 1))
        state0 = pkg.setup_state(model, Pressure=150e5,
                                 Saturations=np.stack([sw, 1 - sw], 1))
        params = pkg.setup_parameters(model)
        forces = {"bc": BC(cells, pb, T, saturations=[0.4, 0.6])}
        sc = SC(pkg.compile_model(model))
        if name == "jax":
            to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
            r, A = jax.jit(lambda s, s0: sc.assemble(s, s0, DT, forces)[:2])(
                jmerge(to_j(state), to_j(params)),
                jmerge(to_j(state0), to_j(params)))
        else:
            r, A, _ = sc.assemble(
                tmerge(tpkg.from_numpy(state, "cpu"), tpkg.from_numpy(params, "cpu")),
                tmerge(tpkg.from_numpy(state0, "cpu"), tpkg.from_numpy(params, "cpu")),
                DT, forces)
        out[name] = (np.asarray(r), np.asarray(A.diag))
        if name == "torch":  # the BC's blocks are on the diagonal
            _, A0, _ = sc.assemble(
                tmerge(tpkg.from_numpy(state, "cpu"), tpkg.from_numpy(params, "cpu")),
                tmerge(tpkg.from_numpy(state0, "cpu"), tpkg.from_numpy(params, "cpu")), DT)
            moved = np.flatnonzero(np.any(np.asarray(A.diag - A0.diag) != 0,
                                          axis=(0, 1)))
            np.testing.assert_array_equal(moved, cells)
    assert_close(out["torch"][0], out["jax"][0], what="residual")
    assert_close(out["torch"][1], out["jax"][1], what="diag")


def test_bordered_residual_and_blocks_match_jax(assembled):
    (rj, Bj), (rt, Bt), eng = assembled
    assert rt.shape == (eng.nc + eng.nw, 2)
    assert_close(rt.numpy(), rj, what="residual")
    assert_close(Bt.A.diag.numpy(), Bj.A.diag, what="diag")
    for a in Bj.A.plus:
        assert_close(Bt.A.plus[a].numpy(), Bj.A.plus[a], what=f"plus {a}")
        assert_close(Bt.A.minus[a].numpy(), Bj.A.minus[a], what=f"minus {a}")
    for k in ("J_rb", "J_br", "D_ww"):
        assert_close(getattr(Bt, k).numpy(), getattr(Bj, k), what=k)
    np.testing.assert_array_equal(Bt.perfs.cell.numpy(), Bj.perf_cell)
    np.testing.assert_array_equal(Bt.perfs.well.numpy(), Bj.perf_well)


def test_bordered_matvec_matches_jax(assembled):
    (_, Bj), (_, Bt), eng = assembled
    x = np.random.default_rng(4).normal(size=(eng.nc + eng.nw, 2))
    assert_close(Bt.matvec(torch.as_tensor(x)).numpy(),
                 Bj.matvec(jnp.asarray(x)), what="matvec")


@pytest.mark.parametrize("form", ["gather", "onehot"])
def test_schur_eliminate_matches_jax(assembled, form):
    """s_matvec, r_schur and back_substitute against each of the JAX
    package's Schur forms (the port implements the gather form)."""
    from jutul.jl_tpu.ops.stencil_wells import schur_eliminate as jschur
    from jutul.jl_tpu_torch.ops.stencil_wells import schur_eliminate

    (rj, Bj), (rt, Bt), eng = assembled
    sj, rsj, bj = jschur(Bj, rj, correction_form=form)
    st, rst, bt = schur_eliminate(Bt, rt)
    x = np.random.default_rng(6).normal(size=(eng.nc, 2))
    assert_close(st(torch.as_tensor(x)).numpy(), sj(jnp.asarray(x)),
                 what="s_matvec")
    assert_close(rst.numpy(), rsj, what="r_schur")
    assert_close(bt(torch.as_tensor(x)).numpy(), bj(jnp.asarray(x)),
                 what="back_substitute")


def test_schur_sums_over_shared_perforated_cells(assembled):
    """Two perforations in one reservoir cell: both blocks land on it
    (the scatter folds them before its index_add) — against JAX's
    gather form on the same modified matrix."""
    from jutul.jl_tpu.ops.stencil_wells import BorderedStencilMatrix as JBM
    from jutul.jl_tpu.ops.stencil_wells import schur_eliminate as jschur
    from jutul.jl_tpu_torch.ops.stencil_wells import (
        BorderedStencilMatrix,
        Perforations,
        schur_eliminate,
    )

    (rj, Bj), (rt, Bt), eng = assembled
    pc = np.asarray(Bj.perf_cell).copy()
    pc[1] = pc[2]  # the injector's 2nd completion joins the producer's cell
    pw = np.asarray(Bj.perf_well)
    rows, idx = np.unique(pc, return_inverse=True)
    P = Perforations(
        cell=torch.as_tensor(pc), well=torch.as_tensor(pw),
        well_cell=torch.as_tensor(pw + eng.nc), rows=torch.as_tensor(rows),
        row_of=torch.as_tensor((np.arange(rows.size)[:, None]
                                == idx[None]).astype(float)),
        well_of=torch.as_tensor((np.arange(eng.nw)[:, None]
                                 == pw[None]).astype(float)))
    B2 = BorderedStencilMatrix(Bt.A, P, Bt.J_rb, Bt.J_br, Bt.D_ww)
    Bj2 = JBM(Bj.A, pc, pw, Bj.J_rb, Bj.J_br, Bj.D_ww)
    sj, rsj, _ = jschur(Bj2, rj, correction_form="gather")
    st, rst, _ = schur_eliminate(B2, rt)
    x = np.random.default_rng(7).normal(size=(eng.nc, 2))
    assert_close(st(torch.as_tensor(x)).numpy(), sj(jnp.asarray(x)),
                 what="s_matvec")
    assert_close(rst.numpy(), rsj, what="r_schur")
    xf = np.random.default_rng(8).normal(size=(eng.nc + eng.nw, 2))
    assert_close(B2.matvec(torch.as_tensor(xf)).numpy(),
                 Bj2.matvec(jnp.asarray(xf)), what="matvec")


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_bordered_solve_matches_jax(assembled, smoother):
    """One CPR(GMG)-BiCGStab solve of the bordered system (Schur
    elimination + back substitution) — same iteration count, same du."""
    (rj, Bj), (rt, Bt), _ = assembled
    sols = []
    for pkg, B, r in (("jutul.jl_tpu", Bj, rj),
                      ("jutul.jl_tpu_torch", Bt, rt)):
        stm = importlib.import_module(pkg + ".ops.stencil")
        solver = stm.StencilKrylovSolver(
            preconditioner=stm.StencilCPR(gmg=stm.GMG(
                n_smooth=2, n_coarse_sweeps=12, min_cells=16,
                smoother=smoother)),
            rtol=1e-8, max_iterations=100)
        du, stats = solver.solve(B, r)
        sols.append((np.asarray(du), int(stats["iterations"])))
    assert sols[1][1] == sols[0][1]
    assert_close(sols[1][0], sols[0][0], rtol=1e-10, what="du")


def test_simulator_dispatches_wells_to_bordered_engine(cases):
    from jutul.jl_tpu_torch.ops.stencil import StencilCompiledModel
    from jutul.jl_tpu_torch.ops.stencil_wells import BorderedStencilModel

    tm, _, tp, ts0, _ = cases["jutul.jl_tpu_torch"]
    sim = tpkg.Simulator(tm, ts0, tp, use_stencil=True, device="cpu")
    assert isinstance(sim._stencil, BorderedStencilModel)
    assert isinstance(sim._stencil.lattice, StencilCompiledModel)
    assert sim._stencil.lattice.L == (4, 5, 6)
