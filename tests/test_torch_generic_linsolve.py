"""The port's generic linear solvers against the JAX package, on the CPU at
f64.

Same seeded inputs through both packages:
- ``gmres`` in both orthogonalizations across restart boundaries (GMRES(5)
  on a two-phase Darcy system): equal iteration and cycle counts, x within
  1e-12 relative;
- each preconditioner's ``apply`` after ``update`` (Trivial, Jacobi,
  BlockJacobi, SPAI0, ILU0, aggregation AMG with both smoothers,
  smoothed-aggregation AMG with both, CPR) within 1e-12 relative;
- AMG aggregates equal to the JAX package's ``greedy_aggregate``, with its
  native C++ copy and with its numpy loop, and the Galerkin coarse values
  within 1e-13 relative;
- ``GenericKrylov`` on tests/test_linsolve.py ``test_krylov_matches_direct``'s
  system, parametrised the same way (GMRES and BiCGStab times five
  preconditioners): equal iteration counts, du within 1e-10 relative;
  and the CPR-GMRES solve of the Darcy system likewise.
"""

import numpy as np
import pytest
import torch

import jutul.jl_tpu.linsolve.amg as jamg
import jutul.jl_tpu.linsolve.cpr as jcpr
import jutul.jl_tpu.linsolve.krylov as jkr
import jutul.jl_tpu.linsolve.precond as jpc
import jutul.jl_tpu_torch.linsolve.amg as tamg
import jutul.jl_tpu_torch.linsolve.cpr as tcpr
import jutul.jl_tpu_torch.linsolve.krylov as tkr
import jutul.jl_tpu_torch.linsolve.precond as tpc
from jutul.jl_tpu.ops.blockell import BlockELL as JBlockELL
from jutul.jl_tpu_torch.ops.blockell import BlockELL as TBlockELL
from jutul.jl_tpu_torch.ops.blockell import ELLStructure as TELL


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _port(Jj):
    """The port's BlockELL over the same sparsity and numbers as the JAX
    BlockELL ``Jj``."""
    cols = np.asarray(Jj.structure.cols)
    n, S = cols.shape
    st = TELL.build(n, np.stack([np.repeat(np.arange(n), S),
                                 cols.reshape(-1)], axis=1))
    assert np.array_equal(st.cols, cols)
    return TBlockELL(st, torch.from_numpy(np.array(Jj.blocks)))


def _darcy(dims=(6, 5, 4), seed=1):
    """(J, r) of the JAX package's two-phase Darcy model with gravity."""
    from jutul.jl_tpu import CartesianMesh, compile_model, setup_parameters
    from jutul.jl_tpu import setup_state
    from jutul.jl_tpu.models.darcy import ImmiscibleFluid, setup_darcy_model
    from jutul.jl_tpu.models.setup import merge_state

    rng = np.random.default_rng(seed)
    nc = int(np.prod(dims))
    model = setup_darcy_model(
        CartesianMesh(dims, (60.0, 50.0, 8.0)),
        ImmiscibleFluid(viscosities=(1e-3, 2e-3)),
        permeability=rng.lognormal(0, 1, nc) * 1e-13, porosity=0.25,
        gravity=True)
    comp = compile_model(model)
    sw = rng.uniform(0.1, 0.9, nc)
    st = merge_state(setup_state(
        model, Pressure=1e7 + 1e5 * rng.normal(size=nc),
        Saturations=np.stack([sw, 1 - sw], axis=1)), setup_parameters(model))
    st0 = dict(st, Pressure=st["Pressure"] * (1 + 1e-3 * rng.normal(
        size=nc)))
    r, J, _ = comp.assemble(st, st0, 3600.0)
    return J, np.array(r)


@pytest.fixture(scope="module")
def darcy():
    J, r = _darcy()
    return J, _port(J), r


def _heat(n=16):
    """tests/test_linsolve.py heat_jacobian: the transient heat system on an
    n-cell line."""
    from jutul.jl_tpu import (CartesianMesh, DataDomain, SimpleHeatSystem,
                              SimulationModel, compile_model,
                              setup_parameters, setup_state)

    model = SimulationModel(DataDomain(CartesianMesh((n,), (1.0,))),
                            SimpleHeatSystem())
    comp = compile_model(model)
    state = comp.evaluate_secondaries(
        {**setup_state(model, T=np.linspace(0.0, 1.0, n)),
         **setup_parameters(model)})
    r = comp.residual(state, state, 1e-3)
    return JBlockELL(comp.ell, comp.jacobian_blocks(state, state, 1e-3)), r


@pytest.mark.parametrize("orth", ["cgs2", "mgs"])
def test_gmres_restarts_match(darcy, orth):
    Jj, Jt, r = darcy
    n = r.shape[0]
    pj, pt = jpc.ILU0Preconditioner(), tpc.ILU0Preconditioner()
    sj, st = pj.update(Jj), pt.update(Jt)
    b = -r.reshape(-1)
    xj, stj = jkr.gmres(
        lambda v: Jj.matvec(v.reshape(n, 2)).reshape(-1), b, restart=5,
        maxiter=60, rtol=1e-10,
        precond=lambda v: pj.apply(sj, Jj, v.reshape(n, 2)).reshape(-1),
        orth=orth)
    xt, stt = tkr.gmres(
        lambda v: Jt.matvec(v.reshape(n, 2)).reshape(-1),
        torch.from_numpy(b), restart=5, maxiter=60, rtol=1e-10,
        precond=lambda v: pt.apply(st, Jt, v.reshape(n, 2)).reshape(-1),
        orth=orth)
    assert int(stj["cycles"]) > 1  # the solve crosses restart boundaries
    assert stt["iterations"] == int(stj["iterations"])
    assert stt["cycles"] == int(stj["cycles"])
    assert stt["converged"] == bool(stj["converged"])
    assert _rel(xt, xj) < 1e-12


def _preconds(pkg_pc, pkg_amg, pkg_cpr):
    return {
        "trivial": pkg_pc.TrivialPreconditioner(),
        "jacobi": pkg_pc.JacobiPreconditioner(),
        "block_jacobi": pkg_pc.BlockJacobiPreconditioner(),
        "spai0": pkg_pc.SPAI0Preconditioner(),
        "ilu0": pkg_pc.ILU0Preconditioner(),
        "cpr": pkg_cpr.CPRPreconditioner(),
        "cpr_cheby": pkg_cpr.CPRPreconditioner(amg=pkg_amg.AMGPreconditioner(
            smoother="chebyshev", min_coarse=16)),
    }


@pytest.mark.parametrize("name", list(_preconds(jpc, jamg, jcpr)))
def test_block_preconditioner_apply(darcy, name):
    Jj, Jt, r = darcy
    pj = _preconds(jpc, jamg, jcpr)[name]
    pt = _preconds(tpc, tamg, tcpr)[name]
    x = np.random.default_rng(7).normal(size=r.shape)
    yj = pj.apply(pj.update(Jj), Jj, x)
    yt = pt.apply(pt.update(Jt), Jt, torch.from_numpy(x))
    assert _rel(yt, yj) < 1e-12


def _pressure_system(darcy):
    """The scalar CPR pressure operator of the Darcy system (both
    packages' CPR ``update``)."""
    Jj, Jt, _ = darcy
    Apj = jcpr.CPRPreconditioner().update(Jj)[1]
    Apt = tcpr.CPRPreconditioner().update(Jt)[1]
    assert _rel(Apt, Apj) < 1e-13
    return (JBlockELL(Jj.structure, np.asarray(Apj)[..., None, None]),
            TBlockELL(Jt.structure, Apt[..., None, None]))


@pytest.mark.parametrize("kind", ["amg_jacobi", "amg_cheby", "sa_jacobi",
                                  "sa_cheby"])
def test_scalar_amg_apply(darcy, kind):
    Aj, At = _pressure_system(darcy)
    smoother = "chebyshev" if kind.endswith("cheby") else "jacobi"
    if kind.startswith("amg"):
        pj = jamg.AMGPreconditioner(smoother=smoother, min_coarse=16)
        pt = tamg.AMGPreconditioner(smoother=smoother, min_coarse=16)
    else:
        pj = jamg.SmoothedAggregationAMG(smoother=smoother, min_coarse=16)
        pt = tamg.SmoothedAggregationAMG(smoother=smoother, min_coarse=16)
    sj, st = pj.update(Aj), pt.update(At)
    for a, b in zip(st[0], sj[0]):  # every level's operator
        assert _rel(a, b) < 1e-13
    x = np.random.default_rng(8).normal(size=(At.blocks.shape[0], 1))
    yj = pj.apply(sj, Aj, x)
    yt = pt.apply(st, At, torch.from_numpy(x))
    assert _rel(yt, yj) < 1e-12


@pytest.mark.parametrize("native", [True, False])
def test_aggregates_and_galerkin_match(darcy, native, monkeypatch):
    import jutul.jl_tpu.native as jnative

    if not native:
        monkeypatch.setattr(jnative, "native_aggregate", lambda c, n: None)
    Aj, At = _pressure_system(darcy)
    hj = jamg.AMGHierarchy(Aj.structure, min_coarse=8)
    ht = tamg.AMGHierarchy(At.structure, min_coarse=8)
    assert ht.n_levels == hj.n_levels > 2
    for lj, lt in zip(hj.levels, ht.levels):
        assert np.array_equal(lt.structure.cols, np.asarray(lj.structure.cols))
        if lj.agg is not None:
            assert np.array_equal(lt.agg, np.asarray(lj.agg))
    cols = np.asarray(At.structure.cols)
    assert np.array_equal(tamg.greedy_aggregate(cols, cols.shape[0]),
                          jamg.greedy_aggregate(cols, cols.shape[0]))
    opj, _ = jamg.amg_coarsen_ops(hj, Aj.blocks[:, :, 0, 0])
    opt, _ = tamg.amg_coarsen_ops(ht, At.blocks[:, :, 0, 0])
    for a, b in zip(opt, opj):
        assert _rel(a, b) < 1e-13
    again, _ = tamg.amg_coarsen_ops(ht, At.blocks[:, :, 0, 0])
    assert all(torch.equal(a, b) for a, b in zip(again, opt))


@pytest.mark.parametrize("method", ["gmres", "bicgstab"])
@pytest.mark.parametrize("precond", ["trivial", "jacobi", "block_jacobi",
                                     "spai0", "ilu0"])
def test_krylov_counts_match(method, precond):
    Jj, r = _heat(16)
    Jt = _port(Jj)
    pj = _preconds(jpc, jamg, jcpr)[precond]
    pt = _preconds(tpc, tamg, tcpr)[precond]
    duj, sj = jkr.GenericKrylov(method, preconditioner=pj, rtol=1e-12,
                                max_iterations=300).solve(Jj, r)
    dut, st = tkr.GenericKrylov(method, preconditioner=pt, rtol=1e-12,
                                max_iterations=300).solve(
        Jt, torch.from_numpy(np.array(r)))
    assert st["iterations"] == int(sj["iterations"])
    assert _rel(dut, duj) < 1e-10
    dense = Jt.to_dense().numpy()
    expected = np.linalg.solve(dense, -np.asarray(r).reshape(-1))
    assert np.allclose(dut.numpy().reshape(-1), expected, atol=1e-7)


@pytest.mark.parametrize("method", ["gmres", "bicgstab"])
def test_cpr_krylov_matches(darcy, method):
    Jj, Jt, r = darcy
    duj, sj = jkr.GenericKrylov(method, jcpr.CPRPreconditioner(), rtol=1e-8,
                                max_iterations=100).solve(Jj, r)
    dut, st = tkr.GenericKrylov(method, tcpr.CPRPreconditioner(), rtol=1e-8,
                                max_iterations=100).solve(
        Jt, torch.from_numpy(r))
    assert st["iterations"] == int(sj["iterations"]) and st["converged"]
    assert _rel(dut, duj) < 1e-10


def test_generic_krylov_refuses_other_matrices():
    with pytest.raises(TypeError, match="StencilKrylovSolver"):
        tkr.GenericKrylov().solve(object(), torch.zeros(3, 1))
    with pytest.raises(TypeError, match="MultiLinearizedSystem"):
        tkr.GenericKrylov().solve(object(), {"a": torch.zeros(3, 1)})
