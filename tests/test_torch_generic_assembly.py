"""The port's generic block-ELL engine (``CompiledModel.assemble``) against
the JAX package's ``CompiledModel``, on the CPU at f64.

Same seeded states through both packages; residual and Jacobian blocks
(per dof column) within 1e-12 relative (their max), the ELL sparsity
equal:
- two-phase Darcy at 6x5x4 with gravity, a ``PhaseSourceTerm`` and a
  ``PressureBoundaryCondition`` (state-dependent: its diagonal Jacobian
  blocks), cells on both saturation clip bounds; once more with a
  boundary cell named twice (its diagonal blocks summed in a fixed order)
  and with the boundary cells out of order;
- VariablePoisson in 1D and 2D (face flux + cell term);
- ScalarTestSystem (no faces: one ELL slot);
- the well-graph model at 10x10x6 (reservoir + 5 wellbore cells,
  perforation faces).
And the port's generic engine against its own stencil engine on the Darcy
case: residuals within 1e-12, the dense Jacobian against the stencil
matrix's products with the unit vectors within 1e-12. Repeated assembly is
bitwise equal.
"""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke
import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _darcy(pkg, dims=(6, 5, 4), bc_cells=(3, 10)):
    D = importlib.import_module(pkg.__name__ + ".models.darcy")
    rng = np.random.default_rng(1)
    nc = int(np.prod(dims))
    model = D.setup_darcy_model(
        pkg.CartesianMesh(dims, (60.0, 50.0, 8.0)),
        D.ImmiscibleFluid(viscosities=(1e-3, 2e-3)),
        permeability=rng.lognormal(0, 1, nc) * 1e-13, porosity=0.25,
        gravity=True)
    sw = rng.uniform(0.0, 1.0, nc)
    sw[::7], sw[::11] = 0.0, 1.0  # cells on both clip bounds
    state = pkg.setup_state(model, Pressure=1e7 + 1e5 * rng.normal(size=nc),
                            Saturations=np.stack([sw, 1 - sw], axis=1))
    forces = {"src": D.PhaseSourceTerm([0, nc - 1],
                                       np.array([[1.0, 0.0], [-0.5, -0.5]])),
              "bc": D.PressureBoundaryCondition(list(bc_cells), 1.02e7,
                                                1e-12, saturations=[0.5, 0.5])}
    return model, state, pkg.setup_parameters(model), forces


def _poisson(pkg, dims):
    rng = np.random.default_rng(2)
    dd = pkg.DataDomain(pkg.CartesianMesh(dims, (1.0,) * len(dims)))
    n = int(np.prod(dims))
    dd.set("poisson_coefficient", rng.uniform(0.5, 2.0, n))
    model = pkg.SimulationModel(dd, pkg.VariablePoissonSystem(
        time_dependent=True))
    state = pkg.setup_state(model, U=rng.normal(size=n))
    forces = {"s": [pkg.PoissonSource(0, 1.0), pkg.PoissonSource(n - 1, -1.0)]}
    return model, state, pkg.setup_parameters(model), forces


def _scalar(pkg):
    model = pkg.SimulationModel(pkg.ScalarTestDomain(5),
                                pkg.ScalarTestSystem())
    state = pkg.setup_state(model, XVar=np.arange(5.0))
    return model, state, pkg.setup_parameters(model), \
        {"f": pkg.ScalarTestForce(2.0)}


def _wells(pkg):
    if pkg is tpkg:
        return chip_smoke.build_well_flagship(10, 10, 6)
    import bench

    model, _, state, params, forces = bench.build(10, 10, 6, gravity=True,
                                                   wells=True,
                                                   well_models=True)
    return model, state, params, forces


CASES = {
    "darcy": _darcy,
    "darcy_repeated_bc": lambda pkg: _darcy(pkg, bc_cells=(3, 10, 3)),
    "darcy_unsorted_bc": lambda pkg: _darcy(pkg, bc_cells=(10, 3)),
    "poisson_1d": lambda pkg: _poisson(pkg, (7,)),
    "poisson_2d": lambda pkg: _poisson(pkg, (5, 4)),
    "scalar": _scalar,
    "wells_10x10x6": _wells,
}


def _assemble_both(name):
    from jutul.jl_tpu.models.setup import merge_state as jmerge
    from jutul.jl_tpu_torch.models.setup import merge_state as tmerge

    jm, jst, jpr, jf = CASES[name](jpkg)
    tm, _, _, tf = CASES[name](tpkg)
    rng = np.random.default_rng(9)
    st0 = {k: np.asarray(v) * (1 + 1e-3 * rng.normal(size=np.shape(v)))
           if k == "Pressure" or k in ("U", "XVar") else np.asarray(v)
           for k, v in jst.items()}
    dt = 3600.0
    jc = jpkg.compile_model(jm)
    rj, Jj, _ = jc.assemble(jmerge(jst, jpr), jmerge(st0, jpr), dt, jf)
    tc = tpkg.compile_model(tm)

    def dev(d):
        return tpkg.from_numpy(d, "cpu", torch.float64)

    args = (tmerge(dev(jst), dev(jpr)), tmerge(dev(st0), dev(jpr)), dt, tf)
    rt, Jt, _ = tc.assemble(*args)
    return jc, rj, Jj, tc, rt, Jt, args


@pytest.mark.parametrize("name", list(CASES))
def test_generic_assembly_matches_jax(name):
    jc, rj, Jj, tc, rt, Jt, args = _assemble_both(name)
    assert np.array_equal(tc.ell.cols, np.asarray(jc.ell.cols))
    assert _rel(rt, rj) < 1e-12
    # per dof column: the pressure column's entries are orders of
    # magnitude below the saturation column's
    Jjb = np.asarray(Jj.blocks)
    for j in range(Jjb.shape[-1]):
        assert _rel(Jt.blocks[..., j], Jjb[..., j]) < 1e-12, j
    rt2, Jt2, _ = tc.assemble(*args)
    assert torch.equal(rt2, rt) and torch.equal(Jt2.blocks, Jt.blocks)


def test_generic_against_stencil_engine():
    from jutul.jl_tpu_torch.ops.cuda import StencilMatvec
    from jutul.jl_tpu_torch.ops.stencil import StencilCompiledModel

    _, _, _, tc, rt, Jt, args = _assemble_both("darcy")
    rs, As, _ = StencilCompiledModel(tc).assemble(*args)
    assert _rel(rt, rs) < 1e-12
    n, neq = rt.shape
    mv = StencilMatvec(As)
    eye = torch.eye(n * neq, dtype=torch.float64)
    dense_s = torch.stack([mv(e.reshape(n, neq)).reshape(-1) for e in eye],
                          dim=1)
    assert _rel(Jt.to_dense(), dense_s) < 1e-12


def test_mixed_entity_model_refused():
    """A FACES equation beside the cell equations makes a mixed-entity
    model: ``compile_model`` gives a ``MixedCompiledModel`` (per-entity
    views), and the direct single-entity engine refuses it."""
    from jutul.jl_tpu_torch.core.entities import FACES
    from jutul.jl_tpu_torch.models.equations import JutulEquation
    from jutul.jl_tpu_torch.ops.mixed import MixedCompiledModel

    class FaceEq(JutulEquation):
        def entity(self, model):
            return FACES

    model, _, _, _ = _darcy(tpkg)
    model.equations["face_eq"] = FaceEq()
    with pytest.raises(ValueError, match="no primary variable"):
        tpkg.compile_model(model)  # Faces rows need a Faces primary
    mesh = tpkg.CartesianMesh((3, 2), (1.0, 1.0))
    mixed = tpkg.SimulationModel(
        tpkg.DataDomain(mesh), importlib.import_module(
            "jutul.jl_tpu_torch.models.test_systems").MixedFluxSystem(
                np.asarray(mesh.neighborship())))
    assert isinstance(tpkg.compile_model(mixed), MixedCompiledModel)
    with pytest.raises(NotImplementedError, match="Mixed-entity"):
        tpkg.CompiledModel(mixed)
