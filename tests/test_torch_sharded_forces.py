"""The port's slab engine against the JAX package's on the forces and
machinery of tests/test_sharded.py (CPU, f64, 4 shards): source terms with
state-dependent pressure BCs in the first and last slab (shard-varying BC
rows), a report step cut twice by the Newton cap, duplicate completion
cells, one Newton iteration with its criteria, and the slab adjoint
(gradients within 1e-9 of the JAX package's distributed adjoint, λ at
rtol 1e-14, on the JAX package's single-device states).
"""

import importlib

import numpy as np

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from chip_smoke import pressure_objective, slab_case
from test_torch_general_dd import assert_states
from test_torch_sharded import DAY, _dmesh, slab_pair

BAR = 1e5


def _darcy(pkg):
    return importlib.import_module(pkg.__name__ + ".models.darcy")


def test_sources_and_pressure_bcs_match_jax():
    def forces_of(pkg, dsim):
        dm = _darcy(pkg)
        nc = dsim.global_model.number_of_cells()
        T_bc = float(np.median(pkg.setup_parameters(
            dsim.global_model)["Transmissibilities"]))
        q = np.zeros((1, 2))
        q[0, 0] = 0.5
        return {"src": dm.PhaseSourceTerm([0], q),
                "prod": dm.PressureBoundaryCondition([1, nc - 1], 100 * BAR,
                                                     5 * T_bc),
                "inj": dm.PressureBoundaryCondition(
                    [2], 120 * BAR, 5 * T_bc, saturations=[1.0, 0.0])}

    slab_pair(4, forces_of=forces_of, tol_cnv=1e-9, max_newton=30)


def test_timestep_cutting_matches_jax():
    def forces_of(pkg, dsim):
        q = np.zeros((1, 2))
        q[0, 0] = 0.3  # 13 Newtons at dT, 11 at dT/2, 7 at dT/4
        return {"src": _darcy(pkg).PhaseSourceTerm([0], q)}

    out = slab_pair(4, forces_of=forces_of, dT=0.2 * DAY, max_newton=8,
                    tol_cnv=1e-7, growth_factor=1.0)
    minis = out[tpkg][2]["ministeps"]
    assert any(not m["success"] for m in minis)
    assert sum(m["dt"] for m in minis if m["success"]) == \
        np.float64(0.2 * DAY)


def test_duplicate_completion_cells_accumulate():
    q = np.array([[0.1, 0.0], [0.25, 0.0]])
    stacks = []
    for pkg in (jpkg, tpkg):
        mesh, system, df, _init, _f = slab_case(pkg)
        group = _dmesh(4) if pkg is jpkg else tpkg.ShardGroup.threads(
            4, "cpu")
        dsim = pkg.DistributedSimulator(mesh, system, group, data_fields=df)
        stacks.append(np.asarray(dsim.stack_cell_sources(
            {"w": _darcy(pkg).PhaseSourceTerm([3, 3], q)})))
    assert np.array_equal(stacks[0], stacks[1])
    assert np.isclose(stacks[1].reshape(-1, 2)[:, 0].sum(), 0.35)


def test_newton_step_matches_jax():
    out = {}
    for pkg in (jpkg, tpkg):
        mesh, system, df, init, _f = slab_case(pkg)
        group = _dmesh(4) if pkg is jpkg else tpkg.ShardGroup.threads(
            4, "cpu")
        dsim = pkg.DistributedSimulator(mesh, system, group, data_fields=df)
        s = dsim.shard_state(dsim.initial_state(**init))
        new, crit, _li, _lr = dsim.newton_step_fn(rtol=1e-12)(s, s, 0.1 * DAY)
        out[pkg] = ((dsim.gather_state(new) if pkg is tpkg else
                     {k: np.asarray(v) for k, v in new.items()}), crit)
    assert_states(out[jpkg][0], out[tpkg][0])
    for eq, crits in out[jpkg][1].items():
        for name, v in crits.items():
            np.testing.assert_allclose(out[tpkg][1][eq][name].numpy(),
                                       np.asarray(v), rtol=1e-12, atol=1e-15)


def test_slab_adjoint_matches_jax():
    import jax.numpy as jnp

    dts = [0.05 * DAY, 0.05 * DAY]
    mesh, system, df, init, forces = slab_case(jpkg, smooth=True)
    jd = jpkg.DistributedSimulator(mesh, system, _dmesh(4), data_fields=df)
    st0 = jd.initial_state(**init)
    params = jpkg.setup_parameters(jd.global_model)
    ref, _ = jpkg.Simulator(jd.global_model, state0=st0,
                            parameters=params).simulate(
        dts, forces=forces, info_level=-1, tolerances={"default": 1e-10},
        max_nonlinear_iterations=30)
    states = [{k: np.asarray(v) for k, v in s.items()} for s in ref]

    def Gj(model, state, dt, n, f):
        return dt * jnp.sum((state["Pressure"] / (100 * BAR)) ** 2)

    gj = jpkg.solve_adjoint_sensitivities_distributed(
        jd, states, dts, Gj, st0, forces=forces, parameters=params,
        rtol=1e-14, max_lin_it=2000)
    mesh, system, df, init, forces = slab_case(tpkg, smooth=True)
    td = tpkg.DistributedSimulator(mesh, system,
                                   tpkg.ShardGroup.threads(4, "cpu"),
                                   data_fields=df)
    gt = tpkg.solve_adjoint_sensitivities_distributed(
        td, states, dts, pressure_objective(100 * BAR), st0, forces=forces,
        parameters=tpkg.setup_parameters(td.global_model), rtol=1e-14,
        max_lin_it=2000)
    assert set(gt) == set(gj)
    for k, a in gj.items():
        a = np.asarray(a)
        assert np.max(np.abs(gt[k] - a)) <= 1e-9 * np.max(np.abs(a)), k
