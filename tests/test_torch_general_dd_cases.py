"""More cases of the port's general-partition engine against the JAX
package's, on the CPU at f64 over 4 shards (4 fake devices for the JAX
package): tests/test_general_dd.py's unstructured case (one Newton
iteration with its criteria; a partition with an empty shard; per-step
forces; the report-step rules of ``jit_timestep`` through a dt cut), the
1-D WENO transport case (a K-wide read stencil, k-ring ghosts), the flipped
flux orientation, and the general adjoint with a pressure BC and per-step
forces, and the product machinery (selectors, forcing, relaxation). Counts
equal (linear its within 2 per Newton iteration), states within 1e-12
(1e-10 under Eisenstat-Walker forcing), gradients within 1e-9.
"""

from collections import OrderedDict

import numpy as np
import pytest
import torch

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from chip_smoke import unstructured_dd_case
from test_torch_general_dd import assert_counts, assert_states

D = 4


def _dmesh(n):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("d",))


def _group(pkg):
    return _dmesh(D) if pkg is jpkg else tpkg.ShardGroup.threads(D, "cpu")


def _sim(pkg, seed, partition=None, **kw):
    mesh, system, df, init = unstructured_dd_case(pkg, seed=seed)
    dsim = pkg.GeneralDistributedSimulator(
        mesh, system, _group(pkg), partition=partition, data_fields=df,
        **kw)
    return dsim, dsim.initial_state(**init)


def _darcy(pkg):
    import importlib

    return importlib.import_module(pkg.__name__ + ".models.darcy")


def test_newton_step_and_criteria_match_jax():
    out = {}
    for pkg in (jpkg, tpkg):
        dsim, st0 = _sim(pkg, 0)
        s = dsim.shard_state(st0)
        step = dsim.newton_step_fn(rtol=1e-12, max_lin_it=500)
        new, crit, _li, _lr = step(s, s, 0.1 * 86400.0)
        out[pkg] = (dsim.gather_state(new), crit)
    (js, jc), (ts, tc) = out[jpkg], out[tpkg]
    assert_states(js, ts)
    for eq, crits in jc.items():
        for name, v in crits.items():
            # atol: MB is a ratio of global sums of signed terms, near
            # zero here, whose summation orders differ (the JAX test's own
            # floor, tests/test_general_dd.py)
            np.testing.assert_allclose(tc[eq][name].numpy(), np.asarray(v),
                                       rtol=1e-12, atol=1e-15)


def test_empty_shard_and_per_step_forces_match_jax():
    nc = 6 * 5 * 4
    part = jpkg.GreedyGraphPartitioner().partition(
        np.asarray(unstructured_dd_case(jpkg)[0].neighborship()), nc, 3)
    part = np.where(part == 2, 3, part)  # shard 2 empty, shard 3 doubled
    out = {}
    for pkg in (jpkg, tpkg):
        P = _darcy(pkg).PhaseSourceTerm
        f1 = {"src": P([0], np.array([[0.05, 0.0]]))}
        f2 = {"src": P([nc - 1], np.array([[-0.01, -0.02]]))}
        dsim, st0 = _sim(pkg, 11, partition=part)
        a = dsim.simulate(st0, [0.05 * 86400.0, 0.05 * 86400.0],
                          forces=[f1, f2], tol_cnv=1e-11, max_newton=40,
                          info_level=-1)
        out[pkg] = a
    assert_counts(out[jpkg][1], out[tpkg][1])
    for a, b in zip(out[jpkg][0], out[tpkg][0]):
        assert_states(a, b)


def test_jit_timestep_rules_match_jax():
    """``jit_timestep=True``: the JAX package's in-program report step
    (ministep loop and dt cuts in one program) against the port's eager
    loop with the same rules, through a step that needs a cut."""
    out = {}
    for pkg in (jpkg, tpkg):
        q = np.zeros((1, 2))
        q[0, 0] = 2.0
        forces = {"src": _darcy(pkg).PhaseSourceTerm([0], q)}
        dsim, st0 = _sim(pkg, 5)
        out[pkg] = dsim.simulate(st0, [2.0 * 86400.0, 86400.0],
                                 forces=forces, max_newton=6, tol_cnv=1e-4,
                                 info_level=-1, jit_timestep=True)
    minis = out[tpkg][1][0]["ministeps"]
    assert any(not m["success"] for m in minis)
    assert sum(m["dt"] for m in minis if m["success"]) == pytest.approx(
        2.0 * 86400.0)
    assert_counts(out[jpkg][1], out[tpkg][1])
    for a, b in zip(out[jpkg][0], out[tpkg][0]):
        assert_states(a, b)


def test_weno_wide_stencil_matches_jax():
    n = 30
    out = {}
    for pkg in (jpkg, tpkg):
        import importlib

        tr = importlib.import_module(pkg.__name__ + ".models.transport")
        mesh = pkg.CartesianMesh((n,), (1.0,))
        system = tr.TransportSystem("weno")
        model = pkg.SimulationModel(pkg.DataDomain(mesh), system)
        params = pkg.setup_parameters(model)
        params["FaceVelocity"] = tr.uniform_face_velocity(
            mesh.tpfv_geometry(), [1.0])
        dsim = pkg.GeneralDistributedSimulator(mesh, system, _group(pkg),
                                               parameters=params)
        assert dsim.dec.K > 2
        C0 = np.where(np.arange(n) < n // 3, 1.0, 0.0)
        out[pkg] = dsim.simulate({"C": C0}, [0.4 / n] * 4, tol_cnv=1e-12,
                                 max_newton=30, info_level=-1)
    assert_counts(out[jpkg][1], out[tpkg][1])
    for a, b in zip(out[jpkg][0], out[tpkg][0]):
        assert_states(a, b)


def _flipped_system(pkg, st):
    """SimpleHeatSystem with its flux stencil ``st`` flipped on some faces
    (T[0] is the stencil's left): the port's functions take face batches,
    the JAX package's one face (it vmaps)."""
    import importlib

    eqm = importlib.import_module(pkg.__name__ + ".models.equations")
    if pkg is tpkg:
        def mass(model_, cs):
            return cs["T"][..., None]

        def flux(model_, cs, fs):
            T = cs["T"]
            return (-fs["HeatTrans"] * (T[..., 1] - T[..., 0]))[..., None]
    else:
        import jax.numpy as jnp

        def mass(model_, cs):
            return jnp.reshape(cs["T"], (1,))

        def flux(model_, cs, fs):
            T = cs["T"]
            return jnp.reshape(-fs["HeatTrans"] * (T[1] - T[0]), (1,))

    class Flipped(pkg.SimpleHeatSystem):
        def select_equations(self, model):
            return OrderedDict(heat=eqm.ConservationLaw(
                flux_fn=flux, mass_fn=mass, neq=1, stencil=st))

    return Flipped()


def test_flipped_flux_orientation_matches_jax():
    cart = jpkg.CartesianMesh((6, 5, 4), (60.0, 50.0, 20.0))
    nb = np.asarray(jpkg.UnstructuredMesh.from_cartesian(cart)
                    .neighborship())
    nc = 120
    flip = np.arange(len(nb)) % 3 == 0
    st = nb.copy()
    st[flip] = st[flip][:, ::-1]
    T0 = np.random.default_rng(3).normal(size=nc)
    part = jpkg.GreedyGraphPartitioner().partition(nb, nc, D)
    out = {}
    for pkg in (jpkg, tpkg):
        mesh = pkg.UnstructuredMesh.from_cartesian(
            pkg.CartesianMesh((6, 5, 4), (60.0, 50.0, 20.0)))
        dsim = pkg.GeneralDistributedSimulator(
            mesh, _flipped_system(pkg, st), _group(pkg), partition=part)
        assert any(k.startswith("__flux_orient_") for k in dsim.face_params)
        s = dsim.shard_state(dsim.initial_state(T=T0))
        new, *_ = dsim.newton_step_fn(rtol=1e-12, max_lin_it=500)(s, s, 0.05)
        out[pkg] = dsim.gather_state(new)["T"]
    np.testing.assert_allclose(out[tpkg], out[jpkg], rtol=1e-12, atol=1e-14)
    # the same physics in mesh order, single device
    mesh = tpkg.UnstructuredMesh.from_cartesian(
        tpkg.CartesianMesh((6, 5, 4), (60.0, 50.0, 20.0)))
    sim = tpkg.Simulator(tpkg.SimulationModel(tpkg.DataDomain(mesh),
                                              tpkg.SimpleHeatSystem()),
                         {"T": T0}, device="cpu")
    ref = sim.simulate([0.05], info_level=-1, max_nonlinear_iterations=1,
                       tolerances={"default": 1e30})
    np.testing.assert_allclose(out[tpkg], ref.states[0]["T"], rtol=1e-8)


def test_adjoint_with_pressure_bc_and_per_step_forces_matches_jax():
    import jax.numpy as jnp

    nc = 120
    BAR = 1e5
    grads = {}
    states = None
    for pkg in (jpkg, tpkg):
        dm = _darcy(pkg)
        dsim, st0 = _sim(pkg, 7)
        T_bc = float(np.median(pkg.setup_parameters(
            dsim.global_model)["Transmissibilities"]))
        forces = [{"src": dm.PhaseSourceTerm([0], np.array([[0.05, 0.0]])),
                   "bhp": dm.PressureBoundaryCondition(
                       [nc - 1], 140.0 * BAR, 5 * T_bc)},
                  {"src": dm.PhaseSourceTerm([3], np.array([[0.02, 0.0]])),
                   "bhp": dm.PressureBoundaryCondition(
                       [nc - 1, nc - 2], 145.0 * BAR, 5 * T_bc)}]
        dts = [0.05 * 86400.0, 0.05 * 86400.0]
        if states is None:  # the JAX package's single-device states
            sim = jpkg.Simulator(dsim.global_model, state0=st0)
            ref, _ = sim.simulate(dts, forces=forces, info_level=-1,
                                  tolerances={"default": 1e-11},
                                  max_nonlinear_iterations=40)
            states = [{k: np.asarray(v) for k, v in s.items()} for s in ref]
        xp = jnp if pkg is jpkg else torch

        def G(model, state, dt, n, f, _xp=xp):
            return dt * _xp.sum((state["Pressure"] / (150 * BAR)) ** 2)

        grads[pkg] = pkg.solve_adjoint_sensitivities_general(
            dsim, states, dts, G, st0, forces=forces, rtol=1e-14,
            max_lin_it=2000)
    for k, a in grads[jpkg].items():
        a = np.asarray(a)
        assert np.max(np.abs(grads[tpkg][k] - a)) <= 1e-9 * np.max(
            np.abs(a)), k


def test_product_machinery_matches_jax():
    """Per-criterion tolerances, timestep selectors, Eisenstat-Walker
    forcing and relaxation in the distributed outer loop
    (tests/test_general_dd.py's product-machinery case)."""
    out = {}
    for pkg in (jpkg, tpkg):
        dsim, st0 = _sim(pkg, 21)
        forces = {"src": _darcy(pkg).PhaseSourceTerm(
            [0], np.array([[0.05, 0.0]]))}
        out[pkg] = dsim.simulate(
            st0, [0.2 * 86400.0, 0.4 * 86400.0], forces=forces,
            max_newton=30, info_level=-1, tolerances={"default": 1e-10},
            linear_forcing="ew", rtol=1e-10,
            relaxation=pkg.SimpleRelaxation(),
            timestep_selectors=[
                pkg.TimestepSelector(initial_fraction=0.5),
                pkg.IterationTimestepSelector(target_iterations=8)])
    assert len(out[tpkg][1][0]["ministeps"]) >= 2
    assert_counts(out[jpkg][1], out[tpkg][1])
    # 1e-11: under Eisenstat-Walker forcing each Newton update comes from a
    # loose solve (rtol up to 0.1), which carries the packages' roundoff
    # into the converged state (measured 1.4e-12 here)
    for a, b in zip(out[jpkg][0], out[tpkg][0]):
        assert_states(a, b, tol=1e-11)
