"""``GeneralDistributedSimulator`` and ``solve_adjoint_sensitivities_general``
of the port over ``ShardGroup.threads`` on the CPU at f64, against the JAX
package's general-partition engine over 4 fake devices and against the
port's single-device engine.

The dryrun case of ``dryrun_multichip`` (6x5x4 ``UnstructuredMesh``, gravity,
2 well models, forced well groups, a rate injector and a BHP producer; 4
shards): both halo modes (all_to_all, ppermute rounds), block-Jacobi and the
distributed CPR with Jacobi and with Chebyshev smoothing. Newton and
ministep counts equal the JAX package's; linear iteration counts within 2
per Newton iteration (BiCGStab's stopping test near the tolerance sees the
two packages' summation orders); states within 1e-12 relative; the distributed
gradients within 1e-9 of the JAX package's (λ at rtol 1e-14).
"""

import numpy as np
import pytest
import torch

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from chip_smoke import dryrun_case, pressure_objective

D = 4


def _dmesh(n):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("d",))


def _counts(reports):
    return [(m["iterations"], m["linear_iterations"], m["success"])
            for r in reports for m in r["ministeps"]]


def assert_counts(jr, tr):
    """Ministeps, Newton counts and outcomes equal; linear its within 2
    per Newton iteration (each BiCGStab stopping test near its tolerance
    sees the packages' summation orders)."""
    jc, tc = _counts(jr), _counts(tr)
    assert len(jc) == len(tc), (jc, tc)
    for (jn, jl, js), (tn, tl, ts) in zip(jc, tc):
        assert (jn, js) == (tn, ts), (jc, tc)
        assert abs(jl - tl) <= 2 * max(jn, 1), (jc, tc)


def assert_states(js, ts, tol=1e-12):
    for k, v in ts.items():
        if k == "substates":
            continue
        a = np.asarray(js[k])
        assert np.max(np.abs(v - a)) <= tol * max(1.0, np.max(np.abs(a))), k


def _dryrun_pair(halo_mode, prec, smoother, jax_too=True):
    out = {}
    for pkg in ((jpkg, tpkg) if jax_too else (tpkg,)):
        c = dryrun_case(pkg, D)
        group = (_dmesh(D) if pkg is jpkg
                 else tpkg.ShardGroup.threads(D, "cpu"))
        dsim = pkg.GeneralDistributedSimulator(
            c["wmesh"], c["model"].system, group, partition=c["part"],
            parameters=c["params"], data_fields=c["data_fields"],
            halo_mode=halo_mode)
        states, reports = dsim.simulate(
            c["state0"], c["dts"], forces=c["forces"], tolerances=c["tols"],
            max_newton=40, preconditioner=prec, cpr_smoother=smoother,
            info_level=-1)
        out[pkg] = (c, dsim, states, reports)
    return out


@pytest.mark.parametrize("halo_mode,prec,smoother", [
    ("all_to_all", "block_jacobi", "jacobi"),
    ("ppermute", "block_jacobi", "jacobi"),
    ("all_to_all", "cpr", "jacobi"),
    ("ppermute", "cpr", "chebyshev"),
])
def test_dryrun_matches_jax(halo_mode, prec, smoother):
    out = _dryrun_pair(halo_mode, prec, smoother)
    _c, _d, js, jr = out[jpkg]
    _c, tsim, ts, tr = out[tpkg]
    assert tsim.halo_mode == halo_mode
    assert_counts(jr, tr)
    for a, b in zip(js, ts):
        assert_states(a, b)


def test_dryrun_matches_single_device_and_adjoint():
    """The distributed CPR (Chebyshev, ppermute) against the port's
    single-device Simulator; then the general adjoint on the JAX package's
    single-device states against the JAX package's general adjoint and
    against the port's single-device adjoint."""
    out = _dryrun_pair("ppermute", "cpr", "chebyshev", jax_too=False)
    c, tsim, ts, _tr = out[tpkg]
    sim = tpkg.Simulator(c["model"], c["state0"], c["params"], device="cpu")
    ref = sim.simulate(c["dts"], forces=c["forces"], info_level=-1,
                       tolerances=c["tols"], max_nonlinear_iterations=40)
    for a, b in zip(ref.states, ts):
        assert_states(a, b, tol=1e-8)

    cj = dryrun_case(jpkg, D)
    jsim = jpkg.GeneralDistributedSimulator(
        cj["wmesh"], cj["model"].system, _dmesh(D), partition=cj["part"],
        parameters=cj["params"], data_fields=cj["data_fields"],
        halo_mode="ppermute")
    states = [{k: np.asarray(v) for k, v in s.items()} for s in ref.states]
    import jax.numpy as jnp

    def Gj(model, state, dt, n, forces):
        return dt * jnp.sum((state["Pressure"] / cj["p_ref"]) ** 2)

    gj = jpkg.solve_adjoint_sensitivities_general(
        jsim, states, cj["dts"], Gj, cj["state0"], forces=cj["forces"],
        parameters=cj["params"], rtol=1e-14, max_lin_it=2000)
    G = pressure_objective(c["p_ref"])
    gt = tpkg.solve_adjoint_sensitivities_general(
        tsim, states, c["dts"], G, c["state0"], forces=c["forces"],
        parameters=c["params"], rtol=1e-14, max_lin_it=2000)
    g1 = tpkg.solve_adjoint_sensitivities(
        c["model"], states, c["dts"], G, parameters=c["params"],
        state0=c["state0"], forces=c["forces"], device="cpu")
    assert set(gt) == set(gj) == set(g1)
    for k in gj:
        a = np.asarray(gj[k])
        scale = np.max(np.abs(a))
        assert np.max(np.abs(gt[k] - a)) <= 1e-9 * scale, k
        assert np.max(np.abs(gt[k] - g1[k])) <= 1e-9 * scale, k


def test_cpr_state_refuses_fluxless_system():
    from jutul.jl_tpu_torch.models.test_systems import ScalarTestSystem

    model = tpkg.SimulationModel(tpkg.ScalarTestDomain(4),
                                 ScalarTestSystem())
    mesh = tpkg.CartesianMesh((4,), (1.0,))
    dsim = tpkg.GeneralDistributedSimulator(
        mesh, None, tpkg.ShardGroup.threads(2, "cpu"),
        partition=np.array([0, 0, 1, 1]), model=model)
    with pytest.raises(NotImplementedError, match="face-flux"):
        dsim.ministep_fn(preconditioner="cpr")
    with pytest.raises(ValueError, match="unknown preconditioner"):
        dsim.ministep_fn(preconditioner="amg")


def test_threads_on_card_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpkg.ShardGroup.threads(2)
