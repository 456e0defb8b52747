"""The port's ``DarcyTransferCrossTerm`` (two half-reservoirs coupled by a
perforation-like connection) against the JAX package's, on the CPU at f64
(counterpart of tests/test_darcy_crossterm.py).

- residual and coupled Jacobian of the halves against the JAX package's
  ``compile_multi_model`` on the same split states (<= 1e-12), and the
  residual against the merged single reservoir's operator (<= 1e-12): a
  connection whose transmissibility equals the interior face's is
  indistinguishable from the uncut mesh;
- the coupled simulation against the JAX package's (identical counts,
  states <= 1e-12) and against the merged simulation (the JAX package's
  own bars);
- mass leaves the high-pressure side (direction and skew symmetry);
- one coupled system solved by the Schur elimination of one half against
  the dense solve (<= 1e-10) and against the JAX package's Schur solve.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import torch

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu.linsolve import schur as jschur
from jutul.jl_tpu.multimodel import core as jmm
from jutul.jl_tpu_torch.linsolve import schur as tschur
from jutul.jl_tpu_torch.multimodel import core as tmm

N = 4
PKGS = (jpkg, tpkg)


def _D(pkg):
    return importlib.import_module(pkg.__name__ + ".models.darcy")


def _units(pkg):
    return pkg.si_units("day", "bar", "darcy")


def _reservoir(pkg, n):
    D = _D(pkg)
    DARCY = _units(pkg)[2]
    return D.setup_darcy_model(pkg.CartesianMesh((n,), (float(n),)),
                               D.ImmiscibleFluid(viscosities=(1e-3, 2e-3)),
                               permeability=1.0 * DARCY, porosity=0.25)


def _build_coupled(pkg, T_conn):
    left, right = _reservoir(pkg, N), _reservoir(pkg, N)
    MM = jmm.MultiModel if pkg is jpkg else tmm.MultiModel
    mm = MM({"L": left, "R": right})
    mm.add_cross_term(_D(pkg).DarcyTransferCrossTerm([T_conn]), target="L",
                      source="R", equation="mass_conservation",
                      target_cells=[N - 1], source_cells=[0])
    prm = {"L": pkg.setup_parameters(left), "R": pkg.setup_parameters(right)}
    return mm, prm


def _states(pkg):
    """(perturbed state, state0, params, forces, T_conn) of the merged
    reservoir (host numpy, the same in both packages)."""
    _, BAR, _ = _units(pkg)
    full = _reservoir(pkg, 2 * N)
    s0 = pkg.setup_state(full, Pressure=100 * BAR, Saturations=[0.3, 0.7])
    params = pkg.setup_parameters(full)
    rng = np.random.default_rng(0)
    st = dict(s0)
    st["Pressure"] = np.asarray(s0["Pressure"]) + rng.uniform(
        0, 1, 2 * N) * BAR
    sat = np.array(s0["Saturations"])
    sat[:, 0] += rng.uniform(-0.05, 0.05, 2 * N)
    sat[:, 1] = 1 - sat[:, 0]
    st["Saturations"] = sat
    return full, st, s0, params, float(params["Transmissibilities"][N - 1])


def _split(base, prm):
    return {nm: {**{k: np.asarray(v)[h * N:(h + 1) * N]
                    for k, v in base.items()
                    if np.ndim(v) >= 1 and np.shape(v)[0] == 2 * N},
                 **prm[nm]}
            for nm, h in (("L", 0), ("R", 1))}


def _forces(pkg):
    q = np.zeros((1, 2))
    q[0, 0] = 0.02
    return {"src": _D(pkg).PhaseSourceTerm([0], q)}


def _assemble(pkg):
    """(coupled residual dict, coupled Jacobian, merged residual) as
    numpy, from the same split states."""
    DAY = _units(pkg)[0]
    dt = 0.2 * DAY
    full, st, s0, params, T_conn = _states(pkg)
    mm, prm = _build_coupled(pkg, T_conn)
    f = _forces(pkg)
    if pkg is jpkg:
        cmf = jpkg.compile_model(full)
        j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
        r_full = np.asarray(cmf.residual(
            cmf.evaluate_secondaries(j({**st, **params})),
            cmf.evaluate_secondaries(j({**s0, **params})), dt, f))
        cm = jmm.compile_multi_model(mm)
        nest = lambda b: {m: j(v) for m, v in _split(b, prm).items()}  # noqa: E731
        r, J, _ = cm.assemble(nest(st), nest(s0), dt, {"L": f, "R": None})
        return ({m: np.asarray(v) for m, v in r.items()},
                np.asarray(J.to_dense()), r_full)
    dev = lambda d: tpkg.from_numpy(d, "cpu", torch.float64)  # noqa: E731
    r_full = tpkg.compile_model(full).residual(
        dev({**st, **params}), dev({**s0, **params}), dt, f).numpy()
    cm = tmm.compile_multi_model(mm)
    r, J, _ = cm.assemble(dev(_split(st, prm)), dev(_split(s0, prm)), dt,
                          {"L": f, "R": None})
    return {m: v.numpy() for m, v in r.items()}, J.to_dense().numpy(), r_full


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - b)) / np.max(np.abs(b))


def test_coupled_residual_and_jacobian_match_jax_and_merged():
    (rj, Jj, fj), (rt, Jt, ft) = (_assemble(p) for p in PKGS)
    for m in ("L", "R"):
        assert _rel(rt[m], rj[m]) <= 1e-12
    assert _rel(Jt, Jj) <= 1e-12
    assert _rel(ft, fj) <= 1e-12
    # the coupled operator IS the merged-mesh operator
    assert _rel(np.concatenate([rt["L"], rt["R"]]), ft) <= 1e-12


def _simulate_coupled(pkg, p_left, p_right, T_conn, dts, forces_l):
    mm, prm = _build_coupled(pkg, T_conn)
    state0 = {"L": pkg.setup_state(mm["L"], Pressure=p_left,
                                   Saturations=[0.3, 0.7]),
              "R": pkg.setup_state(mm["R"], Pressure=p_right,
                                   Saturations=[0.3, 0.7])}
    kw = {} if pkg is jpkg else dict(device="cpu")
    sim = pkg.Simulator(mm, state0=state0, parameters=prm, **kw)
    return sim.simulate(dts, forces={"L": forces_l, "R": None},
                        info_level=-1)


def _counts(res):
    return [(m["iterations"], m["linear_iterations"], m["success"], m["dt"])
            for r in res.reports for m in r["ministeps"]]


def test_coupled_halves_match_jax_and_merged_simulation():
    DAY, BAR, _ = _units(tpkg)
    dts = [0.2 * DAY] * 3
    full, _, s0, params, T_conn = _states(tpkg)
    ref = tpkg.Simulator(full, state0=s0, parameters=params,
                         device="cpu").simulate(dts, forces=_forces(tpkg),
                                                info_level=-1)
    out = {pkg: _simulate_coupled(pkg, 100 * BAR, 100 * BAR, T_conn, dts,
                                  _forces(pkg)) for pkg in PKGS}
    assert _counts(out[tpkg]) == _counts(out[jpkg])
    for sj, st, sr in zip(out[jpkg].states, out[tpkg].states, ref.states):
        for m in ("L", "R"):
            assert _rel(st[m]["Pressure"], sj[m]["Pressure"]) <= 1e-12
            assert np.max(np.abs(st[m]["Saturations"]
                                 - sj[m]["Saturations"])) <= 1e-12
        p = np.concatenate([st["L"]["Pressure"], st["R"]["Pressure"]])
        np.testing.assert_allclose(p, sr["Pressure"], rtol=1e-6)
        s = np.concatenate([st["L"]["Saturations"], st["R"]["Saturations"]])
        np.testing.assert_allclose(s, sr["Saturations"], atol=1e-4)


def test_transfer_direction_and_symmetry():
    DAY, BAR, _ = _units(tpkg)
    mm, prm = _build_coupled(tpkg, 1e-12)
    state0 = {"L": tpkg.setup_state(mm["L"], Pressure=150 * BAR,
                                    Saturations=[0.5, 0.5]),
              "R": tpkg.setup_state(mm["R"], Pressure=100 * BAR,
                                    Saturations=[0.5, 0.5])}
    states, _ = tpkg.Simulator(mm, state0=state0, parameters=prm,
                               device="cpu").simulate([0.1 * DAY] * 2,
                                                      info_level=-1)
    pL, pR = states[-1]["L"]["Pressure"], states[-1]["R"]["Pressure"]
    assert pL.mean() < 150 * BAR
    assert pR.mean() > 100 * BAR
    assert pL.min() > pR.max()
    # skew symmetry: the transfer leaves L exactly as it enters R
    cm = tmm.compile_multi_model(mm)
    st = tpkg.from_numpy({m: {**state0[m], **prm[m]} for m in state0},
                         "cpu", torch.float64)
    full = cm.evaluate_secondaries(st)
    pair = cm._pairs[0]
    lt = cm._local("L", full["L"], pair[1])
    ls = cm._local("R", full["R"], pair[2])
    vals = cm._value(pair[0], lt, ls, 1.0, cm._conn(pair[0].cross_term,
                                                    pair[5], lt["Pressure"]))
    r = cm.residual(st, st, 1.0)
    r0 = {m: cm.comps[m].residual(st[m], st[m], 1.0) for m in st}
    assert torch.all(vals > 0)  # out of the high-pressure target
    assert torch.equal(r["L"][N - 1] - r0["L"][N - 1], vals[0])
    assert torch.equal(r["R"][0] - r0["R"][0], -vals[0])


def test_schur_solve_matches_dense_on_a_coupled_system():
    """The coupled Darcy halves' system: the Schur solve eliminating R
    (GMRES at rtol 1e-13 on the reduced operator) within 1e-10 of the
    dense solve and of the JAX package's Schur solve."""
    DAY = _units(tpkg)[0]
    dt = 0.2 * DAY
    full, st, s0, params, T_conn = _states(tpkg)
    sol = {}
    for pkg in PKGS:
        mm, prm = _build_coupled(pkg, T_conn)
        f = {"L": _forces(pkg), "R": None}
        S = jschur if pkg is jpkg else tschur
        solver = S.SchurComplementSolver(
            inner=pkg.GenericKrylov("gmres", rtol=1e-13, max_iterations=100),
            elim_models=["R"])
        if pkg is jpkg:
            cm = jmm.compile_multi_model(mm)
            j = lambda b: {m: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
                           for m, d in _split(b, prm).items()}
            r, J, _ = cm.assemble(j(st), j(s0), dt, f)
            du, _ = solver.solve(J, r)
            sol[pkg] = {m: np.asarray(v) for m, v in du.items()}
            continue
        cm = tmm.compile_multi_model(mm)
        dev = lambda b: tpkg.from_numpy(_split(b, prm), "cpu",  # noqa: E731
                                        torch.float64)
        r, J, _ = cm.assemble(dev(st), dev(s0), dt, f)
        du, stats = solver.solve(J, r)
        du_d, _ = tpkg.DirectSolver().solve(J, r)
        assert stats["converged"]
        sol[pkg] = {m: v.numpy() for m, v in du.items()}
        sol["direct"] = {m: v.numpy() for m, v in du_d.items()}
    for m in ("L", "R"):
        assert _rel(sol[tpkg][m], sol["direct"][m]) <= 1e-10
        assert _rel(sol[tpkg][m], sol[jpkg][m]) <= 1e-10
