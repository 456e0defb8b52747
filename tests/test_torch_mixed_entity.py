"""Equations on a non-cell entity and mixed-entity models in the port
against the JAX package, on the CPU at f64 (counterparts of
tests/test_face_entity.py and tests/test_mixed_entity.py).

- ``FaceTestSystem`` (unknowns and equations on Faces): the compiled
  engine's row entity is Faces, a constant field has a zero residual, the
  Jacobian is the dense face-graph operator, and one and two implicit
  steps match a dense numpy solve — each residual and Jacobian within
  1e-12 of the JAX package's on the same seeded state;
- ``MixedFluxSystem`` (a Cells equation and a Faces equation in one
  model): ``compile_model`` gives per-entity views with cross-entity
  coupling blocks both ways, the coupled Jacobian is the hand-built mixed
  operator, residual and Jacobian within 1e-12 of the JAX package's, and
  one step through the ordinary Simulator matches the dense monolithic
  solve.
"""

import jax.numpy as jnp
import numpy as np
import torch

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu.models import test_systems as jts
from jutul.jl_tpu_torch.models import test_systems as tts
from jutul.jl_tpu_torch.ops.mixed import MixedCompiledModel

PKGS = (jpkg, tpkg)


def _ts(pkg):
    return jts if pkg is jpkg else tts


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _assemble(pkg, model, state, state0, dt):
    """(residual as numpy (dict for mixed), dense Jacobian) of ``pkg``'s
    compiled model."""
    comp = pkg.compile_model(model)
    if pkg is jpkg:
        j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
        full = comp.evaluate_secondaries(j(state))
        full0 = comp.evaluate_secondaries(j(state0))
        r, J, _ = comp.assemble(full, full0, dt)
        dense = (np.asarray(J.to_dense()) if hasattr(J, "couplings") else
                 np.asarray(jpkg.ops.blockell.ell_to_dense(
                     J.blocks, jnp.asarray(J.structure.cols))))
    else:
        t = lambda d: tpkg.from_numpy(d, "cpu", torch.float64)  # noqa: E731
        r, J, _ = comp.assemble(t(state), t(state0), dt)
        dense = J.to_dense().numpy()
    if isinstance(r, dict):
        r = {k: np.asarray(v) for k, v in r.items()}
    else:
        r = np.asarray(r)
    return comp, r, dense


# ---------------------------------------------------------------------------
# equations on Faces
# ---------------------------------------------------------------------------
def build_face_model(pkg, nx=4, ny=3, w=0.7):
    mesh = pkg.CartesianMesh((nx, ny), (1.0, 1.0))
    edges = _ts(pkg).face_adjacency_edges(mesh)
    model = pkg.SimulationModel(pkg.DataDomain(mesh),
                                _ts(pkg).FaceTestSystem(edges, weight=w))
    return mesh, model, edges


def face_operator(nf, edges, w, dt):
    """I/dt + w L with L the face-adjacency graph Laplacian."""
    L = np.zeros((nf, nf))
    for f, g in edges:
        L[f, f] += w
        L[f, g] -= w
        L[g, g] += w
        L[g, f] -= w
    return np.eye(nf) / dt + L


def face_dense_reference(nf, edges, w, dt, v0, q):
    """Implicit Euler on (v - v0)/dt + w L v = q."""
    return np.linalg.solve(face_operator(nf, edges, w, dt), v0 / dt + q)


def test_face_entity_assembles_as_jax():
    out = {}
    for pkg in PKGS:
        mesh, model, edges = build_face_model(pkg)
        nf = mesh.number_of_faces()
        rng = np.random.default_rng(4)
        params = pkg.setup_parameters(model,
                                      FaceSource=rng.uniform(-0.5, 0.5, nf))
        st = {**pkg.setup_state(model, FaceVal=rng.uniform(-1, 1, nf)),
              **params}
        st0 = {**pkg.setup_state(model, FaceVal=np.zeros(nf)), **params}
        out[pkg] = _assemble(pkg, model, st, st0, 0.5)
        const = {**pkg.setup_state(model, FaceVal=np.full(nf, 0.37)),
                 **pkg.setup_parameters(model)}
        _, r0, _ = _assemble(pkg, model, const, const, 1.0)
        np.testing.assert_allclose(r0, 0.0, atol=1e-14)
    comp, rt, Jt = out[tpkg]
    assert comp.row_entity.name() == "Faces"
    assert comp.n_cells == nf  # the row-entity count
    assert _rel(rt, out[jpkg][1]) <= 1e-12
    assert _rel(Jt, out[jpkg][2]) <= 1e-12
    np.testing.assert_allclose(Jt, face_operator(nf, edges, 0.7, 0.5),
                               atol=1e-12)


def test_face_entity_solves_vs_dense():
    """One and two implicit-Euler steps through the Simulator (the
    default direct solve; linear: one Newton per step) against the dense
    solve and the JAX package's run."""
    mesh, model, edges = build_face_model(tpkg)
    nf = mesh.number_of_faces()
    rng = np.random.default_rng(4)
    v0 = rng.uniform(-1.0, 1.0, nf)
    q = rng.uniform(-0.5, 0.5, nf)
    dt, w = 0.3, 0.7
    out = {}
    for pkg in PKGS:
        _, m, _ = build_face_model(pkg)
        kw = {} if pkg is jpkg else dict(device="cpu")
        out[pkg] = pkg.Simulator(
            m, state0=pkg.setup_state(m, FaceVal=v0),
            parameters=pkg.setup_parameters(m, FaceSource=q), **kw).simulate(
            [dt, dt], info_level=-1, tolerances={"default": 1e-12})
    res = out[tpkg]
    assert all(r["success"] for r in res.reports)
    assert [m["iterations"] for r in res.reports for m in r["ministeps"]] \
        == [m["iterations"] for r in out[jpkg].reports
            for m in r["ministeps"]] == [1, 1]
    v1 = face_dense_reference(nf, edges, w, dt, v0, q)
    v2 = face_dense_reference(nf, edges, w, dt, v1, q)
    np.testing.assert_allclose(res.states[0]["FaceVal"], v1, rtol=1e-9)
    np.testing.assert_allclose(res.states[1]["FaceVal"], v2, rtol=1e-9)
    assert _rel(res.states[1]["FaceVal"],
                out[jpkg].states[1]["FaceVal"]) <= 1e-12


# ---------------------------------------------------------------------------
# a Cells and a Faces equation in one model
# ---------------------------------------------------------------------------
def build_mixed(pkg, nx=5, ny=4, w=0.8):
    mesh = pkg.CartesianMesh((nx, ny), (1.0, 1.0))
    nb = np.asarray(mesh.neighborship())
    model = pkg.SimulationModel(pkg.DataDomain(mesh),
                                _ts(pkg).MixedFluxSystem(nb, weight=w))
    return mesh, model, nb


def mixed_operator(nc, nf, nb, w, dt):
    """[[I/dt, D], [-G, I]] with D the incidence, G = w D^T."""
    D = np.zeros((nc, nf))
    G = np.zeros((nf, nc))
    for f, (L, R) in enumerate(nb):
        D[L, f] += 1.0
        D[R, f] -= 1.0
        G[f, L] += w
        G[f, R] -= w
    return np.block([[np.eye(nc) / dt, D], [-G, np.eye(nf)]])


def test_mixed_entity_compiles_and_assembles_as_jax():
    out = {}
    for pkg in PKGS:
        mesh, model, nb = build_mixed(pkg)
        nc, nf = mesh.number_of_cells(), mesh.number_of_faces()
        rng = np.random.default_rng(7)
        params = pkg.setup_parameters(model,
                                      CellSource=rng.uniform(-0.5, 0.5, nc))
        st = {**pkg.setup_state(model, CellVal=rng.uniform(0, 1, nc),
                                FaceVal=rng.uniform(-1, 1, nf)), **params}
        st0 = {**pkg.setup_state(model, CellVal=np.full(nc, 0.5),
                                 FaceVal=np.zeros(nf)), **params}
        out[pkg] = _assemble(pkg, model, st, st0, 1.0)
        const = {**pkg.setup_state(model, CellVal=np.full(nc, 0.5),
                                   FaceVal=np.zeros(nf)),
                 **pkg.setup_parameters(model)}
        _, r0, _ = _assemble(pkg, model, const, const, 1.0)
        for v in r0.values():
            np.testing.assert_allclose(v, 0.0, atol=1e-14)
    comp, rt, Jt = out[tpkg]
    assert isinstance(comp, MixedCompiledModel)
    assert set(comp.comps) == {"Cells", "Faces"}
    for k in ("Cells", "Faces"):
        assert _rel(rt[k], out[jpkg][1][k]) <= 1e-12
    assert _rel(Jt, out[jpkg][2]) <= 1e-12
    np.testing.assert_allclose(Jt, mixed_operator(nc, nf, nb, 0.8, 1.0),
                               atol=1e-12)
    t = lambda d: tpkg.from_numpy(d, "cpu", torch.float64)  # noqa: E731
    _, J, _ = comp.assemble(t(const), t(const), 1.0)
    pairs = {(cb.target, cb.source) for cb in J.couplings}
    assert {("Cells", "Faces"), ("Faces", "Cells")} <= pairs


def test_mixed_entity_solves_vs_dense():
    """One implicit-Euler step through the ordinary Simulator (the
    default direct solve on the coupled system) matches the dense
    monolithic solve and the JAX package's run."""
    mesh, model, nb = build_mixed(tpkg)
    nc, nf = mesh.number_of_cells(), mesh.number_of_faces()
    rng = np.random.default_rng(7)
    c0 = rng.uniform(0.0, 1.0, nc)
    q = rng.uniform(-0.5, 0.5, nc)
    dt, w = 0.3, 0.8
    out = {}
    for pkg in PKGS:
        _, m, _ = build_mixed(pkg)
        kw = {} if pkg is jpkg else dict(device="cpu")
        out[pkg] = pkg.Simulator(
            m, state0=pkg.setup_state(m, CellVal=c0, FaceVal=np.zeros(nf)),
            parameters=pkg.setup_parameters(m, CellSource=q),
            **kw).simulate([dt], info_level=-1,
                           tolerances={"default": 1e-11})
    res = out[tpkg]
    assert res.reports[-1]["success"]
    x = np.linalg.solve(mixed_operator(nc, nf, nb, w, dt),
                        np.concatenate([c0 / dt + q, np.zeros(nf)]))
    np.testing.assert_allclose(res.states[-1]["CellVal"], x[:nc],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res.states[-1]["FaceVal"], x[nc:],
                               rtol=1e-9, atol=1e-12)
    for k in ("CellVal", "FaceVal"):
        assert _rel(res.states[-1][k], out[jpkg].states[-1][k]) <= 1e-12
