"""Darcy flow on the port's new meshes against the JAX package, on the
CPU at f64.

- ``chip_smoke.layered_reservoir`` (the card's ``extruded-layers`` and
  ``cut-fault`` cases at a small size) through each package's mesh API:
  the same mesh tables, trajectory well cells, cell fields and model
  parameters;
- the layered, the coarse-upscaled (``coarse_reservoir``: Metis
  partition with forced well groups, ``CoarseMesh`` +
  ``coarsen_data_domain``) and the cut-fault cases through
  ``Simulator(use_stencil=False)`` with tight solves (the default direct
  solver; the layered case also with BASELINE.json's CPR-GMRES at rtol
  1e-10): every ministep's counts, dt and success identical, states within
  1e-12;
- an extruded square map against the CartesianMesh of the same cells,
  matched by centroid: residual and J v of the generic engine within
  1e-12.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu_torch.models import darcy as tdarcy
from jutul.jl_tpu_torch.models.setup import merge_state

DT = 6 * 3600.0
DIMS = (6, 5, 3)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _cases(kind):
    out = {}
    for pkg in (jpkg, tpkg):
        c = chip_smoke.layered_reservoir(*DIMS, pkg=pkg,
                                         fault=kind == "fault")
        if kind == "coarse":
            m, s0, p, f, info = chip_smoke.coarse_reservoir(c, 12, pkg=pkg)
            c = dict(c, model=m, state0=s0, params=p, forces=f, info=info)
        out[pkg] = c
    return out


@pytest.mark.parametrize("kind", ["layers", "coarse", "fault"])
def test_case_tables_match(kind):
    c = _cases(kind)
    cj, ct = c[jpkg], c[tpkg]
    mj, mt = cj["mesh"], ct["mesh"]
    assert _same(mj.points, mt.points)
    for name in ("face_nodes", "boundary_face_nodes"):
        assert _same(getattr(mj, name).vals, getattr(mt, name).vals)
        assert _same(getattr(mj, name).pos, getattr(mt, name).pos)
    assert all(map(_same, cj["well_cells"], ct["well_cells"]))
    assert [len(w) for w in ct["well_cells"][:4]] == [DIMS[2]] * 4
    for k in ("perm", "poro", "sw", "p0"):
        assert _same(cj[k], ct[k]), k
    for k, v in cj["params"].items():
        assert _same(v, ct["params"][k]), k
    for k, v in cj["state0"].items():
        assert _same(v, ct["state0"][k]), k
    if kind == "coarse":
        ij, it = cj["info"], ct["info"]
        assert _same(ij["partition"], it["partition"])
        assert ij["well_blocks"] == it["well_blocks"]
        assert it["pore_volume"] == pytest.approx(it["fine_pore_volume"],
                                                  rel=1e-12)
    if kind == "fault":
        assert ct["cells_added"] > 0
        np.testing.assert_allclose(mt.tpfv_geometry().volumes.sum(),
                                   ct["uncut_volume"], rtol=1e-12)


@pytest.mark.parametrize("kind,solver", [
    ("layers", "direct"), ("layers", "cpr"), ("coarse", "direct"),
    ("fault", "direct")])
def test_runs_match_jax(kind, solver):
    c = _cases(kind)
    out = {}
    for pkg in (jpkg, tpkg):
        kw = {} if pkg is jpkg else dict(device="cpu")
        cs = c[pkg]
        sim = pkg.Simulator(cs["model"], state0=cs["state0"],
                            parameters=cs["params"], use_stencil=False, **kw)
        cfg = chip_smoke.generic_config(pkg, pkg.DirectSolver()
                                        if solver == "direct" else
                                        pkg.GenericKrylov(
                                            "gmres", pkg.CPRPreconditioner(),
                                            rtol=1e-10, max_iterations=200,
                                            restart=20))
        out[pkg] = sim.simulate([DT] * 2,
                                forces=chip_smoke.rate_schedule(
                                    cs["forces"], 2), **cfg)
    rj, rt = out[jpkg], out[tpkg]
    assert all(r["success"] for r in rt.reports)
    counts = [[(m["iterations"], m["linear_iterations"], m["success"],
                m["dt"]) for r in res.reports for m in r["ministeps"]]
              for res in (rj, rt)]
    assert counts[0] == counts[1]
    for a, b in zip(rj.states, rt.states):
        assert np.max(np.abs(b["Pressure"] / np.asarray(a["Pressure"])
                             - 1)) <= 1e-12
        assert np.max(np.abs(b["Saturations"]
                             - np.asarray(a["Saturations"]))) <= 1e-12


def test_extruded_square_matches_cartesian():
    """Residual and J v of the generic engine on an extruded square map
    against the CartesianMesh of the same cells (the same cell order:
    x fastest, then y, then the layers)."""
    dims = (4, 3, 3)
    rng = np.random.default_rng(1)
    nc = int(np.prod(dims))
    meshes = [tpkg.CartesianMesh(dims, (4.0, 3.0, 6.0)),
              tpkg.extrude_mesh(tpkg.UnstructuredMesh.from_cartesian(
                  tpkg.CartesianMesh(dims[:2], (4.0, 3.0))),
                  [0.0, 2.0, 4.0, 6.0])]
    cc = [m.tpfv_geometry().cell_centroids for m in meshes]
    assert np.allclose(cc[0], cc[1], atol=1e-13)
    perm = rng.lognormal(0, 1, nc) * 1e-13
    sw = rng.uniform(0.2, 0.8, nc)
    p = 1e7 + rng.uniform(-1, 1, nc) * 1e5
    v = torch.from_numpy(rng.normal(size=(nc, 2)))
    res = []
    for m in meshes:
        model = tdarcy.setup_darcy_model(
            m, tdarcy.ImmiscibleFluid(viscosities=(1e-3, 2e-3)),
            permeability=perm, porosity=0.25, gravity=True)
        comp = tpkg.compile_model(model)
        params = tpkg.from_numpy(tpkg.setup_parameters(model), "cpu")
        st = tpkg.from_numpy(tpkg.setup_state(
            model, Pressure=p, Saturations=np.stack([sw, 1 - sw], 1)), "cpu")
        st0 = dict(st, Pressure=st["Pressure"] * (1 + 1e-3))
        r, J, _ = comp.assemble(merge_state(st, params),
                                merge_state(st0, params), DT)
        res.append((r.numpy(), J.matvec(v).numpy()))
    for a, b, what in zip(res[0], res[1], ("residual", "J v")):
        scale = np.abs(a).max(axis=0)
        assert np.all(np.abs(b - a) <= 1e-12 * scale), what
