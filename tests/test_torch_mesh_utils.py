"""The port's ``utils/`` against the JAX package's, on the CPU.

VTU and PVD files of CartesianMeshes are the same text; the port's
UnstructuredMesh VTU (which the JAX package refuses) holds every cell's
points and faces; Gmsh (MSH 2.2 and 4.1) and MRST files written by the
tests into ``tmp_path`` read back into equal meshes; ``triangulate_mesh``
and ``model_variable_graph`` equal; the matplotlib plots run where
matplotlib is installed and skip where it is not; the timing scopes.
"""

import importlib
import xml.etree.ElementTree as ET

import numpy as np
import pytest
from scipy.io import savemat

import chip_smoke
import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu.utils import plotting as jplot
from jutul.jl_tpu.utils import vtk as jvtk
from jutul.jl_tpu_torch.utils import plotting as tplot
from jutul.jl_tpu_torch.utils import timing as ttiming
from jutul.jl_tpu_torch.utils import vtk as tvtk


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _same_mesh(a, b):
    assert _same(a.points, b.points)
    for name in ("face_nodes", "boundary_face_nodes"):
        x, y = getattr(a, name), getattr(b, name)
        assert _same(x.vals, y.vals) and _same(x.pos, y.pos), name
    assert _same(a.face_neighbors, b.face_neighbors)
    assert _same(a.boundary_face_cells, b.boundary_face_cells)


@pytest.mark.parametrize("dims", [(4, 3), (3, 2, 2)])
def test_vtu_and_pvd_text_equal(dims, tmp_path):
    rng = np.random.default_rng(0)
    n = int(np.prod(dims))
    data = {"p": rng.normal(size=n), "s": rng.uniform(size=(n, 2))}
    texts = []
    for pkg, mod in ((jpkg, jvtk), (tpkg, tvtk)):
        out = tmp_path / pkg.__name__
        m = pkg.CartesianMesh(dims, tuple(float(d) for d in dims))
        out.mkdir()
        vtu = mod.export_mesh_vtu(out / "one.vtk", m, data)
        states = [{"p": data["p"] * k, "s": data["s"], "n": 3}
                  for k in range(3)]
        pvd = mod.export_time_series_pvd(out / "series.pvd", m, states,
                                         [1.0, 2.5], fields=["p"])
        texts.append([open(f).read() for f in (
            vtu, pvd, out / "series_0000.vtu", out / "series_0002.vtu")])
    assert texts[0] == texts[1]


def test_vtu_unstructured(tmp_path):
    m3 = tpkg.extrude_mesh(chip_smoke.perturbed_quad_mesh(3, 2), [0, 1, 3])
    m2 = tpkg.radial_mesh([0.1, 0.5, 1.0], 5)
    for m in (m3, m2):
        nc = m.number_of_cells()
        fn = tvtk.export_mesh_vtu(tmp_path / f"u{m.dim}.vtu", m,
                                  {"x": np.arange(nc, dtype=float)})
        arrays = {a.get("Name"): np.array(a.text.split(), dtype=float)
                  for a in ET.parse(fn).iter("DataArray") if a.get("Name")}
        offsets = arrays["offsets"].astype(int)
        conn = arrays["connectivity"].astype(int)
        assert len(offsets) == nc and offsets[-1] == len(conn)
        assert _same(arrays["x"], np.arange(nc))
        if m.dim == 2:
            assert set(arrays["types"]) == {7}
            continue
        assert set(arrays["types"]) == {42}
        faces, fo = arrays["faces"].astype(int), \
            arrays["faceoffsets"].astype(int)
        assert len(fo) == nc and fo[-1] == len(faces)
        # every cell: 6 quads over its 8 distinct points
        start = np.concatenate([[0], fo[:-1]])
        assert np.all(faces[start] == 6)
        assert np.all(np.diff(np.concatenate([[0], offsets])) == 8)


MSH2 = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
9
1 0 0 0
2 1 0 0
3 2 0 0
4 0 1 0
5 1 1 0
6 2 1 0
7 0 2 0
8 1 2 0
9 2 2 0.5
$EndNodes
$Elements
5
1 3 2 0 1 1 2 5 4
2 3 2 0 1 2 3 6 5
3 2 2 0 1 4 5 7
4 2 2 0 1 5 8 7
5 3 2 0 1 5 6 9 8
$EndElements
"""

MSH4 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Nodes
1 5 1 5
3 1 0 5
1
2
3
4
5
0 0 0
1 0 0
0 1 0
0 0 1
1 1 1
$EndNodes
$Elements
1 2 1 2
3 1 4 2
1 1 2 3 4
2 2 3 4 5
$EndElements
"""


@pytest.mark.parametrize("text", [MSH2, MSH4], ids=["msh2", "msh4"])
def test_gmsh_roundtrip(text, tmp_path):
    fn = tmp_path / "m.msh"
    fn.write_text(text)
    a, b = jpkg.mesh_from_gmsh(fn), tpkg.mesh_from_gmsh(fn)
    _same_mesh(a, b)
    assert _same(a.tpfv_geometry().volumes, b.tpfv_geometry().volumes)


def test_mrst_roundtrip(tmp_path):
    """An MRST ``G`` of a 3x2 quad grid written by scipy, read by both."""
    m = tpkg.UnstructuredMesh.from_cartesian(
        tpkg.CartesianMesh((3, 2), (3.0, 2.0)))
    faces = [m.face_nodes[f] for f in range(m.number_of_faces())] + \
        [m.boundary_face_nodes[f] for f in range(m.number_of_boundary_faces())]
    nbrs = np.concatenate([m.face_neighbors + 1, np.stack(
        [m.boundary_face_cells + 1, np.zeros_like(m.boundary_face_cells)],
        axis=1)])
    G = {"nodes": {"coords": m.points, "num": len(m.points)},
         "faces": {"nodes": np.concatenate(faces) + 1,
                   "nodePos": np.concatenate([[1], 1 + np.cumsum(
                       [len(f) for f in faces])]),
                   "neighbors": nbrs, "num": len(faces)},
         "cells": {"num": m.number_of_cells()}, "griddim": 2}
    fn = tmp_path / "g.mat"
    savemat(fn, {"G": G})
    a, b = jpkg.mesh_from_mat(fn), tpkg.mesh_from_mat(fn)
    _same_mesh(a, b)
    assert _same(b.face_neighbors, m.face_neighbors)
    with pytest.raises(KeyError):
        tpkg.mesh_from_mat(fn, grid_name="H")


def test_triangulate_and_variable_graph():
    for build in (lambda p: p.CartesianMesh((3, 2, 2), (1.0, 1.0, 1.0)),
                  lambda p: chip_smoke.perturbed_quad_mesh(3, 3, p)):
        a, b = jplot.triangulate_mesh(build(jpkg)), \
            tplot.triangulate_mesh(build(tpkg))
        assert a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    a = jplot.triangulate_mesh(build(jpkg), outer=False)
    b = tplot.triangulate_mesh(build(tpkg), outer=False)
    assert all(_same(a[k], b[k]) for k in a)
    graphs = []
    for pkg, mod in ((jpkg, jplot), (tpkg, tplot)):
        D = importlib.import_module(pkg.__name__ + ".models.darcy")
        graphs.append(mod.model_variable_graph(D.setup_darcy_model(
            pkg.CartesianMesh((4, 3, 2), (1.0, 1.0, 1.0)),
            D.ImmiscibleFluid(viscosities=(1e-3, 2e-3)), permeability=1e-13,
            porosity=0.25, gravity=True)))
    assert graphs[0] == graphs[1] and "digraph" in graphs[0]


def test_plots(tmp_path):
    pytest.importorskip("matplotlib")
    ax = tplot.plot_cell_data(chip_smoke.perturbed_quad_mesh(4, 3),
                              np.arange(12.0), title="cells")
    tplot.save_figure(ax, tmp_path / "cells.png")
    ax = tplot.plot_cell_data(tpkg.CartesianMesh((4, 3, 2), (1, 1, 1)),
                              np.arange(24.0))
    tplot.save_figure(ax, tmp_path / "cart.png")
    reports = [{"ministeps": [{"iterations": 3, "wall_time": 0.1}]}] * 2
    tplot.save_figure(tplot.plot_performance(reports), tmp_path / "p.png")
    assert all((tmp_path / f).stat().st_size > 1000
               for f in ("cells.png", "cart.png", "p.png"))


def test_timing():
    ttiming.reset_timings()
    ttiming.set_timing_enabled(True)
    try:
        with ttiming.tic("setup"):
            with ttiming.tic("mesh"):
                pass
            with ttiming.tic("mesh"):
                pass
        t = ttiming.get_timings()
    finally:
        ttiming.set_timing_enabled(False)
        ttiming.reset_timings()
    assert t["setup/mesh"]["count"] == 2 and t["setup"]["count"] == 1
    assert t["setup"]["time"] >= t["setup/mesh"]["time"] >= 0.0
    assert ttiming.timing_breakdown(
        [{"ministeps": [{"wall_time": 1.5}, {"wall_time": 0.5}]}]) == \
        {"ministep": 2.0}
