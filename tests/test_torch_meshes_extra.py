"""The port's meshes beyond ``UnstructuredMesh`` against the JAX package's,
on the CPU (numpy on both sides).

Integer tables (points' order, face nodes, neighbours, boundary cells)
equal and geometry bitwise, on the same seeded inputs: ``extrude_mesh``
of moved quad, radial and triangle maps, ``face_planarity`` (within
1e-14: batched SVDs and products, the same LAPACK call per face) and the
quality checks, ``cell_halfspaces`` and ``cell_bounding_radius``, both
trajectory methods, tags, ``CoarseMesh`` with every coarsening op and
``coarsen_data_domain``, ``radial_mesh`` / ``spiral_mesh``, ``cut_mesh``
(``PlaneCut`` in 2D and 3D, through mesh nodes, ``SurfaceCut`` on a
kinked surface), ``glue_mesh``, ``embed_mesh``, ``merge_faces``,
``SurfaceMesh`` / ``embed_surface`` / ``fracture_matrix_trans``, and the
reference's own limitation: extruding a 2D cut mesh raises in both.
"""

import numpy as np
import pytest

import chip_smoke
import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu.meshes import convexgeom as jcg
from jutul.jl_tpu.meshes import extruded as jex
from jutul.jl_tpu.meshes.coarse import coarsen_cell_value as j_coarsen
from jutul.jl_tpu_torch.meshes import convexgeom as tcg
from jutul.jl_tpu_torch.meshes import extruded as tex
from jutul.jl_tpu_torch.meshes.coarse import coarsen_cell_value as t_coarsen

GEO_FIELDS = ("neighbors", "areas", "volumes", "normals", "cell_centroids",
              "face_centroids", "boundary_areas", "boundary_normals",
              "boundary_centroids", "boundary_neighbors")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _assert_same_mesh(jm, tm, geometry=True):
    assert _same(jm.points, tm.points)
    for name in ("face_nodes", "boundary_face_nodes"):
        ja, ta = getattr(jm, name), getattr(tm, name)
        assert _same(ja.vals, ta.vals) and _same(ja.pos, ta.pos), name
    assert _same(jm.face_neighbors, tm.face_neighbors)
    assert _same(jm.boundary_face_cells, tm.boundary_face_cells)
    assert jm.number_of_cells() == tm.number_of_cells()
    if geometry:
        gj, gt = jm.tpfv_geometry(), tm.tpfv_geometry()
        for f in GEO_FIELDS:
            assert _same(getattr(gj, f), getattr(gt, f)), f


def _layers(nl, seed=3):
    rng = np.random.default_rng(seed)
    return np.concatenate([[0.0], np.cumsum(rng.uniform(2.0, 10.0, nl))])


def _maps(pkg):
    """2D maps of every cell shape: a moved quad mesh, a radial mesh (its
    loops come out clockwise and are turned), a gmsh triangle mesh."""
    tri = pkg.UnstructuredMesh(
        np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0],
                  [0.5, 0.4]]),
        [[1, 4], [4, 2], [4, 3], [0, 4]],
        np.array([[0, 1], [1, 2], [2, 3], [3, 0]]),
        [[0, 1], [1, 2], [2, 3], [3, 0]], [0, 1, 2, 3])
    return {"quad": chip_smoke.perturbed_quad_mesh(6, 5, pkg, amp=0.2),
            "radial": pkg.radial_mesh([0.1, 0.5, 1.0, 2.0], 7),
            "tri": tri}


@pytest.mark.parametrize("kind", ["quad", "radial", "tri"])
def test_extrude_mesh(kind):
    z = _layers(3)
    jm = jpkg.extrude_mesh(_maps(jpkg)[kind], z)
    tm = tpkg.extrude_mesh(_maps(tpkg)[kind], z)
    _assert_same_mesh(jm, tm)
    assert jex._cell_node_loops(_maps(jpkg)[kind]) == \
        tex._cell_node_loops(_maps(tpkg)[kind])


def test_extrude_cut_2d_mesh_raises_in_both():
    """The reference's limitation: a 2D cut leaves faces of 3 nodes (the
    neighbour of a cut cell gains the cut point), which extrusion
    cannot take."""
    for pkg in (jpkg, tpkg):
        m = pkg.UnstructuredMesh.from_cartesian(
            pkg.CartesianMesh((3, 3), (3.0, 3.0)))
        cut = pkg.cut_mesh(m, pkg.PlaneCut((1.4, 1.5), (1.0, 0.3)))
        with pytest.raises(ValueError, match="too many values to unpack"):
            pkg.extrude_mesh(cut, [0.0, 1.0, 2.0])


def test_extruded_square_matches_cartesian_cells():
    """An extruded square map holds the cells of the CartesianMesh of the
    same size, matched by centroid, with the same volumes."""
    m = tpkg.extrude_mesh(tpkg.UnstructuredMesh.from_cartesian(
        tpkg.CartesianMesh((4, 3), (4.0, 3.0))), [0.0, 1.0, 2.0])
    g = m.tpfv_geometry()
    gc = tpkg.CartesianMesh((4, 3, 2), (4.0, 3.0, 2.0)).tpfv_geometry()
    assert np.allclose(g.cell_centroids, gc.cell_centroids, atol=1e-14)
    assert np.allclose(g.volumes, gc.volumes, atol=1e-14)


def _moved_3d(pkg):
    m = pkg.extrude_mesh(chip_smoke.perturbed_quad_mesh(4, 4, pkg), _layers(2))
    pts = m.points.copy()
    rng = np.random.default_rng(5)
    pts[:, 2] += rng.uniform(-0.3, 0.3, len(pts))  # non-planar faces
    fn = m.face_nodes
    flipped = fn.vals.copy()
    flipped[fn.pos[2]:fn.pos[3]] = flipped[fn.pos[2]:fn.pos[3]][::-1]
    return pkg.UnstructuredMesh(pts, pkg.IndirectionMap(flipped, fn.pos),
                                m.face_neighbors, m.boundary_face_nodes,
                                m.boundary_face_cells)


def test_quality_checks():
    jm, tm = _moved_3d(jpkg), _moved_3d(tpkg)
    pj, pt = jex.face_planarity(jm), tex.face_planarity(tm)
    assert pj.max() > 1e-3
    np.testing.assert_allclose(pt, pj, rtol=1e-14, atol=1e-16)
    qj, qt = jex.check_mesh_quality(jm, 0.01), tex.check_mesh_quality(tm, 0.01)
    assert qj.keys() == qt.keys()
    for k in qj:
        np.testing.assert_allclose(qt[k], qj[k], rtol=1e-14)
    okj, badj = jpkg.check_mesh(jm, extra_out=True)
    okt, badt = tpkg.check_mesh(tm, verbose=True, extra_out=True)
    assert okj == okt
    for k in badj:
        assert _same(badj[k], badt[k]), k
    _assert_same_mesh(jpkg.check_and_fix_mesh(jm), tpkg.check_and_fix_mesh(tm),
                      geometry=False)


def test_halfspaces_and_bounding_radius():
    jm, tm = _moved_3d(jpkg), _moved_3d(tpkg)
    gj, gt = jm.tpfv_geometry(strict=False), tm.tpfv_geometry(strict=False)
    for (pj, nj), (pt, nt) in zip(jcg.cell_halfspaces(gj),
                                  tcg.cell_halfspaces(gt)):
        assert _same(pj, pt) and _same(nj, nt)
    some = [7, 3, 20]
    for (pj, nj), c in zip(tcg.cell_halfspaces(gt, some), some):
        assert _same(pj, jcg.cell_halfspaces(gj)[c][0])
    assert _same(jcg.cell_bounding_radius(jm), tcg.cell_bounding_radius(tm))
    np.testing.assert_allclose(tcg.cell_bounding_radius(gt),
                               jcg.cell_bounding_radius(gj), rtol=1e-15)


def _scaled(pkg, nx, ny, scale):
    m = chip_smoke.perturbed_quad_mesh(nx, ny, pkg)
    return pkg.UnstructuredMesh(m.points * scale, m.face_nodes,
                                m.face_neighbors, m.boundary_face_nodes,
                                m.boundary_face_cells)


TRAJ = np.array([[3.1, 0.4, -1.0], [2.2, 1.7, 6.0], [0.2, 3.5, 30.0]])


@pytest.mark.parametrize("method", ["exact", "sampling"])
def test_find_enclosing_cells(method):
    m = {p: p.extrude_mesh(_scaled(p, 8, 8, 4.0), _layers(4))
         for p in (jpkg, tpkg)}
    cj = jpkg.find_enclosing_cells(m[jpkg], TRAJ, method=method)
    ct = tpkg.find_enclosing_cells(m[tpkg], TRAJ, method=method)
    assert len(cj) >= 4 and _same(cj, ct)
    if method == "exact":
        hj = jpkg.trajectory_intersections(m[jpkg], TRAJ)
        ht = tpkg.trajectory_intersections(m[tpkg], TRAJ)
        assert len(hj) == len(ht)
        for a, b in zip(hj, ht):
            assert a.keys() == b.keys()
            for k in a:
                assert _same(a[k], b[k]), k


def test_tags_roundtrip():
    from jutul.jl_tpu.core.entities import CELLS as JC, FACES as JF
    from jutul.jl_tpu_torch.core.entities import CELLS as TC, FACES as TF

    out = []
    for pkg, C, F in ((jpkg, JC, JF), (tpkg, TC, TF)):
        m = pkg.UnstructuredMesh.from_cartesian(
            pkg.CartesianMesh((4, 3, 2), (1.0, 1.0, 1.0)))
        pkg.set_mesh_entity_tag(m, C, "layers", "layer0", [3, 1, 1, 0])
        pkg.set_mesh_entity_tag(m, C, "layers", "layer1", np.arange(12, 24))
        pkg.set_mesh_entity_tag(m, F, "fault", "f", [5])
        with pytest.raises(IndexError):
            pkg.set_mesh_entity_tag(m, C, "layers", "bad", [24])
        out.append((pkg.get_mesh_entity_tag(m, C, "layers", "layer0"),
                    pkg.get_mesh_entity_tag(m, C, "layers"),
                    pkg.get_mesh_entity_tag(m, F, "fault", "f"),
                    m.tags[C].groups()))
    (a0, ag, af, gr), (b0, bg, bf, gr2) = out
    assert _same(a0, b0) and _same(af, bf) and gr == gr2
    assert ag.keys() == bg.keys() and all(_same(ag[k], bg[k]) for k in ag)


def _partition(nc):
    rng = np.random.default_rng(11)
    return rng.permutation(np.arange(nc) % 7)


@pytest.mark.parametrize("op", ["sum", "max", "min", "arithmetic",
                                "harmonic", "volume"])
def test_coarsen_cell_value(op):
    rng = np.random.default_rng(2)
    v = rng.lognormal(0.0, 1.0, (40, 2))
    vol = rng.uniform(0.5, 2.0, 40)
    p = _partition(40)
    assert _same(j_coarsen(v, p, vol, op), t_coarsen(v, p, vol, op))
    assert _same(j_coarsen(v[:, 0], p, vol, op), t_coarsen(v[:, 0], p, vol, op))


def test_coarse_mesh_and_data_domain():
    dds = []
    for pkg in (jpkg, tpkg):
        m = pkg.extrude_mesh(chip_smoke.perturbed_quad_mesh(5, 4, pkg),
                             _layers(2))
        rng = np.random.default_rng(4)
        dd = pkg.DataDomain(m)
        dd.set("permeability", rng.lognormal(0.0, 1.0, 40))
        dd.set("porosity", rng.uniform(0.1, 0.3, 40))
        dd.set("other", rng.uniform(0.0, 1.0, (40, 2)))
        cd = pkg.coarsen_data_domain(dd, _partition(40),
                                     ops={"other": "max"})
        dds.append(cd)
    cj, ct = dds
    gj, gt = cj.mesh.tpfv_geometry(), ct.mesh.tpfv_geometry()
    for f in GEO_FIELDS:
        assert _same(getattr(gj, f), getattr(gt, f)), f
    names = [n for n, _ in cj.items()]
    assert names == [n for n, _ in ct.items()]
    for n in names:
        assert _same(cj[n], ct[n]), n
    assert _same(cj.mesh.fine_cells_of_coarse(3),
                 ct.mesh.fine_cells_of_coarse(3))


def test_radial_and_spiral_meshes():
    _assert_same_mesh(jpkg.radial_mesh([0.1, 0.3, 0.9, 2.0], 9,
                                       origin=(1.0, -2.0)),
                      tpkg.radial_mesh([0.1, 0.3, 0.9, 2.0], 9,
                                       origin=(1.0, -2.0)))
    _assert_same_mesh(jpkg.spiral_mesh(0.5, 0.4, 2.5, 16, 3),
                      tpkg.spiral_mesh(0.5, 0.4, 2.5, 16, 3))


def _kinked(pkg):
    pts = np.array([[1.6, -5.0, -5.0], [2.0, -5.0, 2.0], [1.6, -5.0, 9.0],
                    [1.6, 8.0, -5.0], [2.0, 8.0, 2.0], [1.6, 8.0, 9.0]])
    return pkg.SurfaceCut(pkg.SurfaceMesh(pts, [[0, 1, 4, 3], [1, 2, 5, 4]]))


CUTS = {
    "plane-2d": (lambda p: chip_smoke.perturbed_quad_mesh(6, 5, p),
                 lambda p: p.PlaneCut((0.45, 0.5), (1.0, 0.35))),
    "plane-2d-nodes": (lambda p: p.UnstructuredMesh.from_cartesian(
        p.CartesianMesh((4, 4), (4.0, 4.0))),
        lambda p: p.PlaneCut((2.0, 2.0), (1.0, 1.0))),
    "plane-3d": (lambda p: p.extrude_mesh(
        chip_smoke.perturbed_quad_mesh(5, 4, p), _layers(3)),
        lambda p: p.PlaneCut((0.5, 0.5, 8.0), (1.0, 0.4, 0.25))),
    "plane-3d-nodes": (lambda p: p.UnstructuredMesh.from_cartesian(
        p.CartesianMesh((3, 3, 3), (3.0, 3.0, 3.0))),
        lambda p: p.PlaneCut((1.0, 1.0, 1.5), (1.0, 1.0, 0.0))),
    "surface-kinked": (lambda p: p.UnstructuredMesh.from_cartesian(
        p.CartesianMesh((4, 3, 4), (4.0, 3.0, 4.0))), _kinked),
}


@pytest.mark.parametrize("case", list(CUTS))
def test_cut_mesh(case):
    mesh, cut = CUTS[case]
    jm = jpkg.cut_mesh(mesh(jpkg), cut(jpkg))
    tm = tpkg.cut_mesh(mesh(tpkg), cut(tpkg))
    assert tm.number_of_cells() > mesh(tpkg).number_of_cells()
    _assert_same_mesh(jm, tm)
    np.testing.assert_allclose(tm.tpfv_geometry().volumes.sum(),
                               mesh(tpkg).tpfv_geometry().volumes.sum(),
                               rtol=1e-12)


def test_glue_embed_merge():
    for build in (lambda p: p.UnstructuredMesh.from_cartesian(
            p.CartesianMesh((2, 2), (2.0, 2.0))),
            lambda p: p.UnstructuredMesh.from_cartesian(
            p.CartesianMesh((2, 2, 1), (2.0, 2.0, 1.0)))):
        meshes = []
        for p in (jpkg, tpkg):
            a = build(p)
            shift = np.zeros(a.dim)
            shift[0] = 2.0
            b = p.UnstructuredMesh(a.points + shift, a.face_nodes,
                                   a.face_neighbors, a.boundary_face_nodes,
                                   a.boundary_face_cells)
            meshes.append(p.glue_mesh(a, b))
        _assert_same_mesh(*meshes)
    # merge_faces: a cut fragments faces; merging restores one per plane
    jm = jpkg.merge_faces(jpkg.cut_mesh(*(f(jpkg) for f in CUTS["plane-3d"])))
    tm = tpkg.merge_faces(tpkg.cut_mesh(*(f(tpkg) for f in CUTS["plane-3d"])))
    _assert_same_mesh(jm, tm)
    host = [p.UnstructuredMesh.from_cartesian(p.CartesianMesh(
        (4, 4), (1.0, 1.0))) for p in (jpkg, tpkg)]
    frac = [p.UnstructuredMesh.from_cartesian(p.CartesianMesh(
        (5, 1), (0.9, 0.01), origin=(0.05, 0.551))) for p in (jpkg, tpkg)]
    for x, y in zip(jpkg.embed_mesh(host[0], frac[0], aperture=2e-3),
                    tpkg.embed_mesh(host[1], frac[1], aperture=2e-3)):
        assert _same(x, y)


def test_surface_mesh_embed_surface():
    outs = []
    for p in (jpkg, tpkg):
        host = p.extrude_mesh(chip_smoke.perturbed_quad_mesh(4, 4, p),
                              [0.0, 0.3, 0.6, 1.0])
        surf = p.SurfaceMesh.rectangle((0.05, 0.1, 0.2), (0.9, 0.3, 0.0),
                                       (0.0, 0.2, 0.7), nu=3, nv=2)
        g = surf.tpfv_geometry()
        conn = p.embed_surface(host, surf)
        rng = np.random.default_rng(8)
        km = rng.lognormal(0.0, 1.0, host.number_of_cells())
        kf = rng.lognormal(2.0, 0.5, surf.number_of_cells())
        outs.append((g, conn, p.fracture_matrix_trans(conn, km),
                     p.fracture_matrix_trans(conn, km, kf, aperture=2e-3),
                     surf.edge_neighbors, surf.boundary_edge_cells))
    (gj, cj, *rj), (gt, ct, *rt) = outs
    for f in GEO_FIELDS:
        assert _same(getattr(gj, f), getattr(gt, f)), f
    assert cj.keys() == ct.keys() and len(cj["host_cells"]) > 4
    for k in cj:
        assert _same(cj[k], ct[k]), k
    for a, b in zip(rj, rt):
        assert _same(a, b)


def test_exports_mirror_the_jax_package():
    """Every name the JAX package exports from the modules this slice
    ports is exported by the port, from the counterpart module."""
    mods = tuple(f"jutul.jl_tpu.meshes.{m}" for m in (
        "coarse", "convexgeom", "cutcell", "embedded", "extruded", "radial",
        "tags", "trajectories")) + ("jutul.jl_tpu.utils.",
                                    "jutul.jl_tpu.parallel.partition")
    names = [n for n in dir(jpkg) if getattr(getattr(jpkg, n), "__module__",
                                             "").startswith(mods)]
    names.append("StencilCompiledModel")
    assert len(names) > 25
    for n in names:
        mod = getattr(jpkg, n).__module__.replace("jutul.jl_tpu.",
                                                  "jutul.jl_tpu_torch.")
        assert getattr(tpkg, n).__module__ == mod, n
        assert n in tpkg.__all__, n
