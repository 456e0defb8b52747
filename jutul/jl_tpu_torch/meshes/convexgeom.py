"""Convex-cell geometry kernels: half-spaces, clipping, exact integrals.

Port of the JAX package's ``meshes/convexgeom.py`` (host numpy).
Build-time geometry shared by exact trajectory intersection
(counterpart of reference src/meshes/trajectories.jl:43), embedded-fracture
FV coupling (reference src/meshes/EmbeddedMeshes/finite-volume.jl:1-221) and
cut-cell utilities (reference src/meshes/CutCellMeshes/). Cells are treated
as the intersection of the half-spaces of their faces — exact for convex
cells (every Cartesian/corner-point cell; the standard assumption the
reference makes for point-location too). ``cell_halfspaces`` and
``cell_bounding_radius`` gather over all faces at once (arrays equal to the
JAX package's per-face loops); ``cell_halfspaces`` builds only the cells
asked for.
"""

from __future__ import annotations

import numpy as np


def _geometry(mesh_or_geo):
    return (mesh_or_geo.tpfv_geometry()
            if hasattr(mesh_or_geo, "tpfv_geometry") else mesh_or_geo)


def cell_halfspaces(mesh_or_geo, cells=None):
    """Per-cell outward face half-spaces.

    Returns a list (per cell of ``cells``, default every cell) of
    (points (m, dim), normals (m, dim)): the planes of all incident faces
    with OUTWARD-oriented unit normals (interior normals are stored
    left->right by the geometry, so they flip for the right cell), interior
    faces first in face order, then boundary faces."""
    geo = _geometry(mesh_or_geo)
    nc = geo.n_cells
    nb = np.asarray(geo.neighbors, dtype=np.int64).reshape(-1, 2)
    bn = np.asarray(geo.boundary_neighbors, dtype=np.int64)
    nf = nb.shape[0]
    # one entry per (cell, incident face): interior faces once per side
    # (keys 0..nf-1), boundary faces after them (keys nf..)
    owner = np.concatenate([nb[:, 0], nb[:, 1], bn])
    key = np.concatenate([np.arange(nf), np.arange(nf),
                          nf + np.arange(bn.size)])
    side = np.concatenate([np.zeros(nf, np.int8), np.ones(nf, np.int8),
                           np.zeros(bn.size, np.int8)])
    want = np.arange(nc) if cells is None else np.asarray(cells, np.int64)
    if cells is not None:
        sel = np.flatnonzero(np.isin(owner, want))
        owner, key, side = owner[sel], key[sel], side[sel]
    order = np.lexsort((key, owner))
    owner, key, side = owner[order], key[order], side[order]
    dim = geo.cell_centroids.shape[1]
    interior = key < nf
    pts = np.empty((key.size, dim))
    nrm = np.empty((key.size, dim))
    fi = key[interior]
    pts[interior] = geo.face_centroids[fi]
    n_in = geo.normals[fi]
    nrm[interior] = np.where(side[interior, None] == 1, -n_in, n_in)
    bi = key[~interior] - nf
    pts[~interior] = geo.boundary_centroids[bi]
    nrm[~interior] = geo.boundary_normals[bi]
    lo = np.searchsorted(owner, want, side="left")
    hi = np.searchsorted(owner, want, side="right")
    return [(pts[a:b], nrm[a:b]) for a, b in zip(lo, hi)]


def clip_segment(a, b, planes_pts, planes_nrm, tol: float = 1e-12):
    """Clip segment a->b against half-spaces {x: (x-p).n <= 0}.

    Returns (t0, t1) with 0 <= t0 <= t1 <= 1, or None if the segment misses
    the convex region. Exact for convex cells (vs. the sampling heuristic)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    da = np.einsum("mi,i->m", planes_nrm, a) - np.einsum(
        "mi,mi->m", planes_nrm, planes_pts)
    db = np.einsum("mi,i->m", planes_nrm, b) - np.einsum(
        "mi,mi->m", planes_nrm, planes_pts)
    t0, t1 = 0.0, 1.0
    for fa, fb in zip(da, db):
        d = fb - fa
        if abs(d) < tol:
            if fa > tol:
                return None
            continue
        t = -fa / d
        if d > 0:  # exiting
            t1 = min(t1, t)
        else:  # entering
            t0 = max(t0, t)
        if t0 > t1 + tol:
            return None
    if t0 > t1:
        return None
    return (t0, t1)


def clip_polygon_plane(poly, p0, n, tol: float = 1e-12):
    """Sutherland-Hodgman: keep the part of a (planar, 3D or 2D) polygon
    with (x - p0).n <= 0. Returns (k, dim) vertex array (possibly empty)."""
    poly = np.asarray(poly, dtype=np.float64)
    if len(poly) == 0:
        return poly
    d = (poly - np.asarray(p0)) @ np.asarray(n)
    out = []
    m = len(poly)
    for i in range(m):
        j = (i + 1) % m
        di, dj = d[i], d[j]
        if di <= tol:
            out.append(poly[i])
        if (di < -tol and dj > tol) or (di > tol and dj < -tol):
            t = di / (di - dj)
            out.append(poly[i] + t * (poly[j] - poly[i]))
    return np.asarray(out) if out else np.zeros((0, poly.shape[1]))


def polygon_area_centroid(poly):
    """(area, centroid) of a planar polygon in 2D or 3D (fan rule)."""
    poly = np.asarray(poly, dtype=np.float64)
    if len(poly) < 3:
        return 0.0, np.zeros(poly.shape[1] if poly.ndim == 2 else 3)
    o = poly.mean(axis=0)
    A = poly - o
    B = np.roll(poly, -1, axis=0) - o
    if poly.shape[1] == 2:
        cr = 0.5 * (A[:, 0] * B[:, 1] - A[:, 1] * B[:, 0])
        area = abs(cr.sum())
        tri_c = (o[None] + poly + np.roll(poly, -1, axis=0)) / 3.0
        tot = np.abs(cr).sum()
        cen = (tri_c * np.abs(cr)[:, None]).sum(axis=0) / max(tot, 1e-300)
        return float(area), cen
    cr = 0.5 * np.cross(A, B)
    tri_a = np.linalg.norm(cr, axis=1)
    area = np.linalg.norm(cr.sum(axis=0))
    tri_c = (o[None] + poly + np.roll(poly, -1, axis=0)) / 3.0
    tot = max(tri_a.sum(), 1e-300)
    cen = (tri_c * tri_a[:, None]).sum(axis=0) / tot
    return float(area), cen


def cell_tetrahedra(mesh, cell: int, face_map=None):
    """Decompose a (3D) cell into tetrahedra (apex = face-centroid mean;
    each face fanned from its own centroid) — the same decomposition the
    mesh geometry uses, so volumes sum exactly.

    ``face_map``: optional ``cell_face_node_lists(mesh)`` result; avoids
    an O(n_faces) whole-mesh scan per call when querying many cells."""
    tets = []
    apex = None
    if face_map is not None:
        faces = face_map[cell]
    else:
        pts = mesh.points
        faces = []
        nb = mesh.neighborship()
        for f in range(nb.shape[0]):
            if int(nb[f, 0]) == cell or int(nb[f, 1]) == cell:
                faces.append(pts[np.asarray(mesh.face_nodes[f])])
        for f in range(mesh.number_of_boundary_faces()):
            if int(mesh.boundary_face_cells[f]) == cell:
                faces.append(pts[np.asarray(mesh.boundary_face_nodes[f])])
    cents = [fp.mean(axis=0) for fp in faces]
    apex = np.mean(cents, axis=0)
    for fp, fc in zip(faces, cents):
        m = len(fp)
        for i in range(m):
            tets.append(np.stack([apex, fc, fp[i], fp[(i + 1) % m]]))
    return tets


def _tet_volume(t):
    return abs(np.linalg.det(t[1:] - t[0])) / 6.0


def _positive_part_tets(t, phi, tol: float = 1e-14):
    """Tetrahedra covering {phi >= 0} inside tet ``t`` (phi per vertex of a
    LINEAR field). The four classic sign cases."""
    pos = phi > tol
    npos = int(pos.sum())
    if npos == 0:
        return []
    if npos == 4 or (phi >= -tol).all():
        return [t]

    def cut(i, j):
        a, b = phi[i], phi[j]
        s = a / (a - b)
        return t[i] + s * (t[j] - t[i])

    ip = np.flatnonzero(pos)
    im = np.flatnonzero(~pos)
    if npos == 1:
        p = ip[0]
        i1, i2, i3 = (cut(p, q) for q in im)
        return [np.stack([t[p], i1, i2, i3])]
    if npos == 3:
        q = im[0]
        p1, p2, p3 = (t[i] for i in ip)
        i1, i2, i3 = (cut(i, q) for i in ip)
        return [np.stack([p1, p2, p3, i1]),
                np.stack([p2, p3, i1, i2]),
                np.stack([p3, i1, i2, i3])]
    # npos == 2: wedge p1 p2 | i11 i12 i21 i22
    p1, p2 = ip
    n1, n2 = im
    A1, B1, C1 = t[p1], cut(p1, n1), cut(p1, n2)
    A2, B2, C2 = t[p2], cut(p2, n1), cut(p2, n2)
    return [np.stack([A1, B1, C1, A2]),
            np.stack([B1, C1, A2, B2]),
            np.stack([C1, A2, B2, C2])]


def mean_abs_distance(mesh, cell: int, plane_point, plane_normal,
                      face_map=None):
    """EXACT (1/V) * integral over the cell of |signed distance to plane|
    (reference EmbeddedMeshes/finite-volume.jl average normal distance; the
    standard EDFM <d>). Uses int |phi| = 2 * int_{phi>0} phi - int phi over
    each tetrahedron with phi linear."""
    n = np.asarray(plane_normal, dtype=np.float64)
    n = n / np.linalg.norm(n)
    p0 = np.asarray(plane_point, dtype=np.float64)

    def phi_of(pts):
        return (pts - p0) @ n

    tot_v = 0.0
    tot_i = 0.0
    for t in cell_tetrahedra(mesh, cell, face_map):
        v = _tet_volume(t)
        if v <= 0:
            continue
        phi = phi_of(t)
        i_all = v * phi.mean()
        i_pos = 0.0
        for tp in _positive_part_tets(t, phi):
            vp = _tet_volume(tp)
            i_pos += vp * phi_of(tp).mean()
        tot_i += 2.0 * i_pos - i_all
        tot_v += v
    return tot_i / max(tot_v, 1e-300)


def cell_face_node_lists(mesh):
    """Per-cell list of face node-coordinate arrays, built in ONE pass over
    the mesh (interior + boundary faces). Pass the result to
    ``cell_tetrahedra``/``mean_abs_distance`` when querying many cells —
    the per-call whole-mesh scan is O(n_faces) each otherwise."""
    nc = mesh.number_of_cells()
    pts = mesh.points
    out = [[] for _ in range(nc)]
    nb = mesh.neighborship()
    for f in range(nb.shape[0]):
        fp = pts[np.asarray(mesh.face_nodes[f])]
        out[int(nb[f, 0])].append(fp)
        out[int(nb[f, 1])].append(fp)
    for f in range(mesh.number_of_boundary_faces()):
        out[int(mesh.boundary_face_cells[f])].append(
            pts[np.asarray(mesh.boundary_face_nodes[f])])
    return out


def cell_bounding_radius(mesh_or_geo) -> np.ndarray:
    """Per-cell radius of a centroid-centered ball guaranteed to contain
    the (convex) cell — the sound prefilter radius for intersection
    queries. With mesh connectivity available this is the EXACT max vertex
    distance; from bare geometry it is the conservative bound
    (1 + dim) * max distance to an incident face centroid (covers
    simplices, where circumradius = dim * inradius, and anisotropic boxes
    — a volume-based estimate badly underestimates pancake cells)."""
    geo = _geometry(mesh_or_geo)
    cc = geo.cell_centroids
    nc = geo.n_cells
    mesh = mesh_or_geo if hasattr(mesh_or_geo, "tpfv_geometry") else None
    if (mesh is not None and hasattr(mesh, "points")
            and hasattr(mesh, "face_nodes")):
        r2 = np.zeros(nc)
        nb = np.asarray(mesh.neighborship(), dtype=np.int64).reshape(-1, 2)
        for fmap, owners in (
                (mesh.face_nodes, (nb[:, 0], nb[:, 1])),
                (mesh.boundary_face_nodes, (mesh.boundary_face_cells,))):
            if len(fmap) == 0:
                continue
            nodes, _ = fmap.padded()  # padding repeats a node: max unchanged
            P = mesh.points[nodes]
            for cells in owners:
                cells = np.asarray(cells, dtype=np.int64)
                d2 = np.sum((P - cc[cells][:, None, :]) ** 2, axis=2)
                np.maximum.at(r2, cells, d2.max(axis=1))
        return np.sqrt(r2)
    dim = cc.shape[1]
    r = np.zeros(nc)
    nb = np.asarray(geo.neighbors, dtype=np.int64).reshape(-1, 2)
    for side in (0, 1):
        d = np.linalg.norm(geo.face_centroids - cc[nb[:, side]], axis=1)
        np.maximum.at(r, nb[:, side], d)
    bn = np.asarray(geo.boundary_neighbors, dtype=np.int64)
    if bn.size:
        d = np.linalg.norm(geo.boundary_centroids - cc[bn], axis=1)
        np.maximum.at(r, bn, d)
    return (1.0 + dim) * r
