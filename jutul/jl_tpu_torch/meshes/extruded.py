"""Extruded (2.5D) meshes and mesh quality control.

Port of the JAX package's ``meshes/extruded.py`` (host numpy).
Counterparts of the reference extrusion and quality modules (reference:
src/meshes/extruded.jl — 2.5D extrusion of a 2D mesh into layers;
src/meshes/MeshQualityControl/ — face planarity checks/fixes).

``extrude_mesh``, the cell node loops and ``face_planarity`` work on all
faces or cells at once: the tables are equal to those of the JAX
package's per-face loops, face for face and node for node, and the
planarity SVDs run one LAPACK call per face as there.
"""

from __future__ import annotations

import copy

import numpy as np

from .unstructured import (
    IndirectionMap,
    UnstructuredMesh,
    _concat_maps,
    _fixed_map,
)


def _two_node_faces(fmap: IndirectionMap) -> np.ndarray:
    """(n, 2) node pairs of a 2D mesh's faces; like the JAX package's
    ``a, b = face_nodes[f]``, a face with more nodes raises."""
    cnt = fmap.counts()
    if cnt.size and np.any(cnt != 2):
        bad = int(cnt[cnt != 2][0])
        raise ValueError(f"too many values to unpack (expected 2, got {bad})"
                         if bad > 2 else
                         f"not enough values to unpack (expected 2, got "
                         f"{bad})")
    return fmap.vals.reshape(-1, 2)


def _layered_loops(loops: IndirectionMap, layers: np.ndarray, nn: int):
    """Each cell's node loop lifted to every layer of ``layers``, cell-major
    and layer-minor: rows loop_c + nn * k."""
    cnt = loops.counts()
    nk = len(layers)
    per = cnt * nk
    seg = np.repeat(np.arange(len(cnt)), per)
    start = np.concatenate([[0], np.cumsum(per)[:-1]])
    o = np.arange(int(per.sum())) - start[seg]
    k = layers[o // cnt[seg]]
    vals = loops.vals[loops.pos[seg] + o % cnt[seg]] + nn * k
    pos = np.concatenate([[0], np.cumsum(np.repeat(cnt, nk))])
    return IndirectionMap(vals, pos)


def extrude_mesh(mesh2d: UnstructuredMesh, layer_z) -> UnstructuredMesh:
    """Extrude a 2D mesh into prisms along z (reference extruded.jl).

    ``layer_z``: strictly increasing z-coordinates of the layer interfaces
    (n_layers + 1 values). Cell numbering: layer-major (all cells of layer
    0, then layer 1, ...), matching the slab-decomposition convention.
    Faces: the lateral faces of every 2D face (face-major, layer-minor),
    then the horizontal faces of every cell (cell-major); boundary faces
    likewise, each cell's bottom before its top.
    """
    if mesh2d.dim != 2:
        raise ValueError("extrude_mesh expects a 2D mesh")
    z = np.asarray(layer_z, dtype=np.float64)
    if np.any(np.diff(z) <= 0):
        raise ValueError("layer_z must be strictly increasing")
    nl = len(z) - 1
    pts2 = mesh2d.points
    nn = pts2.shape[0]
    nc2 = mesh2d.number_of_cells()

    pts = np.concatenate([
        np.concatenate([pts2, np.full((nn, 1), zz)], axis=1) for zz in z
    ])
    k = np.arange(nl)

    def lateral(ab):  # (m, 2) edges -> (m * nl, 4) quads, layer-minor
        a = ab[:, 0, None] + nn * k[None, :]
        b = ab[:, 1, None] + nn * k[None, :]
        return np.stack([a, b, b + nn, a + nn], axis=-1).reshape(-1, 4)

    ab = _two_node_faces(mesh2d.face_nodes)
    nb2 = np.asarray(mesh2d.face_neighbors, dtype=np.int64).reshape(-1, 2)
    lat_nbrs = (nb2[:, None, :] + nc2 * k[None, :, None]).reshape(-1, 2)
    bab = _two_node_faces(mesh2d.boundary_face_nodes)
    bc2 = np.asarray(mesh2d.boundary_face_cells, dtype=np.int64)
    lat_bcells = (bc2[:, None] + nc2 * k[None, :]).reshape(-1)

    loops = _cell_node_loop_map(mesh2d)
    c2 = np.arange(nc2)
    hor = _layered_loops(loops, np.arange(1, nl), nn)
    hor_nbrs = np.stack([(c2[:, None] + nc2 * k[None, :-1]).reshape(-1),
                         (c2[:, None] + nc2 * k[None, 1:]).reshape(-1)],
                        axis=1)
    caps = _layered_loops(loops, np.array([0, nl]), nn)
    cap_cells = np.stack([c2, c2 + nc2 * (nl - 1)], axis=1).reshape(-1)

    face_nodes = _concat_maps([_fixed_map(lateral(ab)), hor])
    neighbors = np.concatenate([lat_nbrs, hor_nbrs]).astype(np.int64)
    bnd_nodes = _concat_maps([_fixed_map(lateral(bab)), caps])
    bnd_cells = np.concatenate([lat_bcells, cap_cells]).astype(np.int64)
    return UnstructuredMesh(pts, face_nodes, neighbors.reshape(-1, 2),
                            bnd_nodes, bnd_cells)


def _cell_node_loop_map(mesh2d: UnstructuredMesh) -> IndirectionMap:
    """Ordered node loop per 2D cell, stitched from its edges, as an
    IndirectionMap. The JAX package's walk, for all cells at once: each
    cell's edges in the order interior faces (face order), then boundary
    faces; the loop starts at the first edge's first node, each step takes
    the first edge (in that order) holding the current node whose other
    end is not the previous node; a loop with a negative shoelace area is
    reversed."""
    nb = np.asarray(mesh2d.face_neighbors, dtype=np.int64).reshape(-1, 2)
    nf = nb.shape[0]
    ab = _two_node_faces(mesh2d.face_nodes)
    bab = _two_node_faces(mesh2d.boundary_face_nodes)
    bcells = np.asarray(mesh2d.boundary_face_cells, dtype=np.int64)
    owner = np.concatenate([nb[:, 0], nb[:, 1], bcells])
    key = np.concatenate([np.arange(nf), np.arange(nf),
                          nf + np.arange(len(bcells))])
    edges = np.concatenate([ab, ab, bab])
    order = np.lexsort((key, owner))
    owner, edges = owner[order], edges[order]
    nc = mesh2d.number_of_cells()
    cnt = np.bincount(owner, minlength=nc)
    m = int(cnt.max())
    slot = np.arange(len(owner)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    E = np.full((nc, m, 2), -1, dtype=np.int64)
    E[owner, slot] = edges

    start = E[:, 0, 0]
    loop = np.full((nc, m + 1), -1, dtype=np.int64)
    loop[:, 0] = start
    length = np.ones(nc, dtype=np.int64)
    prev, cur = start.copy(), E[:, 0, 1].copy()
    active = cur != start
    rows = np.arange(nc)
    for _ in range(m):
        if not active.any():
            break
        loop[rows[active], length[active]] = cur[active]
        length += active
        other = np.where(E[:, :, 0] == cur[:, None], E[:, :, 1],
                         np.where(E[:, :, 1] == cur[:, None], E[:, :, 0],
                                  -1))
        ok = (other >= 0) & (other != prev[:, None])
        nxt = other[rows, np.argmax(ok, axis=1)]
        prev = np.where(active, cur, prev)
        cur = np.where(active, nxt, cur)
        active &= cur != start
    if active.any():
        raise ValueError("a 2D cell's edges do not close into one loop")

    # orient counter-clockwise (positive shoelace), per loop length
    P = mesh2d.points
    for L in np.unique(length):
        sel = np.flatnonzero(length == L)
        lp = loop[sel, :L]
        X, Y = P[lp, 0], P[lp, 1]
        area2 = (np.einsum("ij,ij->i", X, np.roll(Y, -1, axis=1))
                 - np.einsum("ij,ij->i", Y, np.roll(X, -1, axis=1)))
        flip = sel[area2 < 0]
        loop[flip, :L] = loop[flip, :L][:, ::-1]
    mask = np.arange(m + 1)[None, :] < length[:, None]
    return IndirectionMap(loop[mask],
                          np.concatenate([[0], np.cumsum(length)]))


def _cell_node_loops(mesh2d: UnstructuredMesh) -> list[list[int]]:
    """Ordered node loop per 2D cell (lists, as the JAX package's)."""
    loops = _cell_node_loop_map(mesh2d)
    return [loops[c].tolist() for c in range(len(loops))]


# ---------------------------------------------------------------------------
# mesh quality control (reference MeshQualityControl: face planarity)
# ---------------------------------------------------------------------------
def face_planarity(mesh: UnstructuredMesh) -> np.ndarray:
    """Max node deviation from each face's best-fit plane, normalized by
    the face diameter (0 = planar). Reference MeshQualityControl checks.
    Faces are taken in groups of equal node count."""
    out = np.zeros(mesh.number_of_faces())
    if mesh.dim == 2:
        return out
    cnt = mesh.face_nodes.counts()
    for m in np.unique(cnt[cnt > 3]):
        f = np.flatnonzero(cnt == m)
        idx = mesh.face_nodes.pos[f, None] + np.arange(m)[None, :]
        P = mesh.points[mesh.face_nodes.vals[idx]]  # (k, m, 3)
        Q = P - P.mean(axis=1, keepdims=True)
        _, _, vt = np.linalg.svd(Q, full_matrices=False)
        normal = vt[:, -1, :]
        dev = np.abs(np.einsum("kmi,ki->km", Q, normal)).max(axis=1)
        diam = np.linalg.norm(Q, axis=2).max(axis=1) * 2
        out[f] = dev / np.maximum(diam, 1e-300)
    return out


def check_mesh_quality(mesh: UnstructuredMesh, planarity_tol: float = 0.05):
    """Return dict of quality metrics + list of offending faces
    (reference MeshQualityControl report)."""
    geo = mesh.tpfv_geometry()
    plan = face_planarity(mesh)
    bad = np.where(plan > planarity_tol)[0]
    return {
        "min_volume": float(geo.volumes.min()) if geo.n_cells else 0.0,
        "max_planarity_deviation": float(plan.max()) if plan.size else 0.0,
        "nonplanar_faces": bad,
        "negative_volume_cells": np.where(geo.volumes <= 0)[0],
    }


def check_mesh(mesh: UnstructuredMesh, verbose: bool = False,
               extra_out: bool = False):
    """Full mesh quality check (reference MeshQualityControl/interface.jl
    check_mesh): non-positive/non-finite cell volumes and face areas, and
    face-normal orientation (normal must point away from the left cell,
    check_faces.jl check_normal)."""
    try:
        geo = mesh.tpfv_geometry(strict=False)
    except TypeError:  # mesh types without a non-strict path
        geo = mesh.tpfv_geometry()

    def _bad_positive(arr):
        arr = np.asarray(arr)
        return np.where(~np.isfinite(arr) | (arr <= 0.0))[0]

    bad = {"bad_volumes": _bad_positive(geo.volumes),
           "bad_internal_areas": _bad_positive(geo.areas),
           "bad_boundary_areas": _bad_positive(geo.boundary_areas)}

    def _bad_normals(cells, fcent, normals):
        if len(cells) == 0:
            return np.zeros(0, dtype=np.int64)
        to_face = fcent - geo.cell_centroids[cells]
        return np.where(np.einsum("fi,fi->f", to_face, normals) < 0.0)[0]

    bad["bad_internal_faces"] = _bad_normals(
        geo.neighbors[:, 0], geo.face_centroids, geo.normals)
    bad["bad_boundary_faces"] = _bad_normals(
        geo.boundary_neighbors, geo.boundary_centroids, geo.boundary_normals)
    ok = all(len(v) == 0 for v in bad.values())
    if verbose:
        from ..simulator.reporting import jutul_message

        for key, v in bad.items():
            if len(v):
                jutul_message("Mesh quality", f"{key}: {len(v)} offenders",
                              color="yellow")
        if ok:
            jutul_message("Mesh quality", "No issues detected.",
                          color="green")
    return (ok, bad) if extra_out else ok


def check_and_fix_mesh(mesh: UnstructuredMesh, verbose: bool = False):
    """Check and automatically fix what can be fixed (reference
    check_and_fix_mesh!, interface.jl): wrongly-oriented face normals are
    repaired by reversing the face's node order; non-positive volumes/areas
    are reported but not fixable. Returns a fixed copy."""
    ok, bad = check_mesh(mesh, verbose=verbose, extra_out=True)
    if ok:
        return mesh
    mesh = copy.deepcopy(mesh)
    for key, fn in (("bad_internal_faces", mesh.face_nodes),
                    ("bad_boundary_faces", mesh.boundary_face_nodes)):
        for f in bad[key]:
            lo, hi = fn.pos[f], fn.pos[f + 1]
            fn.vals[lo:hi] = fn.vals[lo:hi][::-1]
    mesh._geo = None  # geometry cache now stale
    if verbose:
        from ..simulator.reporting import jutul_message

        ok_after = check_mesh(mesh, verbose=verbose)
        color = "green" if ok_after else "yellow"
        msg = ("issues resolved" if ok_after
               else "issues remain; manual intervention may be required")
        jutul_message("Mesh fixing", msg, color=color)
    return mesh
