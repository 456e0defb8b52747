"""Radial and spiral meshes (wellbore gridding).

Port of the JAX package's ``meshes/radial.py`` (host numpy). Counterpart of the reference RadialMeshes module (reference:
src/meshes/RadialMeshes/ — radial & spiral meshes for wellbore modeling,
exported via src/Jutul.jl). Built as UnstructuredMesh instances: rings of
quadrilateral cells around an axis, optionally with a spiral offset.
"""

from __future__ import annotations

import numpy as np

from .unstructured import UnstructuredMesh


def radial_mesh(radii, n_sectors: int, centerpoint: bool = False,
                origin=(0.0, 0.0)) -> UnstructuredMesh:
    """2D radial mesh: ``len(radii)-1`` rings x ``n_sectors`` sectors of
    quads (reference radial_mesh).

    ``radii`` must be strictly increasing; ``centerpoint=False`` leaves a
    hole of radius ``radii[0]`` (wellbore).
    """
    radii = np.asarray(radii, dtype=np.float64)
    if np.any(np.diff(radii) <= 0):
        raise ValueError("radii must be strictly increasing")
    n_r = len(radii) - 1
    m = int(n_sectors)
    if m < 3:
        raise ValueError("need at least 3 sectors")
    theta = 2 * np.pi * np.arange(m) / m
    ox, oy = origin

    # nodes: ring-major
    pts = []
    for r in radii:
        for t in theta:
            pts.append([ox + r * np.cos(t), oy + r * np.sin(t)])
    pts = np.asarray(pts)

    def nid(ring, sector):
        return ring * m + (sector % m)

    def cid(ring, sector):
        return ring * m + (sector % m)

    # interior faces: radial faces (between sectors) + ring faces
    face_nodes, neighbors = [], []
    for i in range(n_r):
        for j in range(m):
            # radial face between cell (i, j-1) and (i, j) at angle theta_j
            face_nodes.append([nid(i, j), nid(i + 1, j)])
            neighbors.append([cid(i, j - 1), cid(i, j)])
    for i in range(1, n_r):
        for j in range(m):
            # ring face between cell (i-1, j) and (i, j)
            face_nodes.append([nid(i, j), nid(i, j + 1)])
            neighbors.append([cid(i - 1, j), cid(i, j)])

    bnd_nodes, bnd_cells = [], []
    for j in range(m):  # inner boundary
        bnd_nodes.append([nid(0, j), nid(0, j + 1)])
        bnd_cells.append(cid(0, j))
    for j in range(m):  # outer boundary
        bnd_nodes.append([nid(n_r, j), nid(n_r, j + 1)])
        bnd_cells.append(cid(n_r - 1, j))

    return UnstructuredMesh(pts, face_nodes, np.asarray(neighbors),
                            bnd_nodes, bnd_cells)


def spiral_mesh(r_inner: float, pitch: float, n_turns: float,
                n_per_turn: int = 32, width_cells: int = 1) -> UnstructuredMesh:
    """2D spiral (Archimedean) strip mesh (reference spiral_mesh):
    quad cells following r = r_inner + pitch * phi / (2 pi)."""
    n_seg = int(round(n_turns * n_per_turn))
    if n_seg < 1:
        raise ValueError("need at least one segment")
    phis = 2 * np.pi * np.arange(n_seg + 1) / n_per_turn
    w = pitch  # strip width equals pitch so successive turns touch

    pts = []
    for k, phi in enumerate(phis):
        r0 = r_inner + pitch * phi / (2 * np.pi)
        for layer in range(width_cells + 1):
            r = r0 + w * layer / width_cells
            pts.append([r * np.cos(phi), r * np.sin(phi)])
    pts = np.asarray(pts)
    L = width_cells + 1

    def nid(seg, layer):
        return seg * L + layer

    def cid(seg, layer):
        return seg * width_cells + layer

    face_nodes, neighbors = [], []
    # cross faces between consecutive segments
    for s in range(1, n_seg):
        for l in range(width_cells):
            face_nodes.append([nid(s, l), nid(s, l + 1)])
            neighbors.append([cid(s - 1, l), cid(s, l)])
    # layer faces within a segment
    for s in range(n_seg):
        for l in range(1, width_cells):
            face_nodes.append([nid(s, l), nid(s + 1, l)])
            neighbors.append([cid(s, l - 1), cid(s, l)])

    bnd_nodes, bnd_cells = [], []
    for s in range(n_seg):
        bnd_nodes.append([nid(s, 0), nid(s + 1, 0)])
        bnd_cells.append(cid(s, 0))
        bnd_nodes.append([nid(s, width_cells), nid(s + 1, width_cells)])
        bnd_cells.append(cid(s, width_cells - 1))
    bnd_nodes.append([nid(0, 0), nid(0, width_cells)])
    bnd_cells.append(cid(0, 0))
    bnd_nodes.append([nid(n_seg, 0), nid(n_seg, width_cells)])
    bnd_cells.append(cid(n_seg - 1, 0))

    return UnstructuredMesh(pts, face_nodes, np.asarray(neighbors),
                            bnd_nodes, bnd_cells)
