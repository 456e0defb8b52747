"""Gmsh .msh import (dependency-free ASCII parser).

Port of the JAX package's ``utils/gmsh.py`` (host numpy).
Counterpart of the reference Gmsh extension (reference: ext/JutulGmshExt —
``mesh_from_gmsh``; the reference binds the Gmsh C library, here the MSH
ASCII formats 2.2 and 4.1 are parsed directly). Elements become cells
(triangles/quads in 2D; tetrahedra/hexahedra/prisms/pyramids in 3D); faces
are derived by enumerating element facets and matching shared ones.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..meshes.unstructured import UnstructuredMesh

# gmsh element type -> (n_nodes, facet template, dimension)
_TRI, _QUAD, _TET, _HEX, _PRISM, _PYR = 2, 3, 4, 5, 6, 7
_FACETS = {
    _TRI: ([[0, 1], [1, 2], [2, 0]], 2, 3),
    _QUAD: ([[0, 1], [1, 2], [2, 3], [3, 0]], 2, 4),
    _TET: ([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]], 3, 4),
    _HEX: ([[0, 3, 2, 1], [4, 5, 6, 7], [0, 1, 5, 4], [1, 2, 6, 5],
            [2, 3, 7, 6], [3, 0, 4, 7]], 3, 8),
    _PRISM: ([[0, 2, 1], [3, 4, 5], [0, 1, 4, 3], [1, 2, 5, 4],
              [2, 0, 3, 5]], 3, 6),
    _PYR: ([[0, 3, 2, 1], [0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]], 3, 5),
}


def _parse_msh2(lines):
    nodes, elements = {}, []
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line == "$Nodes":
            count = int(lines[i + 1])
            for j in range(count):
                parts = lines[i + 2 + j].split()
                nodes[int(parts[0])] = [float(x) for x in parts[1:4]]
            i += count + 2
        elif line == "$Elements":
            count = int(lines[i + 1])
            for j in range(count):
                parts = [int(x) for x in lines[i + 2 + j].split()]
                etype = parts[1]
                ntags = parts[2]
                elements.append((etype, parts[3 + ntags:]))
            i += count + 2
        i += 1
    return nodes, elements


def _parse_msh4(lines):
    nodes, elements = {}, []
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line == "$Nodes":
            hdr = lines[i + 1].split()
            n_blocks = int(hdr[0])
            k = i + 2
            for _ in range(n_blocks):
                bh = lines[k].split()
                n_in_block = int(bh[3])
                tags = [int(lines[k + 1 + t]) for t in range(n_in_block)]
                for t in range(n_in_block):
                    xyz = lines[k + 1 + n_in_block + t].split()
                    nodes[tags[t]] = [float(x) for x in xyz[:3]]
                k += 1 + 2 * n_in_block
            i = k
        elif line == "$Elements":
            hdr = lines[i + 1].split()
            n_blocks = int(hdr[0])
            k = i + 2
            for _ in range(n_blocks):
                bh = lines[k].split()
                etype = int(bh[2])
                n_in_block = int(bh[3])
                for t in range(n_in_block):
                    parts = [int(x) for x in lines[k + 1 + t].split()]
                    elements.append((etype, parts[1:]))
                k += 1 + n_in_block
            i = k
        i += 1
    return nodes, elements


def mesh_from_gmsh(path) -> UnstructuredMesh:
    """Read a .msh file into an UnstructuredMesh (reference mesh_from_gmsh).

    The mesh dimension is the maximum element dimension present; lower-
    dimensional elements are ignored (they usually tag boundaries).
    """
    lines = Path(path).read_text().splitlines()
    version = None
    for i, line in enumerate(lines):
        if line.strip() == "$MeshFormat":
            version = float(lines[i + 1].split()[0])
            break
    if version is None:
        raise ValueError("not a Gmsh MSH file (no $MeshFormat)")
    nodes, elements = (_parse_msh2 if version < 4 else _parse_msh4)(lines)

    dims = [_FACETS[e][1] for e, _ in elements if e in _FACETS]
    if not dims:
        raise ValueError("no supported volume/surface elements found")
    dim = max(dims)
    cells = [(e, nds) for e, nds in elements
             if e in _FACETS and _FACETS[e][1] == dim]

    # renumber nodes densely
    tags = sorted(nodes)
    tag2id = {t: i for i, t in enumerate(tags)}
    pts = np.asarray([nodes[t] for t in tags])
    if dim == 2:
        pts = pts[:, :2]

    # enumerate facets, match shared pairs
    facet_map: dict[tuple, list] = {}
    for ci, (etype, nds) in enumerate(cells):
        templates, _, n_nodes = _FACETS[etype]
        local = [tag2id[t] for t in nds[:n_nodes]]
        for tpl in templates:
            fn = [local[j] for j in tpl]
            key = tuple(sorted(fn))
            facet_map.setdefault(key, []).append((ci, fn))
    face_nodes, neighbors, bnd_nodes, bnd_cells = [], [], [], []
    for key, owners in facet_map.items():
        if len(owners) == 2:
            (c1, fn1), (c2, _fn2) = owners
            face_nodes.append(fn1)
            neighbors.append([c1, c2])
        elif len(owners) == 1:
            (c1, fn1), = owners
            bnd_nodes.append(fn1)
            bnd_cells.append(c1)
        else:
            raise ValueError(f"facet shared by {len(owners)} cells")
    return UnstructuredMesh(pts, face_nodes,
                            np.asarray(neighbors, dtype=np.int64).reshape(-1, 2),
                            bnd_nodes, bnd_cells)
