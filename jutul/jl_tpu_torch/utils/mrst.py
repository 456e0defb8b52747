"""MRST grid import (MATLAB .mat files).

Port of the JAX package's ``utils/mrst.py`` (host numpy).
Counterpart of the reference ``MRSTWrapMesh`` (reference:
src/meshes/mrst.jl:1-296 — wraps a MATLAB MRST ``G`` struct loaded via
MAT.jl). Here scipy.io loads the .mat file and the G struct is converted to
an :class:`UnstructuredMesh` (1-based -> 0-based indices; MRST stores
faces.nodes / cells.faces as CSR-style position arrays).
"""

from __future__ import annotations

import numpy as np

from ..meshes.unstructured import UnstructuredMesh


def _field(s, name):
    """Fetch a field from a scipy loadmat struct (mat_struct or ndarray)."""
    if hasattr(s, name):
        return getattr(s, name)
    if isinstance(s, np.ndarray) and s.dtype.names and name in s.dtype.names:
        v = s[name]
        while isinstance(v, np.ndarray) and v.size == 1 and v.dtype == object:
            v = v.item()
        return v
    raise KeyError(name)


def mesh_from_mrst_grid(G) -> UnstructuredMesh:
    """Convert an MRST ``G`` struct (already loaded) to UnstructuredMesh."""
    nodes = _field(G, "nodes")
    faces = _field(G, "faces")
    coords = np.asarray(_field(nodes, "coords"), dtype=np.float64)
    f_nodes = np.asarray(_field(faces, "nodes")).reshape(-1).astype(np.int64) - 1
    f_pos = np.asarray(_field(faces, "nodePos")).reshape(-1).astype(np.int64) - 1
    nb = np.asarray(_field(faces, "neighbors"), dtype=np.int64)
    if nb.shape[0] == 2 and nb.shape[1] != 2:
        nb = nb.T
    nb = nb - 1  # 0 -> -1 marks the boundary side

    face_nodes_int, neighbors = [], []
    bnd_nodes, bnd_cells = [], []
    nf = nb.shape[0]
    for f in range(nf):
        fn = f_nodes[f_pos[f]:f_pos[f + 1]].tolist()
        l, r = int(nb[f, 0]), int(nb[f, 1])
        if l >= 0 and r >= 0:
            face_nodes_int.append(fn)
            neighbors.append([l, r])
        else:
            bnd_nodes.append(fn)
            bnd_cells.append(max(l, r))
    return UnstructuredMesh(
        coords, face_nodes_int,
        np.asarray(neighbors, dtype=np.int64).reshape(-1, 2),
        bnd_nodes, bnd_cells)


def mesh_from_mat(path, grid_name: str = "G") -> UnstructuredMesh:
    """Load an MRST grid from a .mat file (reference MRSTWrapMesh(path))."""
    from scipy.io import loadmat

    data = loadmat(path, squeeze_me=True, struct_as_record=False)
    if grid_name not in data:
        raise KeyError(f"no variable {grid_name!r} in {path}; "
                       f"found {sorted(k for k in data if not k.startswith('__'))}")
    return mesh_from_mrst_grid(data[grid_name])


MRSTWrapMesh = mesh_from_mat  # reference-parity alias
