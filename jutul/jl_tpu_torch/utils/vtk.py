"""VTK export (dependency-free .vtu / .pvd writers).

Port of the JAX package's ``utils/vtk.py``. Counterpart of the reference
VTK extension (reference: ext/JutulWriteVTKExt:45-223 — ``export_mesh_vtu``
+ PVD time series via WriteVTK.jl). Here plain XML VTK (ascii) is emitted
directly so no external package is needed. A ``CartesianMesh`` is written
as the JAX package writes it (hexahedra or quads, the same text); the port
also writes an ``UnstructuredMesh``, which the JAX package refuses: 2D
cells as polygons, 3D cells as VTK polyhedra (their points and their
faces, interior faces in face order then boundary faces).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_VTK_HEX = 12
_VTK_QUAD = 9
_VTK_POLY = 7
_VTK_POLYHEDRON = 42


def _cartesian_cells_to_vtk(mesh):
    """points + connectivity for a CartesianMesh."""
    dims3 = mesh._dims3()
    nx, ny, nz = dims3
    axes = mesh._node_axes()
    while len(axes) < 3:
        axes.append(np.array([0.0, 1.0]) if mesh.dim < 3 else axes[-1])
    Z, Y, X = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
    pts = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=1)
    npx, npy = nx + 1, ny + 1

    def nid(i, j, k):
        return i + npx * (j + npy * k)

    cells = []
    if mesh.dim <= 2:
        for j in range(ny):
            for i in range(nx):
                cells.append([nid(i, j, 0), nid(i + 1, j, 0),
                              nid(i + 1, j + 1, 0), nid(i, j + 1, 0)])
        ctype = _VTK_QUAD
    else:
        for k in range(nz):
            for j in range(ny):
                for i in range(nx):
                    cells.append([
                        nid(i, j, k), nid(i + 1, j, k), nid(i + 1, j + 1, k),
                        nid(i, j + 1, k), nid(i, j, k + 1),
                        nid(i + 1, j, k + 1), nid(i + 1, j + 1, k + 1),
                        nid(i, j + 1, k + 1),
                    ])
        ctype = _VTK_HEX
    return pts, cells, ctype


def _ints(a) -> str:
    return " ".join(map(str, np.asarray(a, dtype=np.int64).tolist()))


def _unstructured_cells_to_vtk(mesh):
    """points (3D), connectivity, offsets, types and, in 3D, the
    polyhedron face stream and its offsets of an UnstructuredMesh."""
    from ..meshes.extruded import _cell_node_loop_map

    nc = mesh.number_of_cells()
    pts = mesh.points
    if mesh.dim == 2:
        loops = _cell_node_loop_map(mesh)
        pts = np.concatenate([pts, np.zeros((len(pts), 1))], axis=1)
        return (pts, loops.vals, loops.pos[1:], np.full(nc, _VTK_POLY),
                None, None)
    nb = np.asarray(mesh.face_neighbors, dtype=np.int64).reshape(-1, 2)
    nf = nb.shape[0]
    bc = np.asarray(mesh.boundary_face_cells, dtype=np.int64)
    fn, bfn = mesh.face_nodes, mesh.boundary_face_nodes
    # one entry per (cell, incident face), by cell, faces in face order
    owner = np.concatenate([nb[:, 0], nb[:, 1], bc])
    key = np.concatenate([np.arange(nf), np.arange(nf), nf + np.arange(len(bc))])
    order = np.lexsort((key, owner))
    owner, key = owner[order], key[order]
    vals = np.concatenate([fn.vals, bfn.vals])
    pos = np.concatenate([fn.pos[:-1], len(fn.vals) + bfn.pos])
    cnt = pos[key + 1] - pos[key]
    # face stream per cell: n_faces, then per face its count and nodes
    n_faces = np.bincount(owner, minlength=nc)
    per_cell = n_faces + np.bincount(owner, weights=cnt + 1,
                                     minlength=nc).astype(np.int64)
    fend = np.cumsum(per_cell)
    stream = np.empty(int(fend[-1]), dtype=np.int64)
    cstart = fend - per_cell
    stream[cstart] = n_faces
    # each face's slot: after its cell's header and the faces before it
    first = np.searchsorted(owner, np.arange(nc))
    rank_len = np.cumsum(cnt + 1) - (cnt + 1)
    fslot = cstart[owner] + 1 + rank_len - rank_len[first[owner]]
    stream[fslot] = cnt
    within = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    stream[np.repeat(fslot + 1, cnt) + within] = \
        vals[np.repeat(pos[key], cnt) + within]
    # connectivity: each cell's distinct nodes, ascending
    cell_of_node = np.repeat(owner, cnt)
    node = vals[np.repeat(pos[key], cnt) + within]
    pair = np.unique(cell_of_node * len(pts) + node)
    conn = pair % len(pts)
    offsets = np.cumsum(np.bincount(pair // len(pts), minlength=nc))
    return (pts, conn, offsets, np.full(nc, _VTK_POLYHEDRON), stream, fend)


def export_mesh_vtu(path, mesh, cell_data: dict | None = None) -> str:
    """Write mesh + per-cell fields to a .vtu file
    (reference export_mesh_vtu)."""
    from ..meshes.cartesian import CartesianMesh
    from ..meshes.unstructured import UnstructuredMesh

    faces = faceoffsets = None
    if isinstance(mesh, CartesianMesh):
        pts, cells, ctype = _cartesian_cells_to_vtk(mesh)
        n_cells = len(cells)
        conn = np.concatenate([np.asarray(c) for c in cells])
        offsets = np.cumsum([len(c) for c in cells])
        types = " ".join(str(ctype) for _ in range(n_cells))
    elif isinstance(mesh, UnstructuredMesh):
        pts, conn, offsets, types, faces, faceoffsets = \
            _unstructured_cells_to_vtk(mesh)
        n_cells = len(offsets)
        types = _ints(types)
    else:
        raise NotImplementedError(
            "vtu export supports CartesianMesh and UnstructuredMesh; "
            "convert other meshes via their cell data")
    path = Path(path)
    if path.suffix != ".vtu":
        path = path.with_suffix(".vtu")
    lines = []
    w = lines.append
    w('<?xml version="1.0"?>')
    w('<VTKFile type="UnstructuredGrid" version="0.1" '
      'byte_order="LittleEndian">')
    w("  <UnstructuredGrid>")
    w(f'    <Piece NumberOfPoints="{pts.shape[0]}" '
      f'NumberOfCells="{n_cells}">')
    w("      <Points>")
    w('        <DataArray type="Float64" NumberOfComponents="3" '
      'format="ascii">')
    for p in pts:
        w(f"          {p[0]:.10g} {p[1]:.10g} {p[2]:.10g}")
    w("        </DataArray>")
    w("      </Points>")
    w("      <Cells>")
    w('        <DataArray type="Int64" Name="connectivity" format="ascii">')
    w("          " + _ints(conn))
    w("        </DataArray>")
    w('        <DataArray type="Int64" Name="offsets" format="ascii">')
    w("          " + _ints(offsets))
    w("        </DataArray>")
    w('        <DataArray type="UInt8" Name="types" format="ascii">')
    w("          " + types)
    w("        </DataArray>")
    if faces is not None:
        w('        <DataArray type="Int64" Name="faces" format="ascii">')
        w("          " + _ints(faces))
        w("        </DataArray>")
        w('        <DataArray type="Int64" Name="faceoffsets" '
          'format="ascii">')
        w("          " + _ints(faceoffsets))
        w("        </DataArray>")
    w("      </Cells>")
    w("      <CellData>")
    for name, arr in (cell_data or {}).items():
        arr = np.asarray(arr, dtype=np.float64)
        ncomp = 1 if arr.ndim == 1 else arr.shape[1]
        w(f'        <DataArray type="Float64" Name="{name}" '
          f'NumberOfComponents="{ncomp}" format="ascii">')
        flat = arr.reshape(-1)
        w("          " + " ".join(f"{v:.10g}" for v in flat))
        w("        </DataArray>")
    w("      </CellData>")
    w("    </Piece>")
    w("  </UnstructuredGrid>")
    w("</VTKFile>")
    path.write_text("\n".join(lines))
    return str(path)


def export_time_series_pvd(path, mesh, states: list, dts, fields=None) -> str:
    """Write a PVD time series of .vtu snapshots
    (reference PVD output, JutulWriteVTKExt)."""
    path = Path(path)
    base = path.with_suffix("")
    base.parent.mkdir(parents=True, exist_ok=True)
    t = 0.0
    entries = []
    for i, st in enumerate(states):
        t += float(dts[i]) if i < len(dts) else 0.0
        data = {}
        for name, arr in st.items():
            if name == "substates" or not isinstance(arr, np.ndarray):
                continue
            if fields is not None and name not in fields:
                continue
            data[name] = arr
        fn = export_mesh_vtu(f"{base}_{i:04d}.vtu", mesh, data)
        entries.append((t, Path(fn).name))
    lines = ['<?xml version="1.0"?>',
             '<VTKFile type="Collection" version="0.1">',
             "  <Collection>"]
    for t, fn in entries:
        lines.append(f'    <DataSet timestep="{t}" file="{fn}"/>')
    lines += ["  </Collection>", "</VTKFile>"]
    pvd = base.with_suffix(".pvd")
    pvd.write_text("\n".join(lines))
    return str(pvd)
