"""Plotting utilities (matplotlib-optional).

Port of the JAX package's ``utils/plotting.py``. Counterpart of the
reference Makie extension (reference: ext/JutulMakieExt
— mesh plots, interactive inspector, performance plots performance.jl,
GraphMakie model graph; stubs in src/makie_ext.jl). matplotlib is optional:
every function raises a clear error when it is unavailable, mirroring the
reference's weak-dependency extension pattern.
"""

from __future__ import annotations

import numpy as np


def _mpl():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception as e:  # pragma: no cover
        raise ImportError(
            "matplotlib is required for plotting (optional dependency, "
            "like the reference's Makie extension)") from e


def plot_cell_data(mesh, values, ax=None, cmap="viridis", title=None):
    """Color cells by a scalar field (reference plot_cell_data).

    2D Cartesian -> pcolormesh; 3D Cartesian -> top-layer slice;
    unstructured 2D -> polygon patches.
    """
    plt = _mpl()
    from ..meshes.cartesian import CartesianMesh

    values = np.asarray(values)
    if ax is None:
        _, ax = plt.subplots()
    if isinstance(mesh, CartesianMesh):
        dims3 = mesh._dims3()
        nx, ny, nz = dims3
        if mesh.dim == 1:
            ax.plot(np.arange(nx), values)
        else:
            img = values.reshape(nz, ny, nx)[-1] if mesh.dim == 3 else \
                values.reshape(ny, nx)
            pc = ax.pcolormesh(img, cmap=cmap)
            plt.colorbar(pc, ax=ax)
    else:
        from matplotlib.collections import PolyCollection

        from ..meshes.unstructured import UnstructuredMesh

        if not isinstance(mesh, UnstructuredMesh) or mesh.dim != 2:
            raise NotImplementedError("plot_cell_data: 2D meshes only")
        from ..meshes.extruded import _cell_node_loops

        loops = _cell_node_loops(mesh)
        polys = [mesh.points[l] for l in loops]
        pc = PolyCollection(polys, array=values, cmap=cmap)
        ax.add_collection(pc)
        ax.autoscale()
        plt.colorbar(pc, ax=ax)
    if title:
        ax.set_title(title)
    return ax


def plot_performance(reports, ax=None):
    """Newton/ministep performance bars (reference JutulMakieExt
    performance.jl)."""
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots()
    its = [sum(m.get("iterations", 0) for m in r.get("ministeps", []))
           for r in reports]
    wall = [sum(m.get("wall_time", 0.0) for m in r.get("ministeps", []))
            for r in reports]
    x = np.arange(len(reports))
    ax.bar(x - 0.2, its, width=0.4, label="Newton its")
    ax2 = ax.twinx()
    ax2.bar(x + 0.2, wall, width=0.4, color="tab:orange", label="wall [s]")
    ax.set_xlabel("report step")
    ax.set_ylabel("iterations")
    ax2.set_ylabel("wall time [s]")
    return ax


def model_variable_graph(model) -> str:
    """Graphviz DOT of the secondary-variable dependency graph (reference
    GraphMakie model graph). Returns DOT source (no graphviz needed)."""
    lines = ["digraph model {", "  rankdir=LR;"]
    for name in model.primary_variables:
        lines.append(f'  "{name}" [shape=box, style=filled, '
                     'fillcolor=lightblue];')
    for name in model.parameters:
        lines.append(f'  "{name}" [shape=box, style=filled, '
                     'fillcolor=lightgray];')
    for name, var in model.secondary_variables.items():
        lines.append(f'  "{name}" [shape=ellipse];')
        for dep in var.dependencies:
            lines.append(f'  "{dep}" -> "{name}";')
    for name, eq in model.equations.items():
        lines.append(f'  "eq:{name}" [shape=diamond, style=filled, '
                     'fillcolor=lightsalmon];')
    lines.append("}")
    return "\n".join(lines)


def save_figure(ax, path) -> str:
    plt = _mpl()
    fig = ax.get_figure()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return str(path)


def triangulate_mesh(mesh, outer: bool = True):
    """Triangulate a mesh surface for visualization (reference
    ``triangulate_mesh`` — src/meshes/, used by the Makie extension).

    Pure numpy; no matplotlib required. Returns a dict with

    - ``points``: (n_pts, dim) node coordinates,
    - ``triangles``: (n_tri, 3) int indices into ``points``,
    - ``cells``: (n_tri,) the source cell of each triangle (the "mapping"
      the reference returns so per-cell fields color triangles).

    2D meshes fan-triangulate every cell polygon; 3D meshes triangulate
    the boundary faces (the visible surface). Cartesian meshes convert
    through :meth:`UnstructuredMesh.from_cartesian` first.
    """
    from ..meshes.cartesian import CartesianMesh
    from ..meshes.unstructured import UnstructuredMesh

    if isinstance(mesh, CartesianMesh):
        mesh = UnstructuredMesh.from_cartesian(mesh)
    if not isinstance(mesh, UnstructuredMesh):
        raise TypeError(f"triangulate_mesh: unsupported mesh {type(mesh)}")

    tris = []
    cells = []

    def fan(loop, cell):
        for k in range(1, len(loop) - 1):
            tris.append((loop[0], loop[k], loop[k + 1]))
            cells.append(cell)

    if mesh.dim == 2:
        from ..meshes.extruded import _cell_node_loops

        for c, loop in enumerate(_cell_node_loops(mesh)):
            fan(list(loop), c)
    else:
        bnodes = mesh.boundary_face_nodes
        bcells = mesh.boundary_face_cells
        for f in range(len(bnodes)):
            fan(list(bnodes[f]), int(bcells[f]))
        if not outer:
            # include interior faces, attributed to the lower-index cell
            fnodes = mesh.face_nodes
            nb = mesh.face_neighbors
            for f in range(len(fnodes)):
                fan(list(fnodes[f]), int(min(nb[f])))

    return {
        "points": np.asarray(mesh.points, dtype=np.float64),
        "triangles": np.asarray(tris, dtype=np.int64).reshape(-1, 3),
        "cells": np.asarray(cells, dtype=np.int64),
    }
