"""Domain-decomposition submodel extraction.

Port of the JAX package's ``parallel/dd.py`` (reference: src/dd/ —
``submodel`` submodels.jl:2, ``subdomain``/``submap_cells`` (overlap/ghost
buffer) subdomains.jl:58,77, ``substate`` substate.jl:2, ``subforces``;
``FiniteVolumeGlobalMap`` core_types.jl:699-737 marking owned-interior /
owned-boundary / ghost cells). Host numpy; the ghost rings, the subset
meshes and the remapped forces equal the JAX package's.

The SPMD engines (``sharded.py``, ``general.py``) build no per-shard
submodel objects; this explicit extraction serves block preconditioning,
debugging and inspection of a partition.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np

from ..core.domains import DataDomain
from ..core.entities import CELLS, FACES
from ..meshes.cartesian import JutulMesh
from ..meshes.geometry import TwoPointFiniteVolumeGeometry


@dataclass
class FiniteVolumeGlobalMap:
    """Local<->global cell maps with ghost marking
    (reference core_types.jl:699)."""

    cells: np.ndarray  # local -> global
    full_to_inner: dict  # global -> local
    cell_is_ghost: np.ndarray  # bool per local cell
    faces: np.ndarray  # local faces -> global faces

    @property
    def n_owned(self) -> int:
        return int((~self.cell_is_ghost).sum())

    def inner_to_full(self, i: int) -> int:
        return int(self.cells[i])


def subcells_with_overlap(neighbors: np.ndarray, owned: np.ndarray,
                          buffer: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Owned cells + ``buffer`` rings of ghost neighbors, each ring sorted
    (reference submap_cells, dd/subdomains.jl:77).

    Returns (cells, is_ghost) with owned cells first."""
    owned = np.asarray(owned, dtype=np.int64)
    nb = np.asarray(neighbors, dtype=np.int64).reshape(-1, 2)
    n = int(max(nb.max(initial=-1), owned.max(initial=-1))) + 1
    in_set = np.zeros(n, dtype=bool)
    in_set[owned] = True
    current = in_set.copy()
    ghosts = []
    a, b = nb[:, 0], nb[:, 1]
    for _ in range(buffer):
        nxt = np.zeros(n, dtype=bool)
        nxt[b[current[a] & ~in_set[b]]] = True
        nxt[a[current[b] & ~in_set[a]]] = True
        ring = np.flatnonzero(nxt)
        ghosts.append(ring)
        in_set |= nxt
        current = nxt
    ghosts = (np.concatenate(ghosts) if ghosts
              else np.zeros(0, dtype=np.int64))
    cells = np.concatenate([owned, ghosts]) if ghosts.size else owned
    is_ghost = np.zeros(cells.shape[0], dtype=bool)
    is_ghost[owned.shape[0]:] = True
    return cells, is_ghost


class SubsetMesh(JutulMesh):
    """Mesh view over a subset of a parent geometry (renumbered)."""

    def __init__(self, parent_geo: TwoPointFiniteVolumeGeometry,
                 cells: np.ndarray):
        self.parent = parent_geo
        self.cells = np.asarray(cells, dtype=np.int64)
        g2l = {int(g): i for i, g in enumerate(self.cells)}
        nb = np.asarray(parent_geo.neighbors, dtype=np.int64)
        n = int(max(nb.max(initial=-1), self.cells.max(initial=-1))) + 1
        lookup = np.full(n, -1, dtype=np.int64)
        lookup[self.cells] = np.arange(self.cells.shape[0])
        keep = (lookup[nb[:, 0]] >= 0) & (lookup[nb[:, 1]] >= 0)
        self.face_ids = np.where(keep)[0]
        self._neighbors = lookup[nb[keep]].reshape(-1, 2)
        self.global_map = FiniteVolumeGlobalMap(
            self.cells, g2l, np.zeros(len(self.cells), dtype=bool),
            self.face_ids)

    @property
    def dim(self) -> int:
        return self.parent.dim

    def number_of_cells(self) -> int:
        return self.cells.shape[0]

    def number_of_faces(self) -> int:
        return self._neighbors.shape[0]

    def number_of_boundary_faces(self) -> int:
        return 0

    def neighborship(self) -> np.ndarray:
        return self._neighbors

    def tpfv_geometry(self) -> TwoPointFiniteVolumeGeometry:
        p = self.parent
        ids = self.face_ids
        return TwoPointFiniteVolumeGeometry(
            neighbors=self._neighbors,
            areas=p.areas[ids],
            volumes=p.volumes[self.cells],
            normals=p.normals[ids],
            cell_centroids=p.cell_centroids[self.cells],
            face_centroids=p.face_centroids[ids],
            boundary_areas=np.zeros(0),
            boundary_normals=np.zeros((0, p.dim)),
            boundary_centroids=np.zeros((0, p.dim)),
            boundary_neighbors=np.zeros(0, dtype=np.int64),
        )


def subdomain(data_domain: DataDomain, cells, is_ghost=None) -> DataDomain:
    """Subset a DataDomain onto the selected cells
    (reference dd/subdomains.jl:58)."""
    mesh = SubsetMesh(data_domain.geometry, cells)
    out = DataDomain(mesh)
    face_ids = mesh.face_ids
    for name, (entity, arr) in data_domain.items():
        if name in out:
            continue
        if entity == CELLS:
            out.set(name, np.asarray(arr)[mesh.cells], CELLS)
        elif entity == FACES:
            out.set(name, np.asarray(arr)[face_ids], FACES)
    if is_ghost is not None:
        mesh.global_map.cell_is_ghost[:] = is_ghost
    return out


def submodel(model, partition, block: int | None = None, buffer: int = 1):
    """Extract the submodel of one partition block with ghost overlap
    (reference dd/submodels.jl:2). ``partition`` is either a per-cell block
    array (with ``block``) or an explicit owned-cell list."""
    from ..models.system import SimulationModel

    geo = model.domain.geometry
    if block is not None:
        owned = np.where(np.asarray(partition) == block)[0]
    else:
        owned = np.asarray(partition, dtype=np.int64)
    cells, is_ghost = subcells_with_overlap(geo.neighbors, owned, buffer)
    dd = subdomain(model.data_domain, cells, is_ghost)
    sub = SimulationModel(dd, model.system)
    sub.extra["global_map"] = dd.mesh.global_map
    return sub


def substate(state: dict, model, submodel_) -> dict:
    """Restrict a state dict to a submodel's cells
    (reference dd/substate.jl:2)."""
    gmap = submodel_.extra["global_map"]
    out = {}
    for k, v in state.items():
        v = np.asarray(v)
        if v.ndim >= 1 and v.shape[0] == model.number_of_cells():
            out[k] = v[gmap.cells]
        else:
            out[k] = v
    return out


def subforces(forces, submodel_):
    """Remap forces onto a submodel's local cell numbering; forces whose
    cells fall outside the subdomain are dropped (reference subforces)."""
    if forces is None:
        return None
    g2l = submodel_.extra["global_map"].full_to_inner
    out = {}
    for name, fv in forces.items():
        flist = fv if isinstance(fv, (list, tuple)) else [fv]
        kept = []
        for force in flist:
            cells = getattr(force, "cells", None)
            if cells is None:
                cell = getattr(force, "cell", None)
                if cell is None:
                    kept.append(force)
                elif int(cell) in g2l:
                    f2 = copy.copy(force)
                    f2.cell = g2l[int(cell)]
                    kept.append(f2)
                continue
            cells = np.atleast_1d(np.asarray(cells))
            sel = [i for i, c in enumerate(cells) if int(c) in g2l]
            if not sel:
                continue
            f2 = copy.copy(force)
            f2.cells = np.asarray([g2l[int(cells[i])] for i in sel],
                                  dtype=np.int32)
            if hasattr(f2, "values") and np.ndim(f2.values) >= 1:
                f2.values = np.asarray(f2.values)[sel]
            kept.append(f2)
        if kept:
            out[name] = kept if isinstance(fv, (list, tuple)) else kept[0]
    return out
