"""Coarse meshes: partition-based coarsening of any mesh.

Port of the JAX package's ``meshes/coarse.py`` (host numpy). Counterpart of the reference ``CoarseMesh`` (reference: src/meshes/coarse.jl
:3-244 — partition-based coarsening with coarse<->fine maps) and
``coarsen_data_domain`` (src/coarsening.jl:61-180 — per-field coarsening
ops: volume-weighted/harmonic/arithmetic average, sum, max, min).
"""

from __future__ import annotations

import numpy as np

from ..core.domains import DataDomain
from ..core.entities import CELLS
from .cartesian import JutulMesh
from .geometry import TwoPointFiniteVolumeGeometry


class CoarseMesh(JutulMesh):
    """Coarse mesh induced by a cell partition of a fine mesh."""

    def __init__(self, fine_mesh, partition):
        self.fine_mesh = fine_mesh
        self.partition = np.asarray(partition, dtype=np.int64)
        fine_geo = fine_mesh.tpfv_geometry()
        self.fine_geo = fine_geo
        nc = int(self.partition.max()) + 1
        self._n_cells = nc

        # coarse faces: unique (min,max) coarse pairs with any fine face
        nb = fine_geo.neighbors
        cp = self.partition[nb]  # (nf_fine, 2)
        cross = cp[:, 0] != cp[:, 1]
        lo = np.minimum(cp[cross, 0], cp[cross, 1])
        hi = np.maximum(cp[cross, 0], cp[cross, 1])
        key = lo * nc + hi
        ukey, inverse = np.unique(key, return_inverse=True)
        self._coarse_neighbors = np.stack([ukey // nc, ukey % nc], axis=1)
        self._fine_face_ids = np.where(cross)[0]
        self._fine_face_coarse = inverse  # coarse face id per crossing face
        # orientation sign of each fine face wrt its coarse face (left->right)
        self._fine_face_sign = np.where(
            cp[cross, 0] == self._coarse_neighbors[inverse, 0], 1.0, -1.0)
        self._geo = None

    @property
    def dim(self) -> int:
        return self.fine_mesh.dim

    def number_of_cells(self) -> int:
        return self._n_cells

    def number_of_faces(self) -> int:
        return self._coarse_neighbors.shape[0]

    def number_of_boundary_faces(self) -> int:
        return 0  # aggregated boundary not tracked in v1

    def neighborship(self) -> np.ndarray:
        return self._coarse_neighbors

    def coarse_cells_of_fine(self) -> np.ndarray:
        return self.partition

    def fine_cells_of_coarse(self, c: int) -> np.ndarray:
        return np.where(self.partition == c)[0]

    def tpfv_geometry(self) -> TwoPointFiniteVolumeGeometry:
        if self._geo is not None:
            return self._geo
        g = self.fine_geo
        nc = self._n_cells
        vol = np.bincount(self.partition, weights=g.volumes, minlength=nc)
        cent = np.zeros((nc, g.dim))
        for d in range(g.dim):
            cent[:, d] = np.bincount(
                self.partition, weights=g.volumes * g.cell_centroids[:, d],
                minlength=nc) / vol
        nf = self.number_of_faces()
        ids = self._fine_face_ids
        inv = self._fine_face_coarse
        areas = np.bincount(inv, weights=g.areas[ids], minlength=nf)
        normals = np.zeros((nf, g.dim))
        fcent = np.zeros((nf, g.dim))
        for d in range(g.dim):
            normals[:, d] = np.bincount(
                inv, weights=self._fine_face_sign * g.areas[ids]
                * g.normals[ids, d], minlength=nf)
            fcent[:, d] = np.bincount(
                inv, weights=g.areas[ids] * g.face_centroids[ids, d],
                minlength=nf) / np.maximum(areas, 1e-300)
        nrm = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.maximum(nrm, 1e-300)
        geo = TwoPointFiniteVolumeGeometry(
            neighbors=self._coarse_neighbors,
            areas=areas,
            volumes=vol,
            normals=normals,
            cell_centroids=cent,
            face_centroids=fcent,
            boundary_areas=np.zeros(0),
            boundary_normals=np.zeros((0, g.dim)),
            boundary_centroids=np.zeros((0, g.dim)),
            boundary_neighbors=np.zeros(0, dtype=np.int64),
        )
        self._geo = geo
        return geo

    def __repr__(self) -> str:  # pragma: no cover
        return (f"CoarseMesh({self._n_cells} cells from "
                f"{self.fine_mesh!r})")


def coarsen_cell_value(values, partition, volumes=None, op: str = "volume"):
    """Aggregate fine cell values per coarse cell
    (reference coarsening.jl per-field ops)."""
    values = np.asarray(values, dtype=np.float64)
    partition = np.asarray(partition)
    nc = int(partition.max()) + 1
    if values.ndim > 1:
        return np.stack([coarsen_cell_value(values[:, j], partition, volumes,
                                            op) for j in range(values.shape[1])],
                        axis=1)
    if op == "sum":
        return np.bincount(partition, weights=values, minlength=nc)
    if op == "max":
        out = np.full(nc, -np.inf)
        np.maximum.at(out, partition, values)
        return out
    if op == "min":
        out = np.full(nc, np.inf)
        np.minimum.at(out, partition, values)
        return out
    if op == "arithmetic":
        cnt = np.bincount(partition, minlength=nc)
        return np.bincount(partition, weights=values, minlength=nc) / cnt
    if op == "harmonic":
        cnt = np.bincount(partition, minlength=nc)
        inv = np.bincount(partition, weights=1.0 / np.maximum(values, 1e-300),
                          minlength=nc)
        return cnt / inv
    if op == "volume":
        if volumes is None:
            raise ValueError("volume weighting requires volumes")
        v = np.bincount(partition, weights=volumes, minlength=nc)
        return np.bincount(partition, weights=values * volumes,
                           minlength=nc) / v
    raise ValueError(f"unknown coarsening op {op!r}")


_DEFAULT_OPS = {
    "porosity": "volume",
    "permeability": "harmonic",
    "poisson_coefficient": "harmonic",
}


def coarsen_data_domain(data_domain: DataDomain, partition,
                        ops: dict | None = None) -> DataDomain:
    """Coarsen a DataDomain onto the CoarseMesh of ``partition``
    (reference coarsening.jl:93 coarsen_data_domain)."""
    cm = CoarseMesh(data_domain.mesh, partition)
    out = DataDomain(cm)
    ops = {**_DEFAULT_OPS, **(ops or {})}
    vols = data_domain["volumes"]
    for name, (entity, arr) in data_domain.items():
        if entity != CELLS or name in out or not np.issubdtype(
                np.asarray(arr).dtype, np.floating):
            continue
        op = ops.get(name, "volume")
        out.set(name, coarsen_cell_value(arr, partition, vols, op), CELLS)
    return out
