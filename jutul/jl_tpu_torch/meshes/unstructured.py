"""Unstructured (general polyhedral/polygonal) meshes.

Counterpart of the reference ``UnstructuredMesh`` (reference:
src/meshes/unstructured/types.jl:25-726 — cells->faces & faces->nodes
indirection maps (FaceMap), interior/boundary split, 2D/3D, conversion from
Cartesian; geometry by polygon/polyhedron decomposition in
src/meshes/unstructured/geometry.jl) and ``IndirectionMap``
(core_types.jl:1219). A copy of the JAX package's module (numpy, host
model-build data): the geometry arrays are the same bits for the same
points. ``from_cartesian`` and ``IndirectionMap.padded`` are vectorized
(the face and boundary orders are the loops' own): no Python loop over
faces.

Geometry is computed vectorized in numpy:
- faces: fan triangulation around the vertex mean -> area-weighted normals
  and centroids (padded to the max nodes/face; degenerate padding triangles
  contribute zero);
- cells: signed pyramid decomposition from each cell's face-centroid mean
  (divergence theorem), giving exact volumes/centroids for arbitrary convex
  and mildly non-convex polyhedra;
- interior face normals are oriented left -> right (flipped as needed).
"""

from __future__ import annotations

import numpy as np

from .cartesian import CartesianMesh, JutulMesh
from .geometry import TwoPointFiniteVolumeGeometry


class IndirectionMap:
    """CSR-style ragged map (reference core_types.jl:1219)."""

    def __init__(self, vals: np.ndarray, pos: np.ndarray):
        self.vals = np.asarray(vals, dtype=np.int64)
        self.pos = np.asarray(pos, dtype=np.int64)
        assert self.pos[0] == 0 and self.pos[-1] == len(self.vals)

    @classmethod
    def from_lists(cls, lists) -> "IndirectionMap":
        pos = np.zeros(len(lists) + 1, dtype=np.int64)
        for i, l in enumerate(lists):
            pos[i + 1] = pos[i] + len(l)
        vals = np.concatenate([np.asarray(l, dtype=np.int64)
                               for l in lists]) if lists else np.zeros(0, int)
        return cls(vals, pos)

    def __len__(self) -> int:
        return len(self.pos) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        return self.vals[self.pos[i]:self.pos[i + 1]]

    def counts(self) -> np.ndarray:
        return np.diff(self.pos)

    def padded(self, fill_mode: str = "repeat_last"):
        """(n, max_count) padded array + mask. Padding repeats the last
        entry so fan triangulation degenerates to zero-area triangles."""
        n = len(self)
        cnt = self.counts()
        m = max(int(cnt.max()) if n else 0, 1)
        col = np.arange(m)
        mask = col[None, :] < cnt[:, None]
        # entry (i, j) reads vals[pos[i] + min(j, cnt[i] - 1)]; empty rows 0
        src = self.pos[:-1, None] + np.minimum(col[None, :], cnt[:, None] - 1)
        out = np.zeros((n, m), dtype=np.int64)
        full = cnt > 0
        out[full] = self.vals[src[full]]
        return out, mask


class IndexRenumerator:
    """First-seen index renumbering (reference core_types.jl:1248-1295):
    looking up a key assigns it the next 1-based number on first access;
    repeated lookups return the same number. Used to compact sparse index
    sets (e.g. global cell ids touched by a well trajectory) into dense
    local numbering."""

    def __init__(self, keys=None):
        self._indices: dict = {}
        if keys is not None:
            for k in keys:
                self[k]

    def __len__(self) -> int:
        return len(self._indices)

    def __contains__(self, key) -> bool:
        return key in self._indices

    def __getitem__(self, key) -> int:
        n = self._indices.get(key)
        if n is None:
            n = len(self._indices) + 1
            self._indices[key] = n
        return n

    def __call__(self, key) -> int:
        return self[key]

    def indices(self) -> list:
        """Keys ordered by their assigned number (reference ``indices``)."""
        out = [None] * len(self._indices)
        for k, v in self._indices.items():
            out[v - 1] = k
        return out


def _polygon_geometry(points, face_nodes: IndirectionMap, dim: int):
    """areas, unit normals, centroids for each (planar) face."""
    if len(face_nodes) == 0:
        return (np.zeros(0), np.zeros((0, dim)), np.zeros((0, dim)))
    nodes_p, mask = face_nodes.padded()
    if dim == 2:
        a = points[nodes_p[:, 0]]
        b = points[nodes_p[:, 1]]
        d = b - a
        areas = np.linalg.norm(d, axis=1)
        normals = np.stack([d[:, 1], -d[:, 0]], axis=1)
        nrm = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / np.where(nrm > 0, nrm, 1.0)
        centroids = 0.5 * (a + b)
        return areas, normals, centroids
    P = points[nodes_p]  # (nf, m, dim)
    # fan origin = mean of the REAL nodes (padding repeats the last node;
    # summing it would pull the origin off the face plane and corrupt the
    # area-weighted centroid for meshes with heterogeneous face sizes)
    Pm = np.where(mask[..., None], P, 0.0)
    mean = Pm.sum(axis=1) / np.maximum(mask.sum(axis=1, keepdims=True), 1)
    A = P - mean[:, None, :]
    B = np.roll(P, -1, axis=1) - mean[:, None, :]
    cr = 0.5 * np.cross(A, B)  # (nf, m, 3) triangle area vectors
    tri_c = (mean[:, None, :] + P + np.roll(P, -1, axis=1)) / 3.0
    nvec = cr.sum(axis=1)
    tri_area = np.linalg.norm(cr, axis=2)
    area = np.linalg.norm(nvec, axis=1)
    tot = np.maximum(tri_area.sum(axis=1, keepdims=True), 1e-300)
    centroids = (tri_c * tri_area[..., None]).sum(axis=1) / tot
    normals = nvec / np.maximum(area, 1e-300)[:, None]
    return area, normals, centroids


class UnstructuredMesh(JutulMesh):
    """General FV mesh from faces->nodes + faces->cells connectivity."""

    def __init__(self, points, face_nodes, face_neighbors,
                 boundary_face_nodes=None, boundary_face_cells=None):
        self.points = np.asarray(points, dtype=np.float64)
        if self.points.ndim != 2:
            raise ValueError("points must be (n_nodes, dim)")
        self._dim = self.points.shape[1]
        if not isinstance(face_nodes, IndirectionMap):
            face_nodes = IndirectionMap.from_lists(face_nodes)
        self.face_nodes = face_nodes
        self.face_neighbors = np.asarray(face_neighbors, dtype=np.int64)
        if boundary_face_nodes is None:
            boundary_face_nodes = IndirectionMap.from_lists([])
            boundary_face_cells = np.zeros(0, dtype=np.int64)
        elif not isinstance(boundary_face_nodes, IndirectionMap):
            boundary_face_nodes = IndirectionMap.from_lists(boundary_face_nodes)
        self.boundary_face_nodes = boundary_face_nodes
        self.boundary_face_cells = np.asarray(boundary_face_cells,
                                              dtype=np.int64)
        nc = 0
        if self.face_neighbors.size:
            nc = int(self.face_neighbors.max()) + 1
        if self.boundary_face_cells.size:
            nc = max(nc, int(self.boundary_face_cells.max()) + 1)
        self._n_cells = nc
        self._geo = None

    # --- counts ----------------------------------------------------------
    @property
    def dim(self) -> int:
        return self._dim

    def number_of_cells(self) -> int:
        return self._n_cells

    def number_of_faces(self) -> int:
        return len(self.face_nodes)

    def number_of_boundary_faces(self) -> int:
        return len(self.boundary_face_nodes)

    def number_of_nodes(self) -> int:
        return self.points.shape[0]

    def neighborship(self) -> np.ndarray:
        return self.face_neighbors

    # --- geometry --------------------------------------------------------
    def tpfv_geometry(self, strict: bool = True) -> TwoPointFiniteVolumeGeometry:
        """``strict=False`` skips the positivity/shape validation so quality
        control (check_mesh) can inspect broken meshes without raising."""
        if self._geo is not None:
            return self._geo
        dim = self._dim
        areas, normals, fcent = _polygon_geometry(self.points,
                                                  self.face_nodes, dim)
        b_areas, b_normals, b_cent = _polygon_geometry(
            self.points, self.boundary_face_nodes, dim)

        nc = self._n_cells
        # provisional cell centers: mean of adjacent face centroids
        csum = np.zeros((nc, dim))
        ccnt = np.zeros(nc)
        for cells, cent in ((self.face_neighbors[:, 0], fcent),
                            (self.face_neighbors[:, 1], fcent),
                            (self.boundary_face_cells, b_cent)):
            np.add.at(csum, cells, cent)
            np.add.at(ccnt, cells, 1)
        apex = csum / np.maximum(ccnt[:, None], 1)

        # divergence-theorem volumes + centroids via pyramids (face, apex)
        vol = np.zeros(nc)
        cmom = np.zeros((nc, dim))

        def add_pyramids(cells, cent, area, nrml, sign):
            d = cent - apex[cells]
            h = np.einsum("fi,fi->f", d, nrml) * sign
            pv = h * area / dim  # pyramid volume (2D: triangle area)
            pc = apex[cells] + (dim / (dim + 1.0)) * d  # pyramid centroid
            np.add.at(vol, cells, pv)
            np.add.at(cmom, cells, pc * pv[:, None])

        L = self.face_neighbors[:, 0]
        R = self.face_neighbors[:, 1]
        # orient interior normals from provisional-left to provisional-right
        flip = np.einsum("fi,fi->f", normals, apex[R] - apex[L]) < 0
        normals = np.where(flip[:, None], -normals, normals)
        add_pyramids(L, fcent, areas, normals, +1.0)
        add_pyramids(R, fcent, areas, normals, -1.0)
        if len(self.boundary_face_cells):
            bc = self.boundary_face_cells
            out = np.einsum("fi,fi->f", b_normals, b_cent - apex[bc]) < 0
            b_normals = np.where(out[:, None], -b_normals, b_normals)
            add_pyramids(bc, b_cent, b_areas, b_normals, +1.0)
        centroids = cmom / np.maximum(vol[:, None], 1e-300)

        geo = TwoPointFiniteVolumeGeometry(
            neighbors=self.face_neighbors,
            areas=areas,
            volumes=vol,
            normals=normals,
            cell_centroids=centroids,
            face_centroids=fcent,
            boundary_areas=b_areas,
            boundary_normals=b_normals,
            boundary_centroids=b_cent,
            boundary_neighbors=self.boundary_face_cells,
        )
        if strict:
            geo.validate()
            self._geo = geo  # cache only validated geometry
        return geo

    # --- constructors ----------------------------------------------------
    @classmethod
    def from_cartesian(cls, mesh: CartesianMesh) -> "UnstructuredMesh":
        """Convert a CartesianMesh (reference types.jl conversion path).

        Interior faces keep the CartesianMesh's order; boundary faces come
        x low/high, then y low/high (then z low/high in 3D). A 1D mesh
        becomes a thin 2D strip."""
        nx, ny, nz = mesh._dims3()
        dim = mesh.dim
        axes = mesh._node_axes()
        if dim == 1:
            axes = axes + [np.array([0.0, 1.0])]
        nbrs = mesh.neighborship()
        l, r = nbrs[:, 0], nbrs[:, 1]
        if dim <= 2:
            # node order must be i-fastest to match nid(i, j) = i + npx*j
            Y, X = np.meshgrid(axes[1], axes[0], indexing="ij")
            pts = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
            npx = nx + 1
            li, lj = l % nx, l // nx
            ri, rj = r % nx, r // nx
            xf = ri == li + 1  # x-face between (li,lj) and (ri,lj)
            a = np.where(xf, ri + npx * lj, li + npx * rj)
            b = np.where(xf, ri + npx * (lj + 1), (li + 1) + npx * rj)
            face = np.stack([a, b], axis=1)
            j, i = np.arange(ny), np.arange(nx)
            bnd = np.concatenate([
                np.stack([npx * j, npx * (j + 1)], axis=1),
                np.stack([nx + npx * j, nx + npx * (j + 1)], axis=1),
                np.stack([i, i + 1], axis=1),
                np.stack([i + npx * ny, i + 1 + npx * ny], axis=1)])
            bcells = np.concatenate([nx * j, (nx - 1) + nx * j, i,
                                     i + nx * (ny - 1)])
            return cls(pts, _fixed_map(face), nbrs, _fixed_map(bnd), bcells)
        # 3D; node order i-fastest to match nid3(i,j,k) = i + npx*(j + npy*k)
        Z, Y, X = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
        pts = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=1)
        npx, npy = nx + 1, ny + 1

        def nid3(i, j, k):
            return i + npx * (j + npy * k)

        def x_face(i, j, k):
            return np.stack([nid3(i, j, k), nid3(i, j + 1, k),
                             nid3(i, j + 1, k + 1), nid3(i, j, k + 1)], -1)

        def y_face(i, j, k):
            return np.stack([nid3(i, j, k), nid3(i + 1, j, k),
                             nid3(i + 1, j, k + 1), nid3(i, j, k + 1)], -1)

        def z_face(i, j, k):
            return np.stack([nid3(i, j, k), nid3(i + 1, j, k),
                             nid3(i + 1, j + 1, k), nid3(i, j + 1, k)], -1)

        li, lj, lk = l % nx, (l // nx) % ny, l // (nx * ny)
        ri, rj, rk = r % nx, (r // nx) % ny, r // (nx * ny)
        xf = (ri == li + 1)[:, None]
        yf = (rj == lj + 1)[:, None]
        face = np.where(xf, x_face(ri, lj, lk),
                        np.where(yf, y_face(li, rj, lk), z_face(li, lj, rk)))

        def grid(a, b):  # b fastest, as the loops "for a: for b"
            A, B = np.meshgrid(a, b, indexing="ij")
            return A.reshape(-1), B.reshape(-1)

        I, J, K = np.arange(nx), np.arange(ny), np.arange(nz)
        kj, jj = grid(K, J)  # x sides: for k, for j
        ki, ii = grid(K, I)  # y sides: for k, for i
        jz, iz = grid(J, I)  # z sides: for j, for i
        bnd = np.concatenate([
            x_face(0, jj, kj), x_face(nx, jj, kj),
            y_face(ii, 0, ki), y_face(ii, ny, ki),
            z_face(iz, jz, 0), z_face(iz, jz, nz)])
        bcells = np.concatenate([
            nx * (jj + ny * kj), (nx - 1) + nx * (jj + ny * kj),
            ii + nx * (ny * ki), ii + nx * ((ny - 1) + ny * ki),
            iz + nx * jz, iz + nx * (jz + ny * (nz - 1))])
        return cls(pts, _fixed_map(face), nbrs, _fixed_map(bnd), bcells)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"UnstructuredMesh({self.number_of_cells()} cells, "
                f"{self.number_of_faces()} faces, {self._dim}D)")


def _fixed_map(rows: np.ndarray) -> IndirectionMap:
    """IndirectionMap of equal-length rows (n, m)."""
    n, m = rows.shape
    return IndirectionMap(rows.reshape(-1), np.arange(n + 1) * m)


def _concat_maps(maps) -> IndirectionMap:
    """The rows of several IndirectionMaps, one after another."""
    vals = np.concatenate([m.vals for m in maps])
    pos = [np.zeros(1, np.int64)]
    off = 0
    for m in maps:
        pos.append(m.pos[1:] + off)
        off += len(m.vals)
    return IndirectionMap(vals, np.concatenate(pos))
