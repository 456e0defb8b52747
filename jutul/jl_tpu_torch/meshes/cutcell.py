"""Cut-cell meshes: plane cuts, mesh gluing, embedding.

Port of the JAX package's ``meshes/cutcell.py`` (host numpy). ``cut_mesh``
classifies every node, face and cell by the cut's sign at once and runs
the JAX package's clipping code only on the faces the cut touches (a node
on the cut or nodes on both sides); every other face is kept whole, so the
points, faces and cells come out in the JAX package's order and equal to
its tables. Counterpart of the reference CutCellMeshes module (reference:
src/meshes/CutCellMeshes/*.jl — ``cut_mesh``/``PlaneCut`` (cutting a 3D
mesh by planes for fault modeling), ``glue_mesh`` (merging two meshes with
coincident interfaces), ``embed_mesh`` (embedding), exported in
src/Jutul.jl:156) and EmbeddedMeshes (lower-dimensional meshes embedded in
a host with FV coupling).

v1 scope:
- ``PlaneCut`` + ``cut_mesh``: cells crossed by the plane are split into
  two polygonal (2D) / polyhedral (3D) cells via Sutherland–Hodgman face
  clipping with a closing cap face.
- ``glue_mesh``: union of two meshes; coincident boundary faces (same node
  positions) become interior faces.
- ``embed_mesh``: connection list between a host mesh and an embedded
  lower-dimensional mesh (fracture), with transmissibility-style
  connection indices — consumed as MultiModel cross-terms.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from .unstructured import IndirectionMap, UnstructuredMesh, _concat_maps


@dataclass(frozen=True)
class PlaneCut:
    """Plane through ``point`` with ``normal`` (reference PlaneCut)."""

    point: tuple
    normal: tuple

    def signed_distance(self, pts: np.ndarray) -> np.ndarray:
        n = np.asarray(self.normal, dtype=np.float64)
        n = n / np.linalg.norm(n)
        return (pts - np.asarray(self.point)) @ n


@dataclass(frozen=True)
class SurfaceCut:
    """Cut defined by an oriented polygonal surface (reference:
    CutCellMeshes cutting.jl — polygonal-surface cuts, 1,001 LoC; here the
    surface enters ``cut_mesh`` through its signed-distance field).

    ``surface`` is a :class:`~.embedded.SurfaceMesh` of SIMPLE planar
    polygons (convex or not; the inside test is an even-odd crossing
    number in each polygon's plane). The signed distance of a query
    point is the distance to the closest point on the surface, signed
    by the closest polygon's plane.
    Edge crossings start from linear interpolation of nodal distances
    (exact where the surface is locally planar) and are REFINED to the
    true zero of the signed-distance field by a bracketed
    regula-falsi/bisection hybrid (``_refine_crossing``) — exact, to
    root-finding tolerance, across polygon creases too. Surfaces that do not span the domain cut along their
    closest-point extension.
    """

    surface: object

    def signed_distance(self, pts: np.ndarray) -> np.ndarray:
        pts = np.asarray(pts, dtype=np.float64)
        best = np.full(pts.shape[0], np.inf)
        sgn = np.ones(pts.shape[0])
        s = self.surface
        for c in range(s.number_of_cells()):
            poly = s.cell_polygon(c)
            p0, n = s.cell_plane(c)
            d_pl = (pts - p0) @ n  # signed plane distance
            proj = pts - d_pl[:, None] * n[None, :]
            # inside test by even-odd crossing number in the polygon
            # plane — exact for any SIMPLE planar polygon, convex or
            # not (reference cutting.jl handles general polygonal
            # surfaces; the old same-side-of-every-edge test required
            # convexity). Boundary-grazing projections are resolved by
            # the edge-distance pass below, which always also runs.
            m = len(poly)
            u = None
            for i in range(m):
                e = poly[(i + 1) % m] - poly[i]
                ln = np.linalg.norm(e)
                if ln > 1e-300:
                    u = e / ln
                    break
            if u is None:
                continue  # degenerate polygon: no area, edges are points
            v = np.cross(n, u)
            px = (proj - p0) @ u
            py = (proj - p0) @ v
            vx = (poly - p0) @ u
            vy = (poly - p0) @ v
            inside = np.zeros(pts.shape[0], dtype=bool)
            for i in range(m):
                x1, y1 = vx[i], vy[i]
                x2, y2 = vx[(i + 1) % m], vy[(i + 1) % m]
                cond = (y1 > py) != (y2 > py)
                dy = y2 - y1
                xint = x1 + (py - y1) * (x2 - x1) / np.where(
                    dy == 0.0, 1.0, dy)  # dy==0 -> cond False, unused
                inside ^= cond & (px < xint)
            dist = np.where(inside, np.abs(d_pl), np.inf)
            # edges: closest point on each segment
            for i in range(m):
                a, b = poly[i], poly[(i + 1) % m]
                ab = b - a
                t = np.clip(((pts - a) @ ab) / max(ab @ ab, 1e-300), 0.0, 1.0)
                q = a[None] + t[:, None] * ab[None]
                dist = np.minimum(dist, np.linalg.norm(pts - q, axis=1))
            upd = dist < best
            best = np.where(upd, dist, best)
            sgn = np.where(upd, np.where(d_pl >= 0, 1.0, -1.0), sgn)
        return sgn * best


class _PointPool:
    """Deduplicating point registry for cut points: the mesh's points,
    then one new point per cut edge."""

    def __init__(self, points: np.ndarray):
        self.base = points
        self.new: list = []
        self._cut_cache: dict[tuple, int] = {}

    def point(self, i: int) -> np.ndarray:
        n = len(self.base)
        return self.base[i] if i < n else self.new[i - n]

    @property
    def dim(self) -> int:
        return self.base.shape[1]

    def edge_point(self, a: int, b: int, p: np.ndarray) -> int:
        key = (min(a, b), max(a, b))
        if key in self._cut_cache:
            return self._cut_cache[key]
        idx = len(self.base) + len(self.new)
        self.new.append(p)
        self._cut_cache[key] = idx
        return idx

    def array(self) -> np.ndarray:
        if not self.new:
            return self.base
        return np.concatenate([self.base, np.asarray(self.new)])


def _refine_crossing(sdf, pa, pb, da, db, t0, tol=1e-12, max_it=60):
    """Exact zero crossing of a (possibly nonlinear) signed-distance
    field along segment pa->pb: linear interpolation is only first-order
    accurate across polygon creases of a SurfaceCut, so refine with a
    regula-falsi/bisection hybrid on the actual field; the sign change
    brackets the root, so this converges to the true crossing regardless
    of creases."""
    lo, hi = 0.0, 1.0
    flo, fhi = float(da), float(db)
    t = float(t0)
    for _ in range(max_it):
        p = pa + t * (pb - pa)
        f = float(sdf(p[None, :])[0])
        if abs(f) <= tol * max(1.0, np.linalg.norm(pb - pa)):
            return t
        if (f > 0) == (flo > 0):
            lo, flo = t, f
        else:
            hi, fhi = t, f
        if hi - lo <= 1e-15:
            return t
        # regula falsi step, safeguarded by bisection
        t_rf = lo - flo * (hi - lo) / (fhi - flo) if fhi != flo else None
        t = (t_rf if t_rf is not None and lo < t_rf < hi
             else 0.5 * (lo + hi))
    return t


def _clip_polygon(loop, d, pool: _PointPool, side: int, refine=None):
    """Sutherland–Hodgman: keep the part of node loop with sign*d >= 0.

    Returns (sub_loop, cut_edge_nodes) — the two new nodes on the plane
    (None if the polygon is not cut). ``refine(a, b, t0)`` maps the
    linear-interpolation crossing parameter to the exact one for
    nonlinear signed-distance fields (SurfaceCut creases)."""
    sgn = 1.0 if side > 0 else -1.0
    out = []
    cut_nodes = []
    m = len(loop)
    for i in range(m):
        a, b = loop[i], loop[(i + 1) % m]
        da, db = sgn * d[a], sgn * d[b]
        if da >= 0:
            out.append(a)
        if da == 0:
            # existing node ON the cut: it bounds the cap polygon too
            # (cuts through mesh corners/edges)
            cut_nodes.append(a)
        if (da > 0 and db < 0) or (da < 0 and db > 0):
            t = da / (da - db)
            if refine is not None:
                t = refine(a, b, t)
            pa = pool.point(a)
            p = pa + t * (pool.point(b) - pa)
            nid = pool.edge_point(a, b, p)
            out.append(nid)
            cut_nodes.append(nid)
    if len(out) < (2 if pool.dim == 2 else 3):
        return None, cut_nodes
    return out, cut_nodes


def _face_signs(fmap: IndirectionMap, d: np.ndarray):
    """Per face: any node with d > 0, any with d < 0, any with d == 0."""
    if len(fmap) == 0:
        z = np.zeros(0, dtype=bool)
        return z, z, z
    dv = d[fmap.vals]
    starts = fmap.pos[:-1]
    return (np.logical_or.reduceat(dv > 0, starts),
            np.logical_or.reduceat(dv < 0, starts),
            np.logical_or.reduceat(dv == 0, starts))


def _pieces_map(fmap: IndirectionMap, touched: dict):
    """The output faces of ``fmap``'s faces in face order: each untouched
    face whole, each touched face ``f`` as its pieces ``touched[f]``
    (lists of (nodes, side)). Returns (IndirectionMap, source face per
    output face, the touched pieces' sides in output order)."""
    n = len(fmap)
    n_out = np.ones(n, dtype=np.int64)
    for f, pieces in touched.items():
        n_out[f] = len(pieces)
    src = np.repeat(np.arange(n), n_out)
    is_t = np.zeros(n, dtype=bool)
    is_t[list(touched)] = True
    length = fmap.counts()[src]
    t_out = np.flatnonzero(is_t[src])
    t_loops = [loop for f in sorted(touched) for loop, _ in touched[f]]
    t_sides = [side for f in sorted(touched) for _, side in touched[f]]
    length[t_out] = [len(loop) for loop in t_loops]
    pos = np.concatenate([[0], np.cumsum(length)])
    vals = np.empty(int(pos[-1]), dtype=np.int64)
    keep = np.flatnonzero(~is_t[src])
    L = length[keep]
    within = np.arange(int(L.sum())) - np.repeat(np.cumsum(L) - L, L)
    vals[np.repeat(pos[keep], L) + within] = \
        fmap.vals[np.repeat(fmap.pos[src[keep]], L) + within]
    for i, loop in zip(t_out, t_loops):
        vals[pos[i]:pos[i + 1]] = loop
    return IndirectionMap(vals, pos), src, np.asarray(t_sides, np.int64), \
        t_out


def cut_mesh(mesh: UnstructuredMesh, cut,
             tol: float = 1e-9) -> UnstructuredMesh:
    """Split every cell crossed by the cut into two cells
    (reference cut_mesh, CutCellMeshes/cutting.jl). ``cut`` is anything
    with a ``signed_distance(points)`` field — :class:`PlaneCut` for plane
    cuts, :class:`SurfaceCut` for polygonal-surface (fault) cuts. Cells
    fully on one side are kept as-is; a cut cell keeps its id for its
    part with d < 0 and its part with d > 0 gets id n_cells + (its rank
    among the cut cells); the cap face between the two parts comes after
    every other interior face."""
    dim = mesh.dim
    pool = _PointPool(np.asarray(mesh.points, dtype=np.float64))
    d = cut.signed_distance(pool.array())
    d = np.where(np.abs(d) < tol, 0.0, d)

    # Exact edge crossings for nonlinear signed-distance fields: a
    # SurfaceCut's field kinks at polygon creases, where linear
    # interpolation of nodal distances is only first-order accurate —
    # refine each crossing on the true field. PlaneCut fields are linear:
    # the interpolated crossing is already exact.
    refine = None
    if not isinstance(cut, PlaneCut):
        def refine(a, b, t0):
            return _refine_crossing(cut.signed_distance, pool.point(a),
                                    pool.point(b), d[a], d[b], t0)

    fn, bfn = mesh.face_nodes, mesh.boundary_face_nodes
    nb = np.asarray(mesh.face_neighbors, dtype=np.int64).reshape(-1, 2)
    bcells = np.asarray(mesh.boundary_face_cells, dtype=np.int64)
    nc = mesh.number_of_cells()
    f_pos, f_neg, f_zero = _face_signs(fn, d)
    b_pos, b_neg, b_zero = _face_signs(bfn, d)

    # a cell is cut when its faces hold nodes on both sides
    c_pos = np.zeros(nc, dtype=bool)
    c_neg = np.zeros(nc, dtype=bool)
    for cells, pos_, neg_ in ((nb[:, 0], f_pos, f_neg),
                              (nb[:, 1], f_pos, f_neg),
                              (bcells, b_pos, b_neg)):
        c_pos[cells[pos_]] = True
        c_neg[cells[neg_]] = True
    is_cut = c_pos & c_neg
    cut_cells = np.flatnonzero(is_cut)
    plus = np.full(nc, -1, dtype=np.int64)
    plus[cut_cells] = nc + np.arange(cut_cells.size)

    def cell_of(c, node_side):
        if node_side > 0 and plus[c] >= 0:
            return int(plus[c])
        return int(c)

    def face_side_pieces(loop):
        dd = [d[n] for n in loop]
        # uncut face — but when the plane CONTAINS one of its edges (>= 2
        # zero nodes), that edge still bounds the neighbor cells' caps
        zn = [n for n in loop if d[n] == 0]
        zn = zn if 2 <= len(zn) < len(loop) else []
        if all(x >= 0 for x in dd):
            return [(loop, +1)], zn
        if all(x <= 0 for x in dd):
            return [(loop, -1)], zn
        lp, cut_p = _clip_polygon(loop, d, pool, +1, refine=refine)
        lm, cut_m = _clip_polygon(loop, d, pool, -1, refine=refine)
        pieces = []
        if lp:
            pieces.append((lp, +1))
        if lm:
            pieces.append((lm, -1))
        return pieces, sorted(set(cut_p + cut_m))

    # In 2D each cut edge contributes ONE plane point; in 3D each cut face
    # contributes a segment (two plane points). The cap closing a cut cell
    # is the segment (2D) / stitched polygon (3D) of those points.
    cap_edges = defaultdict(list)  # 3D: cell -> cut segments
    cap_nodes = defaultdict(set)  # 2D: cell -> cut nodes

    def record_cut(c, cutn):
        if plus[c] < 0:
            return
        if dim == 2 and len(cutn) >= 1:
            cap_nodes[c].update(cutn)
        elif dim == 3 and len(cutn) >= 2:
            cap_edges[c].append(tuple(cutn[:2]))

    # only faces with a node on the cut or nodes on both sides are
    # clipped (in face order: the new points keep the JAX package's ids);
    # every other face lies whole on one side
    touched, b_touched = {}, {}
    for f in np.flatnonzero(f_zero | (f_pos & f_neg)):
        touched[int(f)], cutn = face_side_pieces(fn[f].tolist())
        record_cut(int(nb[f, 0]), cutn)
        record_cut(int(nb[f, 1]), cutn)
    for f in np.flatnonzero(b_zero | (b_pos & b_neg)):
        b_touched[int(f)], cutn = face_side_pieces(bfn[f].tolist())
        record_cut(int(bcells[f]), cutn)

    def sided(cells, side):
        return np.where((side > 0) & (plus[cells] >= 0), plus[cells], cells)

    faces, src, t_sides, t_out = _pieces_map(fn, touched)
    side = np.where(f_pos[src], 1, -1)
    side[t_out] = t_sides
    nbrs = np.stack([sided(nb[src, 0], side), sided(nb[src, 1], side)], 1)
    bfaces, bsrc, bt_sides, bt_out = _pieces_map(bfn, b_touched)
    bside = np.where(b_pos[bsrc], 1, -1)
    bside[bt_out] = bt_sides
    new_bcells = sided(bcells[bsrc], bside)

    # cap faces between the minus part (old id) and plus part (new id)
    caps, cap_nbrs = [], []
    for c in cut_cells.tolist():
        if dim == 2:
            # the cap spans both genuine cut points and mesh nodes lying
            # exactly on the plane (cuts through corners)
            zero = {n for f in np.flatnonzero((nb[:, 0] == c)
                                              | (nb[:, 1] == c))
                    for n in fn[f].tolist() if d[n] == 0}
            zero |= {n for f in np.flatnonzero(bcells == c)
                     for n in bfn[f].tolist() if d[n] == 0}
            nodes = sorted(cap_nodes[c] | zero)
            if len(nodes) >= 2:
                caps.append([nodes[0], nodes[-1]])
                cap_nbrs.append([c, int(plus[c])])
        else:
            loop = _stitch_cycle(cap_edges[c])
            if loop and len(loop) >= 3:
                caps.append(loop)
                cap_nbrs.append([c, int(plus[c])])
    if caps:
        faces = _concat_maps([faces, IndirectionMap.from_lists(caps)])
        nbrs = np.concatenate([nbrs, np.asarray(cap_nbrs, np.int64)])
    return UnstructuredMesh(pool.array(), faces,
                            nbrs.astype(np.int64).reshape(-1, 2),
                            bfaces, new_bcells.astype(np.int64))


def _stitch_cycle(edges):
    adj = defaultdict(list)
    seen = set()
    for a, b in edges:
        if a == b or (min(a, b), max(a, b)) in seen:
            continue  # degenerate / duplicate cap segments
        seen.add((min(a, b), max(a, b)))
        adj[a].append(b)
        adj[b].append(a)
    if not adj:
        return None
    start = next(iter(adj))
    loop = [start]
    prev = None
    cur = start
    for _ in range(len(adj) + 1):
        nxts = [x for x in adj[cur] if x != prev]
        if not nxts:
            return None
        nxt = nxts[0]
        if nxt == start:
            return loop
        loop.append(nxt)
        prev, cur = cur, nxt
    return loop


def glue_mesh(a: UnstructuredMesh, b: UnstructuredMesh,
              tol: float = 1e-9) -> UnstructuredMesh:
    """Union of two meshes; coincident boundary faces become interior
    (reference glue_mesh)."""
    if a.dim != b.dim:
        raise ValueError("dimension mismatch")
    pa, pb = a.points, b.points
    # merge points with dedupe by rounded coordinates
    scale = max(np.abs(np.concatenate([pa, pb])).max(), 1.0)
    key = lambda p: tuple(np.round(p / (tol * scale)).astype(np.int64))
    pmap = {}
    pts = []
    for p in pa:
        k = key(p)
        if k not in pmap:
            pmap[k] = len(pts)
            pts.append(p)
    amap = [pmap[key(p)] for p in pa]
    for p in pb:
        k = key(p)
        if k not in pmap:
            pmap[k] = len(pts)
            pts.append(p)
    bmap = [pmap[key(p)] for p in pb]
    nca = a.number_of_cells()

    def remap(m, nodemap):
        fn = [[nodemap[n] for n in m.face_nodes[f]]
              for f in range(m.number_of_faces())]
        bn = [[nodemap[n] for n in m.boundary_face_nodes[f]]
              for f in range(m.number_of_boundary_faces())]
        return fn, bn

    fa, ba = remap(a, amap)
    fb, bb = remap(b, bmap)
    faces = fa + fb
    nbrs = list(np.asarray(a.face_neighbors).tolist()) + [
        [l + nca, r + nca] for l, r in np.asarray(b.face_neighbors).tolist()]

    # match coincident boundary faces by node sets
    bnd = [(loop, int(c)) for loop, c in zip(ba, a.boundary_face_cells)]
    bnd += [(loop, int(c) + nca) for loop, c in zip(bb, b.boundary_face_cells)]
    by_key = {}
    glued = set()
    for i, (loop, c) in enumerate(bnd):
        k = frozenset(loop)
        if k in by_key and by_key[k] not in glued and i not in glued:
            j = by_key[k]
            faces.append(bnd[j][0])
            nbrs.append([bnd[j][1], c])
            glued.add(i)
            glued.add(j)
        else:
            by_key[k] = i
    bnd_nodes = [loop for i, (loop, c) in enumerate(bnd) if i not in glued]
    bnd_cells = [c for i, (loop, c) in enumerate(bnd) if i not in glued]
    return UnstructuredMesh(np.asarray(pts), faces,
                            np.asarray(nbrs, dtype=np.int64).reshape(-1, 2),
                            bnd_nodes, bnd_cells)


def embed_mesh(host, embedded, aperture: float = 1e-3, perm_scale: float = 1.0):
    """Embedding connections between a host mesh and a lower-dimensional
    mesh (reference embed_mesh / EmbeddedMeshes).

    Returns (host_cells, embedded_cells, connection_indices): for each
    embedded cell, its enclosing host cell and a transmissibility-style
    connection index CI = area / <distance>, to be consumed as MultiModel
    cross-terms between the host and fracture models.
    """
    hg = host.tpfv_geometry() if hasattr(host, "tpfv_geometry") else host
    eg = embedded.tpfv_geometry() if hasattr(embedded, "tpfv_geometry") \
        else embedded
    hc = hg.cell_centroids
    host_cells = []
    for c in eg.cell_centroids:
        cc = c[: hc.shape[1]] if c.shape[0] >= hc.shape[1] else np.pad(
            c, (0, hc.shape[1] - c.shape[0]))
        host_cells.append(int(np.argmin(np.sum((hc - cc) ** 2, axis=1))))
    host_cells = np.asarray(host_cells, dtype=np.int64)
    dim_h = hc.shape[1]
    # characteristic host-cell size -> average normal distance ~ size/4
    size = hg.volumes[host_cells] ** (1.0 / dim_h)
    area = eg.volumes * (aperture if eg.dim < dim_h else 1.0)
    ci = perm_scale * area / np.maximum(size / 4.0, 1e-300)
    return host_cells, np.arange(len(host_cells), dtype=np.int64), ci


def merge_faces(mesh: UnstructuredMesh, tol: float = 1e-8) -> UnstructuredMesh:
    """Merge coplanar faces that connect the same cell pair into single
    polygons (reference: CutCellMeshes/merge_faces.jl, 493 LoC — cutting
    fragments faces; merging restores one face per cell pair and plane).

    A group of faces is merged when (a) the faces share the SAME (left,
    right) cells — or the same cell for boundary faces — (b) they are
    coplanar within ``tol`` (unit normal and plane offset), and (c) the
    union's once-only edges stitch into one closed loop. Groups failing any
    condition are left untouched. Total area/volume are conserved exactly.
    """
    pts = mesh.points
    scale = max(float(np.abs(pts).max()), 1.0)

    def plane_key(loop):
        P = pts[np.asarray(loop)]
        o = P.mean(axis=0)
        if mesh.dim == 2:
            d = P[1] - P[0]
            n = np.array([d[1], -d[0]])
        else:
            n = np.cross(P - o, np.roll(P, -1, axis=0) - o).sum(axis=0)
        nn = np.linalg.norm(n)
        if nn <= 0:
            return None
        n = n / nn
        # canonical orientation for keying
        for comp in n:
            if abs(comp) > 1e-12:
                if comp < 0:
                    n = -n
                break
        off = float(o @ n)
        return (tuple(np.round(n / tol).astype(np.int64)),
                int(np.round(off / (tol * scale))))

    def try_merge(loops):
        """Union of coplanar loops -> single stitched loop or None."""
        cnt = defaultdict(int)
        for loop in loops:
            m = len(loop)
            for i in range(m):
                a, b = loop[i], loop[(i + 1) % m]
                cnt[(min(a, b), max(a, b))] += 1
        once = [e for e, k in cnt.items() if k == 1]
        if any(k > 2 for k in cnt.values()):
            return None
        loop = _stitch_cycle(once)
        if loop is None or len(loop) != len(once):
            return None
        return loop

    # interior faces by (l, r, plane)
    groups = defaultdict(list)
    nb = mesh.face_neighbors
    for f in range(mesh.number_of_faces()):
        k = plane_key(list(mesh.face_nodes[f]))
        if k is None:
            continue
        l, r = int(nb[f, 0]), int(nb[f, 1])
        groups[(l, r, k)].append(f)
    new_faces, new_nbrs = [], []
    dropped = set()
    for (l, r, _k), fs in groups.items():
        if len(fs) < 2:
            continue
        loops = [list(mesh.face_nodes[f]) for f in fs]
        merged = try_merge(loops)
        if merged is None:
            continue
        new_faces.append(merged)
        new_nbrs.append([l, r])
        dropped.update(fs)
    faces = [list(mesh.face_nodes[f]) for f in range(mesh.number_of_faces())
             if f not in dropped]
    nbrs = [list(nb[f]) for f in range(mesh.number_of_faces())
            if f not in dropped]
    faces += new_faces
    nbrs += new_nbrs

    # boundary faces by (cell, plane)
    bgroups = defaultdict(list)
    for f in range(mesh.number_of_boundary_faces()):
        k = plane_key(list(mesh.boundary_face_nodes[f]))
        if k is None:
            continue
        bgroups[(int(mesh.boundary_face_cells[f]), k)].append(f)
    bnew, bnew_cells = [], []
    bdropped = set()
    for (c, _k), fs in bgroups.items():
        if len(fs) < 2:
            continue
        loops = [list(mesh.boundary_face_nodes[f]) for f in fs]
        merged = try_merge(loops)
        if merged is None:
            continue
        bnew.append(merged)
        bnew_cells.append(c)
        bdropped.update(fs)
    bnd = [list(mesh.boundary_face_nodes[f])
           for f in range(mesh.number_of_boundary_faces())
           if f not in bdropped]
    bnd_cells = [int(mesh.boundary_face_cells[f])
                 for f in range(mesh.number_of_boundary_faces())
                 if f not in bdropped]
    bnd += bnew
    bnd_cells += bnew_cells

    return UnstructuredMesh(pts, faces,
                            np.asarray(nbrs, dtype=np.int64).reshape(-1, 2),
                            bnd, bnd_cells)
