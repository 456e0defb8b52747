"""Well trajectories: polyline-cell intersection.

Port of the JAX package's ``meshes/trajectories.py`` (host numpy); the
face half-spaces are built only for the cells that pass the bounding-ball
prefilter of some segment, not for every cell. Counterpart of the reference trajectories module (reference:
src/meshes/trajectories.jl — ``find_enclosing_cells`` :43: which cells a
well polyline passes through, used to place well perforations).

Two methods:
- "exact" (default): each segment is clipped against every candidate cell's
  face half-spaces — exact for convex cells, with entry/exit parameters and
  in-cell lengths (the reference's exact polyline-cell intersection).
- "sampling": dense sampling + nearest-centroid (round-1 heuristic), kept
  for non-convex cells.
"""

from __future__ import annotations

import numpy as np

from .convexgeom import (
    cell_bounding_radius,
    cell_halfspaces,
    clip_segment,
)


def trajectory_intersections(mesh_or_geo, trajectory):
    """Exact polyline-cell intersections (reference trajectories.jl:43).

    Returns a list of dicts {cell, segment, t0, t1, length, entry, exit}
    ordered along the trajectory. Exact for convex cells: the segment's
    parameter interval is clipped by each candidate cell's face planes.
    """
    geo = (mesh_or_geo.tpfv_geometry()
           if hasattr(mesh_or_geo, "tpfv_geometry") else mesh_or_geo)
    traj = np.asarray(trajectory, dtype=np.float64)
    cc = geo.cell_centroids
    if traj.ndim != 2 or traj.shape[1] != cc.shape[1]:
        raise ValueError(f"trajectory must be (n, {cc.shape[1]})")
    # candidate prefilter: SOUND per-cell bounding radius (exact vertex
    # distance when mesh connectivity is available) — a volume-based
    # estimate misses corner-clipping segments on anisotropic cells
    radius = cell_bounding_radius(mesh_or_geo)

    segments = []
    for s, (a, b) in enumerate(zip(traj[:-1], traj[1:])):
        seg_len = float(np.linalg.norm(b - a))
        if seg_len == 0.0:
            continue
        # cells whose bounding sphere the segment approaches
        ab = (b - a) / seg_len
        v = cc - a[None, :]
        t_near = np.clip(v @ ab, 0.0, seg_len)
        d2 = np.sum((v - t_near[:, None] * ab[None, :]) ** 2, axis=1)
        segments.append((s, a, b, seg_len,
                         np.flatnonzero(d2 <= (1.001 * radius) ** 2)))
    every = np.unique(np.concatenate([c for *_, c in segments])) \
        if segments else np.zeros(0, np.int64)
    hs = dict(zip(every.tolist(), cell_halfspaces(geo, every)))

    out = []
    for s, a, b, seg_len, cand in segments:
        hits = []
        for c in cand:
            pp, nn = hs[int(c)]
            res = clip_segment(a, b, pp, nn)
            if res is None:
                continue
            t0, t1 = res
            if t1 - t0 <= 1e-12:
                continue
            hits.append({
                "cell": int(c), "segment": s, "t0": float(t0),
                "t1": float(t1), "length": (t1 - t0) * seg_len,
                "entry": a + t0 * (b - a), "exit": a + t1 * (b - a),
            })
        hits.sort(key=lambda h: h["t0"])
        out.extend(hits)
    return out


def find_enclosing_cells(mesh_or_geo, trajectory,
                         n_samples_per_segment: int = 25,
                         method: str = "exact"):
    """Cells traversed by the polyline (reference trajectories.jl:43).

    method="exact" clips each segment against cell face half-spaces (exact
    for convex cells); method="sampling" is the dense-sampling heuristic
    (use for strongly non-convex cells). Returns unique cell indices in
    traversal order.
    """
    if method == "exact":
        inter = trajectory_intersections(mesh_or_geo, trajectory)
        seen, out = set(), []
        for h in inter:
            if h["cell"] not in seen:
                seen.add(h["cell"])
                out.append(h["cell"])
        return np.asarray(out, dtype=np.int64)

    geo = mesh_or_geo.tpfv_geometry() if hasattr(mesh_or_geo, "tpfv_geometry") \
        else mesh_or_geo
    cc = geo.cell_centroids
    traj = np.asarray(trajectory, dtype=np.float64)
    if traj.ndim != 2 or traj.shape[1] != cc.shape[1]:
        raise ValueError(f"trajectory must be (n, {cc.shape[1]})")
    # effective cell radius from volume (inside check tolerance)
    dim = cc.shape[1]
    radius = (geo.volumes ** (1.0 / dim)) * (np.sqrt(dim) / 2.0) * 1.05

    found: list[int] = []
    for a, b in zip(traj[:-1], traj[1:]):
        ts = np.linspace(0.0, 1.0, n_samples_per_segment)
        pts = a[None, :] + ts[:, None] * (b - a)[None, :]
        # nearest centroid per sample (chunked for memory)
        d2 = np.sum((pts[:, None, :] - cc[None, :, :]) ** 2, axis=2)
        nearest = np.argmin(d2, axis=1)
        dist = np.sqrt(d2[np.arange(len(ts)), nearest])
        for c, d in zip(nearest, dist):
            if d <= radius[c] and (not found or found[-1] != c):
                found.append(int(c))
    # deduplicate preserving order
    seen = set()
    out = []
    for c in found:
        if c not in seen:
            seen.add(c)
            out.append(c)
    return np.asarray(out, dtype=np.int64)
