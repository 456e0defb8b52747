"""Mesh/graph partitioning.

Port of the JAX package's ``parallel/partition.py`` (host numpy).
Counterpart of the reference partitioning layer (reference:
src/partitioning.jl — ``LinearPartitioner`` :2, ``MetisPartitioner`` :29,
hypergraph partitioning with forced groups & weights :244-500). The
reference delegates to Metis/KaHyPar; here the multilevel partitioner of
the port's native library (``native/partitioner.cpp``) runs first, and a
numpy BFS grower takes over where its result fails the quality gate.
Forced groups (a well's completion cells) are contracted into one node
before partitioning, so a group never straddles two blocks.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ..native import native_partition


class LinearPartitioner:
    """Contiguous index blocks (reference partitioning.jl:2)."""

    def partition(self, neighbors: np.ndarray, n_cells: int,
                  n_blocks: int, weights=None, groups=None) -> np.ndarray:
        bounds = np.linspace(0, n_cells, n_blocks + 1).astype(np.int64)
        out = np.zeros(n_cells, dtype=np.int64)
        for b in range(n_blocks):
            out[bounds[b]:bounds[b + 1]] = b
        if groups:
            out = _force_groups(out, groups)
        return out


class GreedyGraphPartitioner:
    """Multilevel partitioner with a BFS region-growing stand-in
    (MetisPartitioner, reference partitioning.jl:29). Grows blocks of
    (weighted) equal size; honours forced-together cell groups by
    contraction."""

    def partition(self, neighbors: np.ndarray, n_cells: int,
                  n_blocks: int, weights=None, groups=None) -> np.ndarray:
        if groups:
            # contract forced groups into supernodes before partitioning
            # (the reference contracts well groups the same way,
            # partitioning.jl:244): a group then never straddles blocks,
            # and its weight takes part in the balance
            cmap, n_super, wsup = _contract_groups(n_cells, groups, weights)
            nb = np.asarray(neighbors, dtype=np.int64)
            snb = cmap[nb]
            snb = snb[snb[:, 0] != snb[:, 1]]
            sp = self.partition(snb, n_super, n_blocks, wsup, None)
            return sp[cmap]
        # the quality gate of the JAX package: the native KL refinement
        # can empty a block on small graphs (observed
        # [44,43,44,0,42,44,32,71] on a 320-cell mesh); such a result goes
        # to the balanced python grower
        p = native_partition(neighbors, n_cells, n_blocks, weights)
        sizes = np.bincount(p, minlength=n_blocks).astype(float)
        if weights is not None:
            w = np.asarray(weights, dtype=np.float64)
            sizes = np.bincount(p, weights=w, minlength=n_blocks)
        target = sizes.sum() / n_blocks
        if sizes.min() > 0 and sizes.max() <= 2.0 * target:
            return p
        return self._python_partition(neighbors, n_cells, n_blocks, weights,
                                      groups)

    def _python_partition(self, neighbors, n_cells, n_blocks, weights,
                          groups):
        if weights is None:
            weights = np.ones(n_cells)
        weights = np.asarray(weights, dtype=np.float64)
        # adjacency CSR
        nb = np.asarray(neighbors, dtype=np.int64)
        src = np.concatenate([nb[:, 0], nb[:, 1]])
        dst = np.concatenate([nb[:, 1], nb[:, 0]])
        order = np.argsort(src, kind="stable")
        src_s, dst_s = src[order], dst[order]
        start = np.searchsorted(src_s, np.arange(n_cells + 1))

        target = weights.sum() / n_blocks
        part = np.full(n_cells, -1, dtype=np.int64)
        seed = 0
        for b in range(n_blocks):
            # find an unassigned seed (first unassigned cell)
            while seed < n_cells and part[seed] >= 0:
                seed += 1
            if seed >= n_cells:
                break
            q = deque([seed])
            acc = 0.0
            while q and acc < target:
                c = q.popleft()
                if part[c] >= 0:
                    continue
                part[c] = b
                acc += weights[c]
                for j in dst_s[start[c]:start[c + 1]]:
                    if part[j] < 0:
                        q.append(j)
        part[part < 0] = n_blocks - 1
        if groups:
            part = _force_groups(part, groups)
        return part


class MetisPartitioner(GreedyGraphPartitioner):
    """The reference's name: its Metis role is filled by the native
    multilevel partitioner."""


def _contract_groups(n_cells: int, groups, weights):
    """Map cells -> supernodes with each forced group becoming one
    supernode carrying the group's total weight. Overlapping groups
    (e.g. two wells perforating the same cell) merge transitively into
    one supernode. Returns (cell->super map, n_super, super weights)."""
    w = (np.ones(n_cells) if weights is None
         else np.asarray(weights, dtype=np.float64))
    cmap = np.full(n_cells, -1, dtype=np.int64)
    alias: list[int] = []  # union-find over group ids

    def find(a: int) -> int:
        while alias[a] != a:
            alias[a] = alias[alias[a]]
            a = alias[a]
        return a

    for g in groups:
        g = np.asarray(g, dtype=np.int64)
        gid = len(alias)
        alias.append(gid)
        for other in {find(int(i)) for i in cmap[g] if i >= 0}:
            alias[other] = gid  # merge overlapping groups
        cmap[g] = gid
    for c in np.flatnonzero(cmap >= 0):
        cmap[c] = find(int(cmap[c]))
    # compact group ids, then number the free cells
    used = np.unique(cmap[cmap >= 0])
    remap = {int(u): k for k, u in enumerate(used)}
    for c in np.flatnonzero(cmap >= 0):
        cmap[c] = remap[int(cmap[c])]
    nxt = len(used)
    free = np.flatnonzero(cmap < 0)
    cmap[free] = nxt + np.arange(free.size)
    n_super = nxt + free.size
    wsup = np.zeros(n_super)
    np.add.at(wsup, cmap, w)
    return cmap, n_super, wsup


def _force_groups(part: np.ndarray, groups) -> np.ndarray:
    """Force each group of cells into a single block (majority vote) —
    the reference's well-group constraint (partitioning.jl:244)."""
    part = part.copy()
    for g in groups:
        g = np.asarray(g, dtype=np.int64)
        vals, counts = np.unique(part[g], return_counts=True)
        part[g] = vals[np.argmax(counts)]
    return part


def partition_to_groups(part: np.ndarray) -> list[np.ndarray]:
    """The cells of each block 0..max(part), ascending (one stable sort in
    place of a scan per block)."""
    part = np.asarray(part)
    order = np.argsort(part, kind="stable")
    bounds = np.searchsorted(part[order], np.arange(int(part.max()) + 2))
    return [order[bounds[b]:bounds[b + 1]] for b in range(len(bounds) - 1)]


def load_balance(part: np.ndarray, weights=None) -> float:
    """max/mean block weight (1.0 = perfect)."""
    n_blocks = int(part.max()) + 1
    if weights is None:
        weights = np.ones_like(part, dtype=np.float64)
    sizes = np.bincount(part, weights=weights, minlength=n_blocks)
    return float(sizes.max() / sizes.mean())


def edge_cut(part: np.ndarray, neighbors: np.ndarray) -> int:
    nb = np.asarray(neighbors)
    return int(np.sum(part[nb[:, 0]] != part[nb[:, 1]]))
