"""Block-ELL sparse matrix: the generic engine's Jacobian format.

Port of the JAX package's ``ops/blockell.py`` (reference:
src/core_types/core_types.jl:101-165 matrix layouts, src/StaticCSR/mat.jl,
src/linsolve/default.jl LinearizedSystem). A fixed number of slots per row
holding dense (neq x ndof) blocks gives static shapes, coalesced gathers
and SpMV as one gather plus a batched multiply-reduce.

Structure (host numpy, built once per model):
- ``cols`` (n, S) int32: column cell of each slot; slot 0 is the diagonal;
  padded slots point at the row itself and carry zero blocks;
- sorted (row*n + col) keys and their slots for ``slots_for``.
The index tensors derived from it (gather tables, the transpose map, the
plans of the fixed-order sums) are built on first use and kept per device
on the structure: the JAX package's table registry (``ops/tables.py``)
lets index arrays travel as jit arguments, which has no counterpart here.

Data: ``blocks`` (n, S, neq, ndof), a tensor on the simulator's device.

Every sum whose destinations repeat (``rmatvec``, the AMG restriction and
Galerkin products) goes through a ``SegmentSumPlan``: the entries sorted
by destination once on the host and summed along a fixed padded axis, so
a CUDA run adds in the same order every time (``index_add_`` adds float
atomics in no fixed order).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


class SegmentSumPlan:
    """``out[d] = sum(data[i] for i with dest[i] == d)`` in a fixed order.

    Host set-up sorts the entries by destination (stably, so each
    destination's entries keep their source order) and groups the
    destinations by count into buckets of width 1, 2, 4, ...; each bucket
    is a padded (n_b, width) gather table whose pad points at an appended
    zero entry. ``apply`` gathers and sums along the width axis per bucket
    and writes each bucket's distinct destinations: no atomics, the same
    bits on every call."""

    def __init__(self, dest, n_out: int):
        dest = np.asarray(dest, dtype=np.int64).reshape(-1)
        self.n_in = dest.shape[0]
        self.n_out = int(n_out)
        order = np.argsort(dest, kind="stable")
        counts = np.bincount(dest, minlength=self.n_out)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        self._buckets = []  # (dest rows (n_b,), table (n_b, width))
        lo, width = 0, 1
        cmax = int(counts.max()) if counts.size else 0
        while lo < cmax:
            sel = np.nonzero((counts > lo) & (counts <= width))[0]
            if sel.size:
                j = np.arange(width)
                pos = starts[sel][:, None] + j
                valid = j < counts[sel][:, None]
                tab = np.where(valid, order[np.minimum(pos, self.n_in - 1)],
                               self.n_in)
                self._buckets.append((sel, tab))
            lo, width = width, 2 * width
        self._dev = {}

    def _tables(self, device):
        key = str(device)
        if key not in self._dev:
            self._dev[key] = [
                (torch.as_tensor(sel, device=device),
                 torch.as_tensor(tab, device=device))
                for sel, tab in self._buckets]
        return self._dev[key]

    def apply(self, data):
        """``data`` (n_in, ...) -> (n_out, ...)."""
        trail = tuple(data.shape[1:])
        pad = torch.cat([data, data.new_zeros((1,) + trail)])
        out = data.new_zeros((self.n_out,) + trail)
        for sel, tab in self._tables(data.device):
            out[sel] = torch.sum(pad[tab], dim=1)
        return out


class IndexPlan:
    """A host index array ``idx`` (m,) into the rows of a tensor, with
    its device copies (``on``) and the fixed-order ``y[idx] += vals``
    (``add``): entries that share a row are summed by a
    ``SegmentSumPlan`` first, so the write goes to distinct rows only and
    repeats its bits on the card. Built once per index structure (a
    cross-term's connection list, a force's cells)."""

    def __init__(self, idx):
        self.idx = np.asarray(idx, dtype=np.int64).reshape(-1)
        uniq, inv = np.unique(self.idx, return_inverse=True)
        if uniq.shape[0] == self.idx.shape[0]:  # no repeats: no sum
            self.uniq, self.plan = self.idx, None
        else:
            self.uniq, self.plan = uniq, SegmentSumPlan(inv, uniq.shape[0])
        self._dev = {}

    def on(self, device):
        """(idx, the distinct rows ``add`` writes) as int64 tensors on
        ``device``."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (torch.as_tensor(self.idx, device=device),
                              torch.as_tensor(self.uniq, device=device))
        return self._dev[key]

    def gather(self, x):
        """``x[idx]``."""
        return x[self.on(x.device)[0]]

    def add(self, y, vals, *tail, inplace: bool = False):
        """``y`` with ``y[idx, *tail] += vals``; ``tail`` indexes the
        trailing axes (a slot, an equation slice). Out of place unless
        ``inplace`` (autograd and ``torch.func`` see a clone)."""
        if self.plan is not None:  # one sum per distinct row
            vals = self.plan.apply(vals)
        key = (self.on(y.device)[1],) + tail
        out = y if inplace else y.clone()
        out[key] = y[key] + vals.to(y.dtype)
        return out


@dataclass(eq=False)  # identity eq/hash: one instance per model
class ELLStructure:
    n_rows: int
    cols: np.ndarray  # (n, S) int32
    n_slots: int
    # sorted (row*n + col) keys and their slots, for vectorized lookup
    _keys: np.ndarray = None
    _slots: np.ndarray = None
    _cache: dict = field(default_factory=dict, repr=False)

    @staticmethod
    def build(n_rows: int, edges) -> "ELLStructure":
        """Build from an (m, 2) array of (row, col) off-diagonal pairs.

        Diagonal is always present at slot 0; duplicate edges collapse;
        padded slots point at the row itself. Vectorized numpy (the
        analogue of the reference's symbolic setup)."""
        if edges is None or len(edges) == 0:
            edges = np.zeros((0, 2), dtype=np.int64)
        edges = np.asarray(edges, dtype=np.int64)
        edges = edges[edges[:, 0] != edges[:, 1]]
        key = edges[:, 0] * n_rows + edges[:, 1]
        key = np.unique(key)
        rows = key // n_rows
        colv = key % n_rows
        # slot = 1 + rank of the edge within its row (keys are sorted, so
        # the edges of a row are contiguous and ordered by col)
        row_start = np.searchsorted(rows, np.arange(n_rows))
        counts = np.diff(np.append(row_start, rows.shape[0]))
        S = 1 + (int(counts.max()) if counts.size else 0)
        slot = np.arange(key.shape[0]) - row_start[rows] + 1
        cols = np.tile(np.arange(n_rows, dtype=np.int32)[:, None],
                       (1, max(S, 1)))
        cols[rows, slot] = colv
        diag_key = np.arange(n_rows, dtype=np.int64) * n_rows + np.arange(
            n_rows)
        all_keys = np.concatenate([diag_key, key])
        all_slots = np.concatenate([np.zeros(n_rows, dtype=np.int32),
                                    slot.astype(np.int32)])
        order = np.argsort(all_keys)
        return ELLStructure(n_rows, cols, max(S, 1), all_keys[order],
                            all_slots[order])

    def slots_for(self, rows, cols) -> np.ndarray:
        """Slot index for each (row, col) pair; vectorized; raises on pairs
        absent from the sparsity pattern."""
        rows = np.asarray(rows, dtype=np.int64)
        cols_q = np.asarray(cols, dtype=np.int64)
        q = rows * self.n_rows + cols_q
        ix = np.searchsorted(self._keys, q)
        if np.any(ix >= self._keys.shape[0]) or np.any(self._keys[np.minimum(
                ix, self._keys.shape[0] - 1)] != q):
            raise KeyError("slots_for: (row, col) not in sparsity pattern")
        return self._slots[ix]

    # --- host tables, built once -----------------------------------------
    def _host(self, name, make):
        if name not in self._cache:
            self._cache[name] = make()
        return self._cache[name]

    def _on(self, name, device, make):
        """Tensor ``name`` on ``device``, from the host array ``make()``."""
        key = (name, str(device))
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(self._host(name, make),
                                               device=device)
        return self._cache[key]

    def cols_t(self, device):
        """``cols`` as an int64 tensor on ``device``."""
        return self._on("cols", device,
                        lambda: np.asarray(self.cols, dtype=np.int64))

    def pad_mask(self) -> np.ndarray:
        """(n, S) True where a slot is padding (an off-diagonal slot that
        points at its own row)."""
        def make():
            pad = self.cols == np.arange(self.n_rows)[:, None]
            pad[:, 0] = False
            return pad
        return self._host("pad", make)

    def transpose_idx(self) -> np.ndarray:
        """Flat (n*S) gather table mapping each slot of A^T to its source
        slot in A: T_blocks[i, s] = blocks[j, s*]^T with j = cols[i, s] and
        cols[j, s*] == i. Requires a structurally symmetric pattern (mesh
        face stencils are). Padded slots map to themselves (zero blocks)."""
        def make():
            n, S = self.cols.shape
            cols = np.asarray(self.cols, dtype=np.int64)
            rows = np.arange(n, dtype=np.int64)[:, None]
            own = np.broadcast_to(np.arange(S, dtype=np.int64), (n, S))
            pad = cols == rows  # slot 0 (diagonal) + padding slots
            j = cols[~pad]
            i = np.broadcast_to(rows, (n, S))[~pad]
            try:
                src_slot_off = self.slots_for(j, i)
            except KeyError as e:
                raise ValueError(
                    "transpose_idx: sparsity pattern is not structurally "
                    "symmetric") from e
            src_slot = own.copy()
            src_slot[~pad] = src_slot_off
            src_row = np.where(pad, rows, cols)
            return (src_row * S + src_slot).reshape(-1)
        return self._host("tidx", make)

    def partner_slots(self) -> np.ndarray:
        """(n, S) slot of block (cols[i,s], i) in row cols[i,s]: the
        transposed partner of every stored block (ILU(0)); raises on a
        pattern that is not structurally symmetric."""
        def make():
            n, S = self.cols.shape
            rows = np.broadcast_to(np.arange(n)[:, None], (n, S))
            return self.slots_for(self.cols, rows).astype(np.int64)
        return self._host("partner", make)

    def matvec_idx(self, ndof: int, device):
        """Flat SpMV gather index idx[(i,s,j)] = cols[i,s]*ndof + j."""
        return self._on(f"mvidx{ndof}", device, lambda: (
            np.asarray(self.cols, dtype=np.int64)[:, :, None] * ndof
            + np.arange(ndof, dtype=np.int64)).reshape(-1))

    def rmatvec_plan(self) -> SegmentSumPlan:
        """Fixed-order sum of slot contributions into their columns."""
        return self._host("rmv", lambda: SegmentSumPlan(
            self.cols.reshape(-1), self.n_rows))


class BlockELL:
    """blocks (n, S, neq, ndof) over an ELLStructure."""

    def __init__(self, structure: ELLStructure, blocks):
        self.structure = structure
        self.blocks = blocks

    @property
    def neq(self) -> int:
        return self.blocks.shape[2]

    @property
    def ndof(self) -> int:
        return self.blocks.shape[3]

    def matvec(self, x):
        """y = A @ x with x (n, ndof) -> y (n, neq)."""
        return ell_matvec(self.blocks, self.structure, x)

    def rmatvec(self, y):
        """x = A^T @ y with y (n, neq) -> x (n, ndof)."""
        return ell_rmatvec(self.blocks, self.structure, y)

    def to_dense(self):
        return ell_to_dense(self.blocks, self.structure)

    def transpose(self) -> "BlockELL":
        """A^T as a BlockELL over the SAME structure (structurally
        symmetric patterns only — mesh stencils are)."""
        return BlockELL(self.structure,
                        ell_transpose(self.blocks, self.structure))


def ell_matvec(blocks, structure: ELLStructure, x):
    """y[r] = sum_s blocks[r, s] @ x[cols[r, s]] (padded slots hold zero
    blocks, so no masking)."""
    n, S, neq, ndof = blocks.shape
    idx = structure.matvec_idx(ndof, blocks.device)
    xg = x.reshape(-1)[idx].reshape(n, S, ndof)
    return torch.sum(blocks * xg[:, :, None, :], dim=(1, 3))


def ell_rmatvec(blocks, structure: ELLStructure, y):
    """x[c] = sum over (r, s) with cols[r,s]==c of blocks[r,s]^T @ y[r],
    summed in a fixed order."""
    n, S = structure.cols.shape
    contrib = torch.sum(blocks * y[:, None, :, None], dim=2)  # (n, S, ndof)
    return structure.rmatvec_plan().apply(contrib.reshape(n * S, -1))


def ell_transpose(blocks, structure: ELLStructure):
    """Transposed blocks via the ``transpose_idx`` gather (no scatters)."""
    n, S, neq, ndof = blocks.shape
    if neq != ndof:
        raise ValueError("ell_transpose: square cell blocks required")
    tidx = structure._on("tidx", blocks.device, structure.transpose_idx)
    g = blocks.reshape(n * S, neq, ndof)[tidx].reshape(n, S, neq, ndof)
    return torch.transpose(g, 2, 3)


def ell_to_dense(blocks, structure: ELLStructure):
    """Dense (n*neq, n*ndof) matrix (small systems / tests). Every stored
    (row, col) pair is distinct once padding (zero blocks pointing at the
    row's own diagonal) is dropped, so this is a plain write."""
    n, S, neq, ndof = blocks.shape
    keep = torch.as_tensor(~structure.pad_mask(), device=blocks.device)
    cols = structure.cols_t(blocks.device)
    rows = torch.arange(n, device=blocks.device)[:, None].expand(n, S)
    r_idx = (rows[keep][:, None, None] * neq
             + torch.arange(neq, device=blocks.device)[None, :, None])
    c_idx = (cols[keep][:, None, None] * ndof
             + torch.arange(ndof, device=blocks.device)[None, None, :])
    r_b, c_b = torch.broadcast_tensors(r_idx, c_idx)
    dense = blocks.new_zeros((n * neq, n * ndof))
    dense[r_b.reshape(-1), c_b.reshape(-1)] = blocks[keep].reshape(-1)
    return dense


def extract_diagonal(blocks):
    """(n, neq, ndof) diagonal blocks (slot 0 by construction)."""
    return blocks[:, 0]
