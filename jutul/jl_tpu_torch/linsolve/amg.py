"""Algebraic multigrid (aggregation AMG) for scalar block-ELL systems.

Port of the JAX package's ``linsolve/amg.py``. Counterpart of the
reference's AMG stack (reference: src/linsolve/precond/amg.jl:5
``AMGPreconditioner`` with AlgebraicMultigrid.jl hierarchies, custom
coarse-system reassembly amg.jl:238-330 and partial updates reusing the
hierarchy :165).

Split of work, as in the JAX package:
- the symbolic setup is value-independent and runs once per structure on
  the host (numpy): greedy aggregation (Vanek-style) on the sparsity
  graph, the coarse-level ELL structures and the fine->coarse maps;
- the numeric setup (``update``) and the V-cycle run on the simulator's
  device: coarse operators are Galerkin sums R A P with piecewise-constant
  P, smoothing is damped Jacobi or Chebyshev, and the bottom level is a
  dense solve.

Every sum into repeated destinations (Galerkin values, restriction, the
smoothed-aggregation P values) goes through a ``SegmentSumPlan`` built at
the symbolic setup: the same bits on every call, where CUDA's
``index_add_`` would add float atomics in no fixed order.

``greedy_aggregate`` runs the native C++ aggregation, which the JAX
package tries first (``native.native_aggregate``, built from the port's
own copy of ``partitioner.cpp``); ``greedy_aggregate_loop``, the same
aggregates by a loop over Python lists, is the tests' oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..native import native_aggregate
from ..ops.blockell import BlockELL, ELLStructure, SegmentSumPlan, ell_to_dense
from .precond import Preconditioner


def greedy_aggregate(cols: np.ndarray, n: int) -> np.ndarray:
    """Vanek-style greedy aggregation on an ELL sparsity graph, by the
    native library (``greedy_aggregate_loop`` says what it computes).
    Returns (n,) aggregate ids in [0, n_agg)."""
    return native_aggregate(cols, n)


def greedy_aggregate_loop(cols: np.ndarray, n: int) -> np.ndarray:
    """Vanek-style greedy aggregation on an ELL sparsity graph.

    Pass 1: seed aggregates from nodes whose neighborhood is untouched.
    Pass 2: attach remaining nodes to the first adjacent aggregate (slot
    order), else open a new one. Returns (n,) aggregate ids in
    [0, n_agg)."""
    rows = np.asarray(cols, dtype=np.int64).tolist()
    agg = [-1] * n
    n_agg = 0
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = rows[i]
        for j in nbrs:
            if agg[j] >= 0:
                break
        else:
            agg[i] = n_agg
            for j in nbrs:
                agg[j] = n_agg
            n_agg += 1
    for i in range(n):
        if agg[i] >= 0:
            continue
        for j in rows[i]:
            if agg[j] >= 0:
                agg[i] = agg[j]
                break
        else:
            agg[i] = n_agg
            n_agg += 1
    return np.asarray(agg, dtype=np.int64)


def _ell_dense(vals, structure: ELLStructure):
    """Dense (n, n) matrix of scalar ELL values ``vals`` (n, S)."""
    return ell_to_dense(vals[..., None, None], structure)


@dataclass
class AMGLevel:
    structure: ELLStructure  # this level's ELL
    agg: np.ndarray | None  # (n,) fine->coarse map (None at coarsest)
    galerkin: SegmentSumPlan | None  # fine (i, s) -> coarse flat slot
    restrict: SegmentSumPlan | None  # fine row -> coarse row
    n_coarse: int = 0


class AMGHierarchy:
    """Static multilevel structure for a given fine ELLStructure."""

    def __init__(self, structure: ELLStructure, min_coarse: int = 64,
                 max_levels: int = 10):
        self.levels: list[AMGLevel] = []
        cur = structure
        for _ in range(max_levels):
            n = cur.n_rows
            if n <= min_coarse:
                break
            agg = greedy_aggregate(np.asarray(cur.cols), n)
            n_c = int(agg.max()) + 1
            if n_c >= n:  # no coarsening progress
                break
            rows_f = np.repeat(np.arange(n), cur.n_slots)
            cols_f = np.asarray(cur.cols).reshape(-1)
            edges_c = np.stack([agg[rows_f], agg[cols_f]], axis=1)
            cstruct = ELLStructure.build(n_c, edges_c)
            slot_c = cstruct.slots_for(agg[rows_f], agg[cols_f])
            flat = agg[rows_f] * cstruct.n_slots + slot_c
            self.levels.append(AMGLevel(
                cur, agg, SegmentSumPlan(flat, n_c * cstruct.n_slots),
                SegmentSumPlan(agg, n_c), n_c))
            cur = cstruct
        self.levels.append(AMGLevel(cur, None, None, None, 0))
        self._agg_dev = {}

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def agg_t(self, level: int, device):
        key = (level, str(device))
        if key not in self._agg_dev:
            self._agg_dev[key] = torch.as_tensor(self.levels[level].agg,
                                                 device=device)
        return self._agg_dev[key]


class AMGPreconditioner(Preconditioner):
    """Aggregation-AMG V-cycle for SCALAR (1x1 block) ELL systems
    (reference precond/amg.jl:5).

    ``omega``: damped-Jacobi smoother weight; ``n_smooth``: pre/post sweeps;
    ``n_cycles``: V-cycles per apply; ``smoother``: "jacobi" or
    "chebyshev". The hierarchy is built on the first ``update`` of a
    structure and kept for later ones (values-only updates)."""

    def __init__(self, omega: float = 0.67, n_smooth: int = 2,
                 n_cycles: int = 1, min_coarse: int = 64,
                 smoother: str = "jacobi", cheby_lower: float = 0.25):
        self.omega = omega
        self.n_smooth = n_smooth
        self.n_cycles = n_cycles
        self.min_coarse = min_coarse
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown smoother {smoother!r}")
        self.smoother = smoother
        self.cheby_lower = cheby_lower
        self._hier: AMGHierarchy | None = None
        self._struct = None

    def _symbolic(self, structure: ELLStructure) -> AMGHierarchy:
        if self._hier is None or self._struct is not structure:
            self._hier = AMGHierarchy(structure, self.min_coarse)
            self._struct = structure
        return self._hier

    def update(self, J: BlockELL):
        """Galerkin coarse operators for all levels."""
        if J.blocks.shape[2] != 1 or J.blocks.shape[3] != 1:
            raise ValueError("AMGPreconditioner expects a scalar system; "
                             "use CPR for blocks")
        hier = self._symbolic(J.structure)
        return amg_coarsen_ops(hier, J.blocks[:, :, 0, 0])

    def apply(self, state, J: BlockELL, x):
        hier = self._symbolic(J.structure)
        b = x[:, 0] if x.ndim == 2 else x
        u = amg_vcycle_apply(hier, state, b, self.omega, self.n_smooth,
                             self.n_cycles, smoother=self.smoother,
                             cheby_lower=self.cheby_lower)
        return u[:, None] if x.ndim == 2 else u


def amg_coarsen_ops(hier: AMGHierarchy, vals):
    """Galerkin coarse operators for all levels from fine scalar ELL
    values ``vals`` (n, S), and the dense bottom operator."""
    ops = []
    for li, lvl in enumerate(hier.levels[:-1]):
        ops.append(vals)
        cstruct = hier.levels[li + 1].structure
        vals = lvl.galerkin.apply(vals.reshape(-1)).reshape(
            lvl.n_coarse, cstruct.n_slots)
    ops.append(vals)  # coarsest operator
    return (ops, _ell_dense(vals, hier.levels[-1].structure))


def _ell_cheby_data(A):
    """(dinv, lmax) for Chebyshev smoothing of a scalar ELL level: inverse
    diagonal + Gershgorin bound on lambda_max(D^-1 A)."""
    diag = A[:, 0]
    dabs = torch.abs(diag)
    dsafe = torch.where(dabs > 0, dabs, torch.ones_like(dabs))
    offsum = torch.sum(torch.abs(A[:, 1:]), dim=1)
    lmax = 1.0 + torch.max(offsum / dsafe)
    dinv = torch.where(dabs > 0, 1.0 / diag, torch.zeros_like(diag))
    return dinv, lmax


def _ell_cheby_smooth(A, cols, dinv, lmax, u, rhs, n_sweep,
                      lower: float = 0.25):
    """Chebyshev relaxation for a scalar ELL level (linsolve/cheby.py);
    ``u=None`` starts from zero."""
    from .cheby import chebyshev_recurrence

    return chebyshev_recurrence(
        lambda u_: dinv * (rhs - _scalar_matvec(A, cols, u_)),
        dinv * rhs, u, n_sweep, lmax, lower)


def amg_vcycle_apply(hier: AMGHierarchy, state, b, omega: float,
                     n_smooth: int, n_cycles: int,
                     smoother: str = "jacobi", cheby_lower: float = 0.25):
    """Aggregation-AMG V-cycle(s) for rhs ``b`` given ``amg_coarsen_ops``
    output."""
    ops, dense = state
    cols0 = hier.levels[0].structure.cols_t(b.device)
    u = torch.zeros_like(b)
    for _ in range(n_cycles):
        r = b - _scalar_matvec(ops[0], cols0, u)
        u = u + _vcycle(hier, ops, dense, 0, r, omega, n_smooth,
                        smoother == "chebyshev", cheby_lower)
    return u


def _vcycle(hier, ops, dense, level, rhs, omega, n_smooth, cheby,
            cheby_lower):
    """One V-cycle from ``level`` down (a module-level recursion: a
    self-referencing closure would keep every level's operator alive
    until the cyclic garbage collector runs)."""
    if level == hier.n_levels - 1:
        return torch.linalg.solve(dense, rhs)
    lvl = hier.levels[level]
    A = ops[level]
    cols = lvl.structure.cols_t(rhs.device)
    dinv = 1.0 / A[:, 0]
    if cheby:
        cdinv, lmax = _ell_cheby_data(A)
        u = _ell_cheby_smooth(A, cols, cdinv, lmax, None, rhs, n_smooth,
                              lower=cheby_lower)
    else:
        u = omega * dinv * rhs  # first Jacobi sweep from zero
        for _ in range(n_smooth - 1):
            r = rhs - _scalar_matvec(A, cols, u)
            u = u + omega * dinv * r
    r = rhs - _scalar_matvec(A, cols, u)
    e_c = _vcycle(hier, ops, dense, level + 1, lvl.restrict.apply(r), omega,
                  n_smooth, cheby, cheby_lower)
    u = u + e_c[hier.agg_t(level, rhs.device)]
    if cheby:
        return _ell_cheby_smooth(A, cols, cdinv, lmax, u, rhs, n_smooth,
                                 lower=cheby_lower)
    for _ in range(n_smooth):
        r = rhs - _scalar_matvec(A, cols, u)
        u = u + omega * dinv * r
    return u


def _scalar_matvec(vals, cols, x):
    """(n, S) scalar ELL matvec (flat gather)."""
    n, S = vals.shape
    xg = x[cols.reshape(-1)].reshape(n, S)
    return torch.sum(vals * xg, dim=1)


# ---------------------------------------------------------------------------
# Smoothed aggregation with strength of connection
# ---------------------------------------------------------------------------
def strength_mask(vals: np.ndarray, cols: np.ndarray,
                  theta: float) -> np.ndarray:
    """Symmetric strength of connection: |a_ij| >= theta*sqrt(|a_ii a_jj|)
    (reference: AlgebraicMultigrid.jl strength used by amg.jl:5). Slot 0
    (diagonal) is always strong; padded self-columns are weak."""
    n, S = vals.shape
    diag = np.abs(vals[:, 0])
    dj = diag[cols]  # (n, S)
    with np.errstate(invalid="ignore"):
        strong = np.abs(vals) >= theta * np.sqrt(np.abs(diag)[:, None] * dj)
    rows = np.arange(n)[:, None]
    strong &= cols != rows  # padded self-edges are not connections
    strong[:, 0] = True
    return strong


@dataclass
class _SALevel:
    """Static tables of one smoothed-aggregation level (built once from the
    first concrete values; later updates run only the value path)."""

    structure: ELLStructure
    n_fine: int
    n_coarse: int
    Sp: int  # P-row pattern width
    omega: float  # Jacobi prolongation-smoother weight (frozen at setup)
    pattern: np.ndarray  # (n, Sp) coarse col per P-row slot (dump = n_c)
    pos: np.ndarray  # (n, S) position of agg(cols[i,s]) in row pattern
    filt: np.ndarray  # (n, S) 1.0 where strong (A_F mask)
    agg: np.ndarray  # (n,) aggregate ids
    scatter: np.ndarray  # (n*S*Sp*Sp,) flat coarse target (dump)
    gi: np.ndarray  # flat P index of the row factor
    gj: np.ndarray  # flat P index of the col factor
    ai: np.ndarray  # flat A index
    coarse: ELLStructure
    p_plan: SegmentSumPlan  # contributions -> P values
    galerkin: SegmentSumPlan  # triple products -> coarse values
    restrict: SegmentSumPlan  # P^T r
    dev: dict = None

    def t(self, name, device):
        """Table ``name`` as a tensor on ``device`` (cached)."""
        if self.dev is None:
            self.dev = {}
        key = (name, str(device))
        if key not in self.dev:
            self.dev[key] = torch.as_tensor(getattr(self, name),
                                            device=device)
        return self.dev[key]


class SmoothedAggregationAMG(Preconditioner):
    """Smoothed-aggregation AMG with strength-of-connection filtering
    (reference: AMGPreconditioner{:smoothed_aggregation}, precond/amg.jl:5,
    coarse reassembly :238-330, partial hierarchy updates :165).

    The hierarchy (strength graph, aggregates, P-row patterns, Galerkin
    triple-product tables, smoother weights) is built ONCE from the first
    Jacobian's values on the host; every ``update`` re-runs only the value
    path — P values and Galerkin products as gathers and fixed-order sums.
    The triple-product tables hold n*S*Sp^2 entries: this targets the
    mid-size unstructured regime (the structured 1M-cell path uses the
    lattice GMG in ops/stencil.py)."""

    def __init__(self, theta: float = 0.08, omega: float = 0.67,
                 n_smooth: int = 1, n_cycles: int = 1,
                 min_coarse: int = 64, max_levels: int = 10,
                 smoother: str = "jacobi", cheby_lower: float = 0.25):
        self.theta = theta
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown smoother {smoother!r}")
        self.smoother = smoother
        self.cheby_lower = cheby_lower
        self.omega = omega  # relaxation smoother weight
        self.n_smooth = n_smooth
        self.n_cycles = n_cycles
        self.min_coarse = min_coarse
        self.max_levels = max_levels
        self._levels: list[_SALevel] | None = None
        self._struct = None

    # -- symbolic+numeric hierarchy from concrete values ------------------
    def _build(self, structure: ELLStructure, vals0: np.ndarray):
        levels: list[_SALevel] = []
        cur = structure
        vals = np.asarray(vals0, dtype=np.float64)
        for _ in range(self.max_levels):
            n, S = vals.shape
            if n <= self.min_coarse:
                break
            cols = np.asarray(cur.cols)
            strong = strength_mask(vals, cols, self.theta)
            cols_strong = np.where(strong, cols, np.arange(n)[:, None])
            agg = greedy_aggregate(cols_strong, n)
            n_c = int(agg.max()) + 1
            if n_c >= n:
                break

            # filtered matrix A_F: weak off-diagonals lumped to the diagonal
            filt = strong.astype(np.float64)
            aF = vals * filt
            aF[:, 0] += (vals * (1.0 - filt)).sum(axis=1)
            dinv = 1.0 / np.where(np.abs(aF[:, 0]) > 0, aF[:, 0], 1.0)
            # omega_P = 4/3 / rho(D^-1 A_F), rho by power iteration
            x = np.random.default_rng(0).standard_normal(n)
            for _ in range(20):
                y = dinv * (aF * x[cols]).sum(axis=1)
                nx = np.linalg.norm(y)
                x = y / max(nx, 1e-300)
            rho = max(nx, 1e-12)
            omega_p = (4.0 / 3.0) / rho

            # P row patterns: aggregates of strong neighbors (incl. self)
            agg_cols = np.where(strong, agg[cols], -1)
            agg_cols[:, 0] = agg[np.arange(n)]
            pos = np.zeros((n, S), dtype=np.int64)
            Sp = 1
            pat_rows = []
            for i in range(n):
                uniq = []
                for s in range(S):
                    a = agg_cols[i, s]
                    if a >= 0 and a not in uniq:
                        uniq.append(int(a))
                pat_rows.append(uniq)
                Sp = max(Sp, len(uniq))
            pattern = np.full((n, Sp), n_c, dtype=np.int64)  # dump = n_c
            for i, uniq in enumerate(pat_rows):
                pattern[i, :len(uniq)] = uniq
                lookup = {a: p for p, a in enumerate(uniq)}
                for s in range(S):
                    a = agg_cols[i, s]
                    pos[i, s] = lookup.get(int(a), Sp) if a >= 0 else Sp

            # coarse ELL from P-pattern products
            rows_f = np.repeat(np.arange(n), S)
            cols_f = cols.reshape(-1)
            pi_pat = pattern[rows_f]  # (nS, Sp)
            pj_pat = pattern[cols_f]
            edges = []
            for pi in range(Sp):
                for pj in range(Sp):
                    e = np.stack([pi_pat[:, pi], pj_pat[:, pj]], axis=1)
                    ok = (e[:, 0] < n_c) & (e[:, 1] < n_c)
                    edges.append(e[ok])
            cstruct = ELLStructure.build(n_c, np.concatenate(edges, axis=0))
            S_c = cstruct.n_slots

            # triple-product tables (flat; dump = n_c*S_c)
            nS = n * S
            scatter = np.full(nS * Sp * Sp, n_c * S_c, dtype=np.int64)
            gi = np.zeros(nS * Sp * Sp, dtype=np.int64)
            gj = np.zeros(nS * Sp * Sp, dtype=np.int64)
            ai = np.zeros(nS * Sp * Sp, dtype=np.int64)
            idx = 0
            Pw = Sp + 1  # padded P width (last col = dump zeros)
            for pi in range(Sp):
                rc = pi_pat[:, pi]
                for pj in range(Sp):
                    cc = pj_pat[:, pj]
                    ok = (rc < n_c) & (cc < n_c)
                    slot = np.zeros(nS, dtype=np.int64)
                    slot[ok] = cstruct.slots_for(rc[ok], cc[ok])
                    tgt = np.where(ok, rc * S_c + slot, n_c * S_c)
                    sl = slice(idx, idx + nS)
                    scatter[sl] = tgt
                    gi[sl] = rows_f * Pw + pi
                    gj[sl] = cols_f * Pw + pj
                    ai[sl] = np.arange(nS)
                    idx += nS
            seg = np.concatenate([pattern, np.full((n, 1), n_c)], axis=1)
            lvl = _SALevel(
                structure=cur, n_fine=n, n_coarse=n_c, Sp=Sp,
                omega=float(omega_p), pattern=pattern, pos=pos, filt=filt,
                agg=agg, scatter=scatter, gi=gi, gj=gj, ai=ai,
                coarse=cstruct,
                p_plan=SegmentSumPlan(
                    (np.arange(n)[:, None] * (Sp + 1) + pos).reshape(-1),
                    n * (Sp + 1)),
                galerkin=SegmentSumPlan(scatter, n_c * S_c + 1),
                restrict=SegmentSumPlan(seg.reshape(-1), n_c + 1))
            levels.append(lvl)

            # concrete coarse values for the NEXT level's strength/aggregates
            Pv = self._p_values_np(lvl, vals, aF, dinv)
            vals = self._galerkin_np(lvl, vals, Pv, n_c, S_c)
            cur = cstruct
        self._bottom = cur
        return levels

    # -- value paths (numpy mirrors for setup; torch in update) ------------
    @staticmethod
    def _p_values_np(lvl, vals, aF, dinv):
        n, S = vals.shape
        Sp = lvl.Sp
        P = np.zeros((n, Sp + 1))
        contrib = -lvl.omega * dinv[:, None] * aF  # (n, S)
        np.add.at(P, (np.repeat(np.arange(n), S), lvl.pos.reshape(-1)),
                  contrib.reshape(-1))
        own = lvl.pattern == lvl.agg[:, None]
        P[:, :Sp][own] += 1.0
        P[:, Sp] = 0.0
        return P

    @staticmethod
    def _galerkin_np(lvl, vals, P, n_c, S_c):
        flatP = P.reshape(-1)
        terms = flatP[lvl.gi] * vals.reshape(-1)[lvl.ai] * flatP[lvl.gj]
        out = np.zeros(n_c * S_c + 1)
        np.add.at(out, lvl.scatter, terms)
        return out[:-1].reshape(n_c, S_c)

    @staticmethod
    def _p_values(lvl, vals):
        n, S = vals.shape
        Sp = lvl.Sp
        dev = vals.device
        filt = lvl.t("filt", dev).to(vals.dtype)
        aF = vals * filt
        aF0 = aF[:, 0] + torch.sum(vals * (1.0 - filt), dim=1)
        aF = torch.cat([aF0[:, None], aF[:, 1:]], dim=1)
        # guard zero diagonals exactly like the numpy mirror
        dinv = 1.0 / torch.where(torch.abs(aF0) > 0, aF0,
                                 torch.ones_like(aF0))
        contrib = -lvl.omega * dinv[:, None] * aF
        P = lvl.p_plan.apply(contrib.reshape(-1)).reshape(n, Sp + 1)
        own = (lvl.t("pattern", dev) == lvl.t("agg", dev)[:, None]).to(
            vals.dtype)
        return torch.cat([P[:, :Sp] + own, torch.zeros_like(P[:, Sp:])],
                         dim=1)

    @staticmethod
    def _galerkin(lvl, vals, P):
        dev = vals.device
        flatP = P.reshape(-1)
        terms = (flatP[lvl.t("gi", dev)] * vals.reshape(-1)[lvl.t("ai", dev)]
                 * flatP[lvl.t("gj", dev)])
        out = lvl.galerkin.apply(terms)
        return out[:-1].reshape(lvl.n_coarse, lvl.coarse.n_slots)

    # -- Preconditioner interface -----------------------------------------
    def update(self, J: BlockELL):
        if J.blocks.shape[2] != 1 or J.blocks.shape[3] != 1:
            raise ValueError("SmoothedAggregationAMG expects a scalar system")
        vals = J.blocks[:, :, 0, 0]
        if self._levels is None or self._struct is not J.structure:
            self._levels = self._build(
                J.structure, vals.detach().cpu().double().numpy())
            self._struct = J.structure
        ops, Ps = [], []
        v = vals
        for lvl in self._levels:
            ops.append(v)
            P = self._p_values(lvl, v)
            Ps.append(P)
            v = self._galerkin(lvl, v, P)
        ops.append(v)
        return (ops, Ps, _ell_dense(v, self._bottom))

    def _vcycle(self, state, li: int, rhs):
        """One V-cycle from level ``li`` down (a method, not a closure:
        see ``_vcycle`` above)."""
        ops, Ps, dense = state
        levels = self._levels
        if li == len(levels):
            return torch.linalg.solve(dense, rhs)
        lvl = levels[li]
        A = ops[li]
        dev = rhs.device
        cols = lvl.structure.cols_t(dev)
        d0 = A[:, 0]
        dinv = 1.0 / torch.where(torch.abs(d0) > 0, d0, torch.ones_like(d0))
        cheby = self.smoother == "chebyshev"
        if cheby:
            cdinv, lmax = _ell_cheby_data(A)
            u = _ell_cheby_smooth(A, cols, cdinv, lmax, None, rhs,
                                  self.n_smooth, lower=self.cheby_lower)
        else:
            u = self.omega * dinv * rhs
            for _ in range(self.n_smooth - 1):
                r = rhs - _scalar_matvec(A, cols, u)
                u = u + self.omega * dinv * r
        r = rhs - _scalar_matvec(A, cols, u)
        # restriction: r_c = P^T r (fixed-order sum)
        P = Ps[li]
        r_c = lvl.restrict.apply((P * r[:, None]).reshape(-1))[:-1]
        e_c = self._vcycle(state, li + 1, r_c)
        # prolongation: u += P e_c
        e_pad = torch.cat([e_c, e_c.new_zeros(1)])
        u = u + torch.sum(P[:, :-1] * e_pad[lvl.t("pattern", dev)], dim=1)
        if cheby:
            return _ell_cheby_smooth(A, cols, cdinv, lmax, u, rhs,
                                     self.n_smooth, lower=self.cheby_lower)
        for _ in range(self.n_smooth):
            r = rhs - _scalar_matvec(A, cols, u)
            u = u + self.omega * dinv * r
        return u

    def apply(self, state, J: BlockELL, x):
        ops, _, dense = state
        b = x[:, 0] if x.ndim == 2 else x
        if not self._levels:  # system never coarsened: direct solve
            u = torch.linalg.solve(dense, b)
        else:
            u = torch.zeros_like(b)
            cols0 = self._levels[0].structure.cols_t(b.device)
            for _ in range(self.n_cycles):
                r = b - _scalar_matvec(ops[0], cols0, u)
                u = u + self._vcycle(state, 0, r)
        return u[:, None] if x.ndim == 2 else u
