"""Distributed CPR for general partitions.

Port of the JAX package's ``parallel/general_cpr.py`` (reference:
ext/JutulPartitionedArraysExt/linalg.jl:78 parray_preconditioner_apply!
with local ILU/AMG + global AMG; src/linsolve/precond/cpr.jl quasi-IMPES
weights). Unlike the slab engine's CPR, the fine grid is never gathered:

- quasi-IMPES weights and the scalar pressure operator A_p are collapsed
  SHARD-LOCALLY from the face-block Jacobian (owned rows only);
- fine-level smoothing is halo-aware damped Jacobi or Chebyshev (one halo
  exchange per sweep, the residual's plan);
- cells are aggregated SHARD-LOCALLY (greedy aggregation, by the native
  library, on the owned-owned face graph; aggregates never cross shards);
- only the COARSE system is psum-replicated (a rank-order sum, the same
  bits on every shard); below it the aggregation-AMG hierarchy
  (``linsolve/amg.py``) runs redundantly per shard;
- stage 2 is block-Jacobi with the pressure-COLUMN SpMV.

Every repeated-destination sum (the coarse operator, the restriction, the
face-to-row sums) goes through a fixed-order ``SegmentSumPlan``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..linsolve.amg import (
    AMGHierarchy,
    amg_coarsen_ops,
    amg_vcycle_apply,
    greedy_aggregate,
)
from ..linsolve.cheby import chebyshev_recurrence
from ..ops.blockell import ELLStructure, SegmentSumPlan
from ..ops.smallmat import block_inv, bmv


def _owned_graph_cols(eL, eR, n_own):
    """ELL-style adjacency (self-padded) of the owned-owned faces, each
    row's neighbours in the order the JAX package fills them: first the
    faces where the row is the left cell, then those where it is the right
    cell, each in face order."""
    src = np.concatenate([eL, eR])
    dst = np.concatenate([eR, eL])
    deg = np.bincount(src, minlength=n_own)
    S = max(1, int(deg.max()) if deg.size else 1)
    cols = np.tile(np.arange(n_own)[:, None], (1, S))
    order = np.argsort(src, kind="stable")
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.arange(order.shape[0]) - starts[src[order]]
    cols[src[order], slot] = dst[order]
    return cols


class GeneralCPRSetup:
    """Host-side symbolic setup: shard-local aggregation, the replicated
    coarse structure and the per-shard scatter tables (value-independent,
    built once)."""

    def __init__(self, dec, pressure_index: int = 0,
                 min_coarse: int = 64, max_levels: int = 10):
        self.p = pressure_index
        D = dec.n_devices
        nc = dec.partition.shape[0]
        neighbors = dec.neighbors
        stencil = dec.stencil
        nf, K = stencil.shape
        part = dec.partition
        L, R = neighbors[:, 0], neighbors[:, 1]

        # -- shard-local aggregation of OWNED cells over owned-owned faces
        agg_local = np.full(nc, -1, dtype=np.int64)
        n_agg = np.zeros(D, dtype=np.int64)
        for d in range(D):
            own = dec.own_lists[d]
            n_own = len(own)
            mask = (part[L] == d) & (part[R] == d)
            eL, eR = dec.own_pos[L[mask]], dec.own_pos[R[mask]]
            agg_d = greedy_aggregate(_owned_graph_cols(eL, eR, n_own), n_own)
            n_agg[d] = agg_d.max() + 1 if n_own else 0
            agg_local[own] = agg_d
        offsets = np.concatenate([[0], np.cumsum(n_agg)])
        self.n_coarse = int(offsets[-1])
        agg_global = offsets[part] + agg_local  # (nc,)
        self.agg_global = agg_global

        # -- replicated coarse structure: edges from every (row, stencil)
        rows_all = np.concatenate([np.repeat(L, K), np.repeat(R, K)])
        cols_all = np.concatenate([stencil.reshape(-1)] * 2)
        self.cstruct = ELLStructure.build(
            self.n_coarse, np.stack([agg_global[rows_all],
                                     agg_global[cols_all]], axis=1))
        S_c = self.cstruct.n_slots
        self.garbage = self.n_coarse * S_c  # scatter slot for dead entries

        # -- per-shard scatter tables --------------------------------------
        nom, nfm = dec.n_own_max, dec.nf_max
        self.flat_plus = np.full((D, nfm, K), self.garbage, np.int32)
        self.flat_minus = np.full((D, nfm, K), self.garbage, np.int32)
        self.flat_diag = np.full((D, nom), self.garbage, np.int32)
        self.aggG_own = np.full((D, nom), self.n_coarse, np.int32)
        for d in range(D):
            own = dec.own_lists[d]
            self.aggG_own[d, :len(own)] = agg_global[own]
            self.flat_diag[d, :len(own)] = agg_global[own] * S_c  # slot 0
            alive = dec.face_alive[d] > 0
            fg = dec.face_g[d]
            for rows_loc, tab in ((dec.row_plus[d], self.flat_plus),
                                  (dec.row_minus[d], self.flat_minus)):
                fi = np.flatnonzero(alive & (rows_loc < nom))
                if fi.size == 0:
                    continue
                row_c = agg_global[own[rows_loc[fi]]]
                for k in range(K):
                    col_c = agg_global[stencil[fg[fi], k]]
                    tab[d, fi, k] = (row_c * S_c + self.cstruct.slots_for(
                        row_c, col_c)).astype(np.int32)

        # -- replicated sub-hierarchy below the gathered coarse level
        self.hier = AMGHierarchy(self.cstruct, min_coarse=min_coarse,
                                 max_levels=max_levels)
        self._shard_tabs = {}

    def shard_tables(self, d: int, device) -> dict:
        """Shard ``d``'s tables on ``device`` with their fixed-order sum
        plans (the coarse-operator scatter and the restriction)."""
        key = (d, str(device))
        if key not in self._shard_tabs:
            dest = np.concatenate([self.flat_diag[d],
                                   self.flat_plus[d].reshape(-1),
                                   self.flat_minus[d].reshape(-1)])
            self._shard_tabs[key] = dict(
                aggG_own=torch.as_tensor(self.aggG_own[d].astype(np.int64),
                                         device=device),
                cval_plan=SegmentSumPlan(dest, self.garbage + 1),
                rc_plan=SegmentSumPlan(self.aggG_own[d], self.n_coarse + 1))
        return self._shard_tabs[key]


def cpr_update(setup: GeneralCPRSetup, sys, sh, ctabs, halo, comm,
               smoother: str = "jacobi"):
    """Per-Newton-iteration CPR state on one shard: the scalar pressure
    collapse with quasi-IMPES weights, the psum-replicated coarse operator
    and its Galerkin sub-hierarchy."""
    diag_own, diag_acc, jacK = sys["diag_own"], sys["diag_acc"], sys["jacK"]
    own_alive, face_st = sh["own_alive"], sh["face_st"]
    rp, rm, pm_plan = sh["row_plus"], sh["row_minus"], sh["pm_plan"]
    p = setup.p
    nom, neq = diag_own.shape[0], diag_own.shape[1]

    dinv = block_inv(diag_own)  # (nom, neq, ndof)
    w = dinv[:, p, :]  # (nom, neq) quasi-IMPES row weights
    w_ext = torch.cat([w, w.new_zeros((1, neq))])  # dump row
    apd_acc = torch.sum(w * diag_acc[:, :, p], dim=-1)
    apd_full = torch.sum(w * diag_own[:, :, p], dim=-1)
    safe = torch.where(apd_full != 0, apd_full, torch.ones_like(apd_full))
    dinv_p = torch.where(own_alive > 0, 1.0 / safe,
                         torch.zeros_like(apd_full))
    jp = jacK[:, :, :, p]  # (nf, neq, K)
    cpP = torch.sum(w_ext[rp][:, :, None] * jp, dim=1)  # (nf, K)
    cpM = torch.sum(w_ext[rm][:, :, None] * jp, dim=1)

    # replicated coarse operator: fixed-order scatter + psum
    cvals = ctabs["cval_plan"].apply(torch.cat(
        [apd_acc * own_alive, cpP.reshape(-1), -cpM.reshape(-1)]))
    cvals = comm.psum(cvals)[:setup.garbage]
    cvals = cvals.reshape(setup.n_coarse, setup.cstruct.n_slots)
    amg_state = amg_coarsen_ops(setup.hier, cvals)

    def ap_matvec(u):
        """Distributed fine-level scalar pressure matvec (halo-aware)."""
        uk = halo(u)[face_st]  # (nf, K)
        y = pm_plan.apply(torch.cat([torch.sum(cpP * uk, dim=1),
                                     -torch.sum(cpM * uk, dim=1)]))
        return (apd_acc * u + y[:nom]) * own_alive

    # fine-level Chebyshev interval: Gershgorin row sums of the distributed
    # pressure operator (faces touching an owned row are shard-local, so
    # the row sums are local; the max is a pmax); only for Chebyshev
    lmax_p = None
    if smoother == "chebyshev":
        offsum = pm_plan.apply(torch.cat([torch.sum(torch.abs(cpP), dim=1),
                                          torch.sum(torch.abs(cpM), dim=1)]))
        ratio = offsum[:nom] * torch.abs(dinv_p) * own_alive
        lmax_p = 1.0 + comm.pmax(torch.amax(ratio))

    return dict(w=w, dinv=dinv, dinv_p=dinv_p, ap_matvec=ap_matvec,
                amg_state=amg_state, aggG_own=ctabs["aggG_own"],
                rc_plan=ctabs["rc_plan"], comm=comm, lmax_p=lmax_p)


def _cheby_fine(ap_mv, dinv_p, lmax, u, rhs, n_sweep, lower=0.25):
    """Chebyshev relaxation on the distributed fine pressure level: the
    shared recurrence with the halo-aware matvec (no dot products, so no
    extra collectives)."""
    return chebyshev_recurrence(
        lambda u_: dinv_p * (rhs - ap_mv(u_)), dinv_p * rhs, u, n_sweep,
        lmax, lower)


def cpr_apply(setup: GeneralCPRSetup, pstate, sys, sh, halo, x,
              omega: float = 0.8, n_fine_smooth: int = 1,
              smoother: str = "jacobi", cheby_lower: float = 0.25):
    """CPR application on one shard: x (nom, neq) residual -> du
    (nom, ndof). Stage 1: halo-aware pre-smooth on A_p, shard-local
    restriction, psum-replicated coarse AMG V-cycle, prolongation,
    post-smooth. Stage 2: block-Jacobi with the p-column SpMV."""
    diag_acc, jacK = sys["diag_acc"], sys["jacK"]
    own_alive, face_st = sh["own_alive"], sh["face_st"]
    p = setup.p
    w, dinv, dinv_p = pstate["w"], pstate["dinv"], pstate["dinv_p"]
    ap_mv, amg_state = pstate["ap_matvec"], pstate["amg_state"]
    comm = pstate["comm"]
    nom = x.shape[0]
    cheby = smoother == "chebyshev"

    r_p = torch.sum(w * x, dim=-1)  # weighted pressure residual
    if cheby:
        u = _cheby_fine(ap_mv, dinv_p, pstate["lmax_p"], None, r_p,
                        n_fine_smooth, lower=cheby_lower)
    else:
        u = omega * dinv_p * r_p  # first sweep from zero is elementwise
        for _ in range(n_fine_smooth - 1):
            u = u + omega * dinv_p * (r_p - ap_mv(u))
    rho = r_p - ap_mv(u)

    # restrict shard-locally, replicate ONLY the coarse residual
    rc = comm.psum(pstate["rc_plan"].apply(rho * own_alive))
    ec = amg_vcycle_apply(setup.hier, amg_state, rc[:setup.n_coarse],
                          omega=0.67, n_smooth=2, n_cycles=1,
                          smoother=smoother)
    ec = torch.cat([ec, ec.new_zeros(1)])  # dead rows read the pad
    u = u + ec[pstate["aggG_own"]] * own_alive

    if cheby:
        u = _cheby_fine(ap_mv, dinv_p, pstate["lmax_p"], u, r_p,
                        n_fine_smooth, lower=cheby_lower)
    else:
        for _ in range(n_fine_smooth):
            u = u + omega * dinv_p * (r_p - ap_mv(u))
    dp = u

    # stage 2: r2 = x - A (dp e_p) via the pressure COLUMN of the
    # face-block SpMV; then block-Jacobi and re-add dp
    dk = halo(dp)[face_st]  # (nf, K)
    c = torch.sum(jacK[:, :, :, p] * dk[:, None, :], dim=-1)  # (nf, neq)
    y = sh["pm_plan"].apply(torch.cat([c, -c]))[:nom]
    r2 = x - (diag_acc[:, :, p] * dp[:, None] + y) * own_alive[:, None]
    du = bmv(dinv, r2)
    du[:, p] = du[:, p] + dp
    return du * own_alive[:, None]
