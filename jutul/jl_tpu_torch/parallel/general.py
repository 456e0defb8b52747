"""General-partition SPMD Newton over arbitrary meshes and partitions.

Port of the JAX package's ``parallel/general.py`` (reference:
src/dd/subdomains.jl:58,77 ``subdomain``/``submap_cells`` with ghost
buffers; ext/JutulPartitionedArraysExt/interface.jl:2-97 per-rank
submodels over Metis/KaHyPar partitions). Where the slab engine
(``sharded.py``) needs a 1-D plane decomposition of a CartesianMesh, this
engine takes ANY cell partition of ANY mesh, for conservation laws with
ANY face read-stencil width (TPFA's K=2 through WENO/NFVM's K-wide
stencils, which get k-ring ghost buffers).

Design (one body per shard under ``ShardGroup.run``, topology as data):
- every shard's local layout is padded to common maxima
  ``[owned (n_own_max) | ghosts (n_ghost_max) | 1 dump row]``, the JAX
  package's layout;
- per-shard index tables (local face endpoints, halo send/recv plans,
  scatter rows) are built on the host with numpy, batched over all cells
  and faces at once (equal arrays to the JAX package's loops);
- the halo exchange is one ``all_to_all`` of packed send buffers, or, in
  ``halo_mode="ppermute"``, greedy edge-coloured ppermute rounds;
- the Jacobian stays in face-block form (accumulation diagonal blocks + K
  coupling blocks per face): the SpMV gathers over the face stencils and
  sums into rows through a fixed-order ``SegmentSumPlan`` — no atomics;
- Krylov is the psum-dot BiCGStab of the slab engine; the preconditioner
  is owned-diagonal block-Jacobi or the distributed CPR
  (``general_cpr.py``).

The JAX package runs the ministep Newton loop (and, on request, the whole
report step with its dt cuts) as one ``lax.while_loop`` program; here both
are eager loops that take the same rank-order reduced decisions.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.func import jvp

from ..core.domains import DataDomain
from ..dtypes import float_type
from ..linsolve.krylov import bicgstab
from ..models.equations import (
    AccumulationContribution,
    CellTermContribution,
    FaceFluxContribution,
)
from ..models.setup import setup_parameters, setup_state
from ..models.system import SimulationModel
from ..ops.assembly import compile_model
from ..ops.blockell import IndexPlan, SegmentSumPlan
from ..ops.smallmat import block_inv, bmv
from .comm import ShardGroup
from .partition import GreedyGraphPartitioner
from .sharded import (
    bc_force,
    collect_bc_stacks,
    newton_ministep,
    psum_dot,
    reduce_criteria,
)


class GeneralDecomposition:
    """Host-side partition tables (numpy; built once).

    ``stencil`` (nf, K): the cells each face's flux READS. For TPFA this
    is [L, R]; wider stencils (WENO/NFVM) produce the k-ring ghost buffers
    the reference's ``buffer`` argument provides (dd/subdomains.jl:77):
    every stencil cell of a face whose row lands on an owned cell becomes a
    ghost."""

    def __init__(self, mesh, partition: np.ndarray, n_devices: int,
                 stencil: np.ndarray | None = None):
        self.n_devices = D = int(n_devices)
        part = np.asarray(partition, dtype=np.int64)
        nc = mesh.number_of_cells()
        assert part.shape == (nc,)
        neighbors = np.asarray(mesh.neighborship(), dtype=np.int64)
        nf = neighbors.shape[0]
        self.partition = part
        if stencil is None:
            stencil = neighbors
        stencil = np.asarray(stencil, dtype=np.int64)
        assert stencil.shape[0] == nf
        self.K = K = stencil.shape[1]
        self.stencil = stencil
        self.neighbors = neighbors

        order = np.argsort(part, kind="stable")
        counts = np.bincount(part, minlength=D)
        bounds = np.concatenate([[0], np.cumsum(counts)])
        own_lists = [order[bounds[d]:bounds[d + 1]] for d in range(D)]
        # position of every cell within its owner's list
        own_pos = np.empty(nc, dtype=np.int64)
        own_pos[order] = np.arange(nc) - bounds[part[order]]
        self.own_pos = own_pos
        L, R = neighbors[:, 0], neighbors[:, 1]
        ghost_lists, face_lists = [], []
        for d in range(D):
            own_mask = part == d
            faces_d = np.flatnonzero(own_mask[L] | own_mask[R])
            face_lists.append(faces_d)
            touched = np.unique(stencil[faces_d].reshape(-1))
            ghost_lists.append(touched[~own_mask[touched]])

        self.n_own_max = nom = max(1, max(len(o) for o in own_lists))
        self.n_ghost_max = max(1, max(len(g) for g in ghost_lists))
        self.nf_max = max(1, max(len(f) for f in face_lists))
        self.n_loc = nom + self.n_ghost_max + 1  # +1 dump row
        self.dump = self.n_loc - 1
        self.own_lists = own_lists
        self.ghost_lists = ghost_lists

        self.l2g = np.full((D, self.n_loc), -1, dtype=np.int64)
        self.own_alive = np.zeros((D, nom))
        self.face_g = np.zeros((D, self.nf_max), dtype=np.int64)
        self.face_alive = np.zeros((D, self.nf_max))
        self.face_l = np.full((D, self.nf_max), self.dump, dtype=np.int32)
        self.face_r = np.full((D, self.nf_max), self.dump, dtype=np.int32)
        self.face_st = np.full((D, self.nf_max, K), self.dump, dtype=np.int32)
        self.row_plus = np.full((D, self.nf_max), nom, dtype=np.int32)
        self.row_minus = np.full((D, self.nf_max), nom, dtype=np.int32)
        # ghost cell -> owner shard pairs for the halo plans
        pair_cells = {}
        g2l = np.full(nc, -1, dtype=np.int64)
        for d in range(D):
            o, g, fl = own_lists[d], ghost_lists[d], face_lists[d]
            self.l2g[d, :len(o)] = o
            self.l2g[d, nom:nom + len(g)] = g
            self.own_alive[d, :len(o)] = 1.0
            g2l[o] = np.arange(len(o))
            g2l[g] = nom + np.arange(len(g))
            self.face_g[d, :len(fl)] = fl
            self.face_alive[d, :len(fl)] = 1.0
            ll, rr = g2l[L[fl]], g2l[R[fl]]
            self.face_l[d, :len(fl)] = ll
            self.face_r[d, :len(fl)] = rr
            self.face_st[d, :len(fl)] = g2l[stencil[fl]]
            self.row_plus[d, :len(fl)] = np.where(ll < nom, ll, nom)
            self.row_minus[d, :len(fl)] = np.where(rr < nom, rr, nom)
            owner = part[g]
            for s in np.unique(owner):
                cells = g[owner == s]  # ascending, as the ghost list
                pair_cells[(int(s), d)] = (cells, g2l[cells])
            g2l[o] = -1
            g2l[g] = -1

        M = max([1] + [len(c) for c, _ in pair_cells.values()])
        self.halo_m = M
        # send_idx[s, d, m]: s's local OWN index to pack for dst d
        self.send_idx = np.zeros((D, D, M), dtype=np.int32)
        # recv_slot[d, s, m]: d's local slot where s's m-th packed cell lands
        self.recv_slot = np.full((D, D, M), self.dump, dtype=np.int32)
        for (s, d), (cells, slots) in pair_cells.items():
            self.send_idx[s, d, :len(cells)] = own_pos[cells]
            self.recv_slot[d, s, :len(cells)] = slots

        # neighbour-pair ppermute rounds: the message digraph greedily
        # edge-coloured so that per round every shard sends <= 1 and
        # receives <= 1 message; plan memory O(rounds * D * M)
        edges = sorted(k for k in pair_cells if k[0] != k[1])
        colored: list[list] = []
        for (s, d) in edges:
            for r in colored:
                if all(s != s2 and d != d2 for s2, d2 in r):
                    r.append((s, d))
                    break
            else:
                colored.append([(s, d)])
        self.halo_rounds = []  # [(perm, send_idx (D, Mr), recv (D, Mr))]
        for r in colored:
            Mr = max(len(pair_cells[e][0]) for e in r)
            si = np.zeros((D, Mr), dtype=np.int32)
            rs = np.full((D, Mr), self.dump, dtype=np.int32)
            for s, d in r:
                cells, slots = pair_cells[(s, d)]
                si[s, :len(cells)] = own_pos[cells]
                rs[d, :len(cells)] = slots
            self.halo_rounds.append((tuple(r), si, rs))

    def gather_cells(self, g: np.ndarray, fill=0.0) -> np.ndarray:
        """Global per-cell array -> (D, n_loc, ...) padded local stacks."""
        out = np.full((self.n_devices, self.n_loc) + g.shape[1:], fill,
                      dtype=g.dtype)
        ok = self.l2g >= 0
        out[ok] = g[self.l2g[ok]]
        return out

    def gather_faces(self, g: np.ndarray, fill=0.0) -> np.ndarray:
        g = np.asarray(g)
        out = g[self.face_g]
        if np.issubdtype(g.dtype, np.integer):
            # index tables (e.g. WENO memb): zero dead faces, keep dtype
            out = out.copy()
            out[self.face_alive == 0] = int(fill)
            return out
        alive = self.face_alive.reshape(
            (self.n_devices, self.nf_max) + (1,) * (out.ndim - 2))
        return out * alive + fill * (1 - alive)

    def shard_cells(self, g: np.ndarray, fill=0.0) -> np.ndarray:
        """Global per-cell array -> (D * n_own_max, ...) owned-padded
        (padding rows repeat the shard's first owned cell: benign)."""
        g = np.asarray(g)
        D, nom = self.n_devices, self.n_own_max
        out = np.full((D, nom) + g.shape[1:], fill, dtype=g.dtype)
        for d in range(D):
            o = self.own_lists[d]
            out[d, :len(o)] = g[o]
            if 0 < len(o) < nom:
                out[d, len(o):] = g[o[0]]
        return out.reshape((D * nom,) + g.shape[1:])

    def unshard_cells(self, arr: np.ndarray) -> np.ndarray:
        """(D * n_own_max, ...) -> global (nc, ...) in mesh order."""
        arr = np.asarray(arr)
        D, nom = self.n_devices, self.n_own_max
        a = arr.reshape((D, nom) + arr.shape[1:])
        out = np.zeros((self.partition.shape[0],) + a.shape[2:],
                       dtype=a.dtype)
        for d in range(D):
            o = self.own_lists[d]
            out[o] = a[d, :len(o)]
        return out


class GeneralDistributedSimulator:
    """SPMD simulator over an arbitrary partition of an arbitrary mesh
    (reference counterpart: PArraySimulator over Metis partitions,
    ext/JutulPartitionedArraysExt/interface.jl:2-97). States travel as
    lists of per-shard dicts of (n_own_max, ...) tensors."""

    def __init__(self, mesh, system, group: ShardGroup, partition=None,
                 parameters: dict | None = None,
                 data_fields: dict | None = None,
                 halo_mode: str = "auto", model=None, dtype=None):
        self.group = group
        self.device = group.device
        self.dtype = dtype or float_type(self.device)
        D = group.size
        self.n_devices = D
        self.mesh = mesh
        # "all_to_all": dense (D, D, M) packed tables (fine at small D);
        # "ppermute": neighbour-pair rounds with O(D*deg*M) plan memory
        if halo_mode == "auto":
            halo_mode = "all_to_all" if D <= 16 else "ppermute"
        assert halo_mode in ("all_to_all", "ppermute"), halo_mode
        self.halo_mode = halo_mode
        if partition is None:
            partition = GreedyGraphPartitioner().partition(
                mesh.neighborship(), mesh.number_of_cells(), D)
        if model is not None:
            self.global_model = model
        else:
            gdd = DataDomain(mesh)
            for k, v in (data_fields or {}).items():
                gdd.set(k, v)
            self.global_model = SimulationModel(gdd, system)
        self.comp = compile_model(self.global_model)
        gparams = parameters or setup_parameters(self.global_model)
        if self.comp.neq_total != self.comp.ndof:
            raise NotImplementedError("square cell systems only")

        # contributions: any number of face-flux terms (any stencil width;
        # composite systems contribute several) + cell terms. Per-term
        # Jacobians concatenate along the stencil axis into one wide jacK,
        # and each contribution keeps its equation's row slice.
        self.acc_cons, self.flux_cons = [], []
        self._orient_signs = {}
        nb = np.asarray(mesh.neighborship())
        for info, con in self.comp.contribs:
            if isinstance(con, (AccumulationContribution,
                                CellTermContribution)):
                self.acc_cons.append((info, con))
            elif isinstance(con, FaceFluxContribution):
                # rows may follow the mesh orientation (plus=L, minus=R)
                # or flip it per face: flips fold into a +-1 face
                # "parameter" multiplied inside the flux, so the ± sums,
                # the Jacobian blocks, the CPR collapse and the adjoint
                # transpose all stay signed consistently
                plus, minus = np.asarray(con.plus), np.asarray(con.minus)
                same = (plus == nb[:, 0]) & (minus == nb[:, 1])
                flip = (plus == nb[:, 1]) & (minus == nb[:, 0])
                if not np.all(same | flip):
                    raise NotImplementedError(
                        "flux rows must connect the same cell pairs as "
                        "the mesh faces")
                if np.any(flip):
                    key = f"__flux_orient_{len(self.flux_cons)}"
                    self._orient_signs[key] = np.where(same, 1.0, -1.0)
                    con = FaceFluxContribution(
                        fn=(lambda model_, local, f, _b=con.fn, _k=key:
                            f[_k][..., None] * _b(model_, local, f)),
                        stencil=con.stencil, plus=nb[:, 0], minus=nb[:, 1],
                        name=con.name)
                self.flux_cons.append((info, con))
        self.flux_con = self.flux_cons[0][1] if self.flux_cons else None

        self.dec = GeneralDecomposition(
            mesh, partition, D,
            stencil=(np.concatenate(
                [np.asarray(c.stencil) for _i, c in self.flux_cons],
                axis=1) if self.flux_cons else None))
        dec = self.dec
        self.cell_params, self.face_params = {}, {}
        for name, var in self.global_model.parameters.items():
            ent = var.associated_entity(self.global_model).name()
            g = np.asarray(gparams[name])
            if ent == "Cells":
                # tiny-but-nonzero fill keeps dead-row accumulation and CNV
                # scaling finite while leaving global sums exact
                self.cell_params[name] = dec.gather_cells(
                    g.astype(np.float64), fill=1e-30)
            elif ent == "Faces":
                self.face_params[name] = dec.gather_faces(g, fill=0.0)
            else:
                raise NotImplementedError(ent)
        for key, sign in self._orient_signs.items():
            self.face_params[key] = dec.gather_faces(sign, fill=0.0)
        self._shards = {}
        self._bc_plans = {}
        self._cpr_setup = None
        self.last_report = None
        self.last_ministep = None
        self.last_substates = []

    # -- per-shard device data -------------------------------------------
    def _shard(self, d: int) -> dict:
        """Shard ``d``'s device tables, parameters and sum plans (built on
        first use)."""
        if d in self._shards:
            return self._shards[d]
        dec, dev, dt = self.dec, self.device, self.dtype
        nom, n_loc, K = dec.n_own_max, dec.n_loc, dec.K

        def t(a, dtype=torch.int64):
            return torch.as_tensor(np.array(a), device=dev, dtype=dtype)

        face_st = dec.face_st[d].astype(np.int64)
        rp = dec.row_plus[d].astype(np.int64)
        rm = dec.row_minus[d].astype(np.int64)
        fl = dec.face_l[d][:, None]
        fr = dec.face_r[d][:, None]
        sh = dict(
            cp={k: t(v[d], dt) for k, v in self.cell_params.items()},
            fp={k: (t(v[d]) if np.issubdtype(v.dtype, np.integer)
                    else t(v[d], dt)) for k, v in self.face_params.items()},
            face_st=t(face_st), row_plus=t(rp), row_minus=t(rm),
            face_alive=t(dec.face_alive[d], dt),
            own_alive=t(dec.own_alive[d], dt),
            mP=t((face_st == fl) & (fl < nom), torch.bool),
            mM=t((face_st == fr) & (fr < nom), torch.bool),
            pm_plan=SegmentSumPlan(np.concatenate([rp, rm]), nom + 1),
            st_plan=SegmentSumPlan(face_st.T.reshape(-1), n_loc),
        )
        if self.halo_mode == "all_to_all":
            slots = dec.recv_slot[d].reshape(-1).astype(np.int64)
            pos = np.flatnonzero(slots != dec.dump)
            send = dec.send_idx[d].astype(np.int64)
            sh["halo"] = dict(send_idx=t(send), pos=t(pos),
                              slots=t(slots[pos]),
                              send_plan=SegmentSumPlan(send.reshape(-1),
                                                       nom))
        else:
            rounds, sends = [], []
            for perm, si, rs in dec.halo_rounds:
                slots = rs[d].astype(np.int64)
                pos = np.flatnonzero(slots != dec.dump)
                rounds.append((list(perm), t(si[d]), t(pos),
                               t(slots[pos])))
                sends.append(si[d].astype(np.int64))
            sh["halo"] = dict(
                rounds=rounds,
                send_plan=SegmentSumPlan(
                    np.concatenate(sends) if sends else np.zeros(0, np.int64),
                    nom))
        self._shards[d] = sh
        return sh

    # -- state plumbing -------------------------------------------------
    def initial_state(self, **kw) -> dict:
        return setup_state(self.global_model, **kw)

    def shard_state(self, state: dict) -> list:
        """Global state -> per-shard dicts of (n_own_max, ...) tensors."""
        D, nom = self.n_devices, self.dec.n_own_max
        out = [{} for _ in range(D)]
        for k, v in state.items():
            if k not in self.global_model.primary_variables:
                continue
            a = self.dec.shard_cells(np.asarray(v))
            a = a.reshape((D, nom) + a.shape[1:])
            for d in range(D):
                out[d][k] = torch.as_tensor(np.array(a[d]),
                                            device=self.device,
                                            dtype=self.dtype)
        return out

    def gather_state(self, shards: list) -> dict:
        return {k: self.dec.unshard_cells(np.concatenate(
            [s[k].detach().cpu().numpy() for s in shards]))
            for k in shards[0]}

    # -- halo exchange ---------------------------------------------------
    def _halo(self, comm, sh, own):
        """(n_own_max, ...) -> (n_loc, ...) with ghosts filled; the dump
        row stays zero. Every ghost slot receives exactly once, so the
        receive is a plain write."""
        hal = sh["halo"]
        dec = self.dec
        tail = own.shape[1:]
        ext = own.new_zeros((dec.n_loc,) + tail)
        ext[:dec.n_own_max] = own
        if self.halo_mode == "all_to_all":
            recv = comm.all_to_all(own[hal["send_idx"]])  # (D, M, ...)
            ext[hal["slots"]] = recv.reshape((-1,) + tail)[hal["pos"]]
        else:
            for perm, si, pos, slots in hal["rounds"]:
                recv = comm.ppermute(own[si], perm)
                ext[slots] = recv[pos]
        return ext

    def _halo_transpose(self, comm, sh, ext):
        """The exact transpose of ``_halo``: ghost-slot cotangents go back
        along the reverse exchange and are summed into the owned rows they
        were packed from (fixed order)."""
        hal = sh["halo"]
        dec = self.dec
        tail = ext.shape[1:]
        own = ext[:dec.n_own_max]
        if self.halo_mode == "all_to_all":
            D, M = self.n_devices, dec.halo_m
            back = ext.new_zeros((D * M,) + tail)
            back[hal["pos"]] = ext[hal["slots"]]
            got = comm.all_to_all(back.reshape((D, M) + tail))
            got = got.reshape((D * M,) + tail)
        else:
            pieces = []
            for perm, si, pos, slots in hal["rounds"]:
                back = ext.new_zeros((si.shape[0],) + tail)
                back[pos] = ext[slots]
                pieces.append(comm.ppermute(back, [(b, a) for a, b in perm]))
            if not pieces:
                return own.clone()
            got = torch.cat(pieces)
        return own + hal["send_plan"].apply(got)

    def halo_fn(self, comm, sh):
        """The shard's halo closure."""
        return lambda own: self._halo(comm, sh, own)

    # -- the SPMD assembly body (shared by Newton and the adjoint) --------
    def _bc_plan(self, cells) -> IndexPlan:
        key = np.asarray(cells).tobytes()
        if key not in self._bc_plans:
            self._bc_plans[key] = IndexPlan(cells)
        return self._bc_plans[key]

    def _local_system(self, comm, sh, state_own, state0_own, cp, fp, q, dt,
                      with_jac: bool = True, with_crit: bool = True,
                      bc=None, extended: bool = False):
        """This shard's owned-row residual, optionally with the face-block
        Jacobian pieces and the global convergence criteria. ``extended``:
        the states are already halo-filled (n_loc rows) — then the
        ``with_jac=False, with_crit=False`` path runs no collective and is
        pure in its tensor inputs, so ``torch.func.vjp`` of it gives exact
        extended cotangents. Returns a dict (r_own, am, and with_jac:
        diag_own, diag_acc, jacK; with_crit: crit, rnorm)."""
        comp = self.comp
        model = self.global_model
        dec = self.dec
        nom, n_loc = dec.n_own_max, dec.n_loc
        neq, ndof = comp.neq_total, comp.ndof
        if extended:
            state_ext, state0_ext = state_own, state0_own
        else:
            halo = self.halo_fn(comm, sh)
            state_ext = {k: halo(v) for k, v in state_own.items()}
            state0_ext = {k: halo(v) for k, v in state0_own.items()}
        full = comp._eval_secondaries_local({**state_ext, **cp})
        full0 = comp._eval_secondaries_local({**state0_ext, **cp})
        U_ext = comp.get_dofs(state_ext)  # (n_loc, ndof)
        params_cell = comp._cell_entries(cp, include=("parameter",))
        cs0 = comp._cell_entries(full0)
        own_alive, face_alive = sh["own_alive"], sh["face_alive"]
        face_st, pm_plan = sh["face_st"], sh["pm_plan"]
        am = own_alive[:, None]
        fam = face_alive[:, None]
        U_own = U_ext[:nom]
        p_own = {k: v[:nom] for k, v in params_cell.items()}
        cs0_own = {k: v[:nom] for k, v in cs0.items()}
        rows = {info.name: U_ext.new_zeros((nom + 1, info.neq))
                for info in comp.equations}
        acc_jac = {}

        # --- accumulation (+ its diagonal) on owned rows ----------------
        for info, con in self.acc_cons:
            f = comp._local_closure(
                p_own, lambda loc, _c=con: _c.fn(model, loc, cs0_own, dt))
            vals = f(U_own) * am
            rows[info.name] = rows[info.name] + torch.cat(
                [vals, vals.new_zeros((1, info.neq))])
            if with_jac:
                cols = []
                for j in range(ndof):
                    e = torch.zeros_like(U_own)
                    e[:, j] = 1.0
                    cols.append(jvp(f, (U_own,), (e,))[1])
                jac = torch.stack(cols, dim=-1) * am[..., None]
                acc_jac[info.name] = acc_jac.get(info.name, 0) + jac

        # --- face fluxes (+ their Jacobian over the K-wide stencil) ------
        jacKs = []
        off = 0
        for info, con in self.flux_cons:
            Kc = int(np.asarray(con.stencil).shape[1])
            st_c = face_st[:, off:off + Kc]
            off += Kc
            u_st = U_ext[st_c]  # (nf, Kc, ndof)
            p_st = {k: v[st_c] for k, v in params_cell.items()}
            f = comp._local_closure(
                p_st, lambda loc, _c=con: _c.fn(model, loc, fp))
            flux = f(u_st) * fam  # (nf, neq_eq)
            rows[info.name] = rows[info.name] + pm_plan.apply(
                torch.cat([flux, -flux]))
            if with_jac:
                jac = u_st.new_zeros((u_st.shape[0], neq, Kc, ndof))
                sl = info.row_slice
                for k in range(Kc):
                    for j in range(ndof):
                        e = torch.zeros_like(u_st)
                        e[:, k, j] = 1.0
                        jac[:, sl, k, j] = jvp(f, (u_st,), (e,))[1]
                jacKs.append(jac * fam[..., None, None])
        r = torch.cat([rows[i.name] for i in comp.equations], dim=-1)

        # --- state-dependent pressure BCs (shard-local rows; padding rows
        # carry trans=0 and contribute exactly zero) ----------------------
        force = bc_force(bc)
        diag = None
        if with_jac:
            diag = U_ext.new_zeros((nom + 1, neq, ndof))
            for info in comp.equations:
                if info.name in acc_jac:
                    diag[:nom, info.row_slice] = acc_jac[info.name]
        if force is not None:
            pieces = [force.apply(model, info.eq, info.name,
                                  r[:, info.row_slice], full, dt)
                      for info in comp.equations]
            r = torch.cat(pieces, dim=-1)
            if with_jac:
                for info in comp.equations:
                    contrib = force.diagonal_jacobian(
                        model, info.eq, info.name, comp, full, dt)
                    if contrib is not None:
                        cells_j, jac = contrib
                        diag = self._bc_plan(cells_j).add(
                            diag, jac, info.row_slice)

        r_own = (r[:nom] - q) * am
        out = {"r_own": r_own, "am": am}
        if with_jac:
            # diag_acc: accumulation + BC diagonal only (the SpMV applies
            # every face-stencil coupling explicitly, self-couplings too);
            # diag additionally collects the face self-couplings for the
            # block-Jacobi preconditioner
            diag_acc = diag[:nom]
            jacK = None
            if jacKs:
                jacK = jacKs[0] if len(jacKs) == 1 else torch.cat(jacKs, 2)
                mP = sh["mP"][:, None, None, :]
                mM = sh["mM"][:, None, None, :]
                zero = jacK.new_zeros(())
                d_plus = torch.sum(torch.where(mP, jacK.transpose(2, 3),
                                               zero), dim=-1)
                d_minus = torch.sum(torch.where(mM, -jacK.transpose(2, 3),
                                                zero), dim=-1)
                diag = diag + pm_plan.apply(torch.cat([d_plus, d_minus]))
            eye = torch.eye(max(neq, ndof), dtype=diag.dtype,
                            device=diag.device)[:neq, :ndof]
            out["diag_own"] = torch.where(am[..., None] > 0, diag[:nom], eye)
            out.update(diag_acc=diag_acc, jacK=jacK)
        if with_crit:
            own_state = {k: (v[:nom] if torch.is_tensor(v) and v.ndim
                             and v.shape[0] == n_loc else v)
                         for k, v in full.items()}
            out["crit"], out["rnorm"] = reduce_criteria(
                comm, model, comp.equations, r_own, own_state, dt)
        return out

    def _system_matvec(self, comm, sh, sys):
        """Distributed SpMV closure: accumulation diagonal + EVERY
        face-stencil coupling applied explicitly (K slots per face)."""
        nom, ndof = self.dec.n_own_max, self.comp.ndof
        halo = self.halo_fn(comm, sh)
        am, diag_acc, jacK = sys["am"], sys["diag_acc"], sys["jacK"]
        face_st, pm_plan = sh["face_st"], sh["pm_plan"]

        def matvec(x_flat):
            x = x_flat.reshape(nom, ndof)
            y = bmv(diag_acc, x)
            if jacK is not None:
                x_ext = halo(x)
                c = torch.sum(jacK * x_ext[face_st][:, None],
                              dim=(2, 3))  # (nf, neq)
                y = y + pm_plan.apply(torch.cat([c, -c]))[:nom]
            return (y * am).reshape(-1)

        return matvec

    def _system_matvec_T(self, comm, sh, sys):
        """The exact transpose of ``_system_matvec``: face cotangents are
        gathered from the ± rows, pulled back through the coupling blocks,
        summed into the read cells (fixed order) and sent home by the
        transposed halo."""
        nom, neq = self.dec.n_own_max, self.comp.neq_total
        am, diag_acc, jacK = sys["am"], sys["diag_acc"], sys["jacK"]
        face_st = sh["face_st"]
        rp, rm = sh["row_plus"], sh["row_minus"]
        diag_T = torch.transpose(diag_acc, 1, 2)

        def matvec_T(y_flat):
            y = y_flat.reshape(nom, neq) * am
            x = bmv(diag_T, y)
            if jacK is not None:
                y_pad = torch.cat([y, y.new_zeros((1, neq))])
                z = y_pad[rp] - y_pad[rm]  # (nf, neq)
                zk = torch.sum(jacK * z[:, :, None, None], dim=1)  # nf,K,nd
                ext = sh["st_plan"].apply(
                    zk.transpose(0, 1).reshape(-1, zk.shape[-1]))
                x = x + self._halo_transpose(comm, sh, ext)
            return x.reshape(-1)

        return matvec_T

    # -- the SPMD Newton body -------------------------------------------
    def _solver(self, comm, sh, sys, eta, max_lin_it, preconditioner,
                cpr_smoother, cpr_cheby_lower):
        nom, neq, ndof = self.dec.n_own_max, self.comp.neq_total, \
            self.comp.ndof
        matvec = self._system_matvec(comm, sh, sys)
        if preconditioner == "cpr":
            from .general_cpr import cpr_apply, cpr_update

            ctabs = self._cpr_tables(comm.rank)
            halo = self.halo_fn(comm, sh)
            pstate = cpr_update(self._cpr_setup, sys, sh, ctabs, halo, comm,
                                smoother=cpr_smoother)

            def precond(x_flat):
                return cpr_apply(self._cpr_setup, pstate, sys, sh, halo,
                                 x_flat.reshape(nom, neq),
                                 smoother=cpr_smoother,
                                 cheby_lower=cpr_cheby_lower).reshape(-1)
        else:
            dinv = block_inv(sys["diag_own"])

            def precond(x_flat):
                return bmv(dinv, x_flat.reshape(nom, neq)).reshape(-1)

        du, stats = bicgstab(matvec, (-sys["r_own"]).reshape(-1),
                             maxiter=max_lin_it, rtol=eta, precond=precond,
                             dot_fn=psum_dot(comm))
        return du.reshape(nom, ndof) * sys["am"], stats

    def _cpr_tables(self, d: int):
        from .general_cpr import GeneralCPRSetup

        if self._cpr_setup is None:
            if self.flux_con is None:
                raise NotImplementedError(
                    "distributed CPR needs a face-flux system")
            self._cpr_setup = GeneralCPRSetup(self.dec)
        return self._cpr_setup.shard_tables(d, self.device)

    def newton_step_fn(self, rtol: float = 1e-8, max_lin_it: int = 200):
        """One Newton iteration on every shard: ``step(state, state0, dt,
        forces=None) -> (new_state, crit, lin_iters, lin_res)``."""
        def step(state, state0, dt, forces=None):
            fargs = self._force_args(forces)

            def body(comm, a):
                s, s0, (q, bc) = a
                sh = self._shard(comm.rank)
                sys = self._local_system(comm, sh, s, s0, sh["cp"], sh["fp"],
                                         q, dt, bc=bc)
                du, stats = self._solver(comm, sh, sys, rtol, max_lin_it,
                                         "block_jacobi", None, None)
                new = self.comp.apply_update(s, du, 1.0)
                return new, sys["crit"], stats["iterations"], \
                    stats["residual"]

            outs = self.group.run(body, list(zip(state, state0, fargs)))
            return ([o[0] for o in outs], outs[0][1], outs[0][2],
                    float(outs[0][3]))

        return step

    def ministep_fn(self, tolerances=None, max_newton: int = 15,
                    min_newton: int = 1, tol_factor_final_iteration=1.0,
                    max_residual: float = 1e20, rtol: float = 1e-8,
                    max_lin_it: int = 200, linear_forcing: str = "none",
                    relaxation=None, preconditioner: str = "block_jacobi",
                    cpr_smoother: str = "jacobi",
                    cpr_cheby_lower: float = 0.25):
        """The whole ministep Newton loop on every shard: check-before-
        solve, scaled per-criterion tolerances, optional Eisenstat-Walker
        forcing and relaxation, relaxed acceptance at the iteration cap.
        ``preconditioner``: "block_jacobi" (owned-diagonal additive
        Schwarz) or "cpr" (``general_cpr.py``). Returns ``step(state,
        state0, dt, fargs) -> (state, its, err, converged, lin_its)``."""
        comp = self.comp
        tols = 1e-3 if tolerances is None else tolerances
        if preconditioner not in ("block_jacobi", "cpr"):
            raise ValueError(f"unknown preconditioner {preconditioner!r}")
        if preconditioner == "cpr":
            self._cpr_tables(0)  # host set-up before the shards start

        def step(state, state0, dt, fargs):
            def body(comm, a):
                s, s0, (q, bc) = a
                sh = self._shard(comm.rank)

                def eval_state(s_own):
                    sys = self._local_system(comm, sh, s_own, s0, sh["cp"],
                                             sh["fp"], q, dt, bc=bc)
                    return sys, sys["crit"], sys["rnorm"]

                def solve(sys, eta):
                    return self._solver(comm, sh, sys, eta, max_lin_it,
                                        preconditioner, cpr_smoother,
                                        cpr_cheby_lower)

                return newton_ministep(
                    comp, self.global_model, eval_state, solve, s, tols,
                    min_newton, max_newton,
                    float(tol_factor_final_iteration), max_residual, rtol,
                    linear_forcing, relaxation)

            outs = self.group.run(body, list(zip(state, state0, fargs)))
            _s, its, err, conv, lin = outs[0]
            return [o[0] for o in outs], its, err, conv, lin

        return step

    # -- forces ----------------------------------------------------------
    def stack_cell_sources(self, forces) -> np.ndarray:
        neq = self.comp.neq_total
        nc = self.global_model.number_of_cells()
        qg = np.zeros((nc, neq))
        for name, f in (forces or {}).items():
            if hasattr(f, "pressure") and hasattr(f, "trans"):
                continue  # pressure BCs go through stack_boundary_conditions
            if not (hasattr(f, "cells") and hasattr(f, "values")):
                raise NotImplementedError(
                    f"force {name!r} not supported in general DD yet")
            # np.add.at: duplicate completion cells must ACCUMULATE
            np.add.at(qg, np.asarray(f.cells),
                      np.atleast_2d(np.asarray(f.values)))
        out = self.dec.shard_cells(qg)
        return out.reshape(self.n_devices, self.dec.n_own_max, neq) * \
            self.dec.own_alive[..., None]

    def stack_boundary_conditions(self, forces):
        """Per-shard stacks for state-dependent pressure BCs (cells
        remapped to shard-local OWNED indices)."""
        dec = self.dec

        def locate(c):
            return dec.partition[c], dec.own_pos[c]

        return collect_bc_stacks(forces, self.n_devices,
                                 self.comp.neq_total, locate)

    def _force_args(self, forces):
        """Per-shard (q, bc) of one step's forces."""
        D = self.n_devices
        q = (self.stack_cell_sources(forces) if forces else
             np.zeros((D, self.dec.n_own_max, self.comp.neq_total)))
        bc = self.stack_boundary_conditions(forces) if forces else None
        return [(torch.as_tensor(q[d], device=self.device, dtype=self.dtype),
                 None if bc is None else tuple(b[d] for b in bc))
                for d in range(D)]

    # -- outer loops (mirror of the single-process machinery) ------------
    def solve_ministep(self, state, state0, dt, fargs, max_newton: int = 15,
                       tol_cnv: float = 1e-3, **mini_kwargs):
        """One ministep on every shard. Returns (ok, state, newton_its,
        linear_its); divergence or the iteration cap FAIL the ministep so
        the caller cuts dt (reference simulator.jl:779-795)."""
        mini_kwargs.setdefault("tolerances", float(tol_cnv))
        mini_kwargs["max_newton"] = max_newton
        step = self.ministep_fn(**mini_kwargs)
        new_state, its, err, conv, lin = step(state, state0, dt, fargs)
        self._last_err = err
        return conv, (new_state if conv else list(state)), its, lin

    def solve_timestep(self, state, state0, dT, max_newton: int = 15,
                       tol_cnv: float = 1e-3, forces=None,
                       max_timestep_cuts: int = 5, cut_factor: float = 0.5,
                       growth_factor: float = 2.0,
                       timestep_selectors=None, config=None,
                       **mini_kwargs):
        """Report step = ministep loop with dt cutting on failure (the
        same nonlinear machinery as the single-process loop the reference
        reuses per rank, ext overloads.jl:155 + simulator/timesteps.jl:51).
        ``timestep_selectors`` + ``config`` enable the product dt
        machinery; without them dt grows by ``growth_factor``. Returns
        (state, total Newton its); per-ministep detail in
        ``self.last_report``."""
        from ..simulator.simulator import simulator_config
        from ..simulator.timesteps import (
            MinistepRecord,
            pick_first_timestep,
            pick_timestep,
        )

        fargs = self._force_args(forces)
        dT = float(dT)
        if timestep_selectors is not None and config is None:
            config = simulator_config()
        t_done = 0.0
        dt = (pick_first_timestep(dT, timestep_selectors, config)
              if timestep_selectors else dT)
        cuts, its_total = 0, 0
        minis, history = [], []
        self.last_substates = []  # accepted (gathered state, dt) pairs
        cur, prev = list(state), state0
        while t_done < dT * (1 - 1e-12):
            dt_eff = min(dt, dT - t_done)
            t_mini = time.perf_counter()
            ok, cur_new, its, lin = self.solve_ministep(
                cur, prev, dt_eff, fargs, max_newton=max_newton,
                tol_cnv=tol_cnv, **mini_kwargs)
            its_total += its
            minis.append({"dt": dt_eff, "success": ok, "iterations": its,
                          "linear_iterations": lin,
                          "wall_time": time.perf_counter() - t_mini})
            history.append(MinistepRecord(dt=dt_eff, success=ok,
                                          iterations=its))
            if ok:
                # the last accepted ministep (start, end, dt): an f64
                # re-assembly checks it
                self.last_ministep = (prev, cur_new, dt_eff)
                self.last_substates.append(
                    (self.gather_state(cur_new), dt_eff))
                t_done += dt_eff
                prev = cur = cur_new
                after_cut = cuts > 0
                cuts = 0
                if timestep_selectors:
                    dt = pick_timestep(dt_eff, dT - t_done, history,
                                       timestep_selectors, config,
                                       after_cut)
                else:
                    dt = min(dt * growth_factor,
                             dT - t_done if t_done < dT else dt)
                    if after_cut:
                        dt = min(dt, dt_eff)  # damp growth after a cut
            else:
                cuts += 1
                if cuts > max_timestep_cuts:
                    raise RuntimeError(
                        f"general-partition ministep failed after "
                        f"{max_timestep_cuts} cuts (dt={dt_eff:g})")
                dt = dt_eff * cut_factor
                cur = list(prev)
        self.last_report = {"ministeps": minis, "success": True}
        return cur, its_total

    def solve_timestep_jit(self, state, dT, forces=None, dt_init=None,
                           max_newton: int = 15, tol_cnv: float = 1e-3,
                           cap: int = 20, max_timestep_cuts: int = 5,
                           cut_factor: float = 0.5,
                           growth_factor: float = 2.0, target_its=None,
                           dt_max_increase: float = 10.0,
                           dt_max_decrease: float = 0.1, **mini_kwargs):
        """One report step with the JAX package's in-program dt rules
        (``timestep_fn``): ``target_its`` (IterationTimestepSelector's
        formula) or fixed ``growth_factor`` growth, clamped per ministep,
        damped right after a cut; each ministep starts from the last
        accepted state. An eager loop here, with the same decisions.
        Raises when a ministep fails with its cuts spent."""
        fargs = self._force_args(forces)
        dT = float(dT)
        t_done = 0.0
        dt = min(float(dT if dt_init is None else dt_init), dT)
        cuts, k, minis = 0, 0, []
        cur = list(state)
        t0 = time.perf_counter()
        while t_done < dT * (1 - 1e-12):
            dt_eff = min(dt, dT - t_done)
            ok, new, its, lin = self.solve_ministep(
                cur, cur, dt_eff, fargs, max_newton=max_newton,
                tol_cnv=tol_cnv, **mini_kwargs)
            if k < cap:
                minis.append({"dt": dt_eff, "success": ok,
                              "iterations": its, "linear_iterations": lin,
                              "errors": [float(self._last_err)]})
            k += 1
            if not ok and cuts >= max_timestep_cuts:
                raise RuntimeError(
                    f"general-partition report step aborted after "
                    f"{max_timestep_cuts} dt cuts (dT={dT:g}, "
                    f"t_done={t_done:g})")
            if ok:
                self.last_ministep = (cur, new, dt_eff)
                cur = new
                t_done += dt_eff
                if target_its is not None:
                    nxt = dt_eff * (float(target_its) + 1.0) / (
                        max(its, 1) + 1.0)
                else:
                    nxt = dt_eff * float(growth_factor)
                nxt = min(max(nxt, dt_eff * dt_max_decrease),
                          dt_eff * dt_max_increase)
                dt = min(nxt, dt_eff) if cuts > 0 else nxt
                cuts = 0
            else:
                dt = dt_eff * float(cut_factor)
                cuts += 1
        wall = time.perf_counter() - t0
        if k > cap:
            print(f"Warning: {k} ministeps exceeded cap={cap}; "
                  f"reports truncated.")
        for m in minis:
            m.update(wall_time=wall / max(min(k, cap), 1),
                     wall_time_is_amortized=True)
        self.last_report = {"ministeps": minis, "success": True}
        self.last_substates = []
        return cur, int(sum(m["iterations"] for m in minis))

    def simulate(self, state0, timesteps, forces=None, max_newton: int = 15,
                 tol_cnv: float = 1e-3, output_path=None,
                 output_substates: bool = False, info_level: int = 0,
                 jit_timestep: bool = False, **kwargs):
        """Schedule-driven run mirroring the slab surface: per-step forces
        (dict or list), optional per-step output files, states gathered to
        global mesh order. ``output_substates=True`` attaches the accepted
        intermediate ministep states (key ``"substates"``) so
        ``expand_to_ministeps`` can rebuild the exact ministep sequence the
        adjoint requires after dt cuts. ``jit_timestep=True`` takes the
        report-step rules of ``solve_timestep_jit``."""
        if jit_timestep and output_substates:
            raise NotImplementedError(
                "output_substates needs the per-ministep path")
        if jit_timestep and kwargs.get("timestep_selectors"):
            raise NotImplementedError(
                "jit_timestep uses the in-program dt selection: pass "
                "target_its instead of timestep_selectors")
        cur = self.shard_state(state0)
        prev = cur
        states, reports = [], []
        for n, dt in enumerate(timesteps):
            f = forces[n] if isinstance(forces, (list, tuple)) else forces
            t0 = time.perf_counter()
            if jit_timestep:
                cur, its = self.solve_timestep_jit(
                    cur, dt, forces=f, max_newton=max_newton,
                    tol_cnv=tol_cnv, **kwargs)
            else:
                cur, its = self.solve_timestep(cur, prev, dt,
                                               max_newton=max_newton,
                                               tol_cnv=tol_cnv, forces=f,
                                               **kwargs)
            wall = time.perf_counter() - t0
            prev = cur
            host = self.gather_state(cur)
            if output_substates and len(self.last_substates) > 1:
                host["substates"] = [st for st, _dt
                                     in self.last_substates[:-1]]
            minis = self.last_report["ministeps"]
            rep = {"ministeps": list(minis), "success": True,
                   "dt": float(dt)}
            states.append(host)
            reports.append(rep)
            if output_path is not None:
                from ..simulator.io import store_output

                store_output(output_path, n, host, rep)
            if info_level >= 0:
                print(f"Step {n + 1}/{len(timesteps)}: {its} its, "
                      f"{len(minis)} ministeps, {wall:.2f}s "
                      f"({self.n_devices} shards, general partition)")
        return states, reports
