"""The compiled model: dof layout, secondaries, forces, convergence, update,
and the generic block-ELL residual/Jacobian engine.

Port of the JAX package's ``CompiledModel`` (ops/assembly.py). Counterpart
of Jutul's local-AD assembly stack (reference: src/ad/ad.jl dual
allocation and fill_equation_entries!, src/ad/local_ad.jl, src/equations.jl
alignment, src/conservation/conservation.jl TPFA assembly,
src/models.jl:818-928).

The stencil engine (ops/stencil.py) calls the bookkeeping half. The
generic half (``residual``, ``jacobian_blocks``, ``assemble``) serves
``Simulator(use_stencil=False)`` on any mesh:

- residual: secondary variables evaluated once over all cells, each
  contribution evaluated on the whole batch of cells or of faces (cell
  states gathered through the face stencil), and every row SUMS its
  incident faces in a fixed order (``SegmentSumPlan``) — no scatter-add
  anywhere, so a CUDA run repeats its bits;
- Jacobian: the contribution's closure over the packed primary dofs
  re-evaluates the secondary chain and is differentiated with one
  ``torch.func.jvp`` per dof (per stencil position and dof for fluxes) over
  the whole batch — the columns ``jax.vmap(jax.jacfwd(...))`` gives the JAX
  package, with JAX's derivative rules kept by the model code (``clip``
  weight 0.5 at a bound, the upwind tie to the left). The per-face blocks
  are summed into their (row, slot) destinations the same way (the
  reference's ``jacobian_positions`` / ``injective_alignment!``,
  ad/ad.jl:103-169).

The ELL structure and the sum plans are built on the first generic use:
a stencil ``Simulator`` never pays that host work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.func import jvp

from ..core.entities import CELLS, FACES, JutulEntity
from ..models.equations import (
    AccumulationContribution,
    CellTermContribution,
    FaceFluxContribution,
)
from .blockell import BlockELL, ELLStructure, IndexPlan, SegmentSumPlan


@dataclass
class EquationInfo:
    name: str
    eq: Any
    neq: int
    row_slice: slice  # into the stacked per-cell equation axis


class CompiledModel:
    """Static compilation product of a SimulationModel: pure functions
    over state dicts of tensors (evaluate_secondaries, get_dofs,
    unpack_dofs, apply_update, convergence, _apply_forces)."""

    def __init__(self, model):
        self.model = model
        model.validate()
        self.layout = model.dof_layout()
        self.ndof = self.layout.ndof
        self.secondary_order = model.sorted_secondary_variables()

        # classify state entries by entity
        self.cell_entry_entity: dict[str, JutulEntity] = {}
        for group in (model.primary_variables, model.parameters,
                      model.secondary_variables):
            for name, var in group.items():
                self.cell_entry_entity[name] = var.associated_entity(model)

        # equations live on ONE common row entity — Cells usually, but any
        # entity works (reference: equations on arbitrary entities,
        # src/equations.jl:328-434); primaries must share it so the block
        # system stays square per row. Mixed-entity models compile through
        # ops/mixed.py (``compile_model`` dispatches).
        self.equations: list[EquationInfo] = []
        ofs = 0
        row_entity = None
        for name, eq in model.equations.items():
            ent = eq.entity(model)
            if row_entity is None:
                row_entity = ent
            elif ent != row_entity:
                raise NotImplementedError(
                    f"single-entity engine: all equations must share one "
                    f"entity; got {row_entity} and {ent}. Mixed-entity "
                    f"models compile via ops/mixed.py — use compile_model")
            neq = eq.number_of_equations_per_entity(model)
            self.equations.append(EquationInfo(name, eq, neq, slice(ofs, ofs + neq)))
            ofs += neq
        self.row_entity = row_entity if row_entity is not None else CELLS
        for name, var in model.primary_variables.items():
            if var.associated_entity(model) != self.row_entity:
                raise NotImplementedError(
                    f"primary {name!r} lives on "
                    f"{var.associated_entity(model)}, equations on "
                    f"{self.row_entity}")
        # row-entity count; named n_cells for the common Cells case
        self.n_cells = model.count_entities(self.row_entity)
        # coupling ("face") parameters: entries on Faces when rows are not
        # Faces themselves; a Faces-row model has no distinct coupling entity
        self.coupling_entity = FACES if self.row_entity != FACES else None
        self.neq_total = ofs
        if self.neq_total != self.ndof:
            raise ValueError(
                f"equations per row ({self.neq_total}) != dofs per row "
                f"({self.ndof}); square systems required"
            )
        self.contribs = [(info, con) for info in self.equations
                         for con in info.eq.contributions(model)]
        self._ell = None
        self._meta = None  # per-contribution sum plans (generic engine)
        self._force_plans: dict = {}

    # ------------------------------------------------------------------
    # state helpers
    # ------------------------------------------------------------------
    def evaluate_secondaries(self, state: dict) -> dict:
        """Secondary-variable sweep in topological order (reference:
        update_secondary_variables!, variable_evaluation.jl:87). The
        elementwise contract makes it valid for any batch of cells."""
        model = self.model
        state = dict(state)
        for name in self.secondary_order:
            var = model.secondary_variables[name]
            deps = {d: state[d] for d in var.dependencies}
            state[name] = var.evaluate(model, **deps)
        return state

    # the JAX package vmaps a per-cell copy; batched tensors need none
    _eval_secondaries_local = evaluate_secondaries

    def _cell_entries(self, state: dict, include=("primary", "secondary",
                                                  "parameter")) -> dict:
        """Subset of state living on the row entity (Cells usually)."""
        model = self.model
        out = {}
        for name, val in state.items():
            if self.cell_entry_entity.get(name) != self.row_entity:
                continue
            kind = (
                "primary" if name in model.primary_variables
                else "secondary" if name in model.secondary_variables
                else "parameter"
            )
            if kind in include:
                out[name] = val
        return out

    def _face_entries(self, state: dict) -> dict:
        """Coupling-entity entries (Faces parameters of a cell-row
        model; none for a Faces-row model)."""
        if self.coupling_entity is None:
            return {}
        return {name: val for name, val in state.items()
                if self.cell_entry_entity.get(name) == self.coupling_entity}

    def get_dofs(self, state: dict):
        """(n_cells, ndof) packed primary dof matrix."""
        parts = []
        for name in self.layout.names:
            var = self.model.primary_variables[name]
            parts.append(var.pack(state[name]))
        return torch.cat(parts, dim=-1)

    def unpack_dofs(self, U) -> dict:
        """U (..., ndof) -> dict of primary variable values."""
        out = {}
        for name in self.layout.names:
            var = self.model.primary_variables[name]
            out[name] = var.unpack(U[..., self.layout.slices[name]])
        return out

    def apply_update(self, state: dict, du, relaxation=1.0) -> dict:
        """Newton update of primaries with per-variable clamping
        (reference: update_primary_variables!, models.jl:928)."""
        state = dict(state)
        for name in self.layout.names:
            var = self.model.primary_variables[name]
            sl = self.layout.slices[name]
            state[name] = var.update(state[name], du[..., sl], relaxation,
                                     self.model)
        return state

    def _apply_forces(self, r, state, dt, forces):
        r = r.clone()
        for info in self.equations:
            sl = info.row_slice
            r_eq = r[:, sl]
            for fv in forces.values():
                for force in _as_force_list(fv):
                    r_eq = force.apply(self.model, info.eq, info.name, r_eq,
                                       state, dt)
            r[:, sl] = r_eq
        return r

    def _force_diagonal_blocks(self, state, dt, forces):
        """Yield (row_slice, cells, blocks) for every state-dependent force:
        ``cells`` a host int array (ns,), ``blocks`` (ns, neq_e, ndof) to add
        on the Jacobian's diagonal (reference: the force Jacobian path of
        apply_forces_to_equation!, equations.jl:603)."""
        for info in self.equations:
            for fv in forces.values():
                for force in _as_force_list(fv):
                    contrib = force.diagonal_jacobian(
                        self.model, info.eq, info.name, self, state, dt)
                    if contrib is not None:
                        cells, jac = contrib
                        yield info.row_slice, np.asarray(cells), jac

    # ------------------------------------------------------------------
    # generic engine: sparsity and sum plans (host, on first use)
    # ------------------------------------------------------------------
    @property
    def ell(self) -> ELLStructure:
        """The block-ELL structure of the Jacobian (built on first use)."""
        self._generic()
        return self._ell

    def _generic(self) -> list:
        """Per-contribution sum plans (built with the ELL structure on
        first use)."""
        if self._meta is None:
            self._generic_setup()
        return self._meta

    def _generic_setup(self) -> None:
        edges, metas = [], []
        for info, con in self.contribs:
            meta: dict = {}
            if isinstance(con, FaceFluxContribution):
                st = np.asarray(con.stencil, dtype=np.int64)
                plus = np.asarray(con.plus, dtype=np.int64)
                minus = np.asarray(con.minus, dtype=np.int64)
                for k in range(st.shape[1]):
                    edges.append(np.stack([plus, st[:, k]], axis=1))
                    edges.append(np.stack([minus, st[:, k]], axis=1))
                meta.update(stencil=st, plus=plus, minus=minus,
                            K=st.shape[1])
            metas.append(meta)
        all_edges = (np.concatenate(edges, axis=0) if edges
                     else np.zeros((0, 2), np.int64))
        ell = ELLStructure.build(self.n_cells, all_edges)
        for meta in metas:
            if meta:
                st, K = meta["stencil"], meta["K"]
                meta["plus_slots"] = np.stack(
                    [ell.slots_for(meta["plus"], st[:, k]) for k in range(K)],
                    axis=1)
                meta["minus_slots"] = np.stack(
                    [ell.slots_for(meta["minus"], st[:, k])
                     for k in range(K)], axis=1)
                self._build_gather_tables(meta, ell)
        self._ell, self._meta = ell, metas

    def _build_gather_tables(self, meta: dict, ell: ELLStructure) -> None:
        """Fixed-order sums that invert the scatter (the dual of the
        reference's half-face CSR maps, src/domains.jl:101): the
        residual's, over the signed fluxes ``[flux, -flux]`` into the rows
        plus/minus, and the Jacobian's, over the signed per-face blocks
        ``[jac, -jac]`` (face*K + k within each sign) into their
        (row, slot) destinations ``row*S + slot``. The residual is summed
        from plus/minus directly: the Jacobian's diagonal entries would
        multi-count faces for wide stencils where a row appears at
        several stencil positions."""
        n, S = self.n_cells, ell.n_slots
        plus, minus = meta["plus"], meta["minus"]
        meta["r_plan"] = SegmentSumPlan(np.concatenate([plus, minus]), n)
        meta["j_plan"] = SegmentSumPlan(np.concatenate([
            (plus[:, None] * S + meta["plus_slots"]).reshape(-1),
            (minus[:, None] * S + meta["minus_slots"]).reshape(-1)]), n * S)
        meta["dev"] = {}

    @staticmethod
    def _stencil_on(meta, device):
        key = str(device)
        if key not in meta["dev"]:
            meta["dev"][key] = torch.as_tensor(meta["stencil"], device=device)
        return meta["dev"][key]

    # ------------------------------------------------------------------
    # generic engine: residual
    # ------------------------------------------------------------------
    def residual(self, state: dict, state0: dict, dt, forces=None):
        """(n_cells, neq_total) residual of raw states (secondaries are
        evaluated here), the stencil engines' contract."""
        return self._residual_evaluated(self.evaluate_secondaries(state),
                                        self.evaluate_secondaries(state0),
                                        dt, forces)

    def _residual_evaluated(self, state: dict, state0: dict, dt,
                            forces=None):
        """The residual of secondary-evaluated states. Gather-based:
        per-face fluxes computed once, each row sums its incident faces
        in a fixed order."""
        model = self.model
        metas = self._generic()
        cell_state = self._cell_entries(state)
        cell_state0 = self._cell_entries(state0)
        face_state = self._face_entries(state)
        per_eq: dict[str, list] = {info.name: [] for info in self.equations}
        for (info, con), meta in zip(self.contribs, metas):
            if isinstance(con, (AccumulationContribution,
                                CellTermContribution)):
                per_eq[info.name].append(
                    con.fn(model, cell_state, cell_state0, dt))
            elif isinstance(con, FaceFluxContribution):
                dev = next(iter(cell_state.values())).device
                st = self._stencil_on(meta, dev)
                local = {k: v[st] for k, v in cell_state.items()}
                flux = con.fn(model, local, face_state)  # (nf, neq)
                per_eq[info.name].append(
                    meta["r_plan"].apply(torch.cat([flux, -flux])))
            else:
                raise TypeError(f"Unknown contribution {type(con)}")
        pieces = []
        for info in self.equations:
            parts = per_eq[info.name]
            tot = parts[0]
            for p in parts[1:]:
                tot = tot + p
            pieces.append(tot)
        r = torch.cat(pieces, dim=-1) if len(pieces) > 1 else pieces[0]
        if forces:
            r = self._apply_forces(r, state, dt, forces)
        return r

    # ------------------------------------------------------------------
    # generic engine: Jacobian
    # ------------------------------------------------------------------
    def _local_closure(self, params, fn):
        """u (..., ndof) -> fn(secondary-evaluated local state)."""
        def closure(u):
            local = dict(params)
            local.update(self.unpack_dofs(u))
            return fn(self._eval_secondaries_local(local))
        return closure

    def jacobian_blocks(self, state: dict, state0: dict, dt, forces=None):
        """BlockELL blocks (n, S, neq_total, ndof): the columns of
        ``vmap(jacfwd)`` by one ``torch.func.jvp`` per dof over the whole
        batch, gathered into their (row, slot) destinations (counterpart
        of fill_equation_entries!, reference ad/generic.jl:53)."""
        model = self.model
        metas = self._generic()
        n, S, ndof = self.n_cells, self._ell.n_slots, self.ndof
        params_cell = self._cell_entries(state, include=("parameter",))
        cell_state0 = self._cell_entries(state0)
        face_state = self._face_entries(state)
        U_all = self.get_dofs(state)  # (n, ndof)
        dev = U_all.device
        cell_eq: dict[str, list] = {i.name: [] for i in self.equations}
        face_eq: dict[str, list] = {i.name: [] for i in self.equations}
        for (info, con), meta in zip(self.contribs, metas):
            neq_e = info.neq
            if isinstance(con, (AccumulationContribution,
                                CellTermContribution)):
                f = self._local_closure(
                    params_cell,
                    lambda loc, _c=con: _c.fn(model, loc, cell_state0, dt))
                cols = []
                for j in range(ndof):
                    ej = torch.zeros_like(U_all)
                    ej[:, j] = 1.0
                    cols.append(jvp(f, (U_all,), (ej,))[1])  # (n, neq_e)
                cell_eq[info.name].append(torch.stack(cols, dim=-1))
            elif isinstance(con, FaceFluxContribution):
                st = self._stencil_on(meta, dev)
                nf, K = st.shape
                p_st = {k: v[st] for k, v in params_cell.items()}
                U_st = U_all[st]  # (nf, K, ndof)
                f = self._local_closure(
                    p_st, lambda loc, _c=con: _c.fn(model, loc, face_state))
                jac = U_all.new_empty((nf, K, neq_e, ndof))
                for k in range(K):
                    for j in range(ndof):
                        e = torch.zeros_like(U_st)
                        e[:, k, j] = 1.0
                        jac[:, k, :, j] = jvp(f, (U_st,), (e,))[1]
                jac_fk = jac.reshape(nf * K, neq_e, ndof)  # face*K + k
                face_eq[info.name].append(meta["j_plan"].apply(
                    torch.cat([jac_fk, -jac_fk])).reshape(n, S, neq_e, ndof))

        def _sum(parts, zero_shape):
            if not parts:
                return U_all.new_zeros(zero_shape)
            tot = parts[0]
            for p in parts[1:]:
                tot = tot + p
            return tot

        per_eq = []
        for i in self.equations:
            blk = _sum(face_eq[i.name], (n, S, i.neq, ndof))
            if cell_eq[i.name]:
                blk[:, 0] = blk[:, 0] + _sum(cell_eq[i.name], None)
            per_eq.append(blk)
        blocks = torch.cat(per_eq, dim=2)
        if forces:
            blocks = self._apply_force_jacobians(blocks, state, dt, forces)
        return blocks

    def _apply_force_jacobians(self, blocks, state, dt, forces):
        """Add each state-dependent force's diagonal blocks; repeated cells
        are summed in a fixed order first, so the write is atomic-free."""
        for sl, cells, jac in self._force_diagonal_blocks(state, dt, forces):
            key = cells.tobytes()  # one plan per force structure
            if key not in self._force_plans:
                self._force_plans[key] = IndexPlan(cells)
            blocks = self._force_plans[key].add(blocks, jac, 0, sl,
                                                inplace=True)
        return blocks

    def assemble(self, state: dict, state0: dict, dt, forces=None,
                 with_jacobian: bool = True):
        """(r, BlockELL J, secondary-evaluated state) — the generic
        engine's entry, with the stencil engines' signature."""
        state = self.evaluate_secondaries(state)
        state0 = self.evaluate_secondaries(state0)
        r = self._residual_evaluated(state, state0, dt, forces)
        if not with_jacobian:
            return r, None, state
        blocks = self.jacobian_blocks(state, state0, dt, forces)
        return r, BlockELL(self.ell, blocks), state

    def convergence(self, r, state, dt) -> dict:
        """Nested dict eq_name -> criterion -> (neq,) errors
        (reference: check_convergence, models.jl:818)."""
        return {info.name: info.eq.convergence_criterion(
                    self.model, info.name, r[:, info.row_slice], state, dt)
                for info in self.equations}


def _as_force_list(fv):
    if fv is None:
        return ()
    if isinstance(fv, (list, tuple)):
        return fv
    return (fv,)


def compile_model(model):
    """The compiled model: a ``CompiledModel``, or for a model whose
    equations live on more than one entity (reference equations.jl:
    328-434) a ``MixedCompiledModel`` — per-entity views coupled through
    the MultiModel assembly (ops/mixed.py)."""
    from .mixed import MixedCompiledModel, is_mixed_entity

    if is_mixed_entity(model):
        return MixedCompiledModel(model)
    return CompiledModel(model)
