"""The compiled model: dof layout, secondaries, forces, convergence, update.

Port of the part of the JAX package's ``CompiledModel`` (ops/assembly.py)
that the stencil engine (ops/stencil.py) calls. Counterpart of Jutul's
local-AD assembly bookkeeping (reference: src/ad/ad.jl,
src/equations.jl alignment, src/models.jl:818-928). The generic
block-ELL residual/Jacobian engine is not part of this port yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..core.entities import CELLS, FACES, JutulEntity


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

        self.equations: list[EquationInfo] = []
        ofs = 0
        for name, eq in model.equations.items():
            if eq.entity(model) != CELLS:
                raise NotImplementedError(
                    f"equation {name!r}: only cell equations are ported")
            neq = eq.number_of_equations_per_entity(model)
            self.equations.append(EquationInfo(name, eq, neq, slice(ofs, ofs + neq)))
            ofs += neq
        for name, var in model.primary_variables.items():
            if var.associated_entity(model) != CELLS:
                raise NotImplementedError(
                    f"primary {name!r} lives on {var.associated_entity(model)}")
        self.n_cells = model.count_entities(CELLS)
        self.neq_total = ofs
        if self.neq_total != self.ndof:
            raise ValueError(
                f"equations per row ({self.neq_total}) != dofs per row "
                f"({self.ndof}); square systems required"
            )
        self.contribs = [(info, con) for info in self.equations
                         for con in info.eq.contributions(model)]

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
        """Subset of state living on cells."""
        model = self.model
        out = {}
        for name, val in state.items():
            if self.cell_entry_entity.get(name) != CELLS:
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
        """Face parameters."""
        return {name: val for name, val in state.items()
                if self.cell_entry_entity.get(name) == FACES}

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


def compile_model(model) -> CompiledModel:
    return CompiledModel(model)
