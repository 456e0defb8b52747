"""Mixed-entity models: equations on DIFFERENT entities in ONE model.

Port of the JAX package's ``ops/mixed.py``. Counterpart of the reference's
per-equation entity support (reference: src/equations.jl:328-434 — Cells-
and Faces-entity equations coexist in one model; well segment models need
exactly this). ``compile_model`` compiles a mixed model by:

1. splitting it into per-entity VIEW models (same domain/system, the
   subset of primaries/equations living on that entity — each view is an
   ordinary single-entity model for the generic engine);
2. turning each equation's declared ``CrossCoupling``s
   (models/equations.py) into cross-term pairs;
3. reusing the MultiModel assembly (multimodel/core.py): the coupled
   Jacobian is per-view BlockELL diagonals + COO coupling blocks in a
   MultiLinearizedSystem, solved by the Krylov multi path or the direct
   solve. Repeated rows (a cell's incident faces) are summed in a fixed
   order there.

The facade keeps the SINGLE-MODEL state contract: one flat state dict
holding both entities' entries (each view reads only its own keys), so
``Simulator`` drives a mixed model through its ordinary single-model path.
"""

from __future__ import annotations

import copy
from collections import OrderedDict

from .blockell import BlockELL


class _CouplingAdapter:
    """CrossCoupling -> the multimodel cross-term protocol."""

    def __init__(self, cc, base_model):
        self.cc = cc
        self.base_model = base_model
        self.symmetric = cc.symmetric
        self.conn_data = cc.conn_data

    def value(self, model_t, model_s, local_t, local_s, dt, conn=None):
        return self.cc.fn(self.base_model, local_t, local_s, dt, conn)


def _entity_view(model, entity, eq_names):
    """Shallow view of ``model`` restricted to one entity's primaries and
    equations (parameters/secondaries stay shared — the engine filters by
    entity internally)."""
    view = copy.copy(model)
    view.primary_variables = OrderedDict(
        (k, v) for k, v in model.primary_variables.items()
        if v.associated_entity(model) == entity)
    view.equations = OrderedDict((k, model.equations[k]) for k in eq_names)
    if not view.primary_variables:
        raise ValueError(
            f"mixed-entity model: equations on {entity} but no primary "
            "variable lives there (per-entity blocks must be square)")
    return view


def is_mixed_entity(model) -> bool:
    return len({eq.entity(model) for eq in model.equations.values()}) > 1


class MixedCompiledModel:
    """Compiled mixed-entity model with the single-model state contract.

    ``assemble``/``residual``/``convergence``/``apply_update`` take and
    return FLAT state dicts (residuals and updates are dicts by entity
    name); the Jacobian is a MultiLinearizedSystem (per-entity diagonals +
    cross-entity coupling blocks) that ``GenericKrylov`` and
    ``DirectSolver`` consume.
    """

    is_multi = False  # the single-model Simulator path

    def __init__(self, model):
        from ..multimodel.core import CompiledMultiModel, MultiModel

        self.model = model
        groups: "OrderedDict" = OrderedDict()
        for name, eq in model.equations.items():
            groups.setdefault(eq.entity(model), []).append(name)
        self.entity_names = {ent: ent.name() for ent in groups}
        views = OrderedDict(
            (self.entity_names[ent], _entity_view(model, ent, names))
            for ent, names in groups.items())
        mm = MultiModel(views)
        for eq_name, eq in model.equations.items():
            ent = eq.entity(model)
            for cc in eq.cross_couplings(model):
                src = self.entity_names.get(cc.source_entity,
                                            cc.source_entity.name())
                if src not in views:
                    raise KeyError(
                        f"coupling of {eq_name!r} references entity "
                        f"{src!r} with no equations/primaries")
                mm.add_cross_term(
                    _CouplingAdapter(cc, model),
                    target=self.entity_names[ent], source=src,
                    equation=eq_name, target_cells=cc.rows,
                    source_cells=cc.cols)
        self._multi = CompiledMultiModel(mm)
        self.comps = self._multi.comps
        self.layout = self._multi.layout
        # the tolerance lookup sees the ORIGINAL flat equation names
        self.equations = [info for c in self.comps.values()
                          for info in c.equations]
        self.n_cells = model.number_of_cells()
        # the views share the model's whole secondary chain
        self.evaluate_secondaries = next(
            iter(self.comps.values())).evaluate_secondaries

    def _nest(self, flat):
        return {n: flat for n in self.comps}

    def get_dofs(self, state: dict) -> dict:
        return {n: c.get_dofs(state) for n, c in self.comps.items()}

    def apply_update(self, state: dict, du: dict, relaxation=1.0) -> dict:
        out = dict(state)
        for n, c in self.comps.items():
            out = c.apply_update(out, du[n], relaxation)
        return out

    def _residual_evaluated(self, full: dict, full0: dict, dt,
                            forces=None) -> dict:
        # each view applies the forces that act on its equations
        # (``force.apply`` dispatches on the equation type)
        return self._multi._residual_evaluated(
            self._nest(full), self._nest(full0), dt, forces=self._nest(forces))

    def residual(self, state: dict, state0: dict, dt, forces=None) -> dict:
        """Residuals by entity of raw flat states."""
        return self._residual_evaluated(self.evaluate_secondaries(state),
                                        self.evaluate_secondaries(state0),
                                        dt, forces)

    def assemble(self, state: dict, state0: dict, dt, forces=None,
                 with_jacobian: bool = True):
        from ..multimodel.core import MultiLinearizedSystem

        full = self.evaluate_secondaries(state)
        full0 = self.evaluate_secondaries(state0)
        r = self._residual_evaluated(full, full0, dt, forces)
        if not with_jacobian:
            return r, None, full
        diag = {n: BlockELL(c.ell, c.jacobian_blocks(full, full0, dt, forces))
                for n, c in self.comps.items()}
        nf = self._nest(full)
        couplings = []
        for entry in self._multi._pairs:
            couplings.extend(self._multi._cross_term_jacobian(entry, nf, dt,
                                                              diag))
        return r, MultiLinearizedSystem(diag, couplings, self.layout), full

    def convergence(self, r: dict, state: dict, dt) -> dict:
        out = {}
        for n, c in self.comps.items():
            out.update(c.convergence(r[n], state, dt))
        return out
