"""Systems and the SimulationModel.

Counterparts of Jutul's model layer (reference: src/core_types/core_types.jl
— ``JutulSystem`` :19, ``SimulationModel`` :241-361; hook functions
``select_primary_variables!``/``select_secondary_variables!``/
``select_parameters!``/``select_equations!`` in src/variable_evaluation.jl:151-178
and src/models.jl). The multiple-dispatch hooks become methods on the
system object.

A model is a *declarative spec*; ``model.dof_layout()`` derives the static
Newton dof layout (per-cell dof slices per primary variable), and the
assembly engine (ops/assembly.py, ops/stencil.py) turns the spec into
residual / Jacobian functions on tensors. The model itself holds no
tensors and no device: those are chosen by ``Simulator``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any

from ..core.domains import DataDomain, DiscretizedDomain, JutulDomain
from ..core.entities import CELLS, JutulEntity
from .variables import JutulVariable, SecondaryVariable


class JutulSystem:
    """Abstract physics system (reference core_types.jl:19).

    Subclasses override the ``select_*`` hooks to declare which variables,
    parameters, and equations the model carries.
    """

    def select_primary_variables(self, model) -> "OrderedDict[str, JutulVariable]":
        return OrderedDict()

    def select_secondary_variables(self, model) -> "OrderedDict[str, SecondaryVariable]":
        return OrderedDict()

    def select_parameters(self, model) -> "OrderedDict[str, JutulVariable]":
        return OrderedDict()

    def select_equations(self, model) -> "OrderedDict[str, Any]":
        return OrderedDict()

    def select_output_variables(self, model) -> list[str]:
        return []

    def __repr__(self) -> str:  # pragma: no cover
        return type(self).__name__ + "()"


class DofLayout:
    """Static per-cell Newton dof layout over the primary variables."""

    def __init__(self, model: "SimulationModel"):
        self.names: list[str] = []
        self.slices: dict[str, slice] = {}
        ofs = 0
        for name, var in model.primary_variables.items():
            nd = var.degrees_of_freedom_per_entity(model)
            self.names.append(name)
            self.slices[name] = slice(ofs, ofs + nd)
            ofs += nd
        self.ndof = ofs

    def __repr__(self) -> str:  # pragma: no cover
        return f"DofLayout({self.ndof} dof/cell: {self.slices})"


class SimulationModel:
    """Domain + system + ordered variable/equation dicts
    (reference core_types.jl:241-361)."""

    def __init__(self, domain, system: JutulSystem,
                 data_domain: DataDomain | None = None):
        if not isinstance(domain, JutulDomain):
            # allow passing a raw mesh
            domain = DataDomain(domain)
        if isinstance(domain, DataDomain):
            domain = DiscretizedDomain(domain)
        self.domain: DiscretizedDomain = domain
        self.data_domain: DataDomain = data_domain or domain.data_domain
        self.system = system

        self.primary_variables: OrderedDict[str, JutulVariable] = OrderedDict(
            system.select_primary_variables(self)
        )
        self.secondary_variables: OrderedDict[str, SecondaryVariable] = OrderedDict(
            system.select_secondary_variables(self)
        )
        self.parameters: OrderedDict[str, JutulVariable] = OrderedDict(
            system.select_parameters(self)
        )
        self.equations: OrderedDict[str, Any] = OrderedDict(
            system.select_equations(self)
        )
        self.output_variables: list[str] = list(system.select_output_variables(self))
        self.extra: dict[str, Any] = {}  # e.g. a submodel's global map

    # --- counts ----------------------------------------------------------
    def count_entities(self, entity: JutulEntity) -> int:
        return self.domain.count_entities(entity)

    def number_of_cells(self) -> int:
        return self.count_entities(CELLS)

    def number_of_degrees_of_freedom(self) -> int:
        return sum(var.degrees_of_freedom_per_entity(self)
                   * self.count_entities(var.associated_entity(self))
                   for var in self.primary_variables.values())

    def number_of_equations(self) -> int:
        return sum(eq.number_of_equations_per_entity(self)
                   * self.count_entities(eq.entity(self))
                   for eq in self.equations.values())

    def dof_layout(self) -> DofLayout:
        return DofLayout(self)

    # --- secondary variable ordering ------------------------------------
    def sorted_secondary_variables(self) -> list[str]:
        """Topological order of secondary variables by dependency
        (reference: sort_secondary_variables!, variable_evaluation.jl:296)."""
        secondary = self.secondary_variables
        order: list[str] = []
        state: dict[str, int] = {}  # 0 = visiting, 1 = done

        def visit(name: str, chain: tuple[str, ...]) -> None:
            if state.get(name) == 1:
                return
            if state.get(name) == 0:
                raise ValueError(
                    f"Cyclic secondary-variable dependency: {' -> '.join(chain + (name,))}"
                )
            state[name] = 0
            for dep in secondary[name].dependencies:
                if dep in secondary:
                    visit(dep, chain + (name,))
            state[name] = 1
            order.append(name)

        for name in secondary:
            visit(name, ())
        return order

    def validate(self) -> None:
        names = set(self.primary_variables) | set(self.parameters)
        for name in self.secondary_variables:
            if name in names:
                raise ValueError(f"Variable {name!r} declared in multiple roles")
        self.sorted_secondary_variables()  # raises on cycles
        all_known = (
            set(self.primary_variables)
            | set(self.parameters)
            | set(self.secondary_variables)
        )
        for name, var in self.secondary_variables.items():
            for dep in var.dependencies:
                if dep not in all_known:
                    raise ValueError(
                        f"Secondary variable {name!r} depends on unknown {dep!r}"
                    )

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"SimulationModel({self.system!r}, {self.number_of_cells()} cells, "
            f"primaries={list(self.primary_variables)}, "
            f"equations={list(self.equations)})"
        )
