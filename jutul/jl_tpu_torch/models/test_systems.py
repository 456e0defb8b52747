"""Built-in analytic test systems — the conformance suite backbone.

Port of the part of the JAX package's ``models/test_systems.py`` that needs
no cross-entity coupling. Counterparts of the reference's test systems
(src/applications/test_systems/):
- ``ScalarTestSystem`` (scalar/scalar.jl:4-76): single ODE dX/dt = q per
  cell; with implicit Euler one step of dt and force q gives X = X0 + q*dt.
- ``VariablePoissonSystem`` (variable_poisson/variable_poisson.jl:1-133):
  -div(K grad U) = 0 with point sources; face coefficient parameter K built
  by two-point transmissibilities from a cell ``poisson_coefficient``; cell 0
  carries a 1e-10*U regularization (steady variant) to remove the null space.
- ``SimpleHeatSystem`` (heat_2d/heat_2d.jl): transient diffusion with unit
  coefficient.

They run on the generic block-ELL engine (``Simulator(use_stencil=False)``).
Their functions are written over batches (component axis last, the stencil
cells on the axis before it), as every model function of the port.
``FaceTestSystem``, ``MixedFluxSystem`` and ``ScalarTestCrossTerm`` need
mixed-entity models and wait for the MultiModel port.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..core.entities import CELLS, FACES
from ..discretization.tpfa import compute_face_trans
from .equations import CellTermContribution, ConservationLaw
from .forces import JutulForce, as_value
from .system import JutulSystem
from .variables import JutulParameter, ScalarVariable


# ---------------------------------------------------------------------------
# Scalar test system
# ---------------------------------------------------------------------------
class XVar(ScalarVariable):
    pass


class ScalarTestForce(JutulForce):
    """d/dt X = value (reference scalar.jl ScalarTestForce + force apply)."""

    value_fields = ("value",)

    def __init__(self, value):
        self.value = value

    def apply(self, model, eq, eq_name, r, state, dt):
        return r - as_value(self.value, r)


class ScalarTestSystem(JutulSystem):
    """dX/dt = forcing (reference scalar/scalar.jl:4)."""

    def select_primary_variables(self, model):
        return OrderedDict(XVar=XVar())

    def select_equations(self, model):
        def mass(model_, cs):
            return cs["XVar"][..., None]

        eq = ConservationLaw(flux_fn=None, mass_fn=mass, neq=1)
        return OrderedDict(test_equation=eq)


def ScalarTestDomain(n_cells: int = 1):
    """Mesh-free single/multi-cell domain (reference scalar.jl:7-16)."""
    from ..core.domains import DataDomain

    return DataDomain(entities={CELLS: n_cells, FACES: 0})


# ---------------------------------------------------------------------------
# Variable-coefficient Poisson
# ---------------------------------------------------------------------------
class UVar(ScalarVariable):
    pass


class PoissonFaceCoefficient(JutulParameter):
    """Face coefficient from cell poisson_coefficient via two-point
    transmissibilities (reference variable_poisson.jl:58-67)."""

    def __init__(self):
        super().__init__(default=1.0, values_per_entity=1, entity=FACES)

    def initialize_parameter(self, model, n):
        dd = model.data_domain
        if "poisson_coefficient" not in dd:
            raise ValueError(
                "data domain must carry 'poisson_coefficient' to initialize K"
            )
        return compute_face_trans(dd.geometry, dd["poisson_coefficient"])


class _PoissonEquation(ConservationLaw):
    """-div(K grad U) (+ dU/dt) with cell-0 regularization via the
    'PoissonRegularization' parameter."""

    def __init__(self, time_dependent: bool):
        def flux(model, cs, fs):
            U = cs["U"]
            return (-fs["K"] * (U[..., 1] - U[..., 0]))[..., None]

        if time_dependent:
            def mass(model, cs):
                return cs["U"][..., None]
        else:
            mass = None
        super().__init__(flux_fn=flux, mass_fn=mass, neq=1)

    def contributions(self, model):
        out = super().contributions(model)

        def reg(model_, cs, cs0, dt):
            return (cs["PoissonRegularization"] * cs["U"])[..., None]

        out.append(CellTermContribution(reg, name="regularization"))
        return out


class PoissonRegularizationParam(JutulParameter):
    def initialize_parameter(self, model, n):
        v = np.zeros(n)
        v[0] = 1e-10  # pin the singular steady problem (reference :105)
        return v


class VariablePoissonSystem(JutulSystem):
    def __init__(self, time_dependent: bool = False):
        self.time_dependent = time_dependent

    def select_primary_variables(self, model):
        return OrderedDict(U=UVar())

    def select_parameters(self, model):
        return OrderedDict(
            K=PoissonFaceCoefficient(),
            PoissonRegularization=PoissonRegularizationParam(default=0.0),
        )

    def select_equations(self, model):
        return OrderedDict(poisson=_PoissonEquation(self.time_dependent))


class PoissonSource(JutulForce):
    """Point source: residual[cell] += value (reference
    variable_poisson.jl:79-86 — note the + sign)."""

    value_fields = ("value",)

    def __init__(self, cell: int, value):
        self.cell = int(cell)
        self.value = value

    def apply(self, model, eq, eq_name, r, state, dt):
        if not isinstance(eq, _PoissonEquation):
            return r
        r = r.clone()
        r[self.cell, 0] = r[self.cell, 0] + as_value(self.value, r)
        return r


# ---------------------------------------------------------------------------
# Simple heat / diffusion system (heat_2d analogue)
# ---------------------------------------------------------------------------
class TVar(ScalarVariable):
    pass


class PoissonFaceCoefficientUnit(JutulParameter):
    def __init__(self):
        super().__init__(default=1.0, values_per_entity=1, entity=FACES)

    def initialize_parameter(self, model, n):
        dd = model.data_domain
        coef = dd.get("heat_coefficient")
        if coef is None:
            coef = np.ones(model.number_of_cells())
        return compute_face_trans(dd.geometry, coef)


class SimpleHeatSystem(JutulSystem):
    """dT/dt = div(grad T) with unit face coefficient
    (reference heat_2d/heat_2d.jl)."""

    def select_primary_variables(self, model):
        return OrderedDict(T=TVar())

    def select_parameters(self, model):
        return OrderedDict(HeatTrans=PoissonFaceCoefficientUnit())

    def select_equations(self, model):
        def mass(model_, cs):
            return cs["T"][..., None]

        def flux(model_, cs, fs):
            T = cs["T"]
            return (-fs["HeatTrans"] * (T[..., 1] - T[..., 0]))[..., None]

        return OrderedDict(heat=ConservationLaw(flux_fn=flux, mass_fn=mass,
                                                neq=1))
