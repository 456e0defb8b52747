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

- ``ScalarTestCrossTerm`` (scalar.jl + CTSkewSymmetry): two coupled scalar
  models relax to +-1/3 (reference test/test_systems/multimodel.jl).
- ``FaceTestSystem``: unknowns and equations on Faces (a non-cell row
  entity); ``MixedFluxSystem``: a Cells and a Faces equation in ONE model,
  coupled through ``CrossCoupling``s (ops/mixed.py).

They run on the generic block-ELL engine (``Simulator(use_stencil=False)``).
Their functions are written over batches (component axis last, the stencil
cells on the axis before it), as every model function of the port.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..core.entities import CELLS, FACES
from ..discretization.tpfa import compute_face_trans
from .equations import (
    AccumulationContribution,
    CellTermContribution,
    ConservationLaw,
    CrossCoupling,
    FaceFluxContribution,
    JutulEquation,
)
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


class ScalarTestCrossTerm:
    """X_target - X_source, skew-symmetric
    (reference scalar.jl ScalarTestCrossTerm + CTSkewSymmetry)."""

    symmetric = True

    def value(self, model_t, model_s, local_t, local_s, dt):
        return (local_t["XVar"] - local_s["XVar"])[..., None]


# ---------------------------------------------------------------------------
# Face-entity test system (equations on a NON-cell entity)
# ---------------------------------------------------------------------------
class FaceVal(ScalarVariable):
    """Primary variable living on Faces (reference: variables may live on
    any entity, core_types.jl:515-556)."""

    def associated_entity(self, model=None):
        return FACES


class FaceSource(JutulParameter):
    """Per-face source parameter."""

    def __init__(self):
        super().__init__(default=0.0, values_per_entity=1, entity=FACES)


class FaceGraphDiffusionEquation(JutulEquation):
    """Transient diffusion on the face-adjacency graph:

        (v_f - v0_f)/dt + w * sum_{g ~ f} (v_f - v_g) - q_f = 0

    with edges between faces that share a cell: an equation living on
    ``Faces`` (reference: equations on arbitrary entities,
    src/equations.jl:328-434), the non-cell conformance case for the
    assembly engine."""

    def __init__(self, edges: np.ndarray, weight: float = 1.0):
        self.edges = np.asarray(edges, dtype=np.int64)
        self.weight = float(weight)

    def entity(self, model):
        return FACES

    def contributions(self, model):
        w = self.weight

        def acc(model_, fs, fs0, dt):
            return ((fs["FaceVal"] - fs0["FaceVal"]) / dt
                    - fs["FaceSource"])[..., None]

        def edge_flux(model_, sides, es):
            v = sides["FaceVal"]
            return (w * (v[..., 0] - v[..., 1]))[..., None]

        out = [AccumulationContribution(acc, name="face_acc")]
        if len(self.edges):
            out.append(FaceFluxContribution(
                fn=edge_flux, stencil=self.edges,
                plus=self.edges[:, 0], minus=self.edges[:, 1],
                name="face_graph_flux"))
        return out


class FaceTestSystem(JutulSystem):
    """System whose unknowns AND equations live on Faces."""

    def __init__(self, edges, weight: float = 1.0):
        self.edges = np.asarray(edges, dtype=np.int64)
        self.weight = float(weight)

    def select_primary_variables(self, model):
        return OrderedDict(FaceVal=FaceVal())

    def select_parameters(self, model):
        return OrderedDict(FaceSource=FaceSource())

    def select_equations(self, model):
        return OrderedDict(face_diffusion=FaceGraphDiffusionEquation(
            self.edges, self.weight))


def face_adjacency_edges(mesh) -> np.ndarray:
    """(n_edges, 2) pairs of interior faces sharing a cell (build-time)."""
    nb = np.asarray(mesh.neighborship())
    by_cell: dict[int, list[int]] = {}
    for f in range(nb.shape[0]):
        for c in nb[f]:
            by_cell.setdefault(int(c), []).append(f)
    edges = set()
    for faces in by_cell.values():
        for i in range(len(faces)):
            for j in range(i + 1, len(faces)):
                edges.add((faces[i], faces[j]))
    return np.asarray(sorted(edges), dtype=np.int64).reshape(-1, 2)


# ---------------------------------------------------------------------------
# Mixed-entity test system: Cells AND Faces equations in ONE model
# (reference: per-equation entities, src/equations.jl:328-434)
# ---------------------------------------------------------------------------
class CellVal(ScalarVariable):
    pass


class CellSource(JutulParameter):
    def __init__(self):
        super().__init__(default=0.0, values_per_entity=1, entity=CELLS)


class MixedCellMassEquation(JutulEquation):
    """(c - c0)/dt + div(v) - q = 0 on Cells; the divergence reads the
    FACE unknown v through a cross-entity incidence coupling."""

    def __init__(self, neighbors: np.ndarray):
        self.neighbors = np.asarray(neighbors, dtype=np.int64)

    def contributions(self, model):
        def acc(model_, cs, cs0, dt):
            return ((cs["CellVal"] - cs0["CellVal"]) / dt
                    - cs["CellSource"])[..., None]

        return [AccumulationContribution(acc, name="mixed_cell_acc")]

    def cross_couplings(self, model):
        nb = self.neighbors
        nf = nb.shape[0]

        def div_term(model_, local_cell, local_face, dt, conn):
            return (conn["sign"] * local_face["FaceVal"])[..., None]

        return [CrossCoupling(
            rows=np.concatenate([nb[:, 0], nb[:, 1]]),
            cols=np.concatenate([np.arange(nf), np.arange(nf)]),
            source_entity=FACES, fn=div_term,
            conn_data={"sign": np.concatenate([np.ones(nf),
                                               -np.ones(nf)])})]


class MixedFaceClosureEquation(JutulEquation):
    """v - w (c_L - c_R) = 0 on Faces; the closure reads the CELL unknown
    through two cross-entity couplings (one per side)."""

    def __init__(self, neighbors: np.ndarray, weight: float = 1.0):
        self.neighbors = np.asarray(neighbors, dtype=np.int64)
        self.weight = float(weight)

    def entity(self, model):
        return FACES

    def contributions(self, model):
        def local_v(model_, fs, fs0, dt):
            return fs["FaceVal"][..., None]

        return [AccumulationContribution(local_v, name="mixed_face_v")]

    def cross_couplings(self, model):
        nb = self.neighbors
        nf = nb.shape[0]

        def closure(model_, local_face, local_cell, dt, conn):
            return (conn["sign"] * local_cell["CellVal"])[..., None]

        return [CrossCoupling(
            rows=np.concatenate([np.arange(nf), np.arange(nf)]),
            cols=np.concatenate([nb[:, 0], nb[:, 1]]),
            source_entity=CELLS, fn=closure,
            conn_data={"sign": np.concatenate(
                [-self.weight * np.ones(nf), self.weight * np.ones(nf)])})]


class MixedFluxSystem(JutulSystem):
    """ONE model with a Cells equation + a Faces equation (mixed form of
    transient diffusion): cell mass balance with the face flux unknown,
    plus the face flux closure."""

    def __init__(self, neighbors, weight: float = 1.0):
        self.neighbors = np.asarray(neighbors, dtype=np.int64)
        self.weight = float(weight)

    def select_primary_variables(self, model):
        return OrderedDict(CellVal=CellVal(), FaceVal=FaceVal())

    def select_parameters(self, model):
        return OrderedDict(CellSource=CellSource())

    def select_equations(self, model):
        return OrderedDict(
            cell_mass=MixedCellMassEquation(self.neighbors),
            face_closure=MixedFaceClosureEquation(self.neighbors,
                                                  self.weight))
