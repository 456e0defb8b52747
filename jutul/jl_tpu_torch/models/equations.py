"""Equations: residual/Jacobian contribution declarations.

Counterpart of Jutul's equations layer (reference: src/equations.jl —
``number_of_equations_per_entity``, ``update_equation!`` :541-595,
``convergence_criterion`` :620; src/conservation/conservation.jl —
``ConservationLaw`` core_types.jl:850, ``update_equation_in_entity!`` :78).

An equation is compiled into a list of *contributions*, each an
elementwise function plus static index arrays. The stencil engine
(ops/stencil.py) evaluates the accumulation contribution over all cells at
once and differentiates it with ``torch.func.jvp``; the face flux runs
through the system's ``ScalarAssemblyForm`` and the fused flux+Jacobian
kernel (ops/cuda/assembly_kernels.py). The generic block-ELL engine
(ops/assembly.py) evaluates every contribution on gathered batches of
cells or faces and differentiates it the same way.

Local-function contracts (component axis last, any leading batch shape):
- accumulation: ``fn(model, cell_state, cell_state0, dt) -> (..., neq)``.
- cell term: the same signature as accumulation.
- face flux: ``fn(model, cell_states, face_state) -> (..., neq)`` where
  ``cell_states`` entries carry the K stencil cells on axis -2 for vector
  variables and -1 for scalars (TPFA: index 0 = left, 1 = right); positive
  flux flows left -> right and is added to the left row, subtracted from
  the right.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..core.entities import CELLS, JutulEntity


@dataclass
class AccumulationContribution:
    """(M(u) - M(u0)) / dt style cell-local residual term."""

    fn: Callable  # (model, cell_state, cell_state0, dt) -> (..., neq)
    name: str = "accumulation"


@dataclass
class CellTermContribution:
    """Arbitrary cell-local residual term r[c] += fn(cell_state)."""

    fn: Callable  # (model, cell_state, cell_state0, dt) -> (..., neq)
    name: str = "cell_term"


@dataclass
class FaceFluxContribution:
    """Stencil flux over interior faces, scattered ± to two target rows."""

    fn: Callable  # (model, cell_states, face_state) -> (..., neq)
    stencil: np.ndarray  # (n_faces, K) int — cells the flux reads
    plus: np.ndarray  # (n_faces,) int — row receiving +flux
    minus: np.ndarray  # (n_faces,) int — row receiving -flux
    name: str = "flux"


@dataclass(frozen=True)
class ScalarAssemblyForm:
    """Dof-scalar form of a conservation law for the fused flux+Jacobian
    kernel (ops/cuda/assembly_kernels.py).

    The same physics as the equation's dict-based functions, written as
    closures over PLAIN SCALARS — tuples of per-dof tensors, phases
    unrolled in Python — so they evaluate elementwise on any batch of
    faces. ``torch.func.jvp`` of ``flux`` is the kernel's plain version.

    Contracts (u = tuple of ndof tensors, the packed Newton dofs):
    - ``flux(u_l, u_r, cp_l, cp_r, fp) -> tuple of neq tensors``: face
      flux from left to right; ``cp_*`` are the declared per-cell
      parameter values on each side, ``fp`` the per-face parameters in
      ``face_params`` order.
    - ``mass(u, cp) -> tuple of neq tensors``: conserved quantity per cell.
    - ``constants``: the numbers the hand-written CUDA flux kernel takes
      in place of the closures (its argument order is documented there).

    The form MUST match the system's generic flux/mass functions exactly
    (tests/test_torch_assembly.py holds it to them).
    """

    flux: Callable
    mass: Callable
    n_eq: int
    face_params: tuple  # face-entity parameter names, order of ``fp``
    cell_params: tuple = ()  # cell-entity parameter names for ``cp``
    constants: tuple = ()


@dataclass
class CrossCoupling:
    """Cross-ENTITY residual coupling for mixed-entity models (reference:
    equations on arbitrary entities with cross-entity alignment,
    src/equations.jl:328-434). Declared by an equation via
    ``cross_couplings(model)``; the mixed-entity compiler (ops/mixed.py)
    adds the value to the owning equation's rows and derives both Jacobian
    blocks (row-diagonal and the off-entity coupling block).

    ``fn(model, local_row, local_source, dt, conn) -> (m, neq)`` receives
    the row-entity and source-entity local states of the batch of (row,
    col) pairs (leading axis m); ``conn`` holds the pairs' rows of
    ``conn_data`` (or None). ``symmetric``: the negated value is also added
    to the source entity's same-named equation (CTSkewSymmetry).
    """

    rows: np.ndarray  # (m,) row-entity indices (the equation's entity)
    cols: np.ndarray  # (m,) source-entity indices
    source_entity: JutulEntity
    fn: Callable
    conn_data: "dict | None" = None
    symmetric: bool = False


class JutulEquation:
    """Abstract equation (reference core_types.jl JutulEquation)."""

    def entity(self, model) -> JutulEntity:
        return CELLS

    def number_of_equations_per_entity(self, model) -> int:
        return 1

    def contributions(self, model) -> list:
        raise NotImplementedError

    def cross_couplings(self, model) -> "list[CrossCoupling]":
        """Cross-entity couplings (mixed-entity models only)."""
        return []

    # --- convergence -----------------------------------------------------
    def convergence_parts(self, model, eq_name, r, state, dt):
        """Criterion pieces: dict name -> (kind, payload).

        kind "max": payload is a (neq,) tensor.
        kind "ratio": payload is (numerator, denominator) (neq,) tensors;
        the criterion value is |num| / den (global-balance criteria like
        MB).
        """
        return {"Max": ("max", torch.amax(torch.abs(r), dim=0))}

    def convergence_criterion(self, model, eq_name, r, state, dt):
        """Return dict criterion-name -> (neq,) tensor of errors.

        Default = max abs residual (reference equations.jl:620). Derived
        from convergence_parts; override convergence_parts, not this.
        """
        out = {}
        for name, (kind, payload) in self.convergence_parts(
                model, eq_name, r, state, dt).items():
            if kind == "max":
                out[name] = payload
            else:
                num, den = payload
                out[name] = torch.abs(num) / den
        return out

    def default_tolerance(self, model) -> float:
        return 1e-6


class ConservationLaw(JutulEquation):
    """d(M)/dt + div(F) = q on cells (reference core_types.jl:850,
    conservation/conservation.jl:78-99).

    Parameters
    ----------
    flux_fn : callable(model, cell_states, face_state) -> (..., neq)
        Flux from stencil cell 0 (left) to cell 1 (right) across the face.
    mass_fn : callable(model, cell_state) -> (..., neq), optional
        Conserved quantity per cell (including volume factors). ``None``
        gives a steady-state equation (no accumulation term).
    neq : number of conserved quantities.
    """

    def __init__(self, flux_fn, mass_fn=None, neq: int = 1):
        self.flux_fn = flux_fn
        self.mass_fn = mass_fn
        self.neq = int(neq)

    def number_of_equations_per_entity(self, model) -> int:
        return self.neq

    def contributions(self, model) -> list:
        out: list = []
        if self.mass_fn is not None:
            mass = self.mass_fn

            def acc(model_, cs, cs0, dt):
                return (mass(model_, cs) - mass(model_, cs0)) / dt

            out.append(AccumulationContribution(acc, name="accumulation"))
        geo = model.domain.geometry
        if self.flux_fn is not None and geo is not None and geo.n_faces > 0:
            st = np.asarray(geo.neighbors)
            out.append(FaceFluxContribution(fn=self.flux_fn, stencil=st,
                                            plus=st[:, 0], minus=st[:, 1]))
        return out
