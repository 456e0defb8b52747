"""Forces: sources and boundary conditions.

Counterpart of Jutul's force machinery (reference: ``JutulForce``
core_types.jl:88, ``setup_forces`` src/models.jl:914, force application
``apply_forces!`` models.jl:889 and ``apply_forces_to_equation!``
equations.jl:603).

A force implements
- ``apply(model, eq, eq_name, r, state, dt) -> r``: add its residual
  contribution to ``r`` of shape (n_cells, neq);
- ``diagonal_jacobian(model, eq, eq_name, compiled, state, dt)``: for a
  state-dependent force (a pressure boundary condition), ``(cells, blocks)``
  with blocks (ns, neq, ndof) to add on the Jacobian's diagonal; None (the
  default) for state-independent sources.
Forces hold host data (cells, rates); they move what they need to ``r``'s
device. A force's ``value_fields`` name the float data it carries (a rate,
a boundary pressure): ``force_values`` and ``with_force_values`` flatten
them and put tensors in their place, which is how the force gradient
(``solve_adjoint_forces``) differentiates through ``apply``; integer
fields (cells) stay as they are.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn.functional as F


def as_value(v, like):
    """A force's value ``v`` (host data or a tensor) as a tensor of
    ``like``'s dtype on its device; a tensor keeps its autograd history."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype, device=like.device)
    return like.new_tensor(np.asarray(v, dtype=np.float64))


class JutulForce:
    value_fields: tuple = ()

    def apply(self, model, eq, eq_name, r, state, dt):
        return r

    def diagonal_jacobian(self, model, eq, eq_name, compiled, state, dt):
        return None

    def shift_pressure_datum(self, p_ref):
        """A copy with every ABSOLUTE pressure the force carries shifted by
        ``-p_ref``; forces holding no absolute pressure return self."""
        return self


class SourceTerm(JutulForce):
    """Constant-rate source q in cells: residual -= q on the first
    ``values.shape[1]`` equations of each cell (one when ``values`` is
    1-D), whatever the equation (reference: SourceTerm in test systems /
    JutulDarcy conventions — positive value injects). Repeated cells add
    up."""

    value_fields = ("values",)

    def __init__(self, cells, values):
        self.cells = np.atleast_1d(np.asarray(cells, dtype=np.int64))
        self.values = values  # (ns,) or (ns, neq)

    def apply(self, model, eq, eq_name, r, state, dt):
        v = as_value(self.values, r)
        if v.ndim == 1:
            v = v[:, None]
        cells = torch.as_tensor(self.cells, device=r.device)
        return r.index_add(0, cells, -F.pad(v, (0, r.shape[1] - v.shape[1])))


def setup_forces(model, **forces) -> dict:
    """Collect named forces into the canonical forces dict
    (reference src/models.jl:914). Values may be a force, a list of forces,
    or None. For a MultiModel, keyword names are submodel names and values
    the per-submodel forces dicts."""
    from ..multimodel.core import MultiModel

    if isinstance(model, MultiModel):
        return model.setup_forces(**forces)
    return {k: v for k, v in forces.items() if v is not None}


def force_structure(forces):
    """What must stay fixed across the steps of a schedule run as one
    program (the counterpart of the reference's pytree structure plus leaf
    shapes): container layout and names, each force's type and cells, and
    the shape of every value it carries. Values themselves are free."""
    if forces is None:
        return None
    if isinstance(forces, dict):
        return ("dict", tuple((k, force_structure(forces[k]))
                              for k in sorted(forces)))
    if isinstance(forces, (list, tuple)):
        return (type(forces).__name__,
                tuple(force_structure(f) for f in forces))
    if isinstance(forces, JutulForce):
        fields = vars(forces)
        return (type(forces).__qualname__,
                tuple(np.atleast_1d(fields.get("cells", ())).tolist()),
                tuple((k, None if v is None else np.shape(v))
                      for k, v in sorted(fields.items()) if k != "cells"))
    return ("value", np.shape(forces))


def _force_items(forces):
    """The forces of a forces container in a fixed order."""
    if forces is None:
        return []
    if isinstance(forces, dict):
        return [f for k in sorted(forces) for f in _force_items(forces[k])]
    if isinstance(forces, (list, tuple)):
        return [f for x in forces for f in _force_items(x)]
    return [forces]


def force_values(forces) -> list:
    """The float values of every force in ``forces`` (a force, a dict or a
    list of them), in a fixed order; fields that are None are skipped."""
    return [getattr(f, k) for f in _force_items(forces)
            for k in getattr(f, "value_fields", ())
            if getattr(f, k) is not None]


def with_force_values(forces, values):
    """``forces`` with copies of its forces whose value fields take
    ``values`` in ``force_values``'s order (same structure otherwise)."""
    it = iter(values)

    def walk(x):  # force_values's (sorted) order, the container's key order
        if x is None:
            return None
        if isinstance(x, dict):
            new = {k: walk(x[k]) for k in sorted(x)}
            return {k: new[k] for k in x}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        fields = getattr(x, "value_fields", ())
        if not fields:
            return x
        g = copy.copy(x)
        for k in fields:
            if getattr(x, k) is not None:
                setattr(g, k, next(it))
        return g

    return walk(forces)
