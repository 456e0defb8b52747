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
device.
"""

from __future__ import annotations


class JutulForce:
    def apply(self, model, eq, eq_name, r, state, dt):
        return r

    def diagonal_jacobian(self, model, eq, eq_name, compiled, state, dt):
        return None

    def shift_pressure_datum(self, p_ref):
        """A copy with every ABSOLUTE pressure the force carries shifted by
        ``-p_ref``; forces holding no absolute pressure return self."""
        return self


def setup_forces(model, **forces) -> dict:
    """Collect named forces into the canonical forces dict
    (reference src/models.jl:914). Values may be a force, a list of forces,
    or None."""
    return {k: v for k, v in forces.items() if v is not None}
