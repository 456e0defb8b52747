"""Variable metadata & update rules.

Counterpart of Jutul's variables API (reference: src/variables/utils.jl —
``degrees_of_freedom_per_entity``/``values_per_entity``, ``default_value``,
min/max values, ``absolute_increment_limit``/``relative_increment_limit``,
``variable_scale``; Newton update with clamping at :110-175; unit-sum update
for ``FractionVariables`` at :388-471; abstract hierarchy in
src/core_types/core_types.jl:19-88: ScalarVariable / VectorVariables /
FractionVariables).

- A variable's *values* live in the state dict as a tensor with the entity
  axis first and (for vector variables) the component axis LAST, so
  elementwise secondary-variable formulas work on any batch of cells.
- ``pack``/``unpack`` map between values and Newton degrees of freedom. For
  ``FractionVariables`` the dof count is ``m - 1`` and ``unpack`` closes the
  last component as ``1 - sum(rest)``; derivatives flow through ``unpack``
  in the Jacobian closures (the reference's reduced-dof saturations).
- ``update`` applies the clamped Newton increment (abs/rel limits, min/max).
- ``initialize_value`` is host-side numpy (model-build data).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..core.entities import CELLS, JutulEntity


class JutulVariable:
    """Base class for all variables (reference core_types.jl:19-88)."""

    # --- placement -------------------------------------------------------
    def associated_entity(self, model=None) -> JutulEntity:
        return CELLS

    # --- sizes -----------------------------------------------------------
    def values_per_entity(self, model=None) -> int:
        return 1

    def degrees_of_freedom_per_entity(self, model=None) -> int:
        return self.values_per_entity(model)

    def is_scalar(self) -> bool:
        return self.values_per_entity(None) == 1

    # --- defaults & limits ----------------------------------------------
    def default_value(self, model=None):
        return 0.0

    def minimum_value(self, model=None):
        return None

    def maximum_value(self, model=None):
        return None

    def absolute_increment_limit(self, model=None):
        return None

    def relative_increment_limit(self, model=None):
        return None

    def variable_scale(self, model=None):
        return None

    # --- initialization --------------------------------------------------
    def initialize_value(self, model, n: int, value=None) -> np.ndarray:
        m = self.values_per_entity(model)
        if value is None:
            value = self.default_value(model)
        value = np.asarray(value, dtype=np.float64)
        shape = (n,) if m == 1 else (n, m)
        if value.ndim == 0:
            out = np.full(shape, float(value))
        elif value.shape == shape:
            out = value.copy()
        elif m > 1 and value.shape == (m,):
            out = np.tile(value, (n, 1))
        elif value.shape == (n,) and m == 1:
            out = value.copy()
        else:
            raise ValueError(
                f"cannot initialize variable of shape {shape} from {value.shape}"
            )
        lo, hi = self.minimum_value(model), self.maximum_value(model)
        if lo is not None:
            out = np.maximum(out, lo)
        if hi is not None:
            out = np.minimum(out, hi)
        return out

    # --- dof mapping -----------------------------------------------------
    def pack(self, values):
        """values (..., m) or (...,) -> dofs (..., ndof)."""
        if self.is_scalar():
            return values[..., None]
        return values

    def unpack(self, dofs):
        """dofs (..., ndof) -> values in state representation."""
        if self.is_scalar():
            return dofs[..., 0]
        return dofs

    # --- Newton update ---------------------------------------------------
    def update(self, values, dv, relaxation=1.0, model=None):
        """Apply (clamped) Newton increment to values.

        ``dv`` has dof shape (..., ndof); returns updated values. Mirrors
        update_primary_variable! (reference variables/utils.jl:110-175).
        """
        dv = relaxation * dv
        abs_lim = self.absolute_increment_limit(model)
        rel_lim = self.relative_increment_limit(model)
        v = self.pack(values)
        if abs_lim is not None:
            dv = torch.clamp(dv, -abs_lim, abs_lim)
        if rel_lim is not None:
            cap = rel_lim * torch.abs(v)
            dv = torch.clamp(dv, -cap, cap)
        out = v + dv
        lo, hi = self.minimum_value(model), self.maximum_value(model)
        if lo is not None:
            out = torch.clamp(out, min=lo)
        if hi is not None:
            out = torch.clamp(out, max=hi)
        return self.unpack(out)


class ScalarVariable(JutulVariable):
    pass


class VectorVariables(JutulVariable):
    """Variable with several values per entity (component axis last)."""

    def __init__(self, values_per_entity: int = 1):
        self._n = int(values_per_entity)

    def values_per_entity(self, model=None) -> int:
        return self._n


class FractionVariables(VectorVariables):
    """Unit-sum vector variable, e.g. saturations (reference utils.jl:388).

    dofs = first m-1 components; last closes the sum to 1. The Newton update
    uses the reference's unit-sum strategy: clamp the dof increment, then
    project into [minimum_fraction, 1] and renormalize the unit sum.
    """

    def __init__(self, values_per_entity: int = 2, minimum_fraction: float = 0.0,
                 ds_max: float = 0.2):
        super().__init__(values_per_entity)
        self.minimum_fraction = float(minimum_fraction)
        self.ds_max = float(ds_max)

    def degrees_of_freedom_per_entity(self, model=None) -> int:
        return self._n - 1

    def default_value(self, model=None):
        return np.full(self._n, 1.0 / self._n)

    def absolute_increment_limit(self, model=None):
        return self.ds_max

    def pack(self, values):
        return values[..., :-1]

    def unpack(self, dofs):
        last = 1.0 - torch.sum(dofs, dim=-1, keepdim=True)
        return torch.cat([dofs, last], dim=-1)

    def update(self, values, dv, relaxation=1.0, model=None):
        dv = relaxation * dv
        abs_lim = self.absolute_increment_limit(model)
        if abs_lim is not None:
            dv = torch.clamp(dv, -abs_lim, abs_lim)
        head = values[..., :-1] + dv
        out = self.unpack(head)
        out = torch.clamp(out, self.minimum_fraction, 1.0)
        s = torch.sum(out, dim=-1, keepdim=True)
        return out / s


class ConstantVariables(JutulVariable):
    """A parameter-like constant variable (reference variables/utils.jl)."""

    def __init__(self, value, values_per_entity: int = 1):
        self._value = value
        self._n = int(values_per_entity)

    def values_per_entity(self, model=None) -> int:
        return self._n

    def default_value(self, model=None):
        return self._value


class JutulParameter(JutulVariable):
    """Base for parameters (non-solved variables)."""

    def __init__(self, default=1.0, values_per_entity: int = 1,
                 entity: JutulEntity = CELLS, minimum=None, maximum=None):
        self._default = default
        self._n = int(values_per_entity)
        self._entity = entity
        self._min = minimum
        self._max = maximum

    def associated_entity(self, model=None) -> JutulEntity:
        return self._entity

    def values_per_entity(self, model=None) -> int:
        return self._n

    def default_value(self, model=None):
        return self._default

    def minimum_value(self, model=None):
        return self._min

    def maximum_value(self, model=None):
        return self._max


class SecondaryVariable(JutulVariable):
    """A dependent variable computed from other state entries.

    Subclasses define ``dependencies`` (names read from state) and
    ``evaluate(model, **deps) -> tensor``. The evaluate body MUST be
    elementwise along the entity axis (component axis last), so the same
    code runs on whole state tensors and inside the Jacobian's jvps.
    """

    dependencies: tuple[str, ...] = ()

    def evaluate(self, model, **deps):
        raise NotImplementedError


class FunctionSecondaryVariable(SecondaryVariable):
    """Secondary variable from a plain function — the ``@jutul_secondary``
    equivalent (reference src/variable_evaluation.jl:38-85). ``fn`` must
    be elementwise along the entity axis, as every ``evaluate``."""

    def __init__(self, fn: Callable, dependencies: Sequence[str],
                 values_per_entity: int = 1, entity: JutulEntity = CELLS):
        self._fn = fn
        self.dependencies = tuple(dependencies)
        self._n = int(values_per_entity)
        self._entity = entity

    def associated_entity(self, model=None) -> JutulEntity:
        return self._entity

    def values_per_entity(self, model=None) -> int:
        return self._n

    def evaluate(self, model, **deps):
        return self._fn(**deps)


def secondary_variable(*dependencies: str, values_per_entity: int = 1,
                       entity: JutulEntity = CELLS):
    """Decorator: turn a pure elementwise function into a SecondaryVariable.

    >>> @secondary_variable("Pressure")
    ... def Density(Pressure):
    ...     return rho0 * (1 + c * (Pressure - p0))
    """

    def wrap(fn: Callable) -> FunctionSecondaryVariable:
        return FunctionSecondaryVariable(
            fn, dependencies, values_per_entity=values_per_entity,
            entity=entity)

    return wrap
