"""State/parameter setup.

Counterpart of Jutul's ``setup_state`` / ``setup_parameters``
(reference: src/models.jl:249-482). States are plain dicts of arrays
(entity axis first, components last). ``setup_state``/``setup_parameters``
build host numpy data, exactly as the JAX package does; ``from_numpy``
places such a dict on a device in the working dtype — which is also how
the JAX package's own states and parameters are carried into the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dtypes import float_type, resolve_device


def setup_state(model, values: dict | None = None, **kwargs) -> dict:
    """Initialize primary-variable state (reference models.jl:249).

    Unknown keys raise; values may be scalars, per-entity arrays, or
    per-component defaults. For a MultiModel, keyword names are submodel
    names and values their states (missing ones get the defaults).
    """
    from ..multimodel.core import MultiModel

    init = dict(values or {})
    init.update(kwargs)
    if isinstance(model, MultiModel):
        return model.setup_state(**init)
    state: dict[str, np.ndarray] = {}
    for name, var in model.primary_variables.items():
        n = model.count_entities(var.associated_entity(model))
        state[name] = var.initialize_value(model, n, init.pop(name, None))
    if init:
        raise ValueError(
            f"setup_state: unknown variables {sorted(init)}; "
            f"primaries are {list(model.primary_variables)}"
        )
    return state


def setup_parameters(model, values: dict | None = None, **kwargs) -> dict:
    """Initialize parameters (reference models.jl:313).

    A parameter class may define ``initialize_parameter(model, n)`` to derive
    its default from the model's data domain (e.g. transmissibilities from
    geometry + permeability), mirroring the reference's
    parameters-from-DataDomain behavior (variables/vectorization.jl:208).
    For a MultiModel, keyword names are submodel names, as in
    ``setup_state``.
    """
    from ..multimodel.core import MultiModel

    init = dict(values or {})
    init.update(kwargs)
    if isinstance(model, MultiModel):
        return model.setup_parameters(**init)
    params: dict[str, np.ndarray] = {}
    for name, var in model.parameters.items():
        n = model.count_entities(var.associated_entity(model))
        given = init.pop(name, None)
        if given is None and hasattr(var, "initialize_parameter"):
            params[name] = np.asarray(var.initialize_parameter(model, n))
        else:
            params[name] = var.initialize_value(model, n, given)
    if init:
        raise ValueError(
            f"setup_parameters: unknown parameters {sorted(init)}; "
            f"known are {list(model.parameters)}"
        )
    return params


def setup_state_and_parameters(model, values: dict | None = None, **kwargs):
    """Split mixed kwargs into (state, parameters)
    (reference models.jl:370)."""
    init = dict(values or {})
    init.update(kwargs)
    sv = {k: v for k, v in init.items() if k in model.primary_variables}
    pv = {k: v for k, v in init.items() if k in model.parameters}
    unknown = set(init) - set(sv) - set(pv)
    if unknown:
        raise ValueError(f"Unknown variables/parameters: {sorted(unknown)}")
    return setup_state(model, sv), setup_parameters(model, pv)


def from_numpy(state_or_params: dict, device=None, dtype=None) -> dict:
    """Tensors on ``device`` for a dict of arrays (numpy arrays, JAX
    arrays, tensors or other array-likes; non-tensors are copied), or for
    a MultiModel's dict of such dicts (one per submodel). Floating arrays
    become ``dtype`` (default: ``float_type(device)``); integer arrays
    keep their integer type."""
    dev = resolve_device(device)
    dtype = dtype or float_type(dev)
    out = {}
    for k, v in state_or_params.items():
        if isinstance(v, dict):
            out[k] = from_numpy(v, dev, dtype)
            continue
        t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        out[k] = t.to(device=dev, dtype=dtype if t.is_floating_point()
                      else t.dtype)
    return out


def merge_state(state: dict, parameters: dict | None = None) -> dict:
    out = dict(state)
    if parameters:
        out.update(parameters)
    return out

