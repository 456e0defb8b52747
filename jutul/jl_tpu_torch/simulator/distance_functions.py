"""Distance functions over scaled residuals (ConvergenceMonitors menu).

Port of the JAX package's ``simulator/distance_functions.py`` (host-side
Python; criteria arrive as tensors on the simulator's device). Counterpart of the reference's distance-function family (reference:
src/ConvergenceMonitors/distance_functions.jl:8-51 ``compute_distance`` /
``scaled_residual_norm`` / ``nonconverged_equations`` and the residual
flattening utilities in src/ConvergenceMonitors/utils.jl): convergence
monitors measure the "distance from convergence" of a Newton iterate as a
user-pluggable function of the per-equation, per-criterion scaled
residuals, reduced to a scalar by a mapping (max by default).

The residual dict mirrors the reference's
``residuals[equation][criterion] = res/tol`` (our criteria are already
max-reduced over components, so the innermost level is a float).
"""

from __future__ import annotations

import numpy as np
import torch


def max_value(v) -> float:
    """Largest entry of a criterion (a tensor on any device, an array or a
    float) as a host float."""
    if isinstance(v, torch.Tensor):
        return float(torch.max(v))
    return float(np.max(np.asarray(v)))


def get_model_residuals(crit: dict, tol_for) -> dict:
    """Per-equation, per-criterion tolerance-scaled residuals from a
    convergence-criteria dict (reference utils.jl get_model_residuals:
    ``residuals[equation][criterion] = res/tol``). ``tol_for(eq, crit)``
    is the simulator's tolerance lookup."""
    out = {}
    for eq_name, criteria in crit.items():
        out[eq_name] = {
            c: max_value(v) / tol_for(eq_name, c)
            for c, v in criteria.items()
        }
    return out


def flatten_dict(d: dict, separator: str = ".", trail: tuple = ()):
    """Nested dict -> (values, dotted names) (reference utils.jl
    flatten_dict)."""
    values, names = [], []
    for k, v in d.items():
        t = trail + (str(k),)
        if isinstance(v, dict):
            sv, sn = flatten_dict(v, separator, t)
            values += sv
            names += sn
        else:
            values.append(float(v))
            names.append(separator.join(t))
    return values, names


def scaled_residual_norm(residuals: dict):
    """Distance = max(res/tol - 1, 0) per criterion (reference
    distance_functions.jl scaled_residual_norm): 0 means that criterion
    is converged."""
    values, names = flatten_dict(residuals)
    return [max(v - 1.0, 0.0) for v in values], names


def nonconverged_equations(residuals: dict):
    """Distance = 1.0 per non-converged criterion, 0.0 otherwise
    (reference distance_functions.jl nonconverged_equations; typically
    reduced with ``sum``)."""
    values, names = scaled_residual_norm(residuals)
    return [1.0 if v > 0.0 else 0.0 for v in values], names


def compute_distance(residuals: dict, distance_function=scaled_residual_norm,
                     mapping=max):
    """(distance, names): apply ``distance_function`` to the scaled
    residuals and reduce with ``mapping`` (reference
    distance_functions.jl compute_distance)."""
    d, names = distance_function(residuals)
    return (float(mapping(d)) if d else 0.0), names
