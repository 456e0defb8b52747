"""Newton convergence bookkeeping shared by the simulator.

Port of the JAX package's ``simulator/newton_common.py`` (reference:
check_convergence, models.jl:818-884): the tolerance lookup and scaled error
of both Newton loops, and the pieces of the check-before-solve loop behind
``solve_ministep_jit`` / ``simulate_jit`` — Eisenstat-Walker forcing, the
loop's continue rule and the ministep's acceptance rule. The JAX package
traces these inside ``lax.while_loop``; here they are plain functions on host
floats (0-d tensors work too, at one host read per comparison).
"""

from __future__ import annotations

import math

import torch

from ..utils.timing import host_read


def tolerance_for(eq_name: str, crit_name: str, tols, equations=(),
                  model=None) -> float:
    """Tolerance lookup, matching the reference (models.jl:830-874):
    per-equation entry (float, or dict by criterion) beats the
    ``"default"`` entry, which beats the equation's own declared default.
    A user-provided ``"default"`` applies to every criterion."""
    if isinstance(tols, (int, float)):
        return float(tols)
    for key in (f"{eq_name}/{crit_name}", eq_name, crit_name):
        if key in tols:
            v = tols[key]
            if isinstance(v, dict):
                if crit_name in v:
                    return float(v[crit_name])
                continue
            return float(v)
    if "default" in tols:
        return float(tols["default"])
    for info in equations:
        if info.name == eq_name:
            return float(info.eq.default_tolerance(model))
    return 1e-6


def scaled_error(crit, tols, equations=(), model=None) -> float:
    """Worst error/tolerance over all equations and criteria (<= 1 means
    converged). One host read per criterion."""
    worst = 0.0
    for eq_name, criteria in crit.items():
        for crit_name, arr in criteria.items():
            tol = tolerance_for(eq_name, crit_name, tols, equations, model)
            worst = max(worst, host_read(arr.max()) / tol)
    return worst


def max_abs(r):
    """max |r| as a 0-d tensor, over every submodel's (or entity's) rows
    when ``r`` is a dict."""
    if isinstance(r, dict):
        return torch.amax(torch.stack([torch.amax(torch.abs(v))
                                       for v in r.values()]))
    return torch.amax(torch.abs(r))


def scaled_error_and_residual(crit, r, tols, equations=(), model=None):
    """(worst error/tolerance, max |r|) as host floats from ONE device read:
    every criterion's maximum is divided by its tolerance in the working
    dtype (as the reference's traced ``jnp.max(arr) / tol``), reduced on the
    device — NaN propagates — and stacked with the residual's maximum
    (over every submodel's rows for a MultiModel's dict)."""
    scaled = [arr.max() / tolerance_for(eq_name, crit_name, tols, equations,
                                        model)
              for eq_name, criteria in crit.items()
              for crit_name, arr in criteria.items()]
    rmax = max_abs(r)
    worst = (torch.clamp_min(torch.stack(scaled).amax(), 0.0) if scaled
             else torch.zeros_like(rmax))
    err, rnorm = host_read(torch.stack([worst.to(rmax.dtype), rmax]),
                           torch.Tensor.tolist)
    return err, rnorm


# Eisenstat-Walker choice 2 constants: eta_k = gamma (e_k/e_{k-1})^2
# clipped to [eta_min, eta_max]; the first iteration (err_prev = inf)
# uses eta_max.
EW_GAMMA = 0.9
EW_ETA_MIN = 1e-4
EW_ETA_MAX = 0.1


def ew_eta(err, err_prev):
    """The Eisenstat-Walker forcing tolerance of this Newton iteration, in
    double precision like the reference's (its scaled error is a float64
    scalar whatever the state's dtype)."""
    if math.isfinite(err_prev):
        ratio = err / max(err_prev, 1e-30)
        ratio2 = ratio * ratio  # no OverflowError: inf clips to eta_max
    else:
        ratio2 = 1.0
    return min(max(EW_GAMMA * ratio2, EW_ETA_MIN), EW_ETA_MAX)


def newton_continue(err, it, bad, min_it: int, max_it: int) -> bool:
    """Loop condition: keep iterating until (converged AND the minimum
    iteration count is met) OR divergence, bounded by the cap."""
    done = (err <= 1.0 and it >= min_it) or bad
    return bool(not done and it < max_it)


def newton_accept(err, its, bad, max_it: int, tol_final: float) -> bool:
    """Ministep acceptance: converged normally, or within the relaxed
    tol_factor_final_iteration bound at the iteration cap (reference
    config.jl tol_factor_final_iteration)."""
    return bool(not bad and (err <= 1.0 or (its >= max_it
                                            and err <= tol_final)))
