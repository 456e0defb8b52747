"""Adaptive timestep selectors.

Port of the JAX package's ``simulator/timesteps.py`` (host-side Python).
Counterpart of Jutul's timestep machinery (reference: src/timesteps.jl —
``TimestepSelector`` :19, ``IterationTimestepSelector`` :68,
``VariableChangeTimestepSelector`` :96, ``LimitByFailedTimestepSelector``
:158; composition & clamping in src/simulator/timesteps.jl:1-60 and cutting
at :51). Selectors compose: the picked dt is the minimum over all selectors,
clamped by max increase/decrease factors, and growth is damped after cuts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class MinistepRecord:
    dt: float
    success: bool
    iterations: int


class AbstractTimestepSelector:
    def pick_first_timestep(self, dt_report: float, config) -> float:
        return dt_report

    def pick_next_timestep(self, dt_prev: float, history: list[MinistepRecord],
                           config) -> float:
        return math.inf


class TimestepSelector(AbstractTimestepSelector):
    """Fixed-factor selector (reference src/timesteps.jl:19)."""

    def __init__(self, initial_fraction: float = 1.0, initial_absolute=None,
                 maximum=math.inf, minimum=0.0):
        self.initial_fraction = initial_fraction
        self.initial_absolute = initial_absolute
        self.maximum = maximum
        self.minimum = minimum

    def pick_first_timestep(self, dt_report: float, config) -> float:
        dt = dt_report * self.initial_fraction
        if self.initial_absolute is not None:
            dt = min(dt, self.initial_absolute)
        return max(min(dt, self.maximum), self.minimum)

    def pick_next_timestep(self, dt_prev, history, config) -> float:
        return min(self.maximum, math.inf)


class IterationTimestepSelector(AbstractTimestepSelector):
    """Target-Newton-iteration selector (reference src/timesteps.jl:68,233).

    Picks the next dt by linear extrapolation on (dt, its) history toward
    ``target_iterations``.
    """

    def __init__(self, target_iterations: int = 5, offset: int = 1):
        self.target = target_iterations
        self.offset = offset

    def pick_next_timestep(self, dt_prev, history, config) -> float:
        if not history:
            return math.inf
        last = history[-1]
        its = max(last.iterations, 1)
        # dt* = dt_prev * (target + offset) / (its + offset)
        return dt_prev * (self.target + self.offset) / (its + self.offset)


class VariableChangeTimestepSelector(AbstractTimestepSelector):
    """Target change in a state variable (reference src/timesteps.jl:96).

    Requires the simulator to record per-ministep max variable change under
    ``history[i].dv`` (attached dynamically); falls back to no-op otherwise.
    """

    def __init__(self, variable: str, target_change: float,
                 relative: bool = False):
        self.variable = variable
        self.target = target_change
        self.relative = relative

    def pick_next_timestep(self, dt_prev, history, config) -> float:
        if not history:
            return math.inf
        dv = getattr(history[-1], "dv", None)
        if not dv or self.variable not in dv:
            return math.inf
        change = max(dv[self.variable], 1e-20)
        return dt_prev * self.target / change


class LimitByFailedTimestepSelector(AbstractTimestepSelector):
    """Cap dt by the last failed dt (reference src/timesteps.jl:158)."""

    def __init__(self, factor: float = 0.9):
        self.factor = factor

    def pick_next_timestep(self, dt_prev, history, config) -> float:
        failed = [h.dt for h in history if not h.success]
        if not failed:
            return math.inf
        return self.factor * failed[-1]


def pick_timestep(dt_prev: float, dt_remaining: float, history, selectors,
                  config, after_cut: bool) -> float:
    """Compose selectors (reference src/simulator/timesteps.jl:1-50)."""
    dt = min((s.pick_next_timestep(dt_prev, history, config) for s in selectors),
             default=math.inf)
    max_inc = config["timestep_max_increase"]
    max_dec = config["timestep_max_decrease"]
    dt = min(dt, dt_prev * max_inc)
    dt = max(dt, dt_prev * max_dec)
    if after_cut:
        dt = min(dt, dt_prev)  # damp growth right after a cut
    dt = min(dt, dt_remaining, config["max_timestep"])
    dt = max(dt, config["min_timestep"])
    return dt


def pick_first_timestep(dt_report: float, selectors, config) -> float:
    dt = min((s.pick_first_timestep(dt_report, config) for s in selectors),
             default=dt_report)
    return max(min(dt, config["max_timestep"], dt_report), config["min_timestep"])


def cut_timestep(dt: float, cut_count: int, config) -> float | None:
    """Halve (by factor) dt on failure; None if cuts exhausted
    (reference src/simulator/timesteps.jl:51)."""
    if cut_count >= config["max_timestep_cuts"]:
        return None
    return dt * config["timestep_cut_factor"]
