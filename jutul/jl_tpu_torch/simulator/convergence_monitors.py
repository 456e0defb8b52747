"""Convergence monitors: contraction-factor based early cutting/relaxation.

Port of the JAX package's ``simulator/convergence_monitors.py`` (host-side
Python). Counterpart of the reference ConvergenceMonitors module (reference:
src/ConvergenceMonitors/ — distance functions over scaled residuals
distance_functions.jl:8, ``compute_contraction_factor``
contraction_factors.jl:10, oscillation detection,
``ConvergenceMonitorCuttingCriterion`` hooking into cutting_criterion
cutting_criterions.jl:57, ``ConvergenceMonitorRelaxation`` relaxation.jl:1).

The monitor watches the scaled-error history of the Newton loop and
(a) aborts a ministep early when the contraction factor predicts the
remaining iterations cannot converge, (b) adapts the relaxation factor when
errors oscillate. Plugs into the simulator via the ``cutting_criterion``
config option.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .relaxation import NonLinearRelaxation


def compute_contraction_factor(errors: list[float], window: int = 3) -> float:
    """Geometric-mean contraction over the recent error history
    (reference contraction_factors.jl:10)."""
    es = [e for e in errors[-(window + 1):] if e > 0]
    if len(es) < 2:
        return 0.0
    ratios = [es[i + 1] / es[i] for i in range(len(es) - 1)]
    prod = 1.0
    for r in ratios:
        prod *= max(r, 1e-12)
    return prod ** (1.0 / len(ratios))


def detect_oscillation(errors: list[float], window: int = 4) -> bool:
    """Sign-alternation of consecutive error changes."""
    es = errors[-(window + 1):]
    if len(es) < 4:
        return False
    diffs = [es[i + 1] - es[i] for i in range(len(es) - 1)]
    flips = sum(1 for a, b in zip(diffs, diffs[1:]) if a * b < 0)
    return flips >= len(diffs) - 1


class ConvergenceMonitorCuttingCriterion:
    """Early-abort criterion (reference cutting_criterions.jl:57).

    ``__call__(errors, it, max_it, residuals=None) -> True`` requests an
    immediate timestep cut. Following the reference's violation counter
    (cutting_criterions.jl:84-112: "bad" iterates +1, "good" -1, cut only
    when the count exceeds ``num_violations_cut``), each iterate is
    classified from the contraction factor of its history prefix:
    *good* when theta beats the rate needed to land within the remaining
    budget, *bad* when theta exceeds ``max_contraction`` or the
    extrapolated iteration count ``log(target/e) / log(theta)`` exceeds
    the remaining budget by ``slack``. A single slow or plateaued iterate
    (common for the discrete ``nonconverged_equations`` distance, whose
    plateaus carry no divergence information) therefore never cuts on its
    own; violations must accumulate. The counter is replayed from the
    history each call, so the decision is a pure function of the series.

    ``distance_function``/``mapping`` (reference distance-function menu,
    distance_functions.jl:8-51): when given, the monitored scalar is
    ``1 + compute_distance(residuals, distance_function, mapping)``
    instead of the default worst scaled error — e.g.
    ``scaled_residual_norm`` + ``max`` reproduces the default, while
    ``nonconverged_equations`` + ``sum`` monitors the count of
    non-converged criteria. The simulator passes the per-criterion
    scaled-residual dict as the 4th argument.
    """

    def __init__(self, min_iterations: int = 4, slack: float = 1.5,
                 max_contraction: float = 0.95, distance_function=None,
                 mapping=max, num_violations_cut: int = 3):
        self.min_iterations = min_iterations
        self.slack = slack
        self.max_contraction = max_contraction
        self.distance_function = distance_function
        self.mapping = mapping
        self.num_violations_cut = num_violations_cut
        self._dist_hist: list[float] = []

    def _classify(self, window: list[float], max_it: int) -> str:
        """Classify the iterate ending ``window`` (reference
        cutting_criterions.jl:84-99 good/ok/bad)."""
        theta = compute_contraction_factor(window)
        e = window[-1]
        if e <= 1.0:
            return "good"  # at/below the convergence target
        if theta <= 0.0:
            return "none"  # insufficient history
        remaining = max(max_it - len(window), 2)
        # rate that would land exactly at the target in the remaining
        # budget (reference contraction_factors.jl theta_target)
        theta_target = e ** (-1.0 / remaining)
        if theta <= max(theta_target, 0.1):
            return "good"
        if theta >= 1.0:
            return "bad"  # plateau/divergence: infinite extrapolation
        if theta > self.max_contraction:
            return "bad"
        needed = math.log(1.0 / e) / math.log(theta)
        return "bad" if needed > self.slack * remaining else "ok"

    def __call__(self, errors: list[float], it: int, max_it: int,
                 residuals: dict | None = None) -> bool:
        if self.distance_function is not None and residuals is not None:
            from .distance_functions import compute_distance

            if len(errors) <= 1:
                self._dist_hist = []  # new ministep: errors restarted
            d, _names = compute_distance(residuals, self.distance_function,
                                         self.mapping)
            # 1 + d keeps the convergence target at 1.0 (d == 0 converged),
            # so the same contraction/extrapolation machinery applies
            self._dist_hist.append(1.0 + d)
            errors = self._dist_hist
        if it < self.min_iterations or len(errors) < 2:
            return False
        violations = 0
        for j in range(2, len(errors) + 1):
            status = self._classify(errors[:j], max_it)
            if status == "bad":
                violations += 1
            elif status == "good":
                violations = max(0, violations - 1)
        return violations > self.num_violations_cut


class ConvergenceMonitorRelaxation(NonLinearRelaxation):
    """Oscillation-aware relaxation (reference ConvergenceMonitors
    relaxation.jl:1): reduce omega under oscillation, recover on contraction.
    """

    def __init__(self, w_min: float = 0.2, w_max: float = 1.0,
                 decrease: float = 0.5, increase: float = 0.2):
        self.w_min = w_min
        self.w_max = w_max
        self.decrease = decrease
        self.increase = increase

    def select_relaxation(self, omega: float, errors: list[float]) -> float:
        if detect_oscillation(errors):
            return max(self.w_min, omega * self.decrease)
        theta = compute_contraction_factor(errors)
        if 0 < theta < 1:
            return min(self.w_max, omega + self.increase)
        return omega
