"""Newton relaxation strategies.

Counterpart of Jutul's relaxation (reference: src/core_types/core_types.jl
:1049-1069 ``NoRelaxation``/``SimpleRelaxation``; adaptation rule in
src/simulator/relaxation.jl:13-28): ω is decreased when the residual
oscillates or stagnates and increased back toward 1 on good progress.
Host-side scalars; the eager Newton loop calls ``select_relaxation`` on its
error list, the check-before-solve loop ``select_relaxation_jit`` on its last
two scaled errors (``err_prev = inf`` on the first iteration).
"""

from __future__ import annotations

import math


class NonLinearRelaxation:
    def select_relaxation(self, omega: float, errors: list[float]) -> float:
        return omega

    def select_relaxation_jit(self, omega, err, err_prev):
        """Two-error form: adapt omega from the last two scaled errors."""
        return omega


class NoRelaxation(NonLinearRelaxation):
    def select_relaxation(self, omega: float, errors: list[float]) -> float:
        return 1.0

    def select_relaxation_jit(self, omega, err, err_prev):
        return 1.0


class SimpleRelaxation(NonLinearRelaxation):
    def __init__(self, tol: float = 0.01, w_min: float = 0.25,
                 w_max: float = 1.0, dw_decrease: float = 0.25,
                 dw_increase: float = 0.1):
        self.tol = tol
        self.w_min = w_min
        self.w_max = w_max
        self.dw_decrease = dw_decrease
        self.dw_increase = dw_increase

    def select_relaxation(self, omega: float, errors: list[float]) -> float:
        if len(errors) < 2:
            return omega
        e, e_prev = errors[-1], errors[-2]
        if e_prev <= 0:
            return omega
        d = (e - e_prev) / e_prev
        if d > -self.tol:  # stagnation or growth
            omega = max(omega - self.dw_decrease, self.w_min)
        else:
            omega = min(omega + self.dw_increase, self.w_max)
        return omega

    def select_relaxation_jit(self, omega, err, err_prev):
        if not (math.isfinite(err_prev) and err_prev > 0):
            return omega
        d = (err - err_prev) / err_prev
        if d > -self.tol:  # stagnation or growth
            return max(omega - self.dw_decrease, self.w_min)
        return min(omega + self.dw_increase, self.w_max)
