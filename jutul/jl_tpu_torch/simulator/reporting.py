"""Recorders, termination criteria, and console reporting.

Port of the JAX package's ``simulator/reporting.py`` (host-side Python).
Counterparts of the reference's bookkeeping (reference:
``SolveRecorder``/``ProgressRecorder`` simulator/types.jl:69-87 +
recorder.jl:7-86; ``EndTimeTerminationCriterion`` core_types.jl:1667;
console output print.jl:27-217 + convergence tables utils.jl:105-263 —
ProgressMeter/Crayons/PrettyTables become plain ANSI here).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field


@dataclass
class SolveRecorder:
    """Step/iteration counters (reference types.jl:69)."""

    step: int = 0
    iterations: int = 0
    failed: int = 0
    time: float = 0.0
    dt: float = 0.0

    def update(self, dt: float, its: int, success: bool) -> None:
        self.step += 1
        self.iterations += its
        if not success:
            self.failed += its
        else:
            self.time += dt
        self.dt = dt


@dataclass
class ProgressRecorder:
    """Global + local recorders (reference recorder.jl:7)."""

    recorder: SolveRecorder = field(default_factory=SolveRecorder)
    subrecorder: SolveRecorder = field(default_factory=SolveRecorder)

    def next_step(self) -> None:
        self.subrecorder = SolveRecorder()


class TerminationCriterion:
    """Return True to stop the outer loop early."""

    def __call__(self, time_done: float, step_no: int, state) -> bool:
        return False


class EndTimeTerminationCriterion(TerminationCriterion):
    """Stop once simulated time reaches ``end_time``
    (reference core_types.jl:1667)."""

    def __init__(self, end_time: float):
        self.end_time = float(end_time)

    def __call__(self, time_done: float, step_no: int, state) -> bool:
        return time_done >= self.end_time


# --------------------------------------------------------------------------
# console UX (reference print.jl / jutul_message)
# --------------------------------------------------------------------------
_COLORS = {"green": "\033[32m", "yellow": "\033[33m", "red": "\033[31m",
           "blue": "\033[34m", "bold": "\033[1m", "end": "\033[0m"}


def jutul_message(title: str, message: str = "", color: str = "blue",
                  stream=None) -> None:
    """Colored status line (reference print.jl:195 jutul_message)."""
    stream = stream or sys.stdout
    c = _COLORS.get(color, "")
    print(f"{c}{_COLORS['bold']}{title}:{_COLORS['end']} {message}",
          file=stream)


def progress_bar(frac: float, width: int = 40) -> str:
    done = int(round(frac * width))
    return "[" + "=" * done + " " * (width - done) + f"] {100 * frac:5.1f}%"


def convergence_table(crit: dict, tolerances=None) -> str:
    """ASCII table of convergence criteria (reference utils.jl:105-263)."""
    from .distance_functions import max_value

    lines = [f"{'Equation':<24}{'Criterion':<12}{'Value':>12}{'Tol':>10}"]
    for eq_name, criteria in crit.items():
        for crit_name, arr in criteria.items():
            val = max_value(arr)
            tol = ""
            if callable(tolerances):
                t = tolerances(eq_name, crit_name)
                tol = f"{t:.1e}" if t is not None else ""
            elif tolerances:
                t = tolerances.get(f"{eq_name}/{crit_name}",
                                   tolerances.get(eq_name,
                                                  tolerances.get("default")))
                if isinstance(t, dict):
                    t = t.get(crit_name)
                tol = f"{t:.1e}" if t is not None else ""
            lines.append(f"{eq_name:<24}{crit_name:<12}{val:>12.4e}{tol:>10}")
    return "\n".join(lines)
