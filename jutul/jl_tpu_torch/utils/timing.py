"""Lightweight hierarchical timing (tracing/profiling aux).

Port of the JAX package's ``utils/timing.py``. Counterpart of the
reference's TimerOutputs integration (reference: src/Jutul.jl:48-52
``@tic`` alias, ``timeit_debug_enabled``, enabled via the ``extra_timing``
config / JUTUL_EXTRA_TIMING env; printed by set_global_timer!/print.jl:1-26).
The scopes time host wall clock: work queued on a CUDA card inside a scope
is counted only when the scope synchronises. For device time per kernel
use ``torch.profiler``.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

_ENABLED = os.environ.get("JUTUL_EXTRA_TIMING", "0") not in ("0", "", "false")
_TIMES: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)
_STACK: list[str] = []


def set_timing_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = bool(flag)


def timing_enabled() -> bool:
    return _ENABLED


@contextmanager
def tic(name: str):
    """Accumulating timing scope (reference @tic)."""
    if not _ENABLED:
        yield
        return
    _STACK.append(name)
    key = "/".join(_STACK)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _TIMES[key] += time.perf_counter() - t0
        _COUNTS[key] += 1
        _STACK.pop()


def reset_timings() -> None:
    _TIMES.clear()
    _COUNTS.clear()


def get_timings() -> dict:
    return {k: {"time": _TIMES[k], "count": _COUNTS[k]} for k in _TIMES}


def print_timings() -> None:
    """print the accumulated table (reference set_global_timer! output)."""
    if not _TIMES:
        print("no timings recorded (set JUTUL_EXTRA_TIMING=1 or "
              "set_timing_enabled(True))")
        return
    width = max(len(k) for k in _TIMES)
    print(f"{'section':<{width}}  {'count':>7}  {'total':>10}  {'mean':>10}")
    for k in sorted(_TIMES):
        t, c = _TIMES[k], _COUNTS[k]
        print(f"{k:<{width}}  {c:>7}  {t:>9.3f}s  {t / max(c, 1):>9.4f}s")


def timing_breakdown(reports: list) -> dict:
    """Aggregate the per-phase wall times embedded in simulation reports
    (reference timing_breakdown, utils.jl:265-925)."""
    out: dict[str, float] = defaultdict(float)
    for rep in reports:
        for m in rep.get("ministeps", []):
            out["ministep"] += float(m.get("wall_time", 0.0))
    return dict(out)
