"""The program's spans and counters: one scope, three consumers.

Port of the JAX package's ``utils/timing.py``. Counterpart of the
reference's TimerOutputs integration (reference: src/Jutul.jl:48-52
``@tic`` alias, ``timeit_debug_enabled``, enabled via the ``extra_timing``
config / JUTUL_EXTRA_TIMING env; printed by set_global_timer!/print.jl:1-26).

``tic(name, timings)`` marks a span of the program. Entering it does only
what is switched on:

- a running ``torch.profiler`` (``torch.autograd._profiler_enabled()``):
  a host event ``"jt." + name`` (``_RecordFunctionFast``), so the span
  lands among the profiler's host events on the device trace's clock, its
  parent the span that encloses it on the same host thread. Not a
  ``record_function``: that user scope also puts an annotation on the
  device's timeline, from the first kernel it launched to the last, which
  a trace would read as device work;
- a ``timings`` dict (the simulator's ``extra_timing``): the device is
  synchronised when the span ends and its wall time added to
  ``timings[name]``;
- the table (``set_timing_enabled`` / JUTUL_EXTRA_TIMING): the span's
  host wall time under its hierarchical key ("outer/inner") in the table
  that ``get_timings`` and ``print_timings`` read.

With none of them on, ``tic`` checks the flags and returns a shared no-op
scope: nothing is constructed, recorded or synchronised.

``host_read(x, read)`` (``host_array(t)`` for a copy to a host array) is
every blocking device-to-host read of the Newton loop: it returns
``read(x)`` inside a ``jt.host_read`` span, so a trace counts the reads.
The Newton loop's spans are ``jt.schedule`` (a whole schedule),
``jt.assembly``, ``jt.convergence``, ``jt.linear_solve``, ``jt.update``
(``PHASES``, the keys of ``extra_timing``) and ``jt.host_read``.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import nullcontext

import numpy as np
import torch
from torch.autograd import _profiler_enabled

SPAN_PREFIX = "jt."
# the Newton loop's phases: extra_timing's keys, in the order they run
PHASES = ("assembly", "convergence", "linear_solve", "update")

_ENABLED = os.environ.get("JUTUL_EXTRA_TIMING", "0") not in ("0", "", "false")
_TIMES: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)
_STACK: list[str] = []
_OFF = nullcontext()


def set_timing_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = bool(flag)


def timing_enabled() -> bool:
    return _ENABLED


class _Scope:
    """A span with at least one consumer on (see the module's doc)."""

    __slots__ = ("name", "timings", "rf", "key", "t0")

    def __init__(self, name: str, timings):
        self.name, self.timings, self.rf, self.key = name, timings, None, None

    def __enter__(self):
        if _profiler_enabled():
            self.rf = torch._C._profiler._RecordFunctionFast(
                SPAN_PREFIX + self.name)
            self.rf.__enter__()
        if _ENABLED:
            _STACK.append(self.name)
            self.key = "/".join(_STACK)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.timings is not None and torch.cuda.is_initialized():
            torch.cuda.synchronize()  # the phase's queued work is its own
        dt = time.perf_counter() - self.t0
        if self.timings is not None:
            self.timings[self.name] = self.timings.get(self.name, 0.0) + dt
        if self.key is not None:
            _TIMES[self.key] += dt
            _COUNTS[self.key] += 1
            _STACK.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def tic(name: str, timings: dict | None = None):
    """The span ``name`` (reference @tic); ``timings``: the ministep's
    phase-time dict, or None (see the module's doc)."""
    if timings is None and not _ENABLED and not _profiler_enabled():
        return _OFF
    return _Scope(name, timings)


def host_read(x, read=float):
    """``read(x)``: one blocking device-to-host read (``float`` of a 0-d
    tensor, ``torch.Tensor.tolist``), as a
    ``host_read`` span when the profiler or the table is on."""
    if not _ENABLED and not _profiler_enabled():
        return read(x)
    with _Scope("host_read", None):
        return read(x)


def host_array(t) -> np.ndarray:
    """``t`` copied to a host array, through ``host_read``."""
    return host_read(t, _to_numpy)


def _to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


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
