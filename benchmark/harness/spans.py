"""The program's own spans in a traced window, and the device's idle time
inside them.

The port marks its Newton loop with profiler host events named
``jt.<span>`` (``jutul/jl_tpu_torch/utils/timing.py``):
``jt.schedule`` (a whole schedule: the eager ``simulate``, the schedule
path's run and its post-processing), ``jt.assembly``, ``jt.convergence``,
``jt.linear_solve``, ``jt.update``, and ``jt.host_read`` around every
blocking read of a device value. They are host events of the same trace
as the device's operations, on one clock. A program without them (an
older checkout) leaves the trace without ``jt.`` events, and every reader
here then returns None.

Intervals are (start_ns, end_ns) pairs.
"""

from __future__ import annotations

PREFIX = "jt."


def has_spans(trace) -> bool:
    return trace is not None and any(
        name.startswith(PREFIX) for _, _, name in trace.host_ops)


def spans(trace, name: str) -> list:
    """The intervals of every ``jt.<name>`` span, by start."""
    return [(s, e) for s, e, n in trace.host_ops if n == PREFIX + name]


def union(intervals) -> list:
    """The union of ``intervals`` as sorted, disjoint pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def length(intervals) -> int:
    return sum(e - s for s, e in intervals)


def overlap(a, b) -> int:
    """Nanoseconds in both of two sorted, disjoint interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def subtract(a, b) -> list:
    """``a`` less ``b``, both sorted and disjoint."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def idle_ns(intervals, trace) -> int:
    """Nanoseconds inside ``intervals`` (sorted, disjoint) in which no
    operation ran on the device."""
    busy = [tuple(iv) for iv in trace.busy_intervals()]
    return length(intervals) - overlap(intervals, busy)


def phase_idle(trace) -> dict | None:
    """Idle nanoseconds of the Newton loop's layers: inside ``jt.assembly``,
    inside ``jt.linear_solve``, and inside ``jt.schedule`` outside both
    (the Newton loop's own work). Each counts a nanosecond once, so the
    three add up to the idle inside ``jt.schedule``. None without spans or
    without device operations."""
    if not has_spans(trace) or not trace.device_ops:
        return None
    asm = union(spans(trace, "assembly"))
    sol = union(spans(trace, "linear_solve"))
    loop = subtract(union(spans(trace, "schedule")), union(asm + sol))
    return {"assembly": idle_ns(asm, trace),
            "linear_solve": idle_ns(sol, trace),
            "newton_loop": idle_ns(loop, trace)}


def idle_pct(ctx, layer: str):
    """The share of the traced window that the device idled inside
    ``layer`` (a key of ``phase_idle``), in %."""
    idle = phase_idle(ctx.trace)
    if idle is None or ctx.window_s <= 0:
        return None
    return 100.0 * idle[layer] * 1e-9 / ctx.window_s


def total_ms(trace, name: str) -> float | None:
    """The summed length of the ``jt.<name>`` spans in ms; None without
    spans."""
    if not has_spans(trace):
        return None
    return length(spans(trace, name)) * 1e-6
