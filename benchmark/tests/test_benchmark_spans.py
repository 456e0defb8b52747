"""The readers of the program's spans (``harness/spans.py`` and the metrics
that read ``jt.`` spans): their arithmetic on traces placed by hand, and a
tiny traced cell on the CPU that reports them."""

import numpy as np
import pytest

from conftest import BENCH_DIR, run_tiny
from harness import spans as S
from harness import spec
from harness.cell import Context, Totals
from harness.profile import DeviceTrace

SPAN_METRICS = ("assembly_ms_per_newton.span", "solve_ms_per_linear_it.span",
                "host_reads_per_newton", "device_idle_pct.assembly",
                "device_idle_pct.linear_solve", "device_idle_pct.newton_loop")
IDLE = ("device_idle_pct.assembly", "device_idle_pct.linear_solve",
        "device_idle_pct.newton_loop")


def _ctx(host, device, window_ns, newtons=4, linear_iterations=10):
    trace = DeviceTrace(sorted((s, e, "kernel") for s, e in device),
                        sorted(host))
    totals = Totals(newtons=newtons, linear_iterations=linear_iterations)
    return Context(None, None, totals, window_ns * 1e-9, 0.0, 0, {}, {},
                   trace)


def _read(name, ctx):
    return spec.metric_reader(name, BENCH_DIR)(ctx)


# one schedule of two Newtons, by hand (ns): device work in both phases,
# between them and after the schedule
HOST = [(0, 100, "jt.schedule"),
        (10, 30, "jt.assembly"), (40, 80, "jt.linear_solve"),
        (45, 47, "jt.host_read"), (60, 62, "jt.host_read"),
        (82, 84, "jt.host_read"), (12, 14, "aten::mul")]
DEVICE = [(15, 20), (50, 60), (55, 58), (70, 90), (95, 120)]
WINDOW = 200


def test_readers_subtract_the_device_overlap():
    ctx = _ctx(HOST, DEVICE, WINDOW, newtons=2, linear_iterations=5)
    assert _read("assembly_ms_per_newton.span", ctx) == pytest.approx(
        20e-6 / 2)
    assert _read("solve_ms_per_linear_it.span", ctx) == pytest.approx(
        40e-6 / 5)
    assert _read("host_reads_per_newton", ctx) == 3 / 2
    # assembly 20 ns less 5 busy; the solve 40 less 10 and 10; the loop
    # [0,10] [30,40] [80,100] less [80,90] and [95,100]
    assert _read("device_idle_pct.assembly", ctx) == pytest.approx(
        100 * 15 / WINDOW)
    assert _read("device_idle_pct.linear_solve", ctx) == pytest.approx(
        100 * 20 / WINDOW)
    assert _read("device_idle_pct.newton_loop", ctx) == pytest.approx(
        100 * 25 / WINDOW)
    busy = 5 + 10 + 20 + 25
    whole = _read("device_idle_pct", ctx)
    assert whole == pytest.approx(100 * (WINDOW - busy) / WINDOW)
    assert sum(_read(m, ctx) for m in IDLE) == pytest.approx(100 * 60 / WINDOW)


def test_nested_spans_count_once():
    """An assembly span inside another (a caller's own) and a second
    schedule span inside the first count each idle nanosecond once; the
    reads nest anywhere."""
    host = HOST + [(15, 25, "jt.assembly"), (5, 95, "jt.schedule"),
                   (20, 21, "jt.host_read")]
    ctx = _ctx(host, DEVICE, WINDOW, newtons=2)
    assert _read("device_idle_pct.assembly", ctx) == pytest.approx(
        100 * 15 / WINDOW)
    assert _read("device_idle_pct.newton_loop", ctx) == pytest.approx(
        100 * 25 / WINDOW)
    assert _read("host_reads_per_newton", ctx) == 4 / 2
    # the summed lengths: each span's own time, as extra_timing sums them
    assert _read("assembly_ms_per_newton.span", ctx) == pytest.approx(
        30e-6 / 2)


def test_no_program_span_reads_none():
    host = [(s, e, n) for s, e, n in HOST if not n.startswith("jt.")]
    for trace_host in (host, []):
        ctx = _ctx(trace_host, DEVICE, WINDOW)
        assert all(_read(m, ctx) is None for m in SPAN_METRICS)
    ctx = _ctx(HOST, DEVICE, WINDOW)
    ctx.trace = None
    assert all(_read(m, ctx) is None for m in SPAN_METRICS)
    # spans but no device: no idle share, the times still read
    ctx = _ctx(HOST, [], WINDOW)
    assert all(_read(m, ctx) is None for m in IDLE)
    assert _read("host_reads_per_newton", ctx) is not None


@pytest.mark.parametrize("seed", range(6))
def test_idle_shares_never_pass_the_whole(seed):
    """Random schedules of phases and reads inside a window, random device
    work anywhere in it: the three shares sum to the idle inside the
    schedules, never above device_idle_pct."""
    rng = np.random.default_rng(seed)
    window = 10_000
    host, t = [], int(rng.integers(0, 200))
    for _ in range(int(rng.integers(1, 4))):
        start = t
        for _ in range(int(rng.integers(1, 6))):
            for name in ("jt.assembly", "jt.convergence", "jt.linear_solve",
                         "jt.update"):
                t += int(rng.integers(0, 30))
                d = int(rng.integers(1, 200))
                host.append((t, t + d, name))
                if rng.random() < 0.5:
                    host.append((t + d // 2, t + d // 2 + 1, "jt.host_read"))
                t += d
        host.append((start, t, "jt.schedule"))
        t += int(rng.integers(0, 300))
    assert t < window
    device = []
    for _ in range(int(rng.integers(0, 60))):
        s = int(rng.integers(0, window - 1))
        device.append((s, s + int(rng.integers(1, 400))))
    device = [(s, min(e, window)) for s, e in device] or [(0, 1)]
    ctx = _ctx(host, device, window)
    shares = [_read(m, ctx) for m in IDLE]
    whole = _read("device_idle_pct", ctx)
    sched = S.union(S.spans(ctx.trace, "schedule"))
    inside = 100 * S.idle_ns(sched, ctx.trace) * 1e-9 / ctx.window_s
    assert sum(shares) == pytest.approx(inside)
    assert sum(shares) <= whole + 1e-9
    assert all(v >= 0 for v in shares)


def test_interval_helpers():
    a = S.union([(0, 10), (5, 20), (30, 40), (40, 45)])
    assert a == [(0, 20), (30, 45)]
    assert S.subtract(a, [(-5, 2), (8, 9), (18, 35), (44, 50)]) == [
        (2, 8), (9, 18), (35, 44)]
    assert S.overlap(a, [(10, 35)]) == 10 + 5
    assert S.length(a) == 35


@pytest.mark.parametrize("workload", ["flagship-product", "spe10-eager"])
def test_tiny_traced_cell_reports_the_spans(workload):
    """The program marks its spans on the CPU too: a traced tiny cell
    reports the reads and the phase times a Newton (no device: no idle
    shares)."""
    out = run_tiny(workload, trace=True)
    assert out["correct"], out["checks"]
    m = out["metrics"]
    c = out["counts"]
    assert {"host_reads_per_newton", "assembly_ms_per_newton.span",
            "solve_ms_per_linear_it.span"} <= set(m)
    assert not set(IDLE) & set(m)
    # at least the Krylov loop's reads: its + 3 a solve
    assert m["host_reads_per_newton"]["value"] > \
        c["linear_iterations"] / c["newtons"]
    assert m["assembly_ms_per_newton.span"]["value"] > 0
    assert m["solve_ms_per_linear_it.span"]["value"] > 0
