"""Simulated days of the traced schedule's accepted report steps over its
wall time, under the profiler. The window's rate as a per-layer reading:
a schedule's Newton count moves with the seed's field, so the rate over a
window spreads too widely to hold a bound end to end."""


def read(ctx):
    t = ctx.totals
    return t.sim_days / ctx.window_s if t.sim_days > 0 and ctx.window_s > 0 \
        else None
