"""Milliseconds of the linear solve (extra_timing's ``linear_solve``
phase, the device synchronised at its ends) per Krylov iteration. Only
the eager path has the phase timings."""


def read(ctx):
    t = ctx.totals
    s = t.timings.get("linear_solve")
    if s is None or not t.linear_iterations:
        return None
    return 1e3 * s / t.linear_iterations
