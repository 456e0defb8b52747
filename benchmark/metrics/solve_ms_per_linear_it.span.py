"""Milliseconds inside the program's ``jt.linear_solve`` spans (CPR set-up,
the Krylov loop with its V-cycles, the wells' Schur back-substitution, on
the profiler's clock, on both paths) per Krylov iteration of the traced
schedule."""

from harness.spans import total_ms


def read(ctx):
    ms = total_ms(ctx.trace, "linear_solve")
    t = ctx.totals
    return ms / t.linear_iterations if ms is not None and \
        t.linear_iterations else None
