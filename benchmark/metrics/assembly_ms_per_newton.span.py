"""Milliseconds inside the program's ``jt.assembly`` spans (the residual
and Jacobian with the well rows, on the profiler's clock, on both paths)
per Newton iteration of the traced schedule."""

from harness.spans import total_ms


def read(ctx):
    ms = total_ms(ctx.trace, "assembly")
    t = ctx.totals
    return ms / t.newtons if ms is not None and t.newtons else None
