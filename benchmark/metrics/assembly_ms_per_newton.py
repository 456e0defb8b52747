"""Milliseconds of assembly (extra_timing's ``assembly`` phase: the
residual and Jacobian with the well rows, the device synchronised at its
ends) per Newton iteration. Only the eager path has the phase timings."""


def read(ctx):
    t = ctx.totals
    s = t.timings.get("assembly")
    if s is None or not t.newtons:
        return None
    return 1e3 * s / t.newtons
