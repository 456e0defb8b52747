"""Krylov iterations per Newton iteration, from the reports' counts."""


def read(ctx):
    t = ctx.totals
    return t.linear_iterations / t.newtons if t.newtons else None
