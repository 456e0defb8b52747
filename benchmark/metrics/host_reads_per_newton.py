"""Blocking device-to-host reads per Newton iteration of the traced
schedule: the program's ``jt.host_read`` spans (the Krylov loop's
residual, tolerance and convergence reads, the Newton loop's convergence
reads, the returned states' copies) over its Newton iterations."""

from harness.spans import has_spans, spans


def read(ctx):
    t = ctx.totals
    if not has_spans(ctx.trace) or not t.newtons:
        return None
    return len(spans(ctx.trace, "host_read")) / t.newtons
