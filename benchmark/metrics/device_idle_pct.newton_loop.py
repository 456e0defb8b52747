"""The share of the traced window in which the card idled while the
program was inside a ``jt.schedule`` span but outside every
``jt.assembly`` and ``jt.linear_solve`` span: the Newton loop's own work
(convergence reads, updates, timestep control, the returned states), in
%. With ``device_idle_pct.assembly`` and ``device_idle_pct.linear_solve``
it adds up to the idle inside the schedule; the rest of
``device_idle_pct`` lies outside it."""

from harness.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "newton_loop")
