"""Newton iterations per simulated day, from the reports' counts
(report_stats), summed over the window's schedules."""


def read(ctx):
    t = ctx.totals
    return t.newtons / t.sim_days if t.sim_days > 0 else None
