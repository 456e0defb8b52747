"""The share of the traced window in which the card idled while the
program was inside a ``jt.assembly`` span: each span's length less its
overlap with the device operations' union, over the window, in %."""

from harness.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "assembly")
