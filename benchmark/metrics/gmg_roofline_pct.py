"""The GMG level phases' share of their roofline: the bytes of a V-cycle's
phases at the hierarchy's shapes (harness.work.vcycle_bytes), times two
V-cycles per Krylov iteration (BiCGStab applies CPR twice), over the
card's 3.35 TB/s, against the device time of every kernel that implements
them (kernels/gmg.json) in the traced window."""

from harness.spec import kernel_map
from harness.work import HBM_BYTES_PER_S, vcycle_bytes


def read(ctx):
    if ctx.trace is None:
        return None
    kernels = kernel_map("gmg", ctx.cell.bench_dir)["kernels"]
    t = ctx.trace.seconds_of(kernels)
    g = ctx.solver["gmg"]
    need = 2 * ctx.totals.linear_iterations * vcycle_bytes(
        ctx.lattice, g["min_cells"], g.get("coef_dtype"))
    if t <= 0 or need <= 0:
        return None
    return 100.0 * need / HBM_BYTES_PER_S / t
