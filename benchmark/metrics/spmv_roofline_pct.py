"""The block-stencil SpMV's share of its roofline: the bytes its calls
need (kernels/spmv.json's function; harness.work.spmv_bytes at the
lattice's cells, per K1 entry and block shape, times its launches) over
the card's 3.35 TB/s, against the device time of every kernel that
implements it in the traced window."""

from harness.spec import kernel_map
from harness.work import HBM_BYTES_PER_S, spmv_bytes


def read(ctx):
    if ctx.trace is None:
        return None
    kernels = kernel_map("spmv", ctx.cell.bench_dir)["kernels"]
    t = ctx.trace.seconds_of(kernels)
    n = ctx.case.n_lattice
    need = sum(count * spmv_bytes(n, entry, C, K)
               for (entry, C, K), count in ctx.k1_shapes.items())
    if t <= 0 or need <= 0:
        return None
    return 100.0 * need / HBM_BYTES_PER_S / t
