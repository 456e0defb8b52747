"""Run one cell of the port's benchmark once and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``; with
``--trace 1`` also ``breakdown``; the numbers compared last, under
``checks``). Without the cards it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Python's bytecode of every module the run imports, cached at a fixed
# path inside the checkout: only a checkout's first run compiles it
sys.pycache_prefix = str(ROOT / ".pycache")
sys.dont_write_bytecode = False
# one process, few threads: the port's host work is one Python thread
os.environ["OMP_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(BENCH_DIR)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import spec
    from harness.cell import emit, run_cell

    cell = spec.cell(ROOT, args.workload)
    import torch

    torch.set_num_threads(1)

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), T_START, cell=cell)
    return emit(out)


if __name__ == "__main__":
    sys.exit(main())
