"""Read the numbers a cell's check compares over several seeds in one
process: the program's, and the control's (the program's answers rounded
to TF32 and to bfloat16), each with its limit, one JSON line a seed.

    python3 benchmark/readings.py --workload <name> --seeds 1 2 3 \
        [--seconds 0] [--min-schedules 2]

from the root of a checkout, on a machine with the cell's CUDA card. The
limits in ``limits/<workload>.json`` are set from these readings; the
benchmark's own runs (``run.py``) read no control.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
sys.pycache_prefix = str(ROOT / ".pycache")
sys.dont_write_bytecode = False
os.environ["OMP_NUM_THREADS"] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--min-schedules", type=int, default=2)
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(BENCH_DIR)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from harness.cell import run_cell

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        out = run_cell(ROOT, args.workload, seed, args.seconds, False,
                       time.perf_counter(), controls=(10, 7),
                       min_schedules=args.min_schedules)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"], "counts": out["counts"],
                          "metrics": out["metrics"], "checks": out["checks"],
                          "controls": out["controls"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
