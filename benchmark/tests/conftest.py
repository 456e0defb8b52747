"""Tests of the benchmark's harness. Run from the repository root:

    python -m pytest benchmark/tests -q

Tests marked ``cuda`` need a CUDA card and skip without one; on a machine
with the card they run the cells' controls at their own sizes.
"""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control is read on the card")


# tiny lattices of each configuration, (nx, ny, nz), for CPU runs
TINY = {"flagship-1m-wells": [10, 10, 6], "spe10-model2": [8, 22, 9]}


def tiny_cell(workload, bench_root=ROOT, bench_dir=BENCH_DIR):
    """The cell ``workload`` of the benchmark, its configuration cut to a
    tiny lattice; a rate in the configuration is cut by the same factor,
    so that the wells move as much of the pore volume as at full size."""
    import dataclasses

    import numpy as np

    from harness import spec

    cell = spec.cell(bench_root, workload, bench_dir)
    dims = TINY[cell.config["name"]]
    cfg = dict(cell.config, dims=dims)
    cut = np.prod(dims) / np.prod(cell.config["dims"])
    for key in [k for k in cfg if k.endswith("_rate_bbl_per_day")]:
        cfg[key] = cfg[key] * cut
    return dataclasses.replace(cell, config=cfg)


def run_tiny(workload, seed=7, trace=False, **kw):
    """One run of the tiny ``workload`` on the CPU through the harness's
    own path, its window one schedule long."""
    import time

    from harness.cell import run_cell

    return run_cell(ROOT, workload, seed, 0.0, trace, time.perf_counter(),
                    device="cpu", cell=kw.pop("cell", None)
                    or tiny_cell(workload), **kw)
