"""Finds everything of a cell by name, as files of their own.

- ``BENCHMARK.json`` (the checkout's root): the cells (``workloads``), each
  naming a configuration and a traffic mix, and the metrics;
- ``configs/<config>.json``: the configuration, with the ``builder`` and
  the ``reference`` it takes;
- ``builders/<builder>.py``: ``build(cfg, seed) -> Case``;
- ``reference/<reference>.py``: the plain reference of that physics;
- ``mixes/<traffic>.json``: path, schedule, solver settings;
- ``metrics/<metric>.py``: ``read(ctx) -> float | None``, one reader per
  per-layer metric;
- ``kernels/<function>.json``: the kernel names that implement a function.

A later change adds a configuration, a mix, a metric or a kernel entry as
a file of its own and an entry in ``BENCHMARK.json``, and edits nothing.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: list
    per_layer: list
    bench_dir: Path = BENCH_DIR


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "configs" / f"{name}.json")


def mix(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "mixes" / f"{name}.json")


def builder(name: str, bench_dir: Path = BENCH_DIR):
    return _module(bench_dir / "builders" / f"{name}.py",
                   f"bench_builder_{name}")


def reference(name: str, bench_dir: Path = BENCH_DIR):
    return _module(bench_dir / "reference" / f"{name}.py",
                   f"bench_reference_{name}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The reader of per-layer metric ``name``: its ``read``."""
    return _module(bench_dir / "metrics" / f"{name}.py",
                   "bench_metric_" + re.sub(r"\W", "_", name)).read


def kernel_map(function: str, bench_dir: Path = BENCH_DIR) -> dict:
    """``{"function", "kernels": [regex, ...]}``: a device kernel belongs
    to ``function`` when any regex finds its name."""
    return _json(bench_dir / "kernels" / f"{function}.json")


def cell(root: Path, workload: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json, with its
    configuration and mix read from their files and the metrics it
    reports."""
    bench = benchmark(root)
    entry = [w for w in bench["workloads"] if w["name"] == workload]
    if not entry:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entry[0]

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m) and m["moves"] in moves]
    return Cell(workload, config(entry["config"], bench_dir),
                mix(entry["traffic"], bench_dir), int(entry["chips"]),
                e2e, per_layer, Path(bench_dir))


def limits(workload: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The limit of each number the cell's check compares
    (``limits/<workload>.json``)."""
    return _json(bench_dir / "limits" / f"{workload}.json")
