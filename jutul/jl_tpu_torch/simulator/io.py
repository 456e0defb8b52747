"""Output, checkpoint and restart.

Port of the JAX package's ``simulator/io.py`` (numpy only): the files are
the same, so either package reads what the other wrote. Counterpart of the reference's output/restart machinery (reference:
src/simulator/io.jl — ``store_output!`` :54,86 writing per-step
``jutul_<n>.jld2``; src/utils.jl:646-727 ``read_results``/``read_restart``/
``valid_restart_indices``; restart logic simulator.jl:625-709).

Format: per report step ``jutul_<n>.npz`` holding the (possibly nested)
state arrays plus a JSON-serialized report. numpy's npz replaces JLD2 as the
portable container.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path

import numpy as np

_STEP_RE = re.compile(r"jutul_(\d+)\.npz$")


def _flatten_state(state: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in state.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_state(v, key + "/"))
        elif isinstance(v, list):  # substates
            for i, sub in enumerate(v):
                out.update(_flatten_state(sub, f"{key}/{i}/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten_state(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def store_output(path, step_no: int, state: dict, report: dict) -> str:
    """Write one report step (reference io.jl:86)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    fn = path / f"jutul_{step_no + 1}.npz"
    flat = _flatten_state(state)
    flat["__report__"] = np.frombuffer(
        json.dumps(_json_safe(report)).encode(), dtype=np.uint8)
    np.savez_compressed(fn, **flat)
    return str(fn)


def _json_safe(o):
    if isinstance(o, dict):
        return {str(k): _json_safe(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_json_safe(v) for v in o]
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if hasattr(o, "item") and getattr(o, "shape", None) == ():
        return o.item()
    return o


def load_step(path, step_no: int):
    """Read one step -> (state, report) (reference read_restart)."""
    fn = Path(path) / f"jutul_{step_no + 1}.npz"
    with np.load(fn, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    rep_raw = flat.pop("__report__", None)
    report = (json.loads(bytes(rep_raw.tobytes()).decode())
              if rep_raw is not None else None)
    return _unflatten_state(flat), report


def valid_restart_indices(path) -> list[int]:
    """Sorted step numbers present on disk (reference utils.jl:686)."""
    p = Path(path)
    if not p.is_dir():
        return []
    out = []
    for f in p.iterdir():
        m = _STEP_RE.search(f.name)
        if m:
            out.append(int(m.group(1)) - 1)
    return sorted(out)


def read_results(path, steps=None):
    """Read all (or selected) stored steps -> (states, reports)
    (reference utils.jl:646 read_results)."""
    idx = valid_restart_indices(path)
    if not idx and (Path(path) / _CONSOLIDATED).is_file():
        return read_consolidated(Path(path) / _CONSOLIDATED, steps)
    if steps is not None:
        idx = [i for i in idx if i in set(steps)]
    states, reports = [], []
    for i in idx:
        s, r = load_step(path, i)
        states.append(s)
        reports.append(r)
    return states, reports


_CONSOLIDATED = "jutul_steps.npz"


def consolidate_results(path, out: str | None = None,
                        delete_steps: bool = False) -> str:
    """Merge per-step ``jutul_<n>.npz`` files into one archive.

    Counterpart of the reference's case-consolidation utilities (reference
    src/utils.jl:646 read_results collates per-step JLD2 files; we go one
    further and produce a single portable npz so distributed runs — one file
    per report step, possibly written by different hosts into a shared
    directory — end as one artifact). Keys are ``step<k>/<state path>``;
    reports are stored as one JSON blob under ``__reports__``.
    """
    path = Path(path)
    idx = valid_restart_indices(path)
    if not idx:
        raise FileNotFoundError(f"no step files under {path}")
    merged: dict = {}
    reports = []
    for i in idx:
        state, rep = load_step(path, i)
        for k, v in _flatten_state(state).items():
            merged[f"step{i}/{k}"] = v
        reports.append(rep)
    merged["__reports__"] = np.frombuffer(
        json.dumps(_json_safe(reports)).encode(), dtype=np.uint8)
    merged["__steps__"] = np.asarray(idx, dtype=np.int64)
    fn = Path(out) if out is not None else path / _CONSOLIDATED
    np.savez_compressed(fn, **merged)
    if delete_steps:
        for i in idx:
            (path / f"jutul_{i + 1}.npz").unlink(missing_ok=True)
    return str(fn)


def read_consolidated(fn, steps=None):
    """Read a consolidated archive -> (states, reports)."""
    with np.load(fn, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    reports = json.loads(bytes(flat.pop("__reports__").tobytes()).decode())
    idx = [int(i) for i in flat.pop("__steps__")]
    per_step: dict[int, dict] = {i: {} for i in idx}
    for k, v in flat.items():
        stp, rest = k.split("/", 1)
        per_step[int(stp[4:])][rest] = v
    keep = set(steps) if steps is not None else None
    states, reps = [], []
    for j, i in enumerate(idx):
        if keep is not None and i not in keep:
            continue
        states.append(_unflatten_state(per_step[i]))
        reps.append(reports[j])
    return states, reps


# ---------------------------------------------------------------------------
# report statistics (reference utils.jl:265-925 report_stats / print_stats)
# ---------------------------------------------------------------------------
def report_stats(reports: list) -> dict:
    """Aggregate newton/ministep/timing counts from simulation reports."""
    stats = {
        "steps": len(reports),
        "ministeps": 0,
        "newtons": 0,
        "wasted_newtons": 0,
        "failed_ministeps": 0,
        "wall_time": 0.0,
        "linear_iterations": 0,
    }
    stats["timings"] = {}
    for rep in reports:
        for m in rep.get("ministeps", []):
            stats["ministeps"] += 1
            its = int(m.get("iterations", 0))
            stats["newtons"] += its
            if not m.get("success", True):
                stats["failed_ministeps"] += 1
                stats["wasted_newtons"] += its
            stats["wall_time"] += float(m.get("wall_time", 0.0))
            if m.get("wall_time_is_amortized"):
                # jit-timestep paths spread ONE device execution's wall
                # clock evenly across its ministeps — the aggregate is
                # real, per-ministep attribution is not
                stats["wall_time_is_amortized"] = True
            stats["linear_iterations"] += int(m.get("linear_iterations", 0))
            for key, t in (m.get("timings") or {}).items():
                stats["timings"][key] = stats["timings"].get(key, 0.0) + t
    ok_newtons = stats["newtons"] - stats["wasted_newtons"]
    stats["newtons_per_ministep"] = (
        stats["newtons"] / stats["ministeps"] if stats["ministeps"] else 0.0)
    stats["time_per_newton"] = (
        stats["wall_time"] / stats["newtons"] if stats["newtons"] else 0.0)
    stats["linear_iterations_per_newton"] = (
        stats["linear_iterations"] / stats["newtons"] if stats["newtons"]
        else 0.0)
    return stats


def timing_breakdown(stats_or_reports) -> dict:
    """Fractional wall-time split by phase (reference utils.jl
    timing_breakdown) from the per-ministep ``timings`` dicts that
    ``simulate(..., extra_timing=True)`` collects (keys: assembly,
    convergence, linear_solve, update — assembly fuses the reference's
    secondary+equations phases)."""
    stats = (stats_or_reports if isinstance(stats_or_reports, dict)
             else report_stats(stats_or_reports))
    timings = stats.get("timings", {})
    total = sum(timings.values())
    if total <= 0:
        return {"total": stats.get("wall_time", 0.0)}
    out = {k: {"seconds": v, "fraction": v / total}
           for k, v in timings.items()}
    out["total"] = total
    return out


def print_stats(reports: list) -> None:
    s = report_stats(reports)
    print(
        f"Simulation: {s['steps']} steps, {s['ministeps']} ministeps "
        f"({s['failed_ministeps']} failed), {s['newtons']} Newton its "
        f"({s['wasted_newtons']} wasted), "
        f"{s['newtons_per_ministep']:.2f} its/ministep, "
        f"{s['linear_iterations']} linear its "
        f"({s['linear_iterations_per_newton']:.1f}/Newton), "
        f"{s['wall_time']:.2f}s total ({s['time_per_newton'] * 1e3:.1f} "
        "ms/Newton)"
    )
    tb = timing_breakdown(s)
    parts = [f"{k} {100 * v['fraction']:.0f}%" for k, v in tb.items()
             if isinstance(v, dict)]
    if parts:
        print("Timing breakdown: " + ", ".join(parts))
