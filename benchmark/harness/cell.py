"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

The window is a closed loop: one client runs the cell's schedule from the
case's initial state and, when it ends, starts it again, until ``seconds``
have passed; the schedule in flight then finishes and counts. The window
runs from the first start to the last end.
"""

from __future__ import annotations

import json
import math
import sys
import time
from dataclasses import dataclass, field, replace
from pathlib import Path

import numpy as np

from harness import spec
from harness.case import program_case, rate_scales
from harness.imports import forbidden_modules

DAY = 86400.0


@dataclass
class Totals:
    """What the window's schedules did, summed."""

    schedules: int = 0
    unanswered: int = 0
    sim_days: float = 0.0
    newtons: int = 0
    linear_iterations: int = 0
    ministeps: int = 0
    failed_ministeps: int = 0
    timings: dict = field(default_factory=dict)

    def add(self, res):
        from jutul.jl_tpu_torch import report_stats

        st = report_stats(res.reports)
        self.schedules += 1
        ok = all(r["success"] for r in res.reports)
        self.unanswered += not ok
        self.sim_days += sum(r["dt"] for r in res.reports
                             if r["success"]) / DAY
        self.newtons += st["newtons"]
        self.linear_iterations += st["linear_iterations"]
        self.ministeps += st["ministeps"]
        self.failed_ministeps += st["failed_ministeps"]
        for k, v in st["timings"].items():
            self.timings[k] = self.timings.get(k, 0.0) + v


@dataclass
class Context:
    """What a per-layer metric's reader may read. A traced run profiles
    the window's first schedule: ``totals``, ``window_s``, ``launches``,
    ``k1_shapes`` and ``trace`` are that schedule's."""

    cell: spec.Cell
    case: object
    totals: Totals
    window_s: float
    case_build_s: float
    memory_peak_bytes: int
    launches: dict
    k1_shapes: dict
    trace: object = None  # profile.DeviceTrace, traced runs

    @property
    def lattice(self):
        nx, ny, nz = self.case.dims
        return (nz, ny, nx)

    @property
    def solver(self) -> dict:
        return self.cell.mix["solver"]


def solver_config(mix: dict, trace: bool) -> dict:
    """The port's simulate options of ``mix``. Every schedule returns its
    report steps' states; the eager loop also the states of the ministeps
    before each report step's last (the check follows them)."""
    from jutul.jl_tpu_torch import (
        GMG,
        IterationTimestepSelector,
        StencilCPR,
        StencilKrylovSolver,
        TimestepSelector,
    )

    s = mix["solver"]
    gmg = GMG(**s["gmg"])
    gmg.slab_double_buffer = bool(s.get("slab_double_buffer", False))
    cfg = dict(
        linear_solver=StencilKrylovSolver(
            preconditioner=StencilCPR(gmg=gmg), **s["krylov"]),
        tolerances={"mass_conservation/CNV": s["cnv"],
                    "mass_conservation/MB": s["mb"]},
        max_nonlinear_iterations=s["max_nonlinear_iterations"],
        tol_factor_final_iteration=s["tol_factor_final_iteration"],
        timestep_selectors=[
            TimestepSelector(initial_fraction=s["initial_fraction"]),
            IterationTimestepSelector(
                target_iterations=s["target_iterations"])],
        output_variables="primary", info_level=-1)
    if mix["path"] == "schedule":
        cfg.update(mix.get("schedule_options", {}))
        cfg["jit_output_states"] = True
    else:
        cfg["output_substates"] = True
        if trace:
            cfg["extra_timing"] = True  # syncs the device at every phase
    return cfg


class Client:
    """One simulation of ``case`` on ``device``: set-up, then
    ``schedule()`` runs the whole schedule once from the case's initial
    state."""

    def __init__(self, cell: spec.Cell, case, device: str, trace: bool):
        from jutul.jl_tpu_torch import Simulator

        mix = cell.mix
        self.case = case
        n_step = int(mix["report_steps"])
        self.scales = rate_scales(n_step, mix["rate_ramp"])
        model, state0, params, forces = program_case(case, self.scales)
        self.dts = [float(mix["report_step_s"])] * n_step
        self.forces = forces
        self.sim = Simulator(model, state0, params, use_stencil=True,
                             device=device)
        # the eager loop writes into the simulator's initial state: each
        # schedule starts from a copy of it
        self.init = {k: v.clone() for k, v in self.sim.state0.items()}
        self.cfg = solver_config(mix, trace)
        self.path = mix["path"]
        if self.path == "schedule":
            self.lowered = self.sim.lower_schedule(
                self.dts, forces=forces, **self.cfg)

    def warm_up(self):
        """The first report step, through the same path: every shape the
        schedule uses."""
        if self.path == "schedule":
            run, args, post = self.sim.lower_schedule(
                self.dts[:1], forces=self.forces[:1], **self.cfg)
            post(*run(*args))
        else:
            self.restart()
            self.sim.simulate(self.dts[:1], forces=self.forces[:1],
                              **self.cfg)

    def restart(self):
        self.sim.state0 = {k: v.clone() for k, v in self.init.items()}

    def schedule(self):
        if self.path == "schedule":
            run, args, post = self.lowered
            return post(*run(*args))
        self.restart()
        return self.sim.simulate(self.dts, forces=self.forces, **self.cfg)

    def held_start(self):
        """(p, sw) of the initial state every schedule starts from, as the
        program holds it, float64 on the host."""
        held = self.lowered[1][0] if self.path == "schedule" else self.init
        return (_host(held["Pressure"]), _host(held["Saturations"][:, 0]))


def _sync(device: str):
    if device != "cpu":
        import torch

        torch.cuda.synchronize()


def _host(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float64)


def round_mantissa(x: np.ndarray, bits: int) -> np.ndarray:
    """float32 values rounded to nearest-even at ``bits`` explicit
    mantissa bits (10: TF32, 7: bfloat16), as float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    drop = 23 - bits
    half = np.uint32(1 << (drop - 1))
    odd = (u >> np.uint32(drop)) & np.uint32(1)
    r = (u + half - np.uint32(1) + odd) & ~np.uint32((1 << drop) - 1)
    return r.view(np.float32)


def signature(res) -> tuple:
    """What a schedule did, ministep by ministep: length, acceptance,
    Newton and linear iterations."""
    return tuple((float(m["dt"]), bool(m["success"]),
                  int(m.get("iterations", 0)),
                  int(m.get("linear_iterations", 0)))
                 for r in res.reports for m in r["ministeps"])


def report_states(res) -> list:
    """(p, sw) of each report step's state, as the program returned
    them."""
    return [(np.asarray(st["Pressure"]), np.asarray(st["Saturations"]))
            for st in res.states]


def same_schedule(a, b) -> bool:
    """Whether two schedules' (signature, report states) agree bit for
    bit."""
    return a[0] == b[0] and len(a[1]) == len(b[1]) and all(
        np.array_equal(x, y) for s, t in zip(a[1], b[1])
        for x, y in zip(s, t))


def ministeps(res, case, path: str, scales: list) -> list:
    """(p, sw, p0, sw0, dt, rate scale) of the ministeps the reference
    checks, as the program produced them. The eager loop returns every
    accepted ministep's state: the chain from the case's own initial
    state through each of them. The schedule path returns the report
    steps' states and the last ministep's start: that last ministep."""
    if path == "schedule":
        end, start = res.final_state_device, res.final_ministep_start_state
        return [(_host(end["Pressure"]), _host(end["Saturations"][:, 0]),
                 _host(start["Pressure"]), _host(start["Saturations"][:, 0]),
                 float(res.final_ministep_dt), scales[-1])]
    out = []
    p0, sw0 = case.p0, case.sw0
    for s, (rep, st) in enumerate(zip(res.reports, res.states)):
        dts = [float(m["dt"]) for m in rep["ministeps"] if m["success"]]
        ends = list(st.get("substates", [])) + [st]
        if len(ends) != len(dts):
            raise ValueError(f"report step {s}: {len(dts)} accepted "
                             f"ministeps, {len(ends)} states")
        for dt, e in zip(dts, ends):
            p, sw = _host(e["Pressure"]), _host(e["Saturations"][:, 0])
            out.append((p, sw, p0, sw0, dt, scales[s]))
            p0, sw0 = p, sw
    return out


def judge(reference, case, found: dict, limits: dict,
          control_bits: int | None = None) -> dict:
    """The numbers compared, each with its limit. ``found``: what the run
    gave (``ministeps``, ``end``, ``injected``, ``held``, ``differing``,
    ``unanswered``); ``control_bits``: the program's answers rounded to
    that many mantissa bits first (the control).

    - ``cnv``, ``mb``: the worst float64 CNV and MB of the checked
      ministeps (``ministeps``);
    - ``balance``: where the configuration names a phase that no well
      produces, its mass in place at the schedule's end less the initial
      mass and the injected mass, over the injected mass;
    - ``start_gap``: the program's held initial state against the case's
      (pressure relative, saturation absolute);
    - ``repeats_differing``: the window's later schedules whose counts or
      report-step states differ from the first's in any bit;
    - ``unanswered``: schedules with a failed report step."""
    def prog(x):
        return x if control_bits is None else \
            round_mantissa(x, control_bits).astype(np.float64)

    readings = {"repeats_differing": found["differing"],
                "unanswered": found["unanswered"]}
    cnv = mb = 0.0 if found["ministeps"] else math.inf
    for p, sw, p0, sw0, dt, scale in found["ministeps"]:
        p, sw = prog(p), prog(sw)
        if p0 is not case.p0:  # the chain's first start is the case's own
            p0, sw0 = prog(p0), prog(sw0)
        r = reference.residual(case, p, sw, p0, sw0, dt, scale)
        c, m = reference.convergence(case, r, p, dt)
        cnv, mb = max(cnv, c), max(mb, m)
    readings.update(cnv=cnv, mb=mb)
    if found["end"] is not None and found["injected"] is not None:
        p, sw = (prog(v) for v in found["end"])
        readings["balance"] = reference.balance(
            case, p, sw, found["injected"])
    p, sw = (prog(v) for v in found["held"])
    readings["start_gap"] = float(max(
        np.max(np.abs(p - case.p0) / np.abs(case.p0)),
        np.max(np.abs(sw - case.sw0))))
    return {k: {"value": readings.get(k, math.inf), "limit": lim}
            for k, lim in limits.items()}


def injected_mass(case, cfg: dict, res, scales: list):
    """The mass the rate-controlled wells put in over ``res``'s accepted
    report steps, of the phase the configuration names in
    ``balance_phase`` (no well produces it); None where it names none."""
    phase = cfg.get("balance_phase")
    if phase is None:
        return None
    k = ["water", "oil"].index(phase)
    q = sum(float(np.asarray(v)[k]) for _, v in case.rate)
    return phase, sum(q * sc * float(r["dt"])
                      for r, sc in zip(res.reports, scales) if r["success"])


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda",
             cell: spec.Cell | None = None, controls=(),
             min_schedules: int = 1) -> dict:
    """One run of ``workload``; returns the result line's object. ``cell``
    overrides the cell read from ``root`` (tests run tiny cells on the
    CPU); ``min_schedules``: the window holds at least this many
    schedules (tests of the repeats ask for two); ``controls`` adds, under ``controls``, the checks of the
    program's answers rounded to each of these mantissa bits (the control:
    10 for TF32, 7 for bfloat16); the benchmark's runs ask for none.

    The configuration's builder makes the case from ``seed``: its fields,
    and so its work."""
    import torch

    cell = cell or spec.cell(root, workload)
    t_lib = time.perf_counter()
    build_s = 0.0
    if device != "cpu":
        from jutul.jl_tpu_torch.ops.cuda._build import load_library

        # the checkout's first run builds the kernels
        build_s = load_library().build_seconds
    t_case = time.perf_counter()
    case = spec.builder(cell.config["builder"], cell.bench_dir).build(
        cell.config, seed)
    client = Client(cell, case, device, trace)
    case_build_s = time.perf_counter() - t_case
    client.warm_up()
    from jutul.jl_tpu_torch.ops.cuda import (launch_counts,
                                             reset_launch_counts,
                                             stencil_matvec)

    totals = Totals()
    first, repeats = None, []
    prof = dev_trace = traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from harness.profile import DeviceTrace

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device != "cpu" else [])
        prof = profile(activities=acts)
    _sync(device)
    reset_launch_counts()
    if prof is not None:
        prof.__enter__()
    t_first = time.perf_counter()
    setup_s = t_first - t_start
    print(f"set-up {setup_s:.3f} s: to the kernel library {t_lib - t_start:.3f}"
          f", library {t_case - t_lib:.3f} (build {build_s:.3f}), case "
          f"{case_build_s:.3f}, warm-up {t_first - t_case - case_build_s:.3f}",
          file=sys.stderr, flush=True)
    while True:
        res = client.schedule()
        _sync(device)
        totals.add(res)
        if prof is not None:
            # the profiler covers the window's first schedule: reading the
            # trace of a whole window takes longer than a run may
            traced = (replace(totals, timings=dict(totals.timings)),
                      time.perf_counter() - t_first, launch_counts(),
                      dict(stencil_matvec.launches_by_shape))
            prof.__exit__(None, None, None)
            dev_trace, prof = DeviceTrace.read(prof), None
        if first is None:
            first = res
        else:
            repeats.append((signature(res), report_states(res)))
        del res
        t_end = time.perf_counter()
        if t_end - t_first >= seconds and totals.schedules >= min_schedules:
            break
    window_s = t_end - t_first
    peak = int(torch.cuda.max_memory_allocated()) if device != "cpu" else 0
    kept = (signature(first), report_states(first))
    found = {
        "ministeps": ministeps(first, case, client.path, client.scales),
        "end": (_host(first.states[-1]["Pressure"]),
                _host(first.states[-1]["Saturations"][:, 0])),
        "injected": injected_mass(case, cell.config, first, client.scales),
        "held": client.held_start(),
        "differing": sum(not same_schedule(kept, r) for r in repeats),
        "unanswered": totals.unanswered,
    }
    del first, repeats, kept, client
    if device != "cpu":
        torch.cuda.empty_cache()

    e2e = {"sim_days_per_s": totals.sim_days / window_s,
           "cell_newtons_per_s": case.n_cells * totals.newtons / window_s,
           "setup_s": setup_s}
    metrics = {}
    if trace:
        t_totals, t_window_s, launches, k1_shapes = traced
        ctx = Context(cell, case, t_totals, t_window_s, case_build_s, peak,
                      launches, k1_shapes, dev_trace)
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"], cell.bench_dir)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    reference = spec.reference(cell.config["reference"], cell.bench_dir)
    limits = spec.limits(cell.name, cell.bench_dir)
    checks = judge(reference, case, found, limits)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {
        "correct": bool(correct),
        "attempted": totals.schedules,
        "failed": totals.unanswered,
        "metrics": metrics,
        "device": device_record(device, cell.chips, peak),
        "counts": {"schedules": totals.schedules,
                   "ministeps": totals.ministeps,
                   "newtons": totals.newtons,
                   "linear_iterations": totals.linear_iterations,
                   "failed_ministeps": totals.failed_ministeps,
                   "sim_days": totals.sim_days, "window_s": window_s,
                   "checked_ministeps": len(found["ministeps"]),
                   "build_s": build_s},
    }
    if trace:
        out["device"]["busy_s"] = dev_trace.busy_s() if device != "cpu" \
            else 0.0
        out["device"]["window_s"] = t_window_s
        out["breakdown"] = {"device_ops": dev_trace.top_ops(),
                            "idle_gaps": dev_trace.idle_gaps()}
    for bits in controls:
        out.setdefault("controls", {})[bits] = judge(
            reference, case, found, limits, bits)
    out["checks"] = checks
    return out


def device_record(device: str, chips: int, peak: int) -> dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}


def emit(out: dict) -> int:
    """Print the numbers compared on standard error and the result line
    on standard output, unless a module of JAX or the JAX package is
    loaded: then name them and return 3 without a result."""
    bad = forbidden_modules()
    if bad:
        print("modules of JAX or the JAX package are loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
