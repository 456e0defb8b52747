"""The check fails where the timed path is broken underneath it, and where
the control (the program's answers in a lower precision) stands in.

The harness runs a tiny cell on the CPU with the program broken at the
point where it produces an answer; the look for a card is skipped. The
faults a single-client simulation cell can have: a step that returns its
state unchanged, an answer altered where it is produced, a report step
without an answer, a schedule that starts from another state than the
case's (the first, or the window's later ones), and ministeps accepted
before they converged. (No cell has a batch of clients or an exchange
between cards.)"""

import numpy as np
import pytest

from conftest import run_tiny

import jutul.jl_tpu_torch as pkg
import jutul.jl_tpu_torch.simulator.simulator as S
from harness import cell as harness_cell

CELLS = ["flagship-product", "spe10-eager"]


def _patch(monkeypatch, fix):
    """Apply ``fix`` to every SimResult the program returns."""
    sim_eager, lower = S.Simulator.simulate, S.Simulator.lower_schedule

    def simulate(self, *a, **k):
        return fix(sim_eager(self, *a, **k))

    def lower_schedule(self, *a, **k):
        run, args, post = lower(self, *a, **k)
        return run, args, lambda *o: fix(post(*o))

    monkeypatch.setattr(S.Simulator, "simulate", simulate)
    monkeypatch.setattr(S.Simulator, "lower_schedule", lower_schedule)


def _set_last(res, p, sw):
    """The schedule's last state (p, sw), on every output that holds it."""
    dev = res.final_state_device
    s = dev["Saturations"].new_tensor(np.stack([sw, 1 - sw], 1))
    res.final_state_device = dict(dev, Pressure=p.to(dev["Pressure"]),
                                  Saturations=s)
    res.states[-1] = dict(res.states[-1], Pressure=p.cpu().numpy(),
                          Saturations=s.cpu().numpy())
    return res


def _unchanged(res):
    """The last ministep returns the state it started from."""
    start = res.final_ministep_start_state
    sw = start["Saturations"][:, 0].cpu().numpy()
    return _set_last(res, start["Pressure"].clone(), sw)


def _altered(res):
    """One cell's end pressure off by 1 %."""
    end = res.final_state_device
    p = end["Pressure"].clone()
    p[p.shape[0] // 3] *= 1.01
    return _set_last(res, p, end["Saturations"][:, 0].cpu().numpy())


def _unanswered(res):
    res.reports[-1]["success"] = False
    return res


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = run_tiny(workload, min_schedules=2)
    assert out["correct"], out["checks"]
    assert out["checks"]["repeats_differing"]["value"] == 0


@pytest.mark.parametrize("fault", [_unchanged, _altered, _unanswered])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_makes_the_run_incorrect(monkeypatch, workload, fault):
    _patch(monkeypatch, fault)
    out = run_tiny(workload)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_start_from_a_perturbed_state_is_incorrect(monkeypatch, workload):
    """The program sets up its initial state with one cell's water
    saturation 0.05 off the case's: every schedule starts there."""
    setup_state = pkg.setup_state

    def perturbed(model, **kw):
        s = np.array(kw["Saturations"], dtype=np.float64)
        s[s.shape[0] // 2] += (0.05, -0.05)
        return setup_state(model, **dict(kw, Saturations=s))

    monkeypatch.setattr(pkg, "setup_state", perturbed)
    out = run_tiny(workload)
    assert out["correct"] is False
    bad = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert "start_gap" in bad
    if workload == "spe10-eager":  # the chain starts from the case's state
        assert "cnv" in bad


@pytest.mark.parametrize("workload", CELLS)
def test_later_schedules_from_another_state_are_incorrect(monkeypatch,
                                                          workload):
    """The program writes its end state into the initial state it holds,
    so the window's second schedule starts where the first ended."""
    lower = S.Simulator.lower_schedule
    simulate = S.Simulator.simulate

    def write_back(state0, end):
        for k in state0:
            state0[k].copy_(end[k])

    def lower_schedule(self, *a, **k):
        run, args, post = lower(self, *a, **k)

        def run_and_write(*r):
            out = run(*r)
            write_back(r[0], out[0])
            return out
        return run_and_write, args, post

    def simulate_and_write(self, *a, **k):
        res = simulate(self, *a, **k)
        write_back(self.state0, res.final_state_device)
        return res

    monkeypatch.setattr(S.Simulator, "lower_schedule", lower_schedule)
    monkeypatch.setattr(S.Simulator, "simulate", simulate_and_write)
    # and the harness no longer hands each eager schedule a fresh start
    restart = harness_cell.Client.restart
    done = []

    def restart_once(self):
        if not done:
            restart(self)
            done.append(1)

    monkeypatch.setattr(harness_cell.Client, "restart", restart_once)
    out = run_tiny(workload, min_schedules=2)
    assert out["correct"] is False
    assert out["checks"]["repeats_differing"]["value"] >= 1


@pytest.mark.parametrize("workload", CELLS)
def test_ministeps_accepted_unconverged_are_incorrect(monkeypatch, workload):
    """The program accepts a ministep at 20x the configured tolerances and
    one Newton iteration."""
    config = harness_cell.solver_config

    def loose(mix, trace):
        cfg = config(mix, trace)
        cfg["tolerances"] = {k: 20 * v for k, v in cfg["tolerances"].items()}
        cfg["max_nonlinear_iterations"] = 1
        cfg["tol_factor_final_iteration"] = 1e6
        return cfg

    monkeypatch.setattr(harness_cell, "solver_config", loose)
    out = run_tiny(workload)
    assert out["correct"] is False
    assert any(out["checks"][k]["value"] > out["checks"][k]["limit"]
               for k in ("cnv", "mb", "balance") if k in out["checks"])


@pytest.mark.parametrize("bits", [10, 7])  # TF32, bfloat16
@pytest.mark.parametrize("workload", CELLS)
def test_control_in_lower_precision_is_incorrect(workload, bits):
    out = run_tiny(workload, controls=(bits,))
    assert out["correct"]
    assert any(c["value"] > c["limit"]
               for c in out["controls"][bits].values())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["flagship-product", "spe10-eager"])
def test_control_fails_at_the_cells_size_on_the_card(cuda_card, workload):
    """On the card, at the cell's own size: on three seeds the program's
    answers pass, its repeats agree bit for bit, and the TF32 control
    fails."""
    import time
    from pathlib import Path

    from harness.cell import run_cell

    root = Path(__file__).resolve().parents[2]
    for seed in (101, 202, 303):
        out = run_cell(root, workload, seed, 0.0, False, time.perf_counter(),
                       controls=(10,), min_schedules=2)
        assert out["correct"], out["checks"]
        assert any(c["value"] > c["limit"]
                   for c in out["controls"][10].values())
