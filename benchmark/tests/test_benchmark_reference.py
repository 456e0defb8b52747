"""The plain reference reads near zero at the port's converged float64
states, and clearly not at a state the port did not converge to; it
imports nothing of the port."""

import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH_DIR, tiny_cell
from harness import spec
from harness.case import program_case, rate_scales
from harness.cell import injected_mass, ministeps, solver_config


def _converged(workload, seed=5):
    """The tiny cell's first report step on the CPU in float64, solved to
    1e-10 in CNV and 1e-12 in MB."""
    from jutul.jl_tpu_torch import Simulator

    cell = tiny_cell(workload)
    case = spec.builder(cell.config["builder"]).build(cell.config, seed)
    scales = rate_scales(3, cell.mix["rate_ramp"])
    model, state0, params, forces = program_case(case, scales)
    sim = Simulator(model, state0, params, use_stencil=True, device="cpu")
    mix = dict(cell.mix, path="eager")
    mix["solver"] = dict(mix["solver"], cnv=1e-10, mb=1e-12,
                         krylov={"rtol": 1e-12, "max_iterations": 200},
                         max_nonlinear_iterations=20)
    res = sim.simulate([cell.mix["report_step_s"] / 4], forces=forces[:1],
                       **solver_config(mix, False))
    assert all(r["success"] for r in res.reports)
    return case, res, scales



@pytest.mark.parametrize("workload", ["flagship-product", "spe10-eager"])
def test_reference_reads_near_zero_at_converged_states(workload):
    ref = spec.reference("twophase_wells")
    case, res, scales = _converged(workload)
    chain = ministeps(res, case, "eager", scales)
    # every ministep, the first from the case's own initial state
    assert chain[0][2] is case.p0 and len(chain) >= 2
    for p, sw, p0, sw0, dt, scale in chain:
        r = ref.residual(case, p, sw, p0, sw0, dt, scale)
        cnv, mb = ref.convergence(case, r, p, dt)
        assert cnv < 1e-5 and mb < 1e-7, (cnv, mb)
    p, sw, p0, sw0, dt, scale = chain[-1]
    # the program's own float64 state, not rounded to float32
    r = ref.residual(case, p, sw, p0, sw0, dt, scale)
    cnv, mb = ref.convergence(case, r, p, dt)
    assert cnv < 1e-5 and mb < 1e-7, (cnv, mb)
    # the step left out: the end state is the start state
    r = ref.residual(case, p0, sw0, p0, sw0, dt, scale)
    assert ref.convergence(case, r, p0, dt)[0] > max(1e-3, 100 * cnv)
    # one cell's pressure off by 1 bar
    q = p.copy()
    q[case.n_lattice // 2] += 1e5
    r = ref.residual(case, q, sw, p0, sw0, dt, scale)
    assert ref.convergence(case, r, q, dt)[0] > 1e-2
    # the rates of another report step
    r = ref.residual(case, p, sw, p0, sw0, dt, 1.5 * scale)
    assert ref.convergence(case, r, p, dt)[0] > max(1e-4, 100 * cnv)


def test_reference_imports_nothing_of_the_port():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from harness import spec\n"
        "ref = spec.reference('twophase_wells')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jutul', 'jax', 'jaxlib', 'flax', 'torch')]\n"
        "print(bad)\n" % str(BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"
    src = (BENCH_DIR / "reference" / "twophase_wells.py").read_text()
    imports = [line for line in src.splitlines()
               if line.startswith(("import ", "from "))]
    assert imports == ["from __future__ import annotations",
                       "import numpy as np"]


def test_reference_matches_the_port_residual_in_float64():
    """At an arbitrary state, the reference's residual is the port's own
    float64 residual, row for row."""
    import torch

    from jutul.jl_tpu_torch import Simulator

    cell = tiny_cell("spe10-eager")
    case = spec.builder(cell.config["builder"]).build(cell.config, 9)
    model, state0, params, forces = program_case(case, [1.0])
    sim = Simulator(model, state0, params, use_stencil=False, device="cpu")
    rng = np.random.default_rng(1)
    p = case.p0 * (1 + 1e-3 * rng.standard_normal(case.n_cells))
    sw = np.clip(case.sw0 + 0.3 * rng.random(case.n_cells), 0, 1)
    st = {"Pressure": torch.as_tensor(p),
          "Saturations": torch.as_tensor(np.stack([sw, 1 - sw], 1))}
    r_port = sim.compiled.residual(sim._merge(st, sim.parameters),
                                   sim._merge(sim.state0, sim.parameters),
                                   3600.0, forces[0])
    r_ref = spec.reference("twophase_wells").residual(
        case, p, sw, case.p0, case.sw0, 3600.0, 1.0)
    np.testing.assert_allclose(np.asarray(r_port), r_ref, rtol=0,
                               atol=1e-10 * np.abs(r_ref).max())


def test_balance_holds_a_state_to_the_injected_mass():
    """A state with exactly the injected water added to the injector's
    wellbore reads zero; one with the saturation off by 1e-3, or held to
    the injected mass of other rates, does not. The configuration without
    a balance phase gets none."""
    ref = spec.reference("twophase_wells")
    cell = tiny_cell("spe10-eager")
    case = spec.builder(cell.config["builder"]).build(cell.config, 4)
    scales = rate_scales(3, cell.mix["rate_ramp"])

    class Res:  # three accepted report steps of the cell's length
        reports = [{"dt": cell.mix["report_step_s"], "success": True}] * 3

    phase, mass = injected_mass(case, cell.config, Res, scales)
    assert phase == "water"
    assert mass == pytest.approx(case.rate[0][1][0] * 3 * 86400.0)
    wc = case.well_cell("inj")
    p, sw = case.p0.copy(), case.sw0.copy()
    rho_w = case.fluid["densities"][0] * np.exp(
        case.fluid["compressibilities"][0]
        * (p[wc] - case.fluid["reference_pressure"]))
    vol = ref.pore_volume(case)[wc]
    # the wellbore is full of water: its pressure takes the injected mass
    p[wc] += np.log1p(mass / (rho_w * vol)) \
        / case.fluid["compressibilities"][0]
    assert ref.balance(case, p, sw, (phase, mass)) < 1e-9
    assert ref.balance(case, p, sw + 1e-3, (phase, mass)) > 1e-2
    assert ref.balance(case, p, sw, (phase, 1.1 * mass)) > 1e-2
    assert injected_mass(case, tiny_cell("flagship-product").config, Res,
                         scales) is None
