"""The repository's well-model flagship as a ``Case``.

A frozen copy of chip_smoke.py's ``_well_case`` / ``build_well_flagship``
(bench.py ``build(nx, ny, nz, gravity=True, wells=True,
well_models=True)``), with the seed threaded through
``np.random.default_rng(seed)`` in the same order of draws: seed 0 gives
chip_smoke's flagship exactly. The configuration's file gives ``dims``.
"""

from __future__ import annotations

import numpy as np

from harness.case import Case, Well, cell_centroids

BAR = 1e5
DARCY = 9.869232667160130e-13


def build(cfg: dict, seed: int) -> Case:
    nx, ny, nz = cfg["dims"]
    nc = nx * ny * nz
    rng = np.random.default_rng(seed)
    extent = (100.0 * nx / 128, 100.0 * ny / 128, 10.0 * nz / 64)
    perm = rng.lognormal(0.0, 1.0, nc) * 0.1 * DARCY
    sw = rng.uniform(0.2, 0.8, nc)
    x, y, z = cell_centroids((nx, ny, nz), extent)
    Lx = 100.0 * nx / 128
    # near-equilibrium initial pressure: hydrostatic down z plus a smooth
    # lateral field
    p0 = (200.0 * BAR - 1000.0 * 9.80665 * z
          + 2.0 * BAR * np.sin(2 * np.pi * x / Lx) * np.cos(np.pi * y / Lx))

    def cell(i, j, k):
        return (k * ny + j) * nx + i

    cell_vol = (100.0 / 128) ** 2 * (10.0 / 64)
    pore_mass = cell_vol * 0.25 * 1000.0  # kg of water per cell
    ncomp = min(8, nz)
    WI = 2.5e-13  # Peaceman-style, ~ an interior face transmissibility
    inj_cols = [(1, 1), (nx - 2, 1), (1, ny - 2), (nx - 2, ny - 2)]
    wells = [Well(f"inj{i}",
                  np.array([cell(a, b, nz - 1 - k) for k in range(ncomp)]),
                  np.full(ncomp, WI), 1.0)
             for i, (a, b) in enumerate(inj_cols)]
    wells.append(Well("prod", np.array([cell(nx // 2, ny // 2, k)
                                        for k in range(ncomp)]),
                      np.full(ncomp, WI), 1.0))
    # wellbores start at their top completion's pressure; injectors
    # water-filled, the producer at its completion's saturation
    pw = np.array([p0[w.cells[0]] for w in wells])
    sww = np.array([1.0] * 4 + [float(sw[wells[-1].cells[0]])])
    q = 0.2 * pore_mass / 21600.0  # kg/s of water per injector
    bhp = float(p0[wells[-1].cells[0]]) - 2.0 * BAR
    fluid = dict(densities=(1000.0, 800.0), compressibilities=(1e-10, 1e-9),
                 viscosities=(1e-3, 2e-3), reference_pressure=1.0e5,
                 corey_exponents=(2.0, 2.0), residual_saturations=(0.0, 0.0))
    return Case(
        dims=(nx, ny, nz), extent=extent, perm=perm,
        poro=np.full(nc, 0.25), fluid=fluid, gravity=9.80665, wells=wells,
        p0=np.concatenate([p0, pw]), sw0=np.concatenate([sw, sww]),
        rate=[(f"inj{i}", (q, 0.0)) for i in range(4)],
        # BHP control: a fixed-pressure surface connection whose control
        # transmissibility (10x the completions' WI) dominates the row
        bhp=[("prod", bhp, 10.0 * WI * ncomp, (0.5, 0.5))])
