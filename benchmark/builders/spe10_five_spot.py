"""The SPE Tenth Comparative Solution Project's model 2 as a ``Case``.

Christie & Blunt, SPE 72469 (2001): a lattice of ``dims`` cells of
``cell_size_ft``, a five-spot of one water injector at the centre (rate
control) and four producers at the corners (bottom-hole pressure
control), all completed through every layer. The published permeability
and porosity fields are not in the repository: the permeability is drawn
from the seed with the flagship's generator, the porosity is uniform (the
configuration's ``assumed`` lists both). Every number comes from the
configuration's file.
"""

from __future__ import annotations

import numpy as np

from harness.case import Case, Well, cell_centroids

FT = 0.3048
PSI = 6894.757293168
BBL = 0.158987294928
DAY = 86400.0
CP = 1e-3
LB_PER_FT3 = 0.45359237 / FT ** 3
DARCY = 9.869232667160130e-13


def peaceman_wi(k, dx, dy, h, rw):
    """Peaceman's index of a vertical completion in an isotropic cell:
    2 pi k h / ln(r0 / rw), r0 = 0.14 sqrt(dx^2 + dy^2), no skin."""
    r0 = 0.14 * np.sqrt(dx * dx + dy * dy)
    return 2.0 * np.pi * k * h / np.log(r0 / rw)


def build(cfg: dict, seed: int) -> Case:
    nx, ny, nz = cfg["dims"]
    nc = nx * ny * nz
    dx, dy, dz = (v * FT for v in cfg["cell_size_ft"])
    extent = (nx * dx, ny * dy, nz * dz)
    rng = np.random.default_rng(seed)
    perm = rng.lognormal(0.0, cfg["ln_perm_sigma"], nc) \
        * cfg["perm_median_darcy"] * DARCY
    rho_w, rho_o = (v * LB_PER_FT3 for v in cfg["densities_lb_per_ft3"])
    fluid = dict(densities=(rho_w, rho_o),
                 compressibilities=tuple(cfg["compressibilities_per_pa"]),
                 viscosities=tuple(v * CP for v in cfg["viscosities_cp"]),
                 reference_pressure=cfg["reference_pressure_pa"],
                 corey_exponents=tuple(cfg["corey_exponents"]),
                 residual_saturations=tuple(cfg["residual_saturations"]))
    g = 9.80665
    _, _, z = cell_centroids((nx, ny, nz), extent)
    # the top at the published pressure, oil-hydrostatic below it (water
    # sits at connate saturation, immobile)
    p_top = cfg["initial_pressure_top_psi"] * PSI
    rho_top = rho_o * np.exp(fluid["compressibilities"][1]
                             * (p_top - fluid["reference_pressure"]))
    p0 = p_top + rho_top * g * (extent[2] - z)
    swc = fluid["residual_saturations"][0]
    sw = np.full(nc, swc)

    def column(i, j):  # the completions of (i, j), top layer first
        return np.array([(k * ny + j) * nx + i for k in range(nz - 1, -1, -1)])

    rw = 0.5 * cfg["wellbore_diameter_ft"] * FT

    def well(name, i, j):
        cells = column(i, j)
        return Well(name, cells, peaceman_wi(perm[cells], dx, dy, dz, rw),
                    cfg["wellbore_volume_m3"])

    wells = [well("inj", nx // 2, ny // 2)]
    corners = [(0, 0), (nx - 1, 0), (0, ny - 1), (nx - 1, ny - 1)]
    wells += [well(f"prod{i}", a, b) for i, (a, b) in enumerate(corners)]
    pw = np.array([p0[w.cells[0]] for w in wells])
    sww = np.array([1.0] + [swc] * 4)
    q = cfg["injection_rate_bbl_per_day"] * BBL / DAY * rho_w  # kg/s
    bhp = cfg["producer_bhp_psi"] * PSI
    t_ctl = cfg["control_trans_factor"]
    s_in = tuple(cfg["producer_inflow_saturations"])
    return Case(
        dims=(nx, ny, nz), extent=extent, perm=perm,
        poro=np.full(nc, cfg["porosity"]), fluid=fluid, gravity=g,
        wells=wells, p0=np.concatenate([p0, pw]),
        sw0=np.concatenate([sw, sww]), rate=[("inj", (q, 0.0))],
        bhp=[(w.name, bhp, t_ctl * float(w.wi.sum()), s_in)
             for w in wells[1:]])
