"""Plain float64 reference of two-phase immiscible Darcy flow with wells.

Straight NumPy, from a ``Case`` alone (the inputs the benchmark made), and
nothing of the program: it computes the geometry, the transmissibilities,
the fluid properties and the residual of one implicit-Euler ministep
itself, and from it the two convergence measures the configuration's
tolerances are stated in.

Per cell and phase a (water, oil), over a ministep of length dt:

    r_a = pv (rho_a s_a - rho_a0 s_a0) / dt + sum_faces F_a - q_a

    F_a = rho_up lambda_up T (p_L - p_R - 0.5 (rho_L + rho_R) g dz)

on every lattice face (left to right, g dz = -g (z_R - z_L)) and on every
completion, a face from the lattice cell to its wellbore cell with T the
Peaceman index and no gravity term. The upwind side is the left one where
the potential difference is >= 0. rho_a = rho_ref exp(c (p - p_ref)),
lambda_a = s_eff^n / mu with s_eff = clip((s - s_r) / (1 - sum s_r), 0,
1), T the harmonic mean of the half transmissibilities 2 k A / d. A
rate-controlled well receives its surface rate; a pressure-controlled
well loses rho lambda_up T_ctl (p - p_bhp), upwinded from its inflow
saturations where p < p_bhp.

CNV = max over cells and phases of |r| dt / (pv rho); MB = max over
phases of |sum_cells r| dt / sum_cells pv rho.
"""

from __future__ import annotations

import numpy as np


def _props(f, p, sw):
    rho = np.asarray(f["densities"]) * np.exp(
        np.asarray(f["compressibilities"]) * (p[:, None]
                                              - f["reference_pressure"]))
    s = np.stack([sw, 1.0 - sw], axis=1)
    return rho, s, _mobility(f, s)


def _mobility(f, s):
    sr = np.asarray(f["residual_saturations"])
    s_eff = np.clip((s - sr) / (1.0 - sr.sum()), 0.0, 1.0)
    return s_eff ** np.asarray(f["corey_exponents"]) \
        / np.asarray(f["viscosities"])


def pore_volume(case):
    nx, ny, nz = case.dims
    vol = np.prod([e / n for e, n in zip(case.extent, case.dims)])
    return np.concatenate([case.poro * vol,
                           [w.volume for w in case.wells]])


def residual(case, p, sw, p0, sw0, dt, rate_scale):
    """(n_cells, 2) residual of the ministep from (p0, sw0) to (p, sw) of
    length ``dt``, with the rate controls scaled by ``rate_scale``."""
    f = case.fluid
    p, sw, p0, sw0 = (np.asarray(v, dtype=np.float64)
                      for v in (p, sw, p0, sw0))
    rho, s, mob = _props(f, p, sw)
    rho0, s0, _ = _props(f, p0, sw0)
    pv = pore_volume(case)
    r = pv[:, None] * (rho * s - rho0 * s0) / dt
    nx, ny, nz = case.dims
    nl = case.n_lattice
    d = [e / n for e, n in zip(case.extent, case.dims)]
    grid = (nz, ny, nx)
    k = case.perm.reshape(grid)
    P = p[:nl].reshape(grid)
    R = rho[:nl].reshape(grid + (2,))
    M = (rho * mob)[:nl].reshape(grid + (2,))
    rl = r[:nl].reshape(grid + (2,))
    # lattice axis 2 is x, 1 is y, 0 is z
    for ax, (w, a1, a2) in zip((2, 1, 0), ((d[0], d[1], d[2]),
                                          (d[1], d[0], d[2]),
                                          (d[2], d[0], d[1]))):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax], hi[ax] = slice(None, -1), slice(1, None)
        lo, hi = tuple(lo), tuple(hi)
        area = a1 * a2
        t_half_l = 2.0 * k[lo] * area / w
        t_half_r = 2.0 * k[hi] * area / w
        T = 1.0 / (1.0 / t_half_l + 1.0 / t_half_r)
        gdz = -case.gravity * w if ax == 0 else 0.0
        dpot = (P[lo] - P[hi])[..., None] \
            - 0.5 * (R[lo] + R[hi]) * gdz
        F = np.where(dpot >= 0.0, M[lo], M[hi]) * T[..., None] * dpot
        rl[lo] += F
        rl[hi] -= F
    r[:nl] = rl.reshape(nl, 2)
    for i, well in enumerate(case.wells):
        c, wc = np.asarray(well.cells), nl + i
        dpot = (p[c] - p[wc])[:, None]
        F = np.where(dpot >= 0.0, (rho * mob)[c], (rho * mob)[wc]) \
            * np.asarray(well.wi)[:, None] * dpot
        np.add.at(r, c, F)
        r[wc] -= F.sum(axis=0)
    for name, q in case.rate:
        r[case.well_cell(name)] -= np.asarray(q, dtype=np.float64) \
            * rate_scale
    for name, pb, t_ctl, s_in in case.bhp:
        wc = case.well_cell(name)
        dp = p[wc] - pb
        mob_in = _mobility(f, np.asarray(s_in, dtype=np.float64)[None])[0]
        r[wc] += rho[wc] * (mob[wc] if dp >= 0 else mob_in) * t_ctl * dp
    return r


def convergence(case, r, p, dt):
    """(CNV, MB) of residual ``r`` at pressure ``p``."""
    f = case.fluid
    rho = np.asarray(f["densities"]) * np.exp(
        np.asarray(f["compressibilities"])
        * (np.asarray(p, dtype=np.float64)[:, None]
           - f["reference_pressure"]))
    pvr = pore_volume(case)[:, None] * rho
    cnv = float(np.max(np.abs(r) * dt / pvr))
    mb = float(np.max(np.abs(r.sum(axis=0)) * dt / pvr.sum(axis=0)))
    return cnv, mb


def balance(case, p, sw, injected):
    """The schedule's balance of a phase that no well produces:
    ``injected`` is (phase name, mass the wells put in [kg]); the phase's
    mass in place at (p, sw) less its mass at the case's initial state and
    the injected mass, over the injected mass."""
    phase, mass = injected
    k = ["water", "oil"].index(phase)
    pv = pore_volume(case)

    def in_place(p, sw):
        rho, s, _ = _props(case.fluid, np.asarray(p, dtype=np.float64),
                           np.asarray(sw, dtype=np.float64))
        return float(np.sum(pv * rho[:, k] * s[:, k]))

    return abs(in_place(p, sw) - in_place(case.p0, case.sw0) - mass) / mass
