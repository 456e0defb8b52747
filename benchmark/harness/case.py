"""A benchmark case as plain data, and the port's objects made from it.

A configuration's builder (``benchmark/builders/<builder>.py``) turns the
configuration's file and a seed into a ``Case``: numpy arrays and numbers
only. The plain reference (``benchmark/reference/``) reads the same
``Case``; ``program_case`` hands it to the port through its public API.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Well:
    """One well: the lattice cells it completes in (global indices, in the
    order ``(iz * ny + iy) * nx + ix``), a Peaceman index per completion
    [m^3] and the wellbore's storage volume [m^3]."""

    name: str
    cells: np.ndarray
    wi: np.ndarray
    volume: float


@dataclass
class Case:
    """Two-phase immiscible Darcy flow on a Cartesian lattice with wells as
    wellbore cells. Cells are the lattice's ``nx * ny * nz`` followed by
    one cell per well, in ``wells`` order.

    ``extent``: the domain's size per axis [m] (cell width = extent / n);
    ``fluid``: reference densities [kg/m^3], compressibilities [1/Pa],
    viscosities [Pa s], reference pressure [Pa], Corey exponents and
    residual saturations, each per phase (water, oil); ``gravity`` [m/s^2]
    acts down the z axis, or not at all where 0; ``p0`` / ``sw0``: initial
    pressure [Pa] and water saturation of every cell, wells included;
    ``rate``: (well name, surface mass rate per phase [kg/s]) of each
    rate-controlled well; ``bhp``: (well name, pressure [Pa], control
    transmissibility [m^3], inflow saturations) of each pressure-controlled
    well."""

    dims: tuple
    extent: tuple
    perm: np.ndarray
    poro: np.ndarray
    fluid: dict
    gravity: float
    wells: list
    p0: np.ndarray
    sw0: np.ndarray
    rate: list = field(default_factory=list)
    bhp: list = field(default_factory=list)

    @property
    def n_lattice(self) -> int:
        return int(np.prod(self.dims))

    @property
    def n_cells(self) -> int:
        return self.n_lattice + len(self.wells)

    def well_cell(self, name: str) -> int:
        return self.n_lattice + [w.name for w in self.wells].index(name)


def cell_centroids(dims, extent):
    """(x, y, z) of every lattice cell, x fastest, as the port's
    CartesianMesh places them: node planes at the running sum of the
    widths, centres halfway between."""
    centers = []
    for n, e in zip(dims, extent):
        nodes = np.concatenate([[0.0], np.cumsum(np.full(n, e / n))])
        centers.append(0.5 * (nodes[:-1] + nodes[1:]))
    zz, yy, xx = np.meshgrid(centers[2], centers[1], centers[0],
                             indexing="ij")
    return xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)


def rate_scales(n_step: int, ramp) -> list:
    """The rate factor of each report step: linear from ``ramp[0]`` to
    ``ramp[1]`` over the steps (the bench's 0.75 -> 1.25 ramp)."""
    lo, hi = ramp
    return [lo + (hi - lo) * i / max(n_step - 1, 1) for i in range(n_step)]


def program_case(case: Case, scales: list):
    """The port's (model, state0, parameters, per-step forces) for ``case``,
    the rates of report step i scaled by ``scales[i]``."""
    import jutul.jl_tpu_torch as pkg
    from jutul.jl_tpu_torch.models.darcy import ImmiscibleFluid
    from jutul.jl_tpu_torch.models.wells import (WellSpec,
                                                 setup_well_graph_model)

    f = case.fluid
    fluid = ImmiscibleFluid(
        reference_densities=tuple(f["densities"]),
        compressibilities=tuple(f["compressibilities"]),
        viscosities=tuple(f["viscosities"]),
        reference_pressure=f["reference_pressure"],
        corey_exponents=tuple(f["corey_exponents"]),
        residual_saturations=tuple(f["residual_saturations"]))
    mesh = pkg.CartesianMesh(tuple(case.dims), tuple(case.extent))
    specs = [WellSpec(w.name, [int(c) for c in w.cells], WI=w.wi,
                      volume=w.volume) for w in case.wells]
    gravity = True if case.gravity == 9.80665 else \
        (False if case.gravity == 0 else [0.0, 0.0, -case.gravity])
    model, wmesh, params = setup_well_graph_model(
        mesh, fluid, specs, permeability=case.perm, porosity=case.poro,
        gravity=gravity)
    sw = case.sw0
    state0 = pkg.setup_state(model, Pressure=case.p0,
                             Saturations=np.stack([sw, 1 - sw], axis=1))
    forces = []
    for s in scales:
        step = {}
        if case.rate:
            step["rate"] = pkg.PhaseSourceTerm(
                [wmesh.well_cells[n] for n, _ in case.rate],
                np.array([np.asarray(q, dtype=np.float64) * s
                          for _, q in case.rate]))
        if case.bhp:
            step["bhp"] = pkg.PressureBoundaryCondition(
                [wmesh.well_cells[n] for n, *_ in case.bhp],
                np.array([p for _, p, _, _ in case.bhp]),
                np.array([t for _, _, t, _ in case.bhp]),
                saturations=np.array([s_in for *_, s_in in case.bhp]))
        forces.append(step)
    return model, state0, params, forces
