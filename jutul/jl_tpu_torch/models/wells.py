"""Well models: the augmented-graph wellbore formulation.

Port of the JAX package's ``models/wells.py`` (host-side numpy: mesh and
parameter construction). Counterpart of the reference's well treatment:
Jutul core provides the cross-term machinery wells ride on (reference:
src/multimodel/crossterm.jl:3-660; downstream JutulDarcy composes SimpleWell
models + Peaceman perforation cross-terms from it).

A wellbore is a single storage cell with pressure/saturations and a
mass-conservation equation; each perforation is a Peaceman connection
``q_a = WI * mob_up * rho_up * (p_res − p_well)`` with upwinded mobilities.
``WellGraphMesh`` appends the well cells to the reservoir graph and the
perforations as extra faces with transmissibility WI and zero gravity
difference, so the standard TPFA upwind flux IS the Peaceman inflow. On a
Cartesian base mesh the stencil fast path assembles it in bordered form
(ops/stencil_wells.py).

Controls map to existing forces: rate control is a ``PhaseSourceTerm`` on
the well cell (the surface stream); BHP control is a
``PressureBoundaryCondition`` on the well cell (surface connection with a
control transmissibility). The MultiModel formulation
(``setup_well_multimodel``) waits for the MultiModel port.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..meshes.cartesian import JutulMesh
from ..meshes.geometry import TwoPointFiniteVolumeGeometry


@dataclass
class WellSpec:
    """One well: completions + Peaceman indices + wellbore storage.

    ``cells``: global reservoir cells the well completes in.
    ``WI``: Peaceman well index per completion [m^3] (multiplies
    mobility*density*dp to give a mass rate, exactly like a face
    transmissibility).
    ``volume``: wellbore storage volume [m^3].
    """

    name: str
    cells: list
    WI: "float | list" = 1e-12
    volume: float = 1.0

    def wi_array(self) -> np.ndarray:
        c = np.atleast_1d(np.asarray(self.cells))
        wi = np.asarray(self.WI, dtype=np.float64)
        if wi.ndim == 0:
            wi = np.full(c.shape[0], float(wi))
        return wi


class WellGraphMesh(JutulMesh):
    """Reservoir mesh + one extra cell per well + perforation faces.

    Perforation faces are appended AFTER all reservoir faces, oriented
    (reservoir_cell -> well_cell); their transmissibilities must be
    patched to WI with ``patch_well_parameters``.
    """

    def __init__(self, base_mesh, wells: "list[WellSpec]"):
        self.base = base_mesh
        self.wells = list(wells)
        self._nc_base = base_mesh.number_of_cells()
        self._nf_base = base_mesh.number_of_faces()
        self.well_cells = {
            w.name: self._nc_base + i for i, w in enumerate(wells)}
        perf = []
        for i, w in enumerate(wells):
            for c in np.atleast_1d(np.asarray(w.cells)):
                perf.append((int(c), self._nc_base + i))
        self._perf = np.asarray(perf, dtype=np.int64).reshape(-1, 2)
        self._geo = None

    @property
    def dim(self):
        return self.base.dim

    def number_of_cells(self) -> int:
        return self._nc_base + len(self.wells)

    def number_of_faces(self) -> int:
        return self._nf_base + self._perf.shape[0]

    @property
    def well_face_slice(self) -> slice:
        return slice(self._nf_base, self.number_of_faces())

    def neighborship(self) -> np.ndarray:
        return np.vstack([np.asarray(self.base.neighborship()),
                          self._perf])

    def tpfv_geometry(self):
        if self._geo is not None:
            return self._geo
        g = self.base.tpfv_geometry()
        dim = g.cell_centroids.shape[1]
        # well cell centroid: completion centroid average — with the
        # perforation gdz patched to ZERO below this only affects
        # plotting, never physics
        wc = np.array([np.mean(g.cell_centroids[
            np.atleast_1d(np.asarray(w.cells))], axis=0)
            for w in self.wells]).reshape(-1, dim)
        vols = np.concatenate([g.volumes,
                               [w.volume for w in self.wells]])
        npf = self._perf.shape[0]
        areas = np.concatenate([g.areas, np.ones(npf)])
        normals = np.vstack([g.normals,
                             np.tile(np.eye(dim)[-1], (npf, 1))])
        fc = np.vstack([g.face_centroids,
                        g.cell_centroids[self._perf[:, 0]]])
        self._geo = TwoPointFiniteVolumeGeometry(
            neighbors=self.neighborship(), areas=areas, volumes=vols,
            normals=normals,
            cell_centroids=np.vstack([g.cell_centroids, wc]),
            face_centroids=fc,
            boundary_areas=g.boundary_areas,
            boundary_normals=g.boundary_normals,
            boundary_centroids=g.boundary_centroids,
            boundary_neighbors=g.boundary_neighbors)
        return self._geo

    # -- parameter patching -------------------------------------------
    def patch_well_parameters(self, params: dict) -> dict:
        """Set perforation transmissibilities to WI and zero the
        perforation gravity potential difference (the Peaceman inflow
        has no wellbore hydrostatic term in this minimal model)."""
        params = dict(params)
        sl = self.well_face_slice
        wi = np.concatenate([w.wi_array() for w in self.wells]) \
            if self.wells else np.zeros(0)
        T = np.asarray(params["Transmissibilities"]).copy()
        T[sl] = wi
        params["Transmissibilities"] = T
        if "GravityPotentialDifference" in params:
            gdz = np.asarray(params["GravityPotentialDifference"]).copy()
            gdz[sl] = 0.0
            params["GravityPotentialDifference"] = gdz
        return params


def setup_well_graph_model(mesh, fluid, wells: "list[WellSpec]",
                           permeability=None, porosity=None, gravity=None):
    """Augmented-graph well formulation: one SimulationModel over the
    reservoir+wells graph. Returns (model, wmesh, params) with
    perforation transmissibilities already patched to WI."""
    from .darcy import setup_darcy_model
    from .setup import setup_parameters

    nc = mesh.number_of_cells()
    wmesh = WellGraphMesh(mesh, wells)
    nw = len(wells)
    if permeability is None:
        # np.asarray(None) is a 0-d NaN under NumPy 2.x — without this
        # guard every reservoir transmissibility silently goes NaN
        raise ValueError("setup_well_graph_model: permeability is "
                         "required (scalar or per-cell array)")
    perm = np.asarray(permeability, dtype=np.float64)
    if perm.ndim == 0:
        perm = np.full(nc, float(perm))
    poro = np.asarray(porosity if porosity is not None else 1.0,
                      dtype=np.float64)
    if poro.ndim == 0:
        poro = np.full(nc, float(poro))
    # well cells: unit porosity, placeholder permeability (their faces'
    # trans is overwritten with WI)
    model = setup_darcy_model(
        wmesh, fluid,
        permeability=np.concatenate([perm, np.full(nw, perm.mean())]),
        porosity=np.concatenate([poro, np.ones(nw)]),
        gravity=gravity)
    params = wmesh.patch_well_parameters(setup_parameters(model))
    return model, wmesh, params
