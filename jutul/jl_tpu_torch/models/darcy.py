"""Two-phase immiscible Darcy flow — the flagship physics pack.

Port of the JAX package's ``models/darcy.py`` (reference: Jutul's
conservation-law hosting, src/conservation/conservation.jl + flux.jl TPFA/SPU
upwinding; the concrete two-phase system lives downstream in JutulDarcy.jl).

Formulation (standard immiscible two-phase, slightly compressible):
  per phase α in {w, n}:  d/dt (pv ρ_α s_α) + div(ρ_α λ_α T ΔΦ_α) = q_α
  ΔΦ_α = Δp - ρ_α_avg g Δz,  λ_α = kr_α/μ_α single-point upwinded (SPU)
  kr via Brooks–Corey power laws, ρ_α(p) = ρ_ref exp(c_α (p - p_ref)).

Primary variables: Pressure (scalar), Saturations (unit-sum fractions, 1 dof).
Parameters: Transmissibilities (faces), GravityPotentialDifference (faces,
g·Δz), FluidVolume (cells, pore volume). Secondary chain:
PhaseMassDensities -> RelativePermeabilities -> PhaseMobilities ->
TotalMasses, all elementwise along cells.

Derivative conventions follow JAX's, so the port's Jacobians equal the
reference's bit for bit in exact arithmetic: ``clip`` has weight 0.5 at a
bound (``torch.maximum``/``torch.minimum`` tie rule, NOT ``torch.clamp``'s
1.0), ``where`` differentiates the chosen branch, and the upwind tie
``dpot >= 0`` picks the left cell. Saturations sit exactly on 0 or 1 after
the update's chopping, so the clip rule is on the main path.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch
from torch.func import jvp

from ..core.entities import CELLS, FACES
from ..discretization.tpfa import compute_face_gdz, compute_face_trans
from .equations import ConservationLaw, ScalarAssemblyForm
from .forces import JutulForce
from .system import JutulSystem
from .variables import (
    FractionVariables,
    JutulParameter,
    ScalarVariable,
    SecondaryVariable,
)


def clip(x, lo: float, hi: float):
    """``jnp.clip`` with JAX's derivative: weight 0.5 exactly at a bound."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


@dataclass(frozen=True)
class ImmiscibleFluid:
    """Per-phase fluid description (two entries: wetting, non-wetting)."""

    reference_densities: tuple = (1000.0, 800.0)  # kg/m^3
    compressibilities: tuple = (1e-10, 1e-9)  # 1/Pa
    viscosities: tuple = (1e-3, 5e-3)  # Pa s
    reference_pressure: float = 1.0e5  # Pa
    corey_exponents: tuple = (2.0, 2.0)
    residual_saturations: tuple = (0.0, 0.0)

    @property
    def n_phases(self) -> int:
        return len(self.reference_densities)


class Pressure(ScalarVariable):
    def default_value(self, model=None):
        return 1.0e5

    def minimum_value(self, model=None):
        return 1.0  # Pa; matches the reference's hard floor on pressure

    def relative_increment_limit(self, model=None):
        return 0.2


class Saturations(FractionVariables):
    def __init__(self, n_phases: int = 2, ds_max: float = 0.2):
        super().__init__(n_phases, minimum_fraction=0.0, ds_max=ds_max)


class Transmissibilities(JutulParameter):
    def __init__(self):
        super().__init__(default=1.0, entity=FACES, minimum=0.0)

    def initialize_parameter(self, model, n):
        dd = model.data_domain
        perm = dd.get("permeability")
        if perm is None:
            perm = np.ones(model.number_of_cells()) * 1e-13
        return compute_face_trans(dd.geometry, perm)


class GravityPotentialDifference(JutulParameter):
    def __init__(self, gravity=None):
        super().__init__(default=0.0, entity=FACES)
        self.gravity = gravity

    def initialize_parameter(self, model, n):
        dd = model.data_domain
        g = self.gravity
        if g is False or (dd.geometry is not None and dd.geometry.dim < 2 and g is None):
            return np.zeros(n)
        if g is None or g is True:  # default: down the last axis
            return compute_face_gdz(dd.geometry, None)
        g = np.asarray(g, dtype=np.float64)
        if g.ndim == 0:  # scalar magnitude, down the last axis
            vec = np.zeros(dd.geometry.dim)
            vec[-1] = -float(g)
            return compute_face_gdz(dd.geometry, vec)
        return compute_face_gdz(dd.geometry, g)


class FluidVolume(JutulParameter):
    def __init__(self):
        super().__init__(default=1.0, entity=CELLS, minimum=0.0)

    def initialize_parameter(self, model, n):
        dd = model.data_domain
        vol = dd["volumes"]
        poro = dd.get("porosity")
        if poro is None:
            poro = np.ones(n)
        return vol * poro


class PhaseMassDensities(SecondaryVariable):
    dependencies = ("Pressure",)

    def __init__(self, fluid: ImmiscibleFluid):
        self.fluid = fluid

    def values_per_entity(self, model=None) -> int:
        return self.fluid.n_phases

    def evaluate(self, model, Pressure):
        f = self.fluid
        rho0 = Pressure.new_tensor(f.reference_densities)
        c = Pressure.new_tensor(f.compressibilities)
        dp = Pressure[..., None] - f.reference_pressure
        return rho0 * torch.exp(c * dp)


class BrooksCoreyRelativePermeabilities(SecondaryVariable):
    dependencies = ("Saturations",)

    def __init__(self, fluid: ImmiscibleFluid):
        self.fluid = fluid

    def values_per_entity(self, model=None) -> int:
        return self.fluid.n_phases

    def evaluate(self, model, Saturations):
        f = self.fluid
        sr = Saturations.new_tensor(f.residual_saturations)
        n = Saturations.new_tensor(f.corey_exponents)
        sr_tot = torch.sum(sr)
        s_eff = clip((Saturations - sr) / (1.0 - sr_tot), 0.0, 1.0)
        return s_eff**n


class PhaseMobilities(SecondaryVariable):
    dependencies = ("RelativePermeabilities",)

    def __init__(self, fluid: ImmiscibleFluid):
        self.fluid = fluid

    def values_per_entity(self, model=None) -> int:
        return self.fluid.n_phases

    def evaluate(self, model, RelativePermeabilities):
        mu = RelativePermeabilities.new_tensor(self.fluid.viscosities)
        return RelativePermeabilities / mu


class TotalMasses(SecondaryVariable):
    dependencies = ("FluidVolume", "PhaseMassDensities", "Saturations")

    def __init__(self, fluid: ImmiscibleFluid):
        self.fluid = fluid

    def values_per_entity(self, model=None) -> int:
        return self.fluid.n_phases

    def evaluate(self, model, FluidVolume, PhaseMassDensities, Saturations):
        return FluidVolume[..., None] * PhaseMassDensities * Saturations


class TwoPhaseDarcyEquation(ConservationLaw):
    """Mass conservation per phase with SPU-upwinded TPFA flux
    (reference: conservation.jl:78-99 + flux.jl SPU :35)."""

    def __init__(self, n_phases: int = 2):
        def mass(model, cs):
            return cs["TotalMasses"]

        def flux(model, cs, fs):
            # two-cell states: scalars (..., 2), phase vectors (..., 2, nph)
            T = fs["Transmissibilities"][..., None]
            gdz = fs["GravityPotentialDifference"][..., None]
            p = cs["Pressure"]
            rho = cs["PhaseMassDensities"]
            mob = cs["PhaseMobilities"]
            rho_avg = 0.5 * (rho[..., 0, :] + rho[..., 1, :])
            dpot = (p[..., 0] - p[..., 1])[..., None] - rho_avg * gdz
            upwind_is_left = dpot >= 0.0
            mob_up = torch.where(upwind_is_left, mob[..., 0, :], mob[..., 1, :])
            rho_up = torch.where(upwind_is_left, rho[..., 0, :], rho[..., 1, :])
            return rho_up * mob_up * T * dpot

        super().__init__(flux_fn=flux, mass_fn=mass, neq=n_phases)

    def convergence_parts(self, model, eq_name, r, state, dt):
        """CNV (max local scaled residual) + MB (global mass balance),
        the standard pair (reference-scaled criteria, models.jl:818)."""
        pv = state["FluidVolume"]
        rho = state["PhaseMassDensities"]
        scale = dt / (pv[:, None] * rho)
        cnv = torch.amax(torch.abs(r) * scale, dim=0)
        mb_num = torch.sum(r, dim=0) * dt
        mb_den = torch.sum(pv[:, None] * rho, dim=0)
        return {"CNV": ("max", cnv), "MB": ("ratio", (mb_num, mb_den))}

    def default_tolerance(self, model) -> float:
        return 1e-3


class ImmiscibleSystem(JutulSystem):
    """Two-phase immiscible Darcy system."""

    def __init__(self, fluid: ImmiscibleFluid | None = None, gravity=None):
        self.fluid = fluid or ImmiscibleFluid()
        self.gravity = gravity

    def select_primary_variables(self, model):
        return OrderedDict(
            Pressure=Pressure(),
            Saturations=Saturations(self.fluid.n_phases),
        )

    def select_secondary_variables(self, model):
        f = self.fluid
        return OrderedDict(
            PhaseMassDensities=PhaseMassDensities(f),
            RelativePermeabilities=BrooksCoreyRelativePermeabilities(f),
            PhaseMobilities=PhaseMobilities(f),
            TotalMasses=TotalMasses(f),
        )

    def select_parameters(self, model):
        return OrderedDict(
            Transmissibilities=Transmissibilities(),
            GravityPotentialDifference=GravityPotentialDifference(self.gravity),
            FluidVolume=FluidVolume(),
        )

    def select_equations(self, model):
        return OrderedDict(mass_conservation=TwoPhaseDarcyEquation(
            self.fluid.n_phases))

    def scalar_assembly_form(self, model):
        """Dof-scalar mirror of TwoPhaseDarcyEquation's flux/mass for the
        fused flux+Jacobian kernel (see ScalarAssemblyForm). Must track
        evaluate() of PhaseMassDensities / BrooksCorey / PhaseMobilities /
        TotalMasses and TwoPhaseDarcyEquation.flux exactly. ``constants``
        is the CUDA kernel's fluid argument block (two phases only)."""
        f = self.fluid
        nph = f.n_phases
        rho0 = tuple(float(v) for v in f.reference_densities)
        comp = tuple(float(v) for v in f.compressibilities)
        pref = float(f.reference_pressure)
        sr = tuple(float(v) for v in f.residual_saturations)
        nexp = tuple(float(v) for v in f.corey_exponents)
        mu = tuple(float(v) for v in f.viscosities)
        sr_tot = sum(sr)

        def saturations(u):
            s = list(u[1:nph])
            last = 1.0
            for sd in s:
                last = last - sd
            return tuple(s) + (last,)

        def densities(p):
            return tuple(rho0[a] * torch.exp(comp[a] * (p - pref))
                         for a in range(nph))

        def mobilities(s):
            out = []
            for a in range(nph):
                s_eff = clip((s[a] - sr[a]) / (1.0 - sr_tot), 0.0, 1.0)
                out.append(s_eff ** nexp[a] / mu[a])
            return tuple(out)

        def mass(u, cp):
            pv = cp[0]
            s = saturations(u)
            rho = densities(u[0])
            return tuple(pv * rho[a] * s[a] for a in range(nph))

        def flux(u_l, u_r, cp_l, cp_r, fp):
            T, gdz = fp
            p_l, p_r = u_l[0], u_r[0]
            rho_l, rho_r = densities(p_l), densities(p_r)
            mob_l = mobilities(saturations(u_l))
            mob_r = mobilities(saturations(u_r))
            out = []
            for a in range(nph):
                rho_avg = 0.5 * (rho_l[a] + rho_r[a])
                dpot = (p_l - p_r) - rho_avg * gdz
                up = dpot >= 0.0
                mob_up = torch.where(up, mob_l[a], mob_r[a])
                rho_up = torch.where(up, rho_l[a], rho_r[a])
                out.append(rho_up * mob_up * T * dpot)
            return tuple(out)

        constants = ()
        if nph == 2:
            constants = rho0 + comp + (pref,) + sr + (1.0 - sr_tot,) + nexp + mu
        return ScalarAssemblyForm(
            flux=flux, mass=mass, n_eq=nph,
            face_params=("Transmissibilities", "GravityPotentialDifference"),
            cell_params=("FluidVolume",), constants=constants)


class PhaseSourceTerm(JutulForce):
    """Phase mass sources q_α [kg/s] in given cells: residual -= q."""

    def __init__(self, cells, values):
        self.cells = np.atleast_1d(np.asarray(cells, dtype=np.int64))
        self.values = values  # (ns, n_phases) mass rates

    def apply(self, model, eq, eq_name, r, state, dt):
        if not isinstance(eq, TwoPhaseDarcyEquation):
            return r
        v = torch.as_tensor(np.asarray(self.values), dtype=r.dtype,
                            device=r.device)
        cells = torch.as_tensor(self.cells, device=r.device)
        return r.index_add(0, cells, -torch.atleast_2d(v))


class PressureBoundaryCondition(JutulForce):
    """Dirichlet-like pressure BC on cells via a half-face transmissibility
    connection to a fixed-pressure reservoir.

    State-dependent force: contributes to the residual AND the diagonal
    Jacobian (the counterpart of the reference's boundary-condition force
    path, equations.jl:603 apply_forces_to_equation!). Evaluated over the
    batch of its cells at once; the diagonal blocks come from one
    ``torch.func.jvp`` per dof, with the flux's ``where`` differentiating
    the chosen branch as in JAX.
    """

    def __init__(self, cells, pressure, trans, saturations=None):
        self.cells = np.atleast_1d(np.asarray(cells, dtype=np.int64))
        self.pressure = pressure  # scalar or (ns,)
        self.trans = trans  # (ns,) half-face trans to boundary
        self.saturations = saturations  # inflow saturations (ns, nph)

    def shift_pressure_datum(self, p_ref):
        """Boundary pressure is absolute — rebase it with the cell
        pressures (JutulForce.shift_pressure_datum protocol)."""
        import copy as _copy

        g = _copy.copy(self)
        g.pressure = self.pressure - p_ref
        return g

    def _flux(self, model, p, mob, rho, pb, T, s_in):
        """Boundary out-flux (ns, nph) for p (ns,), mob/rho/s_in (ns, nph),
        pb/T (ns,)."""
        dp = p - pb  # > 0: outflow
        mu = mob.new_tensor(model.system.fluid.viscosities)
        # Inflow mobility uses the system's own relative permeability at the
        # boundary saturation, kr(s_in)/mu, consistent with interior fluxes
        # (reference boundary-condition upwinding, equations.jl:603).
        relperm = model.secondary_variables.get("RelativePermeabilities")
        kr_in = relperm.evaluate(model, s_in) if relperm is not None else s_in
        mob_in = kr_in / mu
        mob_up = torch.where((dp >= 0)[:, None], mob, mob_in)
        return rho * mob_up * T[:, None] * dp[:, None]

    def _per_source(self, nph, like):
        ns = self.cells.shape[0]
        as_t = lambda v: like.new_tensor(np.asarray(v, dtype=np.float64))  # noqa: E731
        pb = torch.broadcast_to(as_t(self.pressure), (ns,))
        T = torch.broadcast_to(as_t(self.trans), (ns,))
        if self.saturations is None:
            s_in = like.new_full((ns, nph), 1.0 / nph)
        else:
            s_in = torch.broadcast_to(as_t(self.saturations), (ns, nph))
        return pb, T, s_in

    def apply(self, model, eq, eq_name, r, state, dt):
        if not isinstance(eq, TwoPhaseDarcyEquation):
            return r
        cells = torch.as_tensor(self.cells, device=r.device)
        pb, T, s_in = self._per_source(model.system.fluid.n_phases, r)
        q = self._flux(model, state["Pressure"][cells],
                       state["PhaseMobilities"][cells],
                       state["PhaseMassDensities"][cells], pb, T, s_in)
        return r.index_add(0, cells, q.to(r.dtype))

    def diagonal_jacobian(self, model, eq, eq_name, compiled, state, dt):
        if not isinstance(eq, TwoPhaseDarcyEquation):
            return None
        p0 = state["Pressure"]
        cells = torch.as_tensor(self.cells, device=p0.device)
        U = compiled.get_dofs({k: state[k][cells]
                               for k in compiled.model.primary_variables})
        params = {k: v[cells] for k, v in state.items()
                  if k in compiled.model.parameters
                  and compiled.cell_entry_entity.get(k) == CELLS}
        pb, T, s_in = self._per_source(model.system.fluid.n_phases, p0)

        def flux(u):
            local = dict(params)
            local.update(compiled.unpack_dofs(u))
            local = compiled._eval_secondaries_local(local)
            return self._flux(model, local["Pressure"],
                              local["PhaseMobilities"],
                              local["PhaseMassDensities"], pb, T, s_in)

        cols = []
        for j in range(U.shape[1]):
            ej = torch.zeros_like(U)
            ej[:, j] = 1.0
            cols.append(jvp(flux, (U,), (ej,))[1])  # (ns, neq)
        return self.cells, torch.stack(cols, dim=-1)  # (ns, neq, ndof)


def setup_darcy_model(mesh, fluid: ImmiscibleFluid | None = None,
                      permeability=None, porosity=None, gravity=None):
    """Convenience constructor: DataDomain + ImmiscibleSystem model."""
    from ..core.domains import DataDomain
    from .system import SimulationModel

    dd = DataDomain(mesh)
    nc = dd.number_of_cells()
    if permeability is not None:
        perm = np.asarray(permeability, dtype=np.float64)
        if perm.ndim == 0:
            perm = np.full(nc, float(perm))
        dd.set("permeability", perm)
    if porosity is not None:
        poro = np.asarray(porosity, dtype=np.float64)
        if poro.ndim == 0:
            poro = np.full(nc, float(poro))
        dd.set("porosity", poro)
    return SimulationModel(dd, ImmiscibleSystem(fluid, gravity=gravity))
