"""Port assembly (K3 plain path + fused-form ``assemble``) against the JAX
package.

- K3's plain version (``darcy_flux_jacobian_plain``, torch.func.jvp of the
  port's ``ScalarAssemblyForm.flux``) against the JAX Pallas kernel
  ``axis_flux_jacobian`` in interpret mode, per axis.
- The whole ``StencilCompiledModel.assemble`` (r, diag, plus, minus)
  against the JAX ``StencilCompiledModel`` (its vmap-jvp path on CPU).
- A case with cells at S_w = 0 and 1 exactly and exact upwind ties
  (dpot == 0): JAX's derivative conventions (clip weight 0.5 at a bound,
  left cell on a tie) must carry over.

Tolerance: rtol 1e-12 against the largest magnitude of each array, at
f64 — the two packages evaluate the same formulas in a different
operation order, nothing more.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jutul.jl_tpu import (
    CartesianMesh as JMesh,
    compile_model as jcompile,
    setup_parameters as jsetup_parameters,
    si_unit,
)
from jutul.jl_tpu.models import darcy as jdarcy
from jutul.jl_tpu.models.setup import merge_state as jmerge
from jutul.jl_tpu.ops.pallas.assembly_kernels import axis_flux_jacobian
from jutul.jl_tpu.ops.stencil import StencilCompiledModel as JStencil
from jutul.jl_tpu_torch import CartesianMesh, compile_model, from_numpy
from jutul.jl_tpu_torch.models import darcy as tdarcy
from jutul.jl_tpu_torch.models.setup import merge_state
from jutul.jl_tpu_torch.ops.cuda.assembly_kernels import (
    darcy_flux_jacobian,
    darcy_flux_jacobian_plain,
)
from jutul.jl_tpu_torch.ops.stencil import StencilCompiledModel

BAR = si_unit("bar")
DARCY = si_unit("darcy")
RTOL = 1e-12
DT = 3e4


def assert_close(actual, desired, rtol=RTOL, what=""):
    actual, desired = np.asarray(actual), np.asarray(desired)
    assert actual.shape == desired.shape, what
    scale = max(np.abs(desired).max(), 1e-300)
    err = np.abs(actual - desired).max()
    assert err <= rtol * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def darcy_case(kind, dims=(6, 8, 4)):
    """Same model in both packages plus numpy state/state0/params."""
    nx, ny, nz = dims
    nc = nx * ny * nz
    rng = np.random.default_rng(3)
    if kind == "gravity":
        fluid_kw = dict(viscosities=(1e-3, 3e-3),
                        compressibilities=(1e-9, 5e-10),
                        residual_saturations=(0.1, 0.15),
                        corey_exponents=(2.0, 3.0))
        gravity = 9.81
    else:  # "bounds": saturations on 0/1, exact upwind ties
        fluid_kw = dict(viscosities=(1e-3, 3e-3), corey_exponents=(2.0, 3.0))
        gravity = False
    perm = rng.lognormal(0, 1, nc) * 0.1 * DARCY
    sw = rng.uniform(0.15, 0.8, nc)
    p = 100 * BAR + rng.uniform(-1, 1, nc) * BAR
    if kind == "bounds":
        sw[::3] = 0.0
        sw[1::3] = 1.0
        p[: nc // 2] = 100 * BAR
    sw0 = np.roll(sw, 1)
    state = {"Pressure": p, "Saturations": np.stack([sw, 1 - sw], 1)}
    state0 = {"Pressure": p, "Saturations": np.stack([sw0, 1 - sw0], 1)}
    extent = (6.0, 8.0, 4.0)
    jmodel = jdarcy.setup_darcy_model(
        JMesh(dims, extent), jdarcy.ImmiscibleFluid(**fluid_kw),
        permeability=perm, porosity=0.25, gravity=gravity)
    tmodel = tdarcy.setup_darcy_model(
        CartesianMesh(dims, extent), tdarcy.ImmiscibleFluid(**fluid_kw),
        permeability=perm, porosity=0.25, gravity=gravity)
    params = {k: np.asarray(v) for k, v in jsetup_parameters(jmodel).items()}
    return jmodel, tmodel, state, state0, params


def _jax_full(jmodel, state, params):
    comp = jcompile(jmodel)
    full = comp.evaluate_secondaries(jmerge(
        {k: jnp.asarray(v) for k, v in state.items()},
        {k: jnp.asarray(v) for k, v in params.items()}))
    return comp, full


@pytest.mark.parametrize("kind", ["gravity", "bounds"])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_k3_plain_matches_pallas_interpret(kind, axis):
    jmodel, tmodel, state, _, params = darcy_case(kind)
    comp, full = _jax_full(jmodel, state, params)
    jsc = JStencil(comp)
    form = jsc.form
    nz, ny, nx = L = jsc.L
    nxp = 128
    U = comp.get_dofs(full)
    streams = [U[:, j] for j in range(U.shape[1])]
    streams += [jnp.asarray(full[nm]) for nm in form.cell_params]
    u_pad = jnp.pad(jnp.stack(streams).reshape(len(streams), nz * ny, nx),
                    ((0, 0), (0, ny), (0, nxp - nx)))
    fl = jsc.face_lat[axis]
    pads = {0: ((0, 0), (0, 0), (0, 1)), 1: ((0, 0), (0, 1), (0, 0)),
            2: ((0, 1), (0, 0), (0, 0))}[axis]
    o0, o1 = jsc.face_offsets[axis], jsc.face_offsets[axis + 1]
    fp_pad = jnp.pad(jnp.stack([
        jnp.pad(jnp.asarray(full[nm])[o0:o1].reshape(fl), pads)
        for nm in form.face_params]).reshape(2, nz * ny, nx),
        ((0, 0), (0, ny), (0, nxp - nx)))
    ref = axis_flux_jacobian(form, u_pad, fp_pad, L, axis, 2, interpret=True)
    left = (slice(None),) + {0: np.s_[:, :, :-1], 1: np.s_[:, :-1, :],
                             2: np.s_[:-1, :, :]}[axis]
    ref = np.asarray(ref)[:, :, :nx].reshape(10, nz, ny, nx)[left]

    tform = tmodel.system.scalar_assembly_form(tmodel)
    U_t = torch.tensor(np.asarray(U))
    faces = [torch.as_tensor(params[nm][o0:o1]) for nm in tform.face_params]
    out = darcy_flux_jacobian_plain(tform, U_t, *faces, L, axis)
    for q in range(10):
        assert_close(out[q].reshape(fl).numpy(), ref[q], what=f"stream {q}")
    # the wrapper takes the plain path for CPU tensors
    np.testing.assert_array_equal(
        darcy_flux_jacobian(tform, U_t, *faces, L, axis).numpy(),
        out.numpy())


@pytest.mark.parametrize("kind", ["gravity", "bounds"])
def test_assemble_matches_jax(kind):
    jmodel, tmodel, state, state0, params = darcy_case(kind)
    cells = [0, 17, 40]
    rates = np.array([[1e-3, 0.0], [0.0, -2e-3], [-1e-3, -1e-3]])
    jsc = JStencil(jcompile(jmodel))
    jsc.use_fused_assembly = False
    jf = {"src": jdarcy.PhaseSourceTerm(cells, rates)}
    to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    r_ref, A_ref, _ = jsc.assemble(jmerge(to_j(state), to_j(params)),
                                   jmerge(to_j(state0), to_j(params)), DT, jf)

    sc = StencilCompiledModel(compile_model(tmodel))
    tf = {"src": tdarcy.PhaseSourceTerm(cells, rates)}
    r, A, _ = sc.assemble(merge_state(from_numpy(state, "cpu"), from_numpy(params, "cpu")),
                          merge_state(from_numpy(state0, "cpu"), from_numpy(params, "cpu")),
                          DT, tf)
    assert r.dtype == torch.float64 and r.shape == tuple(r_ref.shape)
    assert_close(r.numpy(), r_ref, what="r")
    assert_close(A.diag.numpy(), A_ref.diag, what="diag")
    assert set(A.plus) == set(A_ref.plus) == set(A.minus)
    for a in A_ref.plus:
        assert_close(A.plus[a].numpy(), A_ref.plus[a], what=f"plus[{a}]")
        assert_close(A.minus[a].numpy(), A_ref.minus[a], what=f"minus[{a}]")


def test_bounds_case_hits_the_clip_and_tie_conventions():
    """The ``bounds`` case really exercises both conventions: torch.clamp's
    derivative (1 at a bound) or a right-cell tie would change the
    Jacobian far beyond the parity tolerance."""
    _, tmodel, state, _, params = darcy_case("bounds")
    sc = StencilCompiledModel(compile_model(tmodel))
    form = sc.form
    U = torch.stack([torch.as_tensor(state["Pressure"]),
                     torch.as_tensor(state["Saturations"][:, 0])], 1)
    o0, o1 = sc.face_offsets[0], sc.face_offsets[1]
    faces = [torch.as_tensor(params[nm][o0:o1]) for nm in form.face_params]
    out = darcy_flux_jacobian_plain(form, U, *faces, sc.L, 0)
    with mock.patch.object(tdarcy, "clip",
                           lambda x, lo, hi: torch.clamp(x, lo, hi)):
        out_clamp = darcy_flux_jacobian_plain(form, U, *faces, sc.L, 0)
    assert (out_clamp - out).abs().max() > 1e-3 * out.abs().max()
    ties = (out[0] == 0) & (out[2] != 0)  # dpot == 0 but dF/dp_L != 0
    assert bool(ties.any())


@pytest.mark.parametrize("kind", ["gravity", "bounds"])
def test_form_matches_equation_functions(kind):
    """The ScalarAssemblyForm contract: flux and mass track the
    TwoPhaseDarcyEquation's dict-based functions exactly."""
    _, tmodel, state, _, params = darcy_case(kind)
    comp = compile_model(tmodel)
    full = comp.evaluate_secondaries(merge_state(from_numpy(state, "cpu"),
                                                 from_numpy(params, "cpu")))
    form = tmodel.system.scalar_assembly_form(tmodel)
    U = comp.get_dofs(full)
    u = tuple(U[:, j] for j in range(U.shape[1]))
    mass = torch.stack(form.mass(u, (full["FluidVolume"],)), dim=-1)
    np.testing.assert_allclose(mass.numpy(), full["TotalMasses"].numpy(),
                               rtol=1e-14)
    nb = np.asarray(tmodel.data_domain.geometry.neighbors)
    lft, rgt = torch.as_tensor(nb[:, 0]), torch.as_tensor(nb[:, 1])
    eq = tmodel.equations["mass_conservation"]
    cs = {k: torch.stack([full[k][lft], full[k][rgt]], dim=1)
          for k in ("Pressure", "PhaseMassDensities", "PhaseMobilities")}
    fs = {k: full[k] for k in form.face_params}
    ref = eq.flux_fn(tmodel, cs, fs)
    got = torch.stack(form.flux(tuple(v[lft] for v in u),
                                tuple(v[rgt] for v in u), (), (),
                                tuple(fs.values())), dim=-1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-13,
                               atol=1e-13 * ref.abs().max().item())
