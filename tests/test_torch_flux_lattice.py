"""K3's three-axis entry (``darcy_flux_jacobian_lattice``) on the CPU.

- Its plain version is the per-axis plain version on each axis, exactly
  (an axis without faces gives an empty output);
- per axis it matches the JAX package's Pallas kernel
  ``axis_flux_jacobian`` in interpret mode at float64, to 1e-12 of each
  stream's largest magnitude (the two packages evaluate the same formulas
  in another operation order);
- the wrapper takes the plain path for CPU tensors and counts no launch;
- ``StencilCompiledModel.assemble_evaluated`` calls it once per assembly.

The kernel itself (bitwise equal to three per-axis launches) is held on
the card: tests/test_torch_cuda.py, chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_assembly import _jax_full, assert_close, darcy_case

from jutul.jl_tpu.ops.pallas.assembly_kernels import axis_flux_jacobian
from jutul.jl_tpu.ops.stencil import StencilCompiledModel as JStencil
from jutul.jl_tpu_torch import compile_model, from_numpy
from jutul.jl_tpu_torch.models.setup import merge_state
from jutul.jl_tpu_torch.ops.cuda import assembly_kernels as AK
from jutul.jl_tpu_torch.ops.stencil import StencilCompiledModel

RTOL = 1e-12
DIMS = [(6, 8, 4), (5, 3, 7), (7, 4, 1)]


def _port_inputs(tmodel, state, params):
    """(form, U, face parameters by axis, L) of the port's stencil model."""
    sc = StencilCompiledModel(compile_model(tmodel))
    full = sc.comp.evaluate_secondaries(merge_state(
        from_numpy(state, "cpu"), from_numpy(params, "cpu")))
    faces = sc.comp._face_entries(full)
    fps = [tuple(sc._axis_face_state(faces, a)[nm]
                 for nm in sc.form.face_params) for a in range(3)]
    return sc.form, sc.comp.get_dofs(full), fps, sc.L


@pytest.mark.parametrize("kind", ["gravity", "bounds"])
@pytest.mark.parametrize("dims", DIMS)
def test_lattice_plain_is_the_per_axis_plain(kind, dims):
    _, tmodel, state, _, params = darcy_case(kind, dims)
    form, U, fps, L = _port_inputs(tmodel, state, params)
    outs = AK.darcy_flux_jacobian_lattice_plain(form, U, fps, L)
    assert len(outs) == 3
    for a in range(3):
        nf = int(np.prod(AK.face_lattice(L, a)))
        assert outs[a].shape == (10, nf)
        if nf:
            assert torch.equal(outs[a], AK.darcy_flux_jacobian_plain(
                form, U, *fps[a], L, a))


@pytest.mark.parametrize("kind", ["gravity", "bounds"])
def test_lattice_entry_matches_pallas_interpret_per_axis(kind):
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
    tform, U_t, fps, L_t = _port_inputs(tmodel, state, params)
    assert tuple(L_t) == tuple(L)
    before = AK.darcy_flux_jacobian_lattice.launches
    outs = AK.darcy_flux_jacobian_lattice(tform, U_t, fps, L_t)
    assert AK.darcy_flux_jacobian_lattice.launches == before  # plain path
    for axis in range(3):
        fl = jsc.face_lat[axis]
        pads = {0: ((0, 0), (0, 0), (0, 1)), 1: ((0, 0), (0, 1), (0, 0)),
                2: ((0, 1), (0, 0), (0, 0))}[axis]
        o0, o1 = jsc.face_offsets[axis], jsc.face_offsets[axis + 1]
        fp_pad = jnp.pad(jnp.stack([
            jnp.pad(jnp.asarray(full[nm])[o0:o1].reshape(fl), pads)
            for nm in form.face_params]).reshape(2, nz * ny, nx),
            ((0, 0), (0, ny), (0, nxp - nx)))
        ref = axis_flux_jacobian(form, u_pad, fp_pad, L, axis, 2,
                                 interpret=True)
        left = (slice(None),) + {0: np.s_[:, :, :-1], 1: np.s_[:, :-1, :],
                                 2: np.s_[:-1, :, :]}[axis]
        ref = np.asarray(ref)[:, :, :nx].reshape(10, nz, ny, nx)[left]
        for q in range(10):
            assert_close(outs[axis][q].reshape(fl).numpy(), ref[q], RTOL,
                         what=f"axis {axis} stream {q}")


def test_assembly_calls_the_lattice_entry_once(monkeypatch):
    from jutul.jl_tpu_torch.ops import stencil as ST

    _, tmodel, state, state0, params = darcy_case("gravity")
    calls = []

    def spy(form, U, fps, L):
        calls.append(len(fps))
        return AK.darcy_flux_jacobian_lattice(form, U, fps, L)

    monkeypatch.setattr(ST, "darcy_flux_jacobian_lattice", spy)
    sc = StencilCompiledModel(compile_model(tmodel))
    pr = from_numpy(params, "cpu")
    sc.assemble(merge_state(from_numpy(state, "cpu"), pr),
                merge_state(from_numpy(state0, "cpu"), pr), 3e4)
    assert calls == [3]
