"""ROADMAP A10's rest: the port's ``StencilMatrix.matvec`` and the generic
``StencilCompiledModel.jacobian`` (jvps through the flux function, no
kernel) against the JAX package's, on the CPU at f64.

- ``jacobian``: diag, plus and minus within 1e-12 of the JAX package's
  ``jacobian`` and of the port's fused assembly (K3's plain version), on
  a gravity case with a pressure boundary condition (a state-dependent
  force diagonal) and on the bounds case (saturations on 0 and 1, exact
  upwind ties);
- ``matvec``: within 1e-12 of the JAX package's ``matvec`` and of K1's
  plain version on the same matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jutul.jl_tpu.meshes.cartesian import CartesianMesh as JMesh
from jutul.jl_tpu.models import darcy as jdarcy
from jutul.jl_tpu.models.setup import merge_state as jmerge
from jutul.jl_tpu.models.setup import setup_parameters as jsetup_parameters
from jutul.jl_tpu.ops.assembly import compile_model as jcompile
from jutul.jl_tpu.ops.stencil import StencilCompiledModel as JStencil
from jutul.jl_tpu_torch import CartesianMesh, compile_model, from_numpy
from jutul.jl_tpu_torch.models import darcy as tdarcy
from jutul.jl_tpu_torch.models.setup import merge_state
from jutul.jl_tpu_torch.ops.cuda.stencil_kernels import (
    StencilMatvec,
    stencil_matvec_plain,
)
from jutul.jl_tpu_torch.ops.stencil import StencilCompiledModel
from jutul.jl_tpu_torch.units import si_unit

BAR = si_unit("bar")
DARCY = si_unit("darcy")
DT = 3e4


def _close(actual, desired, what, rtol=1e-12):
    actual, desired = np.asarray(actual), np.asarray(desired)
    assert actual.shape == desired.shape, what
    scale = max(np.abs(desired).max(), 1e-300)
    err = np.abs(actual - desired).max()
    assert err <= rtol * scale, f"{what}: {err:.3e} vs scale {scale:.3e}"


def _case(kind, dims=(5, 4, 3)):
    nc = int(np.prod(dims))
    rng = np.random.default_rng(7)
    fluid = dict(viscosities=(1e-3, 3e-3), corey_exponents=(2.0, 3.0))
    if kind == "gravity":
        fluid.update(compressibilities=(1e-9, 5e-10),
                     residual_saturations=(0.1, 0.15))
    perm = rng.lognormal(0, 1, nc) * 0.1 * DARCY
    sw = rng.uniform(0.15, 0.8, nc)
    p = 100 * BAR + rng.uniform(-1, 1, nc) * BAR
    if kind == "bounds":
        sw[::3], sw[1::3] = 0.0, 1.0
        p[: nc // 2] = 100 * BAR
    state = {"Pressure": p, "Saturations": np.stack([sw, 1 - sw], 1)}
    sw0 = np.roll(sw, 1)
    state0 = {"Pressure": p, "Saturations": np.stack([sw0, 1 - sw0], 1)}
    grav = 9.81 if kind == "gravity" else False
    models = [D.setup_darcy_model(M(dims, (5.0, 4.0, 3.0)),
                                  D.ImmiscibleFluid(**fluid),
                                  permeability=perm, porosity=0.25,
                                  gravity=grav)
              for D, M in ((jdarcy, JMesh), (tdarcy, CartesianMesh))]
    params = {k: np.asarray(v)
              for k, v in jsetup_parameters(models[0]).items()}
    forces = [{"bc": D.PressureBoundaryCondition([0, 7, 31], 90 * BAR,
                                                 1e-12)}
              for D in (jdarcy, tdarcy)] if kind == "gravity" else [None] * 2
    return models, state, state0, params, forces


@pytest.mark.parametrize("kind", ["gravity", "bounds"])
def test_jacobian_and_matvec_match(kind):
    (jm, tm), state, state0, params, (jf, tf) = _case(kind)
    to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    jc = jcompile(jm)
    jsc = JStencil(jc)
    js = jc.evaluate_secondaries(jmerge(to_j(state), to_j(params)))
    js0 = jc.evaluate_secondaries(jmerge(to_j(state0), to_j(params)))
    A_ref = jsc.jacobian(js, js0, DT, jf)

    tc = compile_model(tm)
    sc = StencilCompiledModel(tc)
    full = lambda d: merge_state(from_numpy(d, "cpu"),  # noqa: E731
                                 from_numpy(params, "cpu"))
    ts = tc.evaluate_secondaries(full(state))
    ts0 = tc.evaluate_secondaries(full(state0))
    A = sc.jacobian(ts, ts0, DT, tf)
    _, A_fused, _ = sc.assemble(full(state), full(state0), DT, tf)
    for ref, what in ((A_ref, "jax"), (A_fused, "fused")):
        _close(A.diag, ref.diag, f"diag vs {what}")
        assert set(A.plus) == set(ref.plus) == set(A.minus)
        for a in ref.plus:
            _close(A.plus[a], ref.plus[a], f"plus[{a}] vs {what}")
            _close(A.minus[a], ref.minus[a], f"minus[{a}] vs {what}")

    x = np.random.default_rng(9).normal(size=(A.n, 2))
    y = A.matvec(torch.from_numpy(x))
    _close(y, A_ref.matvec(jnp.asarray(x)), "matvec vs jax")
    mv = StencilMatvec(A)
    _close(y, stencil_matvec_plain(mv.coef, torch.from_numpy(x), A.L, 2, 2),
           "matvec vs K1 plain")
