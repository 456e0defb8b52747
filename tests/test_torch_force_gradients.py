"""``solve_adjoint_forces`` and ``solve_adjoint_generic`` of the port
against the JAX package's, at f64 on the CPU:

- the force gradient on tests/test_adjoint.py:218's ``ScalarTestSystem``
  case (the JAX package's and a central difference) and on the 8x8x6 well
  model with per-step forces: every value field of the rate control
  (``PhaseSourceTerm.values``) and of the BHP control
  (``PressureBoundaryCondition.pressure/trans/saturations``) against the
  JAX package's, each field to 1e-7 relative: the rates agree to 1e-10,
  the BHP fields to 6.7e-9. That gap stays at 5.1e-9 with numpy's LAPACK
  in place of PyTorch's for the λ-solve: the dense transpose (condition
  ~1e10) turns the two packages' ~1e-16 differences in Jacobian entries
  into that much at the BHP cell's λ, small beside the largest λ that
  the gradients' 1e-9 bar is taken against. The cells stay as they were;
- ``solve_adjoint_generic`` on tests/test_adjoint.py:274's
  ``VariablePoissonSystem`` case (x are log-coefficients): the JAX
  package's value and gradient, and a central difference.
"""

import numpy as np
import jax.numpy as jnp
import torch

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from test_torch_generic_adjoint import BAR, AdjointCase, G_sat, rel

FIELD_BAR = 1e-7


def test_force_gradient_scalar_matches_jax_and_fd():
    """tests/test_adjoint.py:218-252 in both packages."""
    res = {}
    for pkg in (jpkg, tpkg):
        xp = jnp if pkg is jpkg else torch
        kw = {} if pkg is jpkg else dict(device="cpu")
        model = pkg.SimulationModel(pkg.ScalarTestDomain(),
                                    pkg.ScalarTestSystem())
        state0 = pkg.setup_state(model, XVar=0.0)
        params = pkg.setup_parameters(model)

        def run(value, pkg=pkg, model=model, state0=state0, params=params,
                kw=kw):
            forces = pkg.setup_forces(model,
                                      sources=pkg.ScalarTestForce(value))
            states, _ = pkg.simulate(dict(state0), model, [1.0, 1.0],
                                     forces=forces, parameters=params,
                                     info_level=-1, **kw)
            return states, forces

        def G(model_, state, dt, n, forces_, xp=xp):
            return dt * xp.sum(state["XVar"] ** 2)

        states, forces = run(1.5)
        grads = pkg.solve_adjoint_forces(model, states, [1.0, 1.0], G,
                                         params, state0, forces, **kw)
        g = grads["sources"].value
        assert isinstance(grads["sources"], pkg.ScalarTestForce)
        res[pkg] = float(np.asarray(g))
        h = 1e-6

        def total(sts):
            return sum(float(np.sum(np.asarray(s["XVar"]) ** 2))
                       for s in sts)

        fd = (total(run(1.5 + h)[0]) - total(run(1.5 - h)[0])) / (2 * h)
        assert np.isclose(res[pkg], fd, rtol=1e-6), (pkg.__name__, fd)
    assert abs(res[tpkg] - res[jpkg]) <= 1e-12 * abs(res[jpkg])


def test_force_gradient_well_model_matches_jax():
    """Per-step rate and BHP controls of the 8x8x6 well model: every value
    field's gradient against the JAX package's."""
    out = {}
    case = AdjointCase((8, 8, 6), well_models=True)
    for pkg, (model, st, pr, f) in ((jpkg, case.j), (tpkg, case.t)):
        kw = {} if pkg is jpkg else dict(device="cpu")
        out[pkg] = pkg.solve_adjoint_forces(
            model, case.states, case.dts, G_sat(pkg, case.nc), pr, st, f,
            **kw)
    assert isinstance(out[tpkg], list) and len(out[tpkg]) == 2
    for n in range(2):
        for name, fields in (("rate", ("values",)),
                             ("bhp", ("pressure", "trans", "saturations"))):
            for fld in fields:
                a = getattr(out[tpkg][n][name], fld)
                b = np.asarray(getattr(out[jpkg][n][name], fld))
                assert isinstance(a, torch.Tensor)
                assert rel(a.numpy(), b) <= FIELD_BAR, (n, name, fld)
            np.testing.assert_array_equal(out[tpkg][n][name].cells,
                                          case.t[3][n][name].cells)


# ---------------------------------------------------------------------------
# solve_adjoint_generic
# ---------------------------------------------------------------------------
def _poisson(pkg):
    nx = 4
    model = pkg.SimulationModel(
        pkg.DataDomain(pkg.CartesianMesh((nx,), (1.0,)),
                       poisson_coefficient=1.0),
        pkg.VariablePoissonSystem(time_dependent=True))
    forces = pkg.setup_forces(model, sources=[pkg.PoissonSource(0, 1.0),
                                              pkg.PoissonSource(nx - 1,
                                                                -1.0)])
    return nx, model, pkg.setup_parameters(model), forces


def test_generic_adjoint_through_setup_fn_matches_jax():
    """tests/test_adjoint.py:274-310 in both packages: x are
    log-coefficients, K = exp(x), U0 = 0.1 x[0]; the JAX package's value
    and gradient, and a central difference."""
    dts = [0.3, 0.7]
    x0 = np.log(np.linspace(2.0, 3.0, 3))
    out = {}
    for pkg in (jpkg, tpkg):
        xp = jnp if pkg is jpkg else torch
        nx, model, base, forces = _poisson(pkg)
        kw = {} if pkg is jpkg else dict(device="cpu")

        def setup_fn(x, xp=xp, base=base, nx=nx):
            params = {k: xp.asarray(v) for k, v in base.items()}
            params["K"] = xp.exp(x)
            return {"U": 0.1 * x[0] + xp.zeros(nx, dtype=x.dtype)}, params

        def G(model_, state, dt, n, f, xp=xp):
            return dt * xp.sum(state["U"] ** 2)

        v, dx = pkg.solve_adjoint_generic(x0, setup_fn, model, dts, G,
                                          forces=forces, **kw)
        out[pkg] = (v, np.asarray(dx))
        if pkg is tpkg:
            def total(xq):
                s0, p = setup_fn(torch.as_tensor(xq))
                states, _ = tpkg.simulate(
                    {k: w.numpy() for k, w in s0.items()}, model, dts,
                    forces=forces, parameters={k: np.asarray(w) for k, w in
                                               p.items()},
                    info_level=-1, device="cpu")
                return sum(dts[i] * float(np.sum(s["U"] ** 2))
                           for i, s in enumerate(states))

            h = 1e-6
            fd = np.array([(total(x0 + h * e) - total(x0 - h * e)) / (2 * h)
                           for e in np.eye(3)])
            assert rel(out[tpkg][1], fd) <= 1e-6
    assert abs(out[tpkg][0] - out[jpkg][0]) <= 1e-12 * abs(out[jpkg][0])
    assert rel(out[tpkg][1], out[jpkg][1]) <= BAR
