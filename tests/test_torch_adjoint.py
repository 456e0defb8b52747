"""The port's stencil-path discrete adjoint against the JAX package, at f64
on the CPU.

The same numpy inputs go through both packages. The forward states that
feed a gradient are computed once, by the JAX package, and handed to both
adjoints as the same numpy arrays (gradients are compared, not iteration
counts). Covered here, on tests/test_adjoint.py's 5x4x3 lattice with a
source and a ``PressureBoundaryCondition`` and on its 4x4x2 jit-sweep case
(tests/test_torch_adjoint_wells.py has the well models):

- ``stencil_transpose`` and ``bordered_transpose``: the JAX package's
  blocks exactly, and the dot identity <x, A y> = <Aᵀx, y> to 1e-12;
- ``residual_differentiable``: the port's ``assemble`` residual to 1e-13
  relative and the JAX package's ``residual`` to 1e-12;
- ``AdjointStorage._vjp_u0_p``: the JAX package's to 1e-12;
- gradients (Transmissibilities, FluidVolume, state0): the JAX package's
  ``use_stencil=True`` adjoint to 1e-9 relative and its generic adjoint
  to 1e-6 (the JAX package's own bar between its two engines). The
  λ-solves run at rtol 1e-14: at 1e-12 the two packages' BiCGStab stop
  at iterates whose transmissibility gradients differ by more than 1e-9
  on the 8x8x6 well flagship;
- ``solve_adjoint_sensitivities_jit`` equals the host loop and the JAX
  package's ``_jit``, on a run cut into ministeps by ``max_timestep``
  and flattened by ``expand_to_ministeps`` (``output_substates``), whose
  dts and states match the JAX package's (1e-10);
- the objectives, the finite-difference checker and the refusals.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from jutul.jl_tpu.adjoint import gradients as jgrad
from jutul.jl_tpu.models.setup import merge_state as jmerge
from jutul.jl_tpu_torch.adjoint import gradients as tgrad
from jutul.jl_tpu_torch.adjoint.objectives import l2_misfit_objective
from jutul.jl_tpu_torch.models.setup import merge_state as tmerge

BAR = tpkg.si_unit("bar")
DAY = tpkg.si_unit("day")
DARCY = tpkg.si_unit("darcy")
TIGHT = {"tolerances": {"mass_conservation": 1e-10},
         "max_nonlinear_iterations": 30}


def assert_close(actual, desired, rtol, what=""):
    actual, desired = np.asarray(actual), np.asarray(desired)
    assert actual.shape == desired.shape, (what, actual.shape, desired.shape)
    scale = max(np.abs(desired).max(), 1e-300)
    err = np.abs(actual - desired).max()
    assert err <= rtol * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def solver(pkg, min_cells=32, rtol=1e-14):
    """The λ-solver both packages get: CPR(GMG)-BiCGStab, tight."""
    st = importlib.import_module(pkg.__name__ + ".ops.stencil")
    return st.StencilKrylovSolver(
        preconditioner=st.StencilCPR(gmg=st.GMG(
            n_smooth=2, n_coarse_sweeps=30, min_cells=min_cells)),
        rtol=rtol, max_iterations=1000)


def G_sat(pkg, scale=1.0):
    """G = dt Σ S_w² / scale, in ``pkg``'s array library."""
    xp = jnp if pkg is jpkg else torch

    def G(model, state, dt, n, forces):
        return dt * xp.sum(state["Saturations"][:, 0] ** 2) / scale

    return G


def lattice_case(pkg):
    """tests/test_adjoint.py:362's case: a 5x4x3 lattice with gravity, a
    water source and a pressure boundary condition."""
    darcy = importlib.import_module(pkg.__name__ + ".models.darcy")
    nx, ny, nz = 5, 4, 3
    nc = nx * ny * nz
    rng = np.random.default_rng(0)
    mesh = pkg.CartesianMesh((nx, ny, nz), (10.0, 8.0, 6.0))
    fluid = darcy.ImmiscibleFluid(viscosities=(1e-3, 2e-3))
    model = darcy.setup_darcy_model(
        mesh, fluid, permeability=rng.lognormal(0, 0.5, nc) * DARCY,
        porosity=0.25, gravity=True)
    sw = rng.uniform(0.2, 0.8, nc)
    state0 = pkg.setup_state(model, Pressure=100 * BAR,
                             Saturations=np.stack([sw, 1 - sw], 1))
    params = pkg.setup_parameters(model)
    forces = {
        "sources": darcy.PhaseSourceTerm([0], np.array([[0.01, 0.0]])),
        "bc": darcy.PressureBoundaryCondition(
            [nc - 1], 100 * BAR, 2 * float(params["Transmissibilities"][0])),
    }
    return model, state0, params, forces


def sweep_case(pkg):
    """tests/test_adjoint.py:421's case: a 4x4x2 lattice, an injector and a
    producer as sources, no gravity."""
    darcy = importlib.import_module(pkg.__name__ + ".models.darcy")
    nx, ny, nz = 4, 4, 2
    nc = nx * ny * nz
    rng = np.random.default_rng(1)
    mesh = pkg.CartesianMesh((nx, ny, nz), (10.0, 8.0, 6.0))
    fluid = darcy.ImmiscibleFluid(viscosities=(1e-3, 2e-3))
    model = darcy.setup_darcy_model(
        mesh, fluid, permeability=rng.lognormal(0, 0.5, nc) * DARCY,
        porosity=0.25)
    sw = rng.uniform(0.3, 0.7, nc)
    state0 = pkg.setup_state(model, Pressure=100 * BAR,
                             Saturations=np.stack([sw, 1 - sw], 1))
    params = pkg.setup_parameters(model)
    forces = {"sources": darcy.PhaseSourceTerm(
        [0, nc - 1], np.array([[0.01, 0.0], [-0.004, -0.004]]))}
    return model, state0, params, forces


def numpy_states(states):
    return [{k: np.asarray(v) for k, v in s.items()} for s in states]


class GradientCase:
    """One case's numpy forward states and the gradients of G_sat over
    them (with state0), each computed when first asked for, so that a test
    pays only for the references it compares: the JAX package's stencil
    adjoint (its host loop, or with ``jax_sweep="jit"`` its ``_jit`` sweep:
    one compile instead of one per step's kernels, the cheaper on large
    cases), its generic adjoint, and the port's host loop and ``_jit``."""

    def __init__(self, jcase, tcase, states, dts, G_scale=1.0, min_cells=32,
                 jax_sweep="host"):
        self.jcase, self.tcase, self.states, self.dts = (jcase, tcase,
                                                         states, dts)
        self.G_scale, self.min_cells = G_scale, min_cells
        self.jax_sweep = jax_sweep
        self._done = {}

    def gradients(self, which):
        if which not in self._done:
            self._done[which] = getattr(self, "_" + which)()
        return self._done[which]

    def _jax(self, stencil):
        jm, js0, jp, jf = self.jcase
        kw = dict(parameters=jp, state0=js0, forces=jf)
        if not stencil:
            return jgrad.solve_adjoint_sensitivities(
                jm, self.states, self.dts, G_sat(jpkg, self.G_scale), **kw)
        fn = (jgrad.solve_adjoint_sensitivities if self.jax_sweep == "host"
              else jgrad.solve_adjoint_sensitivities_jit)
        return fn(jm, self.states, self.dts, G_sat(jpkg, self.G_scale),
                  use_stencil=True, linear_solver=solver(jpkg, self.min_cells),
                  include_state0=True, **kw)

    def _port(self, fn):
        tm, ts0, tp, tf = self.tcase
        return fn(tm, self.states, self.dts, G_sat(tpkg, self.G_scale),
                  parameters=tp, state0=ts0, forces=tf, device="cpu",
                  include_state0=True, use_stencil=True,
                  linear_solver=solver(tpkg, self.min_cells))

    def _jax_stencil(self):
        return self._jax(True)

    def _jax_generic(self):
        return self._jax(False)

    def _port_host(self):
        return self._port(tgrad.solve_adjoint_sensitivities)

    def _port_jit(self):
        return self._port(tgrad.solve_adjoint_sensitivities_jit)


AGAINST = {"stencil": ("jax_stencil", 1e-9), "generic": ("jax_generic", 1e-6),
           "jit": ("port_jit", 0.0)}


def check_gradients(case, against):
    """The port's host-loop gradients against the JAX package's stencil
    adjoint (1e-9 relative), its generic adjoint (1e-6; it returns no
    state0 gradient) or the port's _jit (exactly)."""
    which, rtol = AGAINST[against]
    host, want = case.gradients("port_host"), case.gradients(which)
    for k in ("Transmissibilities", "FluidVolume", "state0"):
        if k in want:
            assert_close(host[k], np.asarray(want[k]), rtol,
                         f"{k} vs {which}")


# ---------------------------------------------------------------------------
# fixtures: each JAX reference is computed once
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lattice():
    jcase, tcase = lattice_case(jpkg), lattice_case(tpkg)
    jm, js0, jp, jf = jcase
    dts = [0.2 * DAY, 0.3 * DAY]
    states, reports = jpkg.simulate(js0, jm, dts, forces=jf, parameters=jp,
                                    info_level=-1, **TIGHT)
    assert all(r["success"] for r in reports)
    return GradientCase(jcase, tcase, numpy_states(states), dts)


def _perturbed(state0, seed=3):
    """state0 with pressure perturbed and saturations on both clip bounds
    in some cells."""
    rng = np.random.default_rng(seed)
    st = {k: np.array(v, dtype=np.float64) for k, v in state0.items()}
    n = st["Pressure"].shape[0]
    st["Pressure"] = st["Pressure"] * (1.0 + 0.01 * rng.normal(size=n))
    s = st["Saturations"]
    s[::7] = (1.0, 0.0)
    s[::11] = (0.0, 1.0)
    return st


def wells_case(pkg):
    from test_torch_wells import _case

    model, _, params, state0, forces = _case(pkg.__name__, nx=5, ny=4, nz=3)
    return model, state0, params, forces


CASES = {"lattice": lattice_case, "wells": wells_case}


def _engines(name):
    """Both packages' engines, states (perturbed, state0), params, forces."""
    from jutul.jl_tpu.ops.assembly import compile_model as jcompile

    out = {}
    for pkg in (jpkg, tpkg):
        model, state0, params, forces = CASES[name](pkg)
        comp = (jcompile if pkg is jpkg else tpkg.compile_model)(model)
        st = importlib.import_module(pkg.__name__ + ".ops.stencil")
        sw = importlib.import_module(pkg.__name__ + ".ops.stencil_wells")
        if name == "wells":
            eng = sw.BorderedStencilModel(comp, *(("cpu",) if pkg is tpkg
                                                  else ()))
        else:
            eng = st.StencilCompiledModel(comp)
        out[pkg.__name__] = (model, comp, eng, _perturbed(state0), state0,
                             params, forces)
    return out


# ---------------------------------------------------------------------------
# transposes
# ---------------------------------------------------------------------------
def test_stencil_transpose_matches_jax():
    """tests/test_adjoint.py:338: a random 3x4x5 block stencil."""
    from jutul.jl_tpu.ops.stencil import StencilMatrix as JSM
    from jutul.jl_tpu.ops.stencil import stencil_transpose as jtr
    from jutul.jl_tpu_torch.ops.cuda import StencilMatvec
    from jutul.jl_tpu_torch.ops.stencil import StencilMatrix, stencil_transpose

    rng = np.random.default_rng(0)
    L, n = (3, 4, 5), 60
    face_lat = {0: (3, 4, 4), 1: (3, 3, 5), 2: (2, 4, 5)}
    diag = rng.normal(size=(2, 2, n))
    plus = {a: rng.normal(size=(2, 2) + f) for a, f in face_lat.items()}
    minus = {a: rng.normal(size=(2, 2) + f) for a, f in face_lat.items()}
    At_j = jtr(JSM(L, jnp.asarray(diag),
                   {a: jnp.asarray(v) for a, v in plus.items()},
                   {a: jnp.asarray(v) for a, v in minus.items()}))
    A = StencilMatrix(L, torch.from_numpy(diag),
                      {a: torch.from_numpy(v) for a, v in plus.items()},
                      {a: torch.from_numpy(v) for a, v in minus.items()})
    At = stencil_transpose(A)
    np.testing.assert_array_equal(At.diag.numpy(), np.asarray(At_j.diag))
    for a in range(3):
        np.testing.assert_array_equal(At.plus[a].numpy(),
                                      np.asarray(At_j.plus[a]))
        np.testing.assert_array_equal(At.minus[a].numpy(),
                                      np.asarray(At_j.minus[a]))
    x = torch.from_numpy(rng.normal(size=(n, 2)))
    y = torch.from_numpy(rng.normal(size=(n, 2)))
    lhs = float(torch.sum(x * StencilMatvec(A)(y)))
    rhs = float(torch.sum(StencilMatvec(At)(x) * y))
    assert np.isclose(lhs, rhs, rtol=1e-12, atol=0)


def test_bordered_transpose_matches_jax():
    """tests/test_stencil_wells.py:99: the JAX package's assembled bordered
    matrix transposed by both packages (the same blocks exactly), and the
    dot identity on the port's own matrix."""
    from jutul.jl_tpu.ops.stencil_wells import bordered_transpose as jtr
    from jutul.jl_tpu_torch.ops.stencil import StencilMatrix
    from jutul.jl_tpu_torch.ops.stencil_wells import (
        BorderedStencilMatrix,
        bordered_transpose,
    )

    e = _engines("wells")
    jm, jc, jeng, jst, js0, jp, jf = e["jutul.jl_tpu"]
    tm, tc, teng, tst, ts0, tp, tf = e["jutul.jl_tpu_torch"]
    to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    Bj = jax.jit(lambda s, s0: jeng.assemble(s, s0, DAY, jf)[1])(
        jmerge(to_j(jst), to_j(jp)), jmerge(to_j(js0), to_j(jp)))
    t = lambda v: torch.from_numpy(np.array(v))  # noqa: E731
    B = BorderedStencilMatrix(
        StencilMatrix(Bj.A.L, t(Bj.A.diag),
                      {a: t(v) for a, v in Bj.A.plus.items()},
                      {a: t(v) for a, v in Bj.A.minus.items()}),
        teng.perforations(torch.float64), t(Bj.J_rb), t(Bj.J_br),
        t(Bj.D_ww))
    np.testing.assert_array_equal(teng.perforations(torch.float64).cell,
                                  Bj.perf_cell)
    Bt, Bt_j = bordered_transpose(B), jtr(Bj)
    pairs = [(Bt.A.diag, Bt_j.A.diag), (Bt.J_rb, Bt_j.J_rb),
             (Bt.J_br, Bt_j.J_br), (Bt.D_ww, Bt_j.D_ww)]
    pairs += [(Bt.A.plus[a], Bt_j.A.plus[a]) for a in range(3)]
    pairs += [(Bt.A.minus[a], Bt_j.A.minus[a]) for a in range(3)]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _, Bp, _ = teng.assemble(
        tmerge(tpkg.from_numpy(tst, "cpu"), tpkg.from_numpy(tp, "cpu")),
        tmerge(tpkg.from_numpy(ts0, "cpu"), tpkg.from_numpy(tp, "cpu")),
        DAY, tf)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(Bp.n, 2)))
    y = torch.from_numpy(rng.normal(size=(Bp.n, 2)))
    lhs = float(torch.sum(x * Bp.matvec(y)))
    rhs = float(torch.sum(bordered_transpose(Bp).matvec(x) * y))
    assert np.isclose(lhs, rhs, rtol=1e-12, atol=0)


# ---------------------------------------------------------------------------
# the differentiable residual and its pull-back
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_residual_differentiable_matches_assemble_and_jax(name):
    e = _engines(name)
    jm, jc, jeng, jst, js0, jp, jf = e["jutul.jl_tpu"]
    tm, tc, teng, tst, ts0, tp, tf = e["jutul.jl_tpu_torch"]
    to_j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    rj = jax.jit(lambda s, s0: jeng.residual(
        jc.evaluate_secondaries(s), jc.evaluate_secondaries(s0), DAY, jf))(
        jmerge(to_j(jst), to_j(jp)), jmerge(to_j(js0), to_j(jp)))
    full = tmerge(tpkg.from_numpy(tst, "cpu"), tpkg.from_numpy(tp, "cpu"))
    full0 = tmerge(tpkg.from_numpy(ts0, "cpu"), tpkg.from_numpy(tp, "cpu"))
    r = teng.residual_differentiable(tc.evaluate_secondaries(full),
                                     tc.evaluate_secondaries(full0), DAY, tf)
    assert_close(r.numpy(), teng.residual(full, full0, DAY, tf).numpy(),
                 1e-13, "vs assemble")
    assert_close(r.numpy(), np.asarray(rj), 1e-12, "vs JAX residual")


@pytest.mark.parametrize("name", sorted(CASES))
def test_vjp_u0_p_matches_jax(name):
    """(λᵀ dF/du0, λᵀ dF/dp) for the same (u, u0, params, dt, forces, λ)."""
    jm, js0, jp, jf = CASES[name](jpkg)
    tm, ts0, tp, tf = CASES[name](tpkg)
    st = _perturbed(js0)
    rng = np.random.default_rng(5)
    js = jgrad.AdjointStorage(jm, jp, use_stencil=True)
    ts = tgrad.AdjointStorage(tm, tp, use_stencil=True, device="cpu")
    assert set(ts.params_f) == set(js.params_f)
    u = ts.dofs_of(st)
    u0 = ts.dofs_of(ts0)
    lam = rng.normal(size=tuple(u.shape))
    gj = js._vjp_u0_p(jnp.asarray(u.numpy()), jnp.asarray(u0.numpy()),
                      js.params_f, DAY, jf, jnp.asarray(lam))
    gt = ts._vjp_u0_p(u, u0, ts.params_f, DAY, tf, torch.from_numpy(lam))
    assert_close(gt[0].numpy(), np.asarray(gj[0]), 1e-12, "du0")
    for k in ts.params_f:
        assert_close(gt[1][k].numpy(), np.asarray(gj[1][k]), 1e-12, k)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("against", sorted(AGAINST))
def test_lattice_gradients_match_jax(lattice, against):
    """Source term + pressure BC (the state-dependent force diagonal)."""
    check_gradients(lattice, against)


def test_lambda_solves_run_and_are_recorded(lattice):
    tm, ts0, tp, tf = lattice.tcase
    states, dts = lattice.states, lattice.dts
    storage = tgrad.AdjointStorage(tm, tp, linear_solver=solver(tpkg),
                                   use_stencil=True, device="cpu")
    tgrad.solve_adjoint_sensitivities(
        tm, states, dts, G_sat(tpkg), parameters=tp, state0=ts0, forces=tf,
        storage=storage)
    assert len(storage.lambda_iterations) == len(dts)
    assert all(0 < it < 1000 for it in storage.lambda_iterations)
    assert storage.lambda_converged == [True] * len(dts)


def test_jit_and_ministeps_match_jax():
    """tests/test_adjoint.py:421's case forced to cut (max_timestep): the
    eager path with output_substates, flattened by expand_to_ministeps,
    gives the JAX package's dts and states; the gradient of that ministep
    sequence from the port's host loop and _jit equals the JAX package's
    _jit (and its host loop: equal to each other exactly)."""
    jm, js0, jp, jf = sweep_case(jpkg)
    tm, ts0, tp, tf = sweep_case(tpkg)
    dts = [0.1 * DAY, 0.2 * DAY]
    kw = dict(info_level=-1, max_timestep=0.07 * DAY, output_substates=True,
              **TIGHT)
    jres = jpkg.Simulator(jm, state0=js0, parameters=jp,
                          use_stencil=True).simulate(
        dts, forces=jf, linear_solver=solver(jpkg), **kw)
    tres = tpkg.simulate(ts0, tm, dts, forces=tf, parameters=tp,
                         use_stencil=True, device="cpu",
                         linear_solver=solver(tpkg), **kw)
    assert all(r["success"] for r in tres.reports)
    js_, jdt = jpkg.expand_to_ministeps(jres.states, jres.reports)
    ts_, tdt = tpkg.expand_to_ministeps(tres.states, tres.reports)
    assert len(tdt) == len(jdt) > len(dts)
    np.testing.assert_allclose(tdt, jdt, rtol=1e-12)
    for a, b in zip(ts_, js_):
        np.testing.assert_allclose(a["Pressure"], np.asarray(b["Pressure"]),
                                   rtol=1e-10)
        np.testing.assert_allclose(a["Saturations"],
                                   np.asarray(b["Saturations"]), atol=1e-10)
    states = numpy_states(js_)
    G = dict(jax=lambda m, s, dt, n, f: dt * jnp.sum(s["Pressure"] ** 2)
             / (100 * BAR) ** 2,
             torch=lambda m, s, dt, n, f: dt * torch.sum(s["Pressure"] ** 2)
             / (100 * BAR) ** 2)
    ref = jgrad.solve_adjoint_sensitivities_jit(
        jm, states, jdt, G["jax"], parameters=jp, state0=js0, forces=jf,
        use_stencil=True, linear_solver=solver(jpkg), include_state0=True)
    tkw = dict(parameters=tp, state0=ts0, forces=tf, device="cpu",
               linear_solver=solver(tpkg), include_state0=True,
               use_stencil=True)
    jit = tgrad.solve_adjoint_sensitivities_jit(tm, states, jdt,
                                                G["torch"], **tkw)
    host = tgrad.solve_adjoint_sensitivities(tm, states, jdt, G["torch"],
                                             **tkw)
    for k in ("Transmissibilities", "FluidVolume", "state0"):
        assert_close(jit[k], np.asarray(ref[k]), 1e-9, k)
        np.testing.assert_array_equal(jit[k], host[k])


def test_output_substates_refused_on_schedule_path():
    tm, ts0, tp, tf = sweep_case(tpkg)
    sim = tpkg.Simulator(tm, ts0, tp, use_stencil=True, device="cpu")
    with pytest.raises(ValueError, match="output_substates"):
        sim.simulate_jit([DAY], forces=tf, output_substates=True)
    with pytest.raises(ValueError, match="output_substates"):
        sim.simulate([DAY], forces=tf, output_substates=True,
                     jit_timestep=True)
    with pytest.raises(KeyError):
        tpkg.simulator_config(output_substate=True)  # unknown option


# ---------------------------------------------------------------------------
# objectives and the finite-difference checker, on a 3x1x1 lattice
# ---------------------------------------------------------------------------
def tiny_case():
    darcy = importlib.import_module("jutul.jl_tpu_torch.models.darcy")
    mesh = tpkg.CartesianMesh((3, 1, 1), (30.0, 10.0, 10.0))
    model = darcy.setup_darcy_model(
        mesh, darcy.ImmiscibleFluid(viscosities=(1e-3, 2e-3)),
        permeability=np.array([0.2, 0.5, 0.3]) * DARCY, porosity=0.25)
    state0 = tpkg.setup_state(model, Pressure=100 * BAR,
                              Saturations=np.array([[0.3, 0.7]] * 3))
    params = tpkg.setup_parameters(model)
    forces = {"sources": darcy.PhaseSourceTerm(
        [0, 2], np.array([[0.5, 0.0], [-0.2, -0.2]]))}
    dts = [0.5 * DAY, 0.5 * DAY]
    res = tpkg.simulate(state0, model, dts, forces=forces, parameters=params,
                        use_stencil=True, device="cpu", info_level=-1,
                        linear_solver=solver(tpkg, 4), **TIGHT)
    return model, state0, params, forces, dts, res.states


OBS = [np.array([[0.5, 0.5], [0.4, 0.6], [0.3, 0.7]]),
       np.array([[0.6, 0.4], [0.45, 0.55], [0.3, 0.7]])]
OBJECTIVES = {
    "sum": lambda: tpkg.SumObjective(G_sat(tpkg)),
    "global": lambda: tpkg.GlobalObjective(
        lambda m, s, dt, n, f: 1e3 * torch.sum(s["Saturations"][:, 0] ** 3),
        2),
    "l2_misfit": lambda: l2_misfit_objective(
        {"Saturations": OBS}, weights={"Saturations": 2.0}),
}


FD_TARGETS = {"sum": ("FluidVolume", "Transmissibilities"),
              "global": ("FluidVolume",), "l2_misfit": ("FluidVolume",)}


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_objective_gradient_matches_fd_checker(name):
    """The adjoint of each objective kind against
    ``solve_numerical_sensitivities`` on the 3 pore volumes (and, for the
    sum objective, both transmissibilities): central differences at
    relative step 1e-4 (at 1e-6 the difference of a 3e-12
    transmissibility is Newton-tolerance noise)."""
    model, state0, params, forces, dts, states = tiny_case()
    G = OBJECTIVES[name]()
    adj = tgrad.solve_adjoint_sensitivities(
        model, states, dts, G, parameters=params, state0=state0,
        forces=forces, device="cpu", use_stencil=True,
        linear_solver=solver(tpkg, 4))
    fd = tgrad.solve_numerical_sensitivities(
        model, states, dts, G, params, state0, forces=forces,
        targets=FD_TARGETS[name], eps_scale=1e-4, device="cpu",
        use_stencil=True, linear_solver=solver(tpkg, 4), **TIGHT)
    for k in FD_TARGETS[name]:
        assert adj[k].shape == fd[k].shape == np.shape(params[k])
        assert_close(adj[k], fd[k], 1e-6, k)


def test_objectives_evaluate_and_global_zero_steps():
    model, state0, params, forces, dts, states = tiny_case()
    G = OBJECTIVES["l2_misfit"]()
    want = sum(dts[n] * 2.0 * np.sum((states[n]["Saturations"] - OBS[n]) ** 2)
               for n in range(2))
    assert np.isclose(G.evaluate(model, states, dts, forces), want,
                      rtol=1e-14)
    Gg = OBJECTIVES["global"]()
    st = tpkg.from_numpy(states[0], "cpu")
    z = Gg(model, st, dts[0], 0, forces)
    assert float(z) == 0.0 and z.dtype == torch.float64
    # an objective that ignores the state gives a zero gradient, no error
    g = tgrad.solve_adjoint_sensitivities(
        model, states[:1], dts[:1], Gg, parameters=params, state0=state0,
        forces=forces, device="cpu", use_stencil=True,
        linear_solver=solver(tpkg, 4))
    assert not np.any(g["Transmissibilities"]) and not np.any(
        g["FluidVolume"])
    sg = tgrad.state_gradient(model, states[-1], OBJECTIVES["sum"](), params,
                              dt=2.0, device="cpu")
    np.testing.assert_allclose(
        sg["Saturations"][:, 0], 4.0 * states[-1]["Saturations"][:, 0])


# ---------------------------------------------------------------------------
# what is not ported raises
# ---------------------------------------------------------------------------
def test_refusals():
    model, state0, params, forces, dts, states = tiny_case()
    # a λ-solver of the other engine raises, naming the one it needs
    with pytest.raises(TypeError, match="GenericKrylov"):
        tgrad.AdjointStorage(model, params, linear_solver=solver(tpkg, 4),
                             device="cpu")
    # a MultiModel (two uncoupled copies) takes the MultiModel adjoint in
    # both entry points: a finite gradient for each submodel
    mm = tpkg.MultiModel({"a": model, "b": model})
    g = G_sat(tpkg)

    def G_mm(m, state, dt, n, f):
        return g(m, state["a"], dt, n, f) + g(m, state["b"], dt, n, f)

    for fn in (tgrad.solve_adjoint_sensitivities,
               tgrad.solve_adjoint_sensitivities_jit):
        grads = fn(mm, [{"a": s, "b": s} for s in states], dts, G_mm,
                   parameters={"a": params, "b": params},
                   state0={"a": state0, "b": state0},
                   forces={"a": forces, "b": forces}, device="cpu")
        for m in ("a", "b"):
            assert np.all(np.isfinite(grads[m]["Transmissibilities"]))
            assert np.any(grads[m]["Transmissibilities"])
    with pytest.raises(TypeError, match="solve_adjoint_sensitivities"):
        tgrad.AdjointStorage(mm, {"a": params, "b": params}, device="cpu")
    with pytest.raises(TypeError, match="StencilKrylovSolver"):
        tgrad.AdjointStorage(model, params, linear_solver=object(),
                             use_stencil=True, device="cpu")
    sched = [forces, {"other": forces["sources"]}]
    with pytest.raises(NotImplementedError, match="one structure"):
        tgrad.solve_adjoint_sensitivities_jit(
            model, states, dts, G_sat(tpkg), parameters=params,
            state0=state0, forces=sched, use_stencil=True, device="cpu")
