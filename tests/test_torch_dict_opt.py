"""``DictParameters`` (adjoint/dict_opt.py) of the port against the JAX
package's, on the CPU at f64.

- the bookkeeping (numpy in both packages, the port's a copy):
  ``vectorize``, ``devectorize`` and ``gradient_to_unit`` bit for bit on
  nested paths with log and linear scalers, absolute and relative limits
  and lumping; ``freeze_optimization_parameter`` and the free functions;
- ``parameters_gradient`` on examples/history_match.py's case (12 cells,
  a pressure misfit against observations at perturbed
  transmissibilities) within 1e-8 relative; ``optimize`` there:
  tests/test_torch_dict_opt_history.py;
- ``DictParametersSampler``: the same prior samples, and for each sample
  the same output states and objective.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from test_torch_defaults import BAR, history_match_case

# Newton to 1e-10 in both packages: at the examples' default tolerances
# the states of the two packages' forwards agree to 1e-12 relative, which
# a pressure misfit (p - p_obs, ~1e-3 of p) turns into objectives 1e-9
# apart and L-BFGS histories 2e-8 apart after 5 iterations
TIGHT = {"tolerances": {"mass_conservation": 1e-9},
         "max_nonlinear_iterations": 30}
KW = {jpkg: TIGHT, tpkg: {"device": "cpu", **TIGHT}}


def _dopt(pkg):
    dp = importlib.import_module(pkg.__name__ + ".adjoint.dict_opt")
    rng = np.random.default_rng(3)
    params = {"rock": {"perm": rng.uniform(1.0, 500.0, 12),
                       "poro": rng.uniform(0.1, 0.3, 12)},
              "well": {"rate": np.array([0.2, -0.5, 1.5])},
              "scalar": 2.5}
    d = dp.DictParameters(params, verbose=False)
    d.free_optimization_parameter(("rock", "perm"), rel_min=0.1,
                                  rel_max=10.0)
    d.free_optimization_parameter(("rock", "poro"), abs_min=0.05,
                                  abs_max=0.4, lumping=np.arange(12) % 4)
    dp.free_optimization_parameter(d, ("well", "rate"))
    dp.free_optimization_parameter(d, "scalar", scaler="log", rel_min=0.5,
                                   rel_max=2.0)
    return dp, d, rng


def test_vectorize_devectorize_gradient_bitwise():
    out = {}
    for pkg in (jpkg, tpkg):
        dp, d, rng = _dopt(pkg)
        x = d.vectorize()
        back = d.devectorize(x)
        grads = {"rock": {"perm": rng.normal(size=12),
                          "poro": rng.normal(size=12)},
                 "well": {"rate": rng.normal(size=3)},
                 "scalar": np.asarray(rng.normal())}
        g = d.gradient_to_unit(grads, x)
        dp.freeze_optimization_parameter(d, ("well", "rate"))
        out[pkg] = (x, back, g, d.vectorize(),
                    {p: (f.low, f.high, f.scaler) for p, f in d.free.items()})
    (xj, bj, gj, fj, lj), (xt, bt, gt, ft, lt) = out[jpkg], out[tpkg]
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_array_equal(ft, fj)
    assert lt == lj
    for path in (("rock", "perm"), ("rock", "poro"), ("well", "rate"),
                 ("scalar",)):
        a, b = bt, bj
        for k in path:
            a, b = a[k], b[k]
        np.testing.assert_array_equal(a, b)


def _history_match(pkg):
    """examples/history_match.py's DictParameters workflow in ``pkg``."""
    xp = jnp if pkg is jpkg else torch
    dp = importlib.import_module(pkg.__name__ + ".adjoint.dict_opt")
    model, st, pr, f, dts = history_match_case(pkg)
    truth = np.asarray(pr["Transmissibilities"]) * np.random.default_rng(
        0).uniform(0.5, 2.0, np.shape(pr["Transmissibilities"]))

    def setup(params):
        m, s0, p, forces, dt = history_match_case(pkg)
        p["Transmissibilities"] = np.asarray(params["Transmissibilities"])
        return pkg.JutulCase(m, dt, forces, state0=s0, parameters=p)

    obs = None
    if pkg is jpkg:  # observations from the JAX package's forward
        obs = [np.array(s["Pressure"]) for s in pkg.simulate(
            setup({"Transmissibilities": truth}), info_level=-1,
            **KW[pkg]).states]
    return dp, setup, pr, obs, xp


def _misfit(obs, xp):
    def misfit(model, state, dt, n_step, forces):
        d = (state["Pressure"] - xp.asarray(obs[n_step])) / BAR
        return dt * xp.sum(d * d)
    return misfit


def test_parameters_gradient_matches_jax():
    out = {}
    obs = None
    for pkg in (jpkg, tpkg):
        dp, setup, pr, obs_pkg, xp = _history_match(pkg)
        obs = obs if obs is not None else obs_pkg
        dopt = dp.DictParameters(
            {"Transmissibilities": pr["Transmissibilities"]}, setup,
            verbose=False)
        dopt.free_optimization_parameter("Transmissibilities", rel_min=0.1,
                                         rel_max=10.0, scaler="log")
        out[pkg] = dp.parameters_gradient(dopt, _misfit(obs, xp),
                                          sim_kwargs=KW[pkg])
    a = out[tpkg]["Transmissibilities"]
    b = out[jpkg]["Transmissibilities"]
    assert np.max(np.abs(a - b)) <= 1e-8 * np.max(np.abs(b))


def test_sampler_matches_jax():
    out = {}
    obs = None
    for pkg in (jpkg, tpkg):
        dp, setup, pr, obs_pkg, xp = _history_match(pkg)
        obs = obs if obs is not None else obs_pkg
        dopt = dp.DictParameters(
            {"Transmissibilities": pr["Transmissibilities"]}, setup,
            verbose=False)
        dopt.free_optimization_parameter("Transmissibilities", rel_min=0.5,
                                         rel_max=2.0)
        sampler = dp.DictParametersSampler(
            dopt, output_function=lambda case, states, reports: [
                np.asarray(s["Saturations"]) for s in states],
            objective=_misfit(obs, xp), sim_kwargs=KW[pkg])
        X = sampler.sample_prior(2, rng=11)
        out[pkg] = (X, sampler(X, info_level=0))
    np.testing.assert_array_equal(out[tpkg][0], out[jpkg][0])
    for a, b in zip(out[tpkg][1], out[jpkg][1]):
        assert abs(a["objective"] - b["objective"]) <= 1e-10 * abs(
            b["objective"])
        for sa, sb in zip(a["output"], b["output"]):
            assert np.max(np.abs(sa - sb)) <= 1e-12


def test_dict_parameters_requires_setup():
    for pkg in (jpkg, tpkg):
        dp = importlib.import_module(pkg.__name__ + ".adjoint.dict_opt")
        d = dp.DictParameters({"a": np.ones(2)}, verbose=False)
        with pytest.raises(ValueError, match="setup_function"):
            d.optimize(lambda *a: 0.0)
        with pytest.raises(ValueError, match="no free parameters"):
            dp.DictParametersSampler(d)
