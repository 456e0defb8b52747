"""``DictParameters.optimize`` of the port against the JAX package's on
examples/history_match.py's case (12 cells, a pressure misfit against
observations at perturbed transmissibilities, log-scaled rel 0.1-10), 5
L-BFGS iterations on the default engine with Newton to 1e-10 (see
tests/test_torch_dict_opt.py): the histories (values, projected gradient
norms) and the recovered transmissibilities within 1e-8 relative.
"""

import numpy as np

import jutul.jl_tpu as jpkg
import jutul.jl_tpu_torch as tpkg
from test_torch_dict_opt import KW, _history_match, _misfit


def test_optimize_history_match_matches_jax():
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
        best = dp.optimize(dopt, _misfit(obs, xp), max_iterations=5,
                           sim_kwargs=KW[pkg])
        out[pkg] = (dopt.history, best)
    (hj, bj), (ht, bt) = out[jpkg], out[tpkg]
    assert len(ht.values) == len(hj.values) > 1
    assert ht.values[-1] < ht.values[0]
    for a, b in ((ht.values, hj.values), (ht.grad_norms, hj.grad_norms),
                 (bt["Transmissibilities"], bj["Transmissibilities"])):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.max(np.abs(a - b)) <= 1e-8 * np.max(np.abs(b))
