"""Parameter-optimization harness.

Port of the JAX package's ``adjoint/optimization.py`` (reference:
src/simulator/optimization.jl — ``setup_parameter_optimization`` :40-157
returning F!/dF!/F_and_dF! closures + box limits + x0, with forward-sim
and adjoint-storage caching; ``optimization_config`` :319 with
per-parameter rel/abs limits and linear/log scalers).

The closures drive the port's ``simulate`` (the eager path) and its
adjoint, on the generic engine by default as in the JAX package (a
``use_stencil`` in the harness's keywords reaches both); the [0,1] box
mapping with linear/log scaling matches the reference.
``_case_objective_and_gradient`` is the value-and-gradient of
``DictParameters`` (``dict_opt.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.setup import from_numpy
from ..simulator.simulator import simulate
from .gradients import AdjointStorage, solve_adjoint_sensitivities


@dataclass
class ParameterTarget:
    name: str
    low: float
    high: float
    scaler: str = "linear"  # or "log"

    def to_unit(self, v):
        if self.scaler == "log":
            lo, hi = np.log(self.low), np.log(self.high)
            return (np.log(v) - lo) / (hi - lo)
        return (v - self.low) / (self.high - self.low)

    def from_unit(self, u):
        u = np.clip(u, 0.0, 1.0)
        if self.scaler == "log":
            lo, hi = np.log(self.low), np.log(self.high)
            return np.exp(lo + u * (hi - lo))
        return self.low + u * (self.high - self.low)

    def chain(self, v):
        """d(value)/d(unit) evaluated at value v."""
        if self.scaler == "log":
            return v * (np.log(self.high) - np.log(self.low))
        return self.high - self.low


def optimization_config(model, parameters: dict, targets=None,
                        rel_min: float = 0.1, rel_max: float = 10.0,
                        scalers: dict | None = None) -> dict:
    """Per-parameter optimization metadata (reference optimization.jl:319).

    Default limits are relative to the initial values, like the
    reference's ``rel_min``/``rel_max``."""
    cfg = {}
    scalers = scalers or {}
    names = targets if targets is not None else list(parameters)
    for name in names:
        base = np.asarray(parameters[name], dtype=np.float64)
        pos = np.all(base > 0)
        scaler = scalers.get(name, "log" if pos and base.max() / max(
            base.min(), 1e-300) > 1e2 else "linear")
        lo = float(base.min()) * rel_min if pos else float(base.min()) - (
            rel_max - 1) * max(abs(float(base.min())), 1.0)
        hi = float(base.max()) * rel_max if pos else float(base.max()) + (
            rel_max - 1) * max(abs(float(base.max())), 1.0)
        if lo == hi:
            hi = lo + 1.0
        cfg[name] = ParameterTarget(name, lo, hi, scaler)
    return cfg


class ParameterOptimization:
    """Closures + state for external optimizers (reference
    setup_parameter_optimization return value).

    ``sim_kwargs`` go to the port's ``simulate``, ``device``, ``dtype``
    and ``use_stencil`` among them (they also place the adjoint and pick
    its engine: the generic one by default, as in the JAX package);
    ``adjoint_linear_solver`` is the λ-solver (a ``GenericKrylov`` or None
    on the generic engine, a ``StencilKrylovSolver`` on the stencil one).
    The forward run and the ``AdjointStorage`` are cached between
    optimizer calls, as the reference does: a repeated ``x`` costs
    nothing, and the storage is built once. ``evaluations`` counts
    forward runs."""

    def __init__(self, case, G, config: dict, sim_kwargs: dict):
        self.case = case
        self.G = G
        self.config = config
        self.sim_kwargs = dict(info_level=-1, **sim_kwargs)
        self._adj_solver = self.sim_kwargs.pop("adjoint_linear_solver", None)
        self.device = self.sim_kwargs.get("device")
        self.dtype = self.sim_kwargs.get("dtype")
        self.use_stencil = self.sim_kwargs.get("use_stencil", False)
        self.names = list(config)
        self._sizes = {n: np.asarray(case.parameters[n]).size
                       for n in self.names}
        self._shapes = {n: np.asarray(case.parameters[n]).shape
                        for n in self.names}
        self.n = sum(self._sizes.values())
        self._cache_x = None
        self._cache = None  # (value, grad, states)
        self._adj_storage = None
        self.evaluations = 0

    # -- vector <-> parameter dict ------------------------------------
    def devectorize(self, x: np.ndarray) -> dict:
        params = {k: np.array(v, dtype=np.float64)
                  for k, v in self.case.parameters.items()}
        ofs = 0
        for n in self.names:
            sz = self._sizes[n]
            params[n] = self.config[n].from_unit(
                x[ofs:ofs + sz]).reshape(self._shapes[n])
            ofs += sz
        return params

    def vectorize(self, params: dict) -> np.ndarray:
        return np.concatenate([
            self.config[n].to_unit(np.asarray(params[n], dtype=np.float64)
                                   ).reshape(-1)
            for n in self.names
        ]) if self.names else np.zeros(0)

    def x0(self) -> np.ndarray:
        return np.clip(self.vectorize(self.case.parameters), 0.0, 1.0)

    # -- objective / gradient -----------------------------------------
    def _evaluate(self, x: np.ndarray, need_grad: bool):
        if self._cache_x is not None and np.array_equal(x, self._cache_x) \
                and (not need_grad or self._cache[1] is not None):
            return
        params = self.devectorize(x)
        case = self.case
        states, _ = simulate(dict(case.state0), case.model, case.dt,
                             forces=case.forces, parameters=params,
                             **self.sim_kwargs)
        self.evaluations += 1
        total = 0.0
        for n_step, st in enumerate(states):
            f = case.forces[n_step] if isinstance(case.forces, list) \
                else case.forces
            total += float(self.G(case.model,
                                  from_numpy(st, self.device, self.dtype),
                                  float(case.dt[n_step]), n_step, f))
        grad = None
        if need_grad:
            if self._adj_storage is None:
                self._adj_storage = AdjointStorage(
                    case.model, params, linear_solver=self._adj_solver,
                    use_stencil=self.use_stencil, device=self.device,
                    dtype=self.dtype)
            adj = solve_adjoint_sensitivities(
                case.model, states, case.dt, self.G, parameters=params,
                state0=case.state0, forces=case.forces,
                storage=self._adj_storage)
            grad = np.concatenate([
                np.asarray(adj[n], dtype=np.float64).reshape(-1)
                * self.config[n].chain(np.asarray(
                    params[n], dtype=np.float64).reshape(-1))
                for n in self.names]) if self.names else np.zeros(0)
        self._cache_x = x.copy()
        self._cache = (total, grad, states)

    def F(self, x: np.ndarray) -> float:
        self._evaluate(np.asarray(x, dtype=np.float64), need_grad=False)
        return self._cache[0]

    def dF(self, x: np.ndarray) -> np.ndarray:
        self._evaluate(np.asarray(x, dtype=np.float64), need_grad=True)
        return self._cache[1]

    def F_and_dF(self, x: np.ndarray):
        self._evaluate(np.asarray(x, dtype=np.float64), need_grad=True)
        return self._cache[0], self._cache[1]


def setup_parameter_optimization(case, G, config: dict | None = None,
                                 targets=None, **sim_kwargs):
    """Build the optimization closures (reference optimization.jl:40).

    Returns a :class:`ParameterOptimization` with ``F``, ``dF``,
    ``F_and_dF``, ``x0()`` and the unit-box convention."""
    if config is None:
        config = optimization_config(case.model, case.parameters,
                                     targets=targets)
    return ParameterOptimization(case, G, config, sim_kwargs)


def _case_objective_and_gradient(setup_function, params_nested, objective,
                                 free_paths, sim_kwargs):
    """Forward simulate a case built from a nested parameter dict and return
    (objective value, nested gradient dict for the free paths).

    The case's model parameters are the nested leaves themselves (possibly
    under nested keys whose LAST component is the model parameter name),
    the reference's common case; the general x -> case chain rule is
    ``solve_adjoint_generic`` (generic.py). ``sim_kwargs`` go to
    ``simulate``; their ``device``, ``dtype`` and ``use_stencil`` also
    place the adjoint (the generic engine by default, as in the JAX
    package)."""
    from .dict_opt import _copy_nested, _get_path, _set_path

    case = setup_function(params_nested)
    states, _ = simulate(dict(case.state0), case.model, case.dt,
                         forces=case.forces, parameters=case.parameters,
                         info_level=-1, **sim_kwargs)
    dev, dtype = sim_kwargs.get("device"), sim_kwargs.get("dtype")
    total = 0.0
    for n_step, st in enumerate(states):
        f = case.forces[n_step] if isinstance(case.forces, list) \
            else case.forces
        total += float(objective(case.model, from_numpy(st, dev, dtype),
                                 float(case.dt[n_step]), n_step, f))
    adj = solve_adjoint_sensitivities(
        case.model, states, case.dt, objective, parameters=case.parameters,
        state0=case.state0, forces=case.forces,
        use_stencil=sim_kwargs.get("use_stencil", False), device=dev,
        dtype=dtype)
    grads = _copy_nested(params_nested)

    def zero(d):  # zero everything, then fill the free paths
        for k in d:
            if isinstance(d[k], dict):
                zero(d[k])
            else:
                d[k] = np.zeros_like(np.asarray(d[k], dtype=np.float64))

    zero(grads)
    for path in free_paths:
        name = path[-1]
        if name not in adj:
            raise KeyError(
                f"free parameter path {path} does not end in a model "
                f"parameter (known: {sorted(adj)}); use the generic adjoint "
                "for derived parameters")
        base = np.asarray(_get_path(params_nested, path))
        _set_path(grads, path, np.asarray(adj[name]).reshape(base.shape))
    return total, grads
