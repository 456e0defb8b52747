"""DictParameters: high-level dictionary-addressed optimization.

Port of the JAX package's ``adjoint/dict_opt.py`` (numpy bookkeeping; the
simulations and gradients go through the port's ``simulate`` and adjoint,
placed by ``sim_kwargs``' ``device`` and ``dtype``). Counterpart of the reference DictOptimization module (reference:
src/DictOptimization/ — ``DictParameters`` types.jl:51-284, ``optimize``
interface.jl:102-560, ``parameters_gradient`` optimization.jl:446,
``free_optimization_parameter!``/``freeze_optimization_parameter!``).

Parameters are addressed by nested-dict paths (tuples of keys); freeing a
parameter registers limits/scaler/lumping; ``optimize`` maps the free set
into the unit box and drives :func:`unit_box_bfgs`. The setup function turns
the (possibly nested) parameter dict into a :class:`JutulCase`; gradients
flow through the adjoint (``_case_objective_and_gradient``); a setup map
that is not the identity on the model parameters goes through
``solve_adjoint_generic``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np


def _get_path(d: dict, path: tuple):
    for k in path:
        d = d[k]
    return d


def _set_path(d: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        d = d[k]
    d[path[-1]] = value


def _copy_nested(d):
    if isinstance(d, dict):
        return {k: _copy_nested(v) for k, v in d.items()}
    return np.array(d, dtype=np.float64)


@dataclass
class FreeParameter:
    path: tuple
    low: float
    high: float
    scaler: str = "linear"
    lumping: np.ndarray | None = None  # int groups over the flat entries

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
        if self.scaler == "log":
            return v * (np.log(self.high) - np.log(self.low))
        return self.high - self.low


class DictParameters:
    """Reference DictOptimization.DictParameters equivalent."""

    def __init__(self, parameters: dict, setup_function: Callable | None = None,
                 strict: bool = True, verbose: bool = True):
        self.parameters = _copy_nested(parameters)
        self.setup_function = setup_function
        self.strict = strict
        self.verbose = verbose
        self.free: dict[tuple, FreeParameter] = {}
        self.history = None

    # -- parameter bookkeeping ----------------------------------------
    def _norm_path(self, path) -> tuple:
        if isinstance(path, (str, int)):
            return (path,)
        return tuple(path)

    def free_optimization_parameter(self, path, rel_min=None, rel_max=None,
                                    abs_min=None, abs_max=None,
                                    scaler=None, lumping=None):
        """Mark a parameter (by nested path) as free
        (reference interface.jl free_optimization_parameter!)."""
        path = self._norm_path(path)
        base = np.asarray(_get_path(self.parameters, path), dtype=np.float64)
        lo_candidates = []
        hi_candidates = []
        if abs_min is not None:
            lo_candidates.append(abs_min)
        if abs_max is not None:
            hi_candidates.append(abs_max)
        if rel_min is not None:
            lo_candidates.append(float(base.min()) * rel_min)
        if rel_max is not None:
            hi_candidates.append(float(base.max()) * rel_max)
        if not lo_candidates or not hi_candidates:
            if np.all(base > 0):
                lo_candidates.append(float(base.min()) * 0.1)
                hi_candidates.append(float(base.max()) * 10.0)
            else:
                span = max(float(np.abs(base).max()), 1.0)
                lo_candidates.append(float(base.min()) - span)
                hi_candidates.append(float(base.max()) + span)
        lo = max(lo_candidates)
        hi = min(hi_candidates)
        if scaler is None:
            scaler = "log" if lo > 0 and hi / max(lo, 1e-300) > 100 else "linear"
        if lumping is not None:
            lumping = np.asarray(lumping, dtype=np.int64).reshape(-1)
        self.free[path] = FreeParameter(path, lo, hi, scaler, lumping)

    def freeze_optimization_parameter(self, path):
        self.free.pop(self._norm_path(path), None)

    # -- vectorization ------------------------------------------------
    def _flat_info(self):
        info = []
        ofs = 0
        for path, fp in self.free.items():
            base = np.asarray(_get_path(self.parameters, path))
            if fp.lumping is not None:
                n = int(fp.lumping.max()) + 1
            else:
                n = base.size
            info.append((path, fp, base.shape, ofs, n))
            ofs += n
        return info, ofs

    def vectorize(self) -> np.ndarray:
        info, n = self._flat_info()
        x = np.zeros(n)
        for path, fp, shape, ofs, sz in info:
            v = np.asarray(_get_path(self.parameters, path),
                           dtype=np.float64).reshape(-1)
            if fp.lumping is not None:
                # representative value per lump (mean)
                sums = np.bincount(fp.lumping, weights=v, minlength=sz)
                cnts = np.bincount(fp.lumping, minlength=sz)
                v = sums / np.maximum(cnts, 1)
            x[ofs:ofs + sz] = fp.to_unit(v)
        return np.clip(x, 0.0, 1.0)

    def devectorize(self, x: np.ndarray) -> dict:
        out = _copy_nested(self.parameters)
        info, _ = self._flat_info()
        for path, fp, shape, ofs, sz in info:
            u = x[ofs:ofs + sz]
            v = fp.from_unit(u)
            if fp.lumping is not None:
                v = v[fp.lumping]
            _set_path(out, path, v.reshape(shape))
        return out

    def gradient_to_unit(self, grads: dict, x: np.ndarray) -> np.ndarray:
        info, n = self._flat_info()
        g = np.zeros(n)
        for path, fp, shape, ofs, sz in info:
            gv = np.asarray(_get_path(grads, path), dtype=np.float64).reshape(-1)
            u = x[ofs:ofs + sz]
            v = fp.from_unit(u)
            if fp.lumping is not None:
                gv = np.bincount(fp.lumping, weights=gv, minlength=sz)
            g[ofs:ofs + sz] = gv * fp.chain(v if fp.lumping is None else v)
        return g

    # -- optimize ------------------------------------------------------
    def optimize(self, objective, setup_function: Callable | None = None,
                 max_iterations: int = 25, maximize: bool = False,
                 grad_tol: float = 1e-8, sim_kwargs: dict | None = None,
                 optimizer: str = "lbfgs"):
        """Run unit-box LBFGS (reference interface.jl:102 ``optimize``;
        ``optimizer="lbfgsb"`` selects the scipy L-BFGS-B binding,
        ``optimizer="trust_region"`` the Steihaug-CG trust-region — the
        reference's LBFGSB extension).

        ``setup_function(parameters_dict) -> JutulCase``;
        ``objective(model, state, dt, step_no, forces) -> scalar``.
        Returns the optimized nested parameter dict (and stores history).
        """
        from .lbfgs import lbfgsb_optimize, unit_box_bfgs
        from .trust_region import box_trust_region
        from .optimization import _case_objective_and_gradient

        setup_function = setup_function or self.setup_function
        if setup_function is None:
            raise ValueError("a setup_function is required")
        sim_kwargs = sim_kwargs or {}

        def f_and_g(x):
            params = self.devectorize(x)
            v, grads = _case_objective_and_gradient(
                setup_function, params, objective, list(self.free),
                sim_kwargs)
            return v, self.gradient_to_unit(grads, x)

        x0 = self.vectorize()
        opt_fn = {"lbfgs": unit_box_bfgs, "lbfgsb": lbfgsb_optimize,
                  "trust_region": box_trust_region}[optimizer]
        v, x, hist = opt_fn(
            x0, f_and_g, maximize=maximize, max_iterations=max_iterations,
            grad_tol=grad_tol, verbose=self.verbose)
        self.history = hist
        best = self.devectorize(x)
        self.parameters = best
        return best

    def parameters_gradient(self, objective, setup_function=None,
                            sim_kwargs=None):
        """Gradient of the objective wrt the free parameters
        (reference DictOptimization parameters_gradient)."""
        from .optimization import _case_objective_and_gradient

        setup_function = setup_function or self.setup_function
        v, grads = _case_objective_and_gradient(
            setup_function, self.parameters, objective, list(self.free),
            sim_kwargs or {})
        return grads


# -- reference-compatible free functions ------------------------------
# (the reference exports these as functions taking the DictParameters
# first: free_optimization_parameter! interface.jl, optimize
# interface.jl:102, parameters_gradient optimization.jl:446)

def optimize(dopt: DictParameters, objective, setup_function=None, **kwargs):
    """Free-function form of :meth:`DictParameters.optimize`."""
    return dopt.optimize(objective, setup_function, **kwargs)


def free_optimization_parameter(dopt: DictParameters, path, **kwargs):
    """Free-function form of
    :meth:`DictParameters.free_optimization_parameter`."""
    return dopt.free_optimization_parameter(path, **kwargs)


def freeze_optimization_parameter(dopt: DictParameters, path):
    """Free-function form of
    :meth:`DictParameters.freeze_optimization_parameter`."""
    return dopt.freeze_optimization_parameter(path)


def parameters_gradient(dopt: DictParameters, objective,
                        setup_function=None, sim_kwargs=None):
    """Free-function form of :meth:`DictParameters.parameters_gradient`."""
    return dopt.parameters_gradient(objective, setup_function, sim_kwargs)


class DictParametersSampler:
    """Sampling/uncertainty-quantification helper over a
    :class:`DictParameters` free set (reference:
    src/DictOptimization/uq.jl + the ``DictParametersSampler`` struct,
    types.jl:123-147).

    ``sampler(x)`` simulates the case built from the unit-box vector
    ``x`` (same parameterization as ``optimize``: every free parameter
    mapped through its scaler/limits) and returns
    ``output_function(case, states, reports)``; with an ``objective`` it
    returns ``{"output": ..., "objective": ...}``. A matrix ``x``
    (n_params, n_samples) simulates each column — the reference's
    ensemble loop — returning a list."""

    def __init__(self, dopt: DictParameters, output_function=None,
                 objective=None, sim_kwargs: dict | None = None):
        if not dopt.free:
            raise ValueError("no free parameters to sample over")
        if dopt.setup_function is None:
            raise ValueError("DictParameters needs a setup_function")
        self.dopt = dopt
        self.output_function = (output_function if output_function
                                is not None
                                else (lambda case, states, reports: states))
        self.objective = objective
        self.sim_kwargs = sim_kwargs or {}

    def n_parameters(self) -> int:
        return self.dopt.vectorize().size

    def sample_prior(self, n_samples: int, rng=None) -> np.ndarray:
        """(n_params, n_samples) uniform unit-box samples around the
        current parameters' feasible box."""
        rng = np.random.default_rng(rng)
        return rng.uniform(0.0, 1.0, (self.n_parameters(), n_samples))

    def __call__(self, x: np.ndarray, info_level: int = 1):
        from ..simulator.simulator import simulate

        x = np.asarray(x, dtype=np.float64)
        if x.ndim == 2:
            out = []
            for i in range(x.shape[1]):
                if info_level > 0:
                    print(f"Simulating parameter set {i + 1}/{x.shape[1]}")
                out.append(self(x[:, i], info_level=0))
            return out
        params = self.dopt.devectorize(x)
        case = self.dopt.setup_function(params)
        states, reports = simulate(
            dict(case.state0), case.model, case.dt, forces=case.forces,
            parameters=case.parameters, info_level=-1, **self.sim_kwargs)
        qoi = self.output_function(case, states, reports)
        if self.objective is None:
            return qoi
        from ..models.setup import from_numpy

        dev, dtype = self.sim_kwargs.get("device"), self.sim_kwargs.get(
            "dtype")
        total = 0.0
        for n_step, st in enumerate(states):
            dt = float(case.dt[n_step])
            # Simulator.simulate treats BOTH list and tuple forces as
            # per-step schedules — mirror that here or the objective sees
            # the whole schedule instead of step n's forces
            f = (case.forces[n_step]
                 if isinstance(case.forces, (list, tuple))
                 else case.forces)
            total += float(self.objective(
                case.model, from_numpy(st, dev, dtype), dt, n_step, f))
        return {"output": qoi, "objective": total}
