"""Objective functions for adjoints and optimization.

Port of the JAX package's ``adjoint/objectives.py`` (reference:
src/core_types/core_types.jl:1582-1649 ``AbstractSumObjective`` — a sum over
steps of G(model, state, dt, step_info, forces) — against
``AbstractGlobalObjective``; auto-wrapping in src/ad/objectives.jl).

The callable signature throughout is the sum-objective form:
``G(model, state, dt, step_no, forces) -> 0-d tensor``, where ``state``
holds tensors (primaries, parameters and secondaries).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.setup import from_numpy


class SumObjective:
    """Σ_n g(model, state_n, dt_n, n, forces) (reference core_types.jl:1582).

    Wraps a per-step callable; instances are usable wherever a ``G`` is
    expected."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, model, state, dt, step_no, forces):
        return self.fn(model, state, dt, step_no, forces)

    def evaluate(self, model, states, dts, forces=None, device="cpu",
                 dtype=None) -> float:
        """The sum over ``states`` (dicts of arrays, e.g. ``simulate``'s
        output states), each placed on ``device`` in ``dtype``."""
        tot = 0.0
        for n, st in enumerate(states):
            f = forces[n] if isinstance(forces, list) else forces
            tot += float(self(model, from_numpy(st, device, dtype),
                              float(dts[n]), n, f))
        return tot


class GlobalObjective(SumObjective):
    """G evaluated on the FINAL state only (reference
    AbstractGlobalObjective). The per-step view is a zero tensor except at
    the last step; the adjoint takes an objective that does not depend on
    the state as a zero gradient."""

    def __init__(self, fn: Callable, n_steps: int):
        self.fn = fn
        self.n_steps = int(n_steps)

    def __call__(self, model, state, dt, step_no, forces):
        if step_no != self.n_steps - 1:
            return next(iter(state.values())).new_zeros(())
        return self.fn(model, state, dt, step_no, forces)


def l2_misfit_objective(observations: dict, weights: dict | None = None):
    """Σ_n dt Σ_k w_k ||x_k − obs_k||², the standard history-match misfit.

    ``observations``: name -> list over steps of arrays (numpy or
    tensors), moved to each state's device and dtype."""
    weights = weights or {}

    def G(model, state, dt, step_no, forces):
        tot = 0.0
        for name, obs in observations.items():
            w = weights.get(name, 1.0)
            x = state[name]
            d = x - torch.as_tensor(obs[step_no], dtype=x.dtype,
                                    device=x.device)
            tot = tot + w * torch.sum(d * d)
        return dt * tot

    return SumObjective(G)
