"""Generic adjoints through arbitrary setup functions.

Port of the JAX package's ``adjoint/generic.py``. Counterpart of the
reference AdjointsDI module (reference: src/ad/AdjointsDI/adjoints.jl —
``solve_adjoint_generic`` :4, ``setup_adjoint_storage_generic`` :149,
``evaluate_residual_and_jacobian_for_state_pair`` :518; used by
DictParameters.optimize when parameters enter through case setup rather
than as model parameters).

The setup map ``x -> (state0, parameters)`` is a torch-differentiable
function, so its exact reverse-mode pullback is ONE ``torch.func.vjp`` —
composed with the discrete adjoint's parameter and initial-state
gradients (the state0 cotangent first goes back through ``get_dofs``,
another vjp).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..dtypes import float_type, resolve_device
from ..models.setup import from_numpy
from ..ops.assembly import compile_model
from .gradients import _forces_for, solve_adjoint_sensitivities


def _tree_map(fn, x):
    """``fn`` over the leaves of a dict / list / tuple tree."""
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def solve_adjoint_generic(
    x,
    setup_fn: Callable,
    model,
    dts,
    G: Callable,
    forces=None,
    states: list | None = None,
    sim_kwargs: dict | None = None,
    device=None,
    dtype=None,
):
    """∇_x G where (state0, parameters) = setup_fn(x)
    (reference solve_adjoint_generic, AdjointsDI/adjoints.jl:4).

    ``setup_fn`` maps the tree ``x`` (a tensor, or a dict/list of them;
    numpy is accepted and moved to ``device``/``dtype``) to the pair
    ``(state0_dict, parameters_dict)`` of tensors, differentiably. If
    ``states`` is None the forward simulation (``simulate`` with
    ``sim_kwargs``) is run first. The adjoint runs with its defaults, as
    in the JAX package. Returns (objective value, numpy gradient tree like
    ``x``)."""
    from ..simulator.simulator import simulate

    dev = resolve_device(device)
    dtype = dtype or float_type(dev)

    def to_t(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype=dtype, device=dev)
        return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                               device=dev)

    def to_np(v):
        return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))

    x = _tree_map(to_t, x)
    with torch.no_grad():
        state0, parameters = setup_fn(x)
    state0_np = {k: to_np(v) for k, v in state0.items()}
    params_np = {k: to_np(v) for k, v in parameters.items()}
    dts = np.atleast_1d(np.asarray(dts, dtype=np.float64))
    if states is None:
        states, _ = simulate(dict(state0_np), model, dts, forces=forces,
                             parameters=params_np, info_level=-1, device=dev,
                             dtype=dtype, **(sim_kwargs or {}))

    total = 0.0
    for n, st in enumerate(states):
        total += float(G(model, from_numpy(st, dev, dtype), float(dts[n]), n,
                         _forces_for(forces, n)))

    # the standard adjoint: gradients wrt the parameters and state0's dofs
    adj = solve_adjoint_sensitivities(
        model, states, dts, G, parameters=params_np, state0=state0_np,
        forces=forces, include_state0=True, device=dev, dtype=dtype)
    dstate0_dofs = torch.as_tensor(adj.pop("state0"), dtype=dtype,
                                   device=dev)

    # the dof-space state0 cotangent back to state-dict cotangents
    comp = compile_model(model)
    prim0 = {k: to_t(state0[k]) for k in model.primary_variables}
    _, pull_state0 = torch.func.vjp(comp.get_dofs, prim0)
    (dstate0,) = pull_state0(dstate0_dofs)

    # everything back through the setup map: only the float entries the
    # adjoint produced cotangents for
    def setup_pair(x_):
        s0, p = setup_fn(x_)
        s0 = {k: s0[k] for k in dstate0 if k in s0}
        p = {k: p[k] for k in adj if k in p and isinstance(p[k], torch.Tensor)
             and p[k].is_floating_point()}
        return s0, p

    (s0_out, p_out), pull = torch.func.vjp(setup_pair, x)
    cot_s0 = {k: dstate0[k].to(v.dtype).reshape(v.shape)
              for k, v in s0_out.items()}
    cot_p = {k: torch.as_tensor(adj[k], dtype=v.dtype,
                                device=v.device).reshape(v.shape)
             for k, v in p_out.items()}
    (dx,) = pull((cot_s0, cot_p))
    return total, _tree_map(to_np, dx)
