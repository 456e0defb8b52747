"""Shared Chebyshev relaxation core.

Port of the JAX package's ``linsolve/cheby.py``: the 3-term recurrence
(Saad Alg. 12.1 adapted to a diagonally preconditioned operator) on the
interval [lower*lmax, lmax]. The GMG level kernel K4 (ops/cuda) runs the
same recurrence one step per launch with its per-step scalars taken from
``chebyshev_steps``, which computes them with the recurrence's own
operations; ``chebyshev_recurrence`` is the reference those level hooks
are held to.

Convention for zero/dead diagonal rows: dinv = 0 (the row never
updates), matching the kernels.
"""
from __future__ import annotations

import torch


def chebyshev_recurrence(prec_residual, rhs_prec0, u0, n_sweep: int,
                         lmax, lower: float = 0.25):
    """``n_sweep`` Chebyshev steps on the interval [lower*lmax, lmax].

    ``prec_residual(u)`` returns the diagonally preconditioned residual
    D^-1 (rhs - A u); ``rhs_prec0`` is its value at u = 0 (usually just
    ``dinv * rhs``). ``u0=None`` starts from zero.
    """
    lmin = lower * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = rhs_prec0 if u0 is None else prec_residual(u0)
    d = r / theta
    u = d if u0 is None else u0 + d
    for _ in range(1, n_sweep):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = prec_residual(u)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        u = u + d
        rho = rho_new
    return u


def chebyshev_steps(lmax, lower: float, n_sweep: int):
    """The recurrence's per-step scalars for ``n_sweep`` steps, computed
    on ``lmax``'s device in its dtype with ``chebyshev_recurrence``'s
    operations (no host sync). ``lmax`` may carry leading batch axes
    (one entry per GMG level); the result is ``lmax.shape + (n_sweep, 2)``
    with row 0 = (theta, 0) for the first step and row k >= 1 =
    (rho_k * rho_{k-1}, 2 rho_k / delta): step k updates
    ``d = row[0] * d + row[1] * dinv (b - A u)``."""
    lmin = lower * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    rows = [torch.stack([theta, torch.zeros_like(theta)], dim=-1)]
    for _ in range(1, n_sweep):
        rho_new = 1.0 / (2.0 * sigma - rho)
        rows.append(torch.stack([rho_new * rho, 2.0 * rho_new / delta],
                                dim=-1))
        rho = rho_new
    return torch.stack(rows, dim=-2)
