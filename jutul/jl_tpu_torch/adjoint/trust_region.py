"""Bound-constrained trust-region optimizer on the unit box.

A copy of the JAX package's ``adjoint/trust_region.py`` (numpy only).
Companion to :mod:`lbfgs` (reference: src/LBFGS/constrained_optimizer.jl:62
offers line-search unit-box BFGS; this module provides the trust-region
variant for problems where line searches stall — same `f_and_g` contract and
history convention, so it is a drop-in for `unit_box_bfgs`).

Design: limited-memory BFGS *Hessian* (not inverse) in the compact
Byrd–Nocedal–Schnabel representation B = g0*I - U M^-1 U^T, Steihaug
truncated-CG for the trust-region subproblem, and a gradient-projection
Cauchy phase so active bounds are handled exactly. Host-side numpy driver
(the expensive work is the simulation and the adjoint inside ``f_and_g``).
"""

from __future__ import annotations

import numpy as np

from .lbfgs import OptimizationHistory, _projected_grad_norm


class _LBFGSHessian:
    """Compact-form limited-memory BFGS approximation of the Hessian.

    B = gamma*I - [gamma*S Y] @ Minv @ [gamma*S Y]^T with the standard
    Byrd–Nocedal–Schnabel M = [[gamma*S^T S, L], [L^T, -D]].
    Only matvecs are needed (Steihaug-CG), so nothing is densified.
    """

    def __init__(self, memory: int = 10):
        self.memory = memory
        self.S: list[np.ndarray] = []
        self.Y: list[np.ndarray] = []
        self.gamma = 1.0

    def update(self, s, y):
        sy = float(np.dot(s, y))
        if sy <= 1e-10 * np.linalg.norm(s) * np.linalg.norm(y):
            return  # skip non-curvature pairs (keeps B positive definite)
        self.S.append(np.asarray(s, dtype=np.float64))
        self.Y.append(np.asarray(y, dtype=np.float64))
        if len(self.S) > self.memory:
            self.S.pop(0)
            self.Y.pop(0)
        self.gamma = float(np.dot(y, y) / sy)  # B0 = gamma * I
        self._factor()

    def _factor(self):
        S = np.stack(self.S, axis=1)
        Y = np.stack(self.Y, axis=1)
        k = S.shape[1]
        StS = S.T @ S
        StY = S.T @ Y
        L = np.tril(StY, -1)
        D = np.diag(np.diag(StY))
        M = np.block([[self.gamma * StS, L], [L.T, -D]])
        self._U = np.concatenate([self.gamma * S, Y], axis=1)
        # M is symmetric indefinite but small (2k x 2k); LU is fine.
        self._M = M + 1e-14 * np.eye(2 * k)

    def matvec(self, v):
        out = self.gamma * v
        if self.S:
            Uv = self._U.T @ v
            out = out - self._U @ np.linalg.solve(self._M, Uv)
        return out


def _steihaug_cg(B, g, delta, free, tol=1e-8, max_iter=None):
    """Truncated CG for min g^T p + p^T B p / 2 on the free variables,
    ||p|| <= delta. Returns the step p (zeros on active set)."""
    n = g.size
    if max_iter is None:
        max_iter = min(2 * n, 250)
    p = np.zeros(n)
    r = -g * free
    d = r.copy()
    rr = float(np.dot(r, r))
    if np.sqrt(rr) <= tol:
        return p
    for _ in range(max_iter):
        Bd = B.matvec(d) * free
        dBd = float(np.dot(d, Bd))
        if dBd <= 1e-300:  # negative curvature: go to the boundary
            return p + _boundary_tau(p, d, delta) * d
        alpha = rr / dBd
        p_new = p + alpha * d
        if np.linalg.norm(p_new) >= delta:
            return p + _boundary_tau(p, d, delta) * d
        p = p_new
        r = r - alpha * Bd
        rr_new = float(np.dot(r, r))
        if np.sqrt(rr_new) <= tol * max(1.0, np.sqrt(float(np.dot(g, g)))):
            return p
        d = r + (rr_new / rr) * d
        rr = rr_new
    return p


def _boundary_tau(p, d, delta):
    """Positive tau with ||p + tau*d|| = delta."""
    dd = float(np.dot(d, d))
    if dd <= 0:
        return 0.0
    pd = float(np.dot(p, d))
    pp = float(np.dot(p, p))
    disc = max(pd * pd - dd * (pp - delta * delta), 0.0)
    return (-pd + np.sqrt(disc)) / dd


def box_trust_region(x0, f_and_g, maximize: bool = False,
                     max_iterations: int = 100, memory: int = 10,
                     grad_tol: float = 1e-8, obj_change_tol: float = 1e-12,
                     delta0: float = 0.25, delta_max: float = 1.0,
                     eta: float = 1e-4, verbose: bool = False):
    """Trust-region L-BFGS on [0,1]^n. Same contract as
    :func:`.lbfgs.unit_box_bfgs`:
    ``f_and_g(x) -> (value, gradient)``; returns (value, x, history)."""
    sign = -1.0 if maximize else 1.0
    x = np.clip(np.asarray(x0, dtype=np.float64), 0.0, 1.0)

    def eval_fg(xq):
        v, g = f_and_g(xq)
        return sign * float(v), sign * np.asarray(g, dtype=np.float64)

    v, g = eval_fg(x)
    hist = OptimizationHistory([sign * v], [_projected_grad_norm(x, g)],
                               [0.0])
    B = _LBFGSHessian(memory)
    delta = float(delta0)
    eps = 1e-12

    for it in range(max_iterations):
        pgn = _projected_grad_norm(x, g)
        if pgn <= grad_tol:
            break
        # active set: at a bound with the gradient pushing outward
        free = ~(((x <= eps) & (g > 0)) | ((x >= 1 - eps) & (g < 0)))
        p = _steihaug_cg(B, g, delta, free.astype(np.float64))
        # pull the step back inside the box (feasible trust region)
        x_try = np.clip(x + p, 0.0, 1.0)
        p = x_try - x
        pn = np.linalg.norm(p)
        if pn <= 1e-300:
            delta *= 0.25
            if delta < 1e-14:
                break
            continue
        pred = -(float(np.dot(g, p)) + 0.5 * float(np.dot(p, B.matvec(p))))
        v_new, g_new = eval_fg(x_try)
        ared = v - v_new
        rho = ared / pred if pred > 0 else (1.0 if ared > 0 else -1.0)
        if rho < 0.25:
            delta = 0.25 * pn
        elif rho > 0.75 and pn >= 0.99 * delta:
            delta = min(2.0 * delta, delta_max)
        if rho > eta:  # accept
            B.update(x_try - x, g_new - g)
            obj_change = abs(v_new - v)
            x, v, g = x_try, v_new, g_new
            hist.values.append(sign * v)
            hist.grad_norms.append(_projected_grad_norm(x, g))
            hist.steps.append(pn)
            if verbose:
                print(f"TR it {it + 1}: f={sign * v:.6e} "
                      f"|pg|={hist.grad_norms[-1]:.3e} "
                      f"delta={delta:.3e} rho={rho:.2f}")
            if obj_change <= obj_change_tol * max(abs(v), 1e-300):
                break
        if delta < 1e-14:
            break
    return sign * v, x, hist
