"""Limited-memory BFGS in the unit box.

A copy of the JAX package's ``adjoint/lbfgs.py`` (numpy only). Counterpart
of the reference LBFGS module (reference: src/LBFGS/ ``unit_box_bfgs``
constrained_optimizer.jl:62 — scaled unit-box BFGS with inexact line
search and limited-memory Hessian limited_memory_hessian.jl:1).
Host-side numpy driver (like the reference's Julia host code); the expensive
calls are the simulation and the adjoint on the card inside ``f_and_g``.

API: ``unit_box_bfgs(x0, f_and_g)`` minimizes (or maximizes) f over
[0,1]^n; ``f_and_g(x) -> (value, gradient)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class OptimizationHistory:
    values: list = field(default_factory=list)
    grad_norms: list = field(default_factory=list)
    steps: list = field(default_factory=list)


def _two_loop(g, S, Y):
    """Standard L-BFGS two-loop recursion for H @ g."""
    q = g.copy()
    alphas = []
    rhos = [1.0 / max(np.dot(y, s), 1e-300) for s, y in zip(S, Y)]
    for (s, y), rho in zip(reversed(list(zip(S, Y))),
                           reversed(rhos)):
        a = rho * np.dot(s, q)
        q -= a * y
        alphas.append((a, rho))
    if S:
        s, y = S[-1], Y[-1]
        gamma = np.dot(s, y) / max(np.dot(y, y), 1e-300)
        q *= gamma
    for (s, y), (a, rho) in zip(zip(S, Y), reversed(alphas)):
        b = rho * np.dot(y, q)
        q += (a - b) * s
    return q


def _projected_grad_norm(x, g, eps=1e-12):
    pg = g.copy()
    pg[(x <= eps) & (g > 0)] = 0.0
    pg[(x >= 1 - eps) & (g < 0)] = 0.0
    return np.max(np.abs(pg)) if pg.size else 0.0


class LinearConstraints:
    """Linear constraints ``A_eq x = b_eq`` and ``A_in x <= b_in`` on top of
    the unit box (reference constrained_optimizer.jl keywords ``lin_eq`` /
    ``lin_ineq`` with ``check_feasible`` repair)."""

    def __init__(self, n: int, lin_eq=None, lin_ineq=None):
        def unpack(c):
            if c is None:
                return np.zeros((0, n)), np.zeros(0)
            A, b = (c["A"], c["b"]) if isinstance(c, dict) else (c[0], c[1])
            A = np.atleast_2d(np.asarray(A, dtype=np.float64))
            b = np.atleast_1d(np.asarray(b, dtype=np.float64))
            if A.shape != (b.size, n):
                raise ValueError(f"constraint shape {A.shape} != ({b.size},{n})")
            return A, b

        self.A_eq, self.b_eq = unpack(lin_eq)
        self.A_in, self.b_in = unpack(lin_ineq)

    @property
    def empty(self) -> bool:
        return self.A_eq.shape[0] == 0 and self.A_in.shape[0] == 0

    def violation(self, x) -> float:
        v = 0.0
        if self.A_eq.shape[0]:
            v = max(v, float(np.max(np.abs(self.A_eq @ x - self.b_eq))))
        if self.A_in.shape[0]:
            v = max(v, float(np.max(self.A_in @ x - self.b_in, initial=0.0)))
        return v

    def project(self, x, tol: float = 1e-10, max_rounds: int = 200):
        """Repair to the feasible set by cyclic projection onto the equality
        affine subspace, each violated halfspace, and the box (the
        reference's ``check_feasible`` feasibility repair)."""
        x = np.clip(np.asarray(x, dtype=np.float64), 0.0, 1.0)
        if self.empty:
            return x
        AeT = self.A_eq.T if self.A_eq.shape[0] else None
        for _ in range(max_rounds):
            if AeT is not None:
                # x <- x - A^T (A A^T)^+ (A x - b)
                corr, *_ = np.linalg.lstsq(self.A_eq @ AeT,
                                           self.A_eq @ x - self.b_eq,
                                           rcond=None)
                x = x - AeT @ corr
            for a, b in zip(self.A_in, self.b_in):
                r = float(a @ x - b)
                if r > 0:
                    x = x - (r / max(float(a @ a), 1e-300)) * a
            x = np.clip(x, 0.0, 1.0)
            if self.violation(x) <= tol:
                break
        return x

    def active_rows(self, x, d=None, eps: float = 1e-9):
        """Equality rows plus inequality rows at their bound (that ``d``
        pushes outward of, when given)."""
        rows = [self.A_eq] if self.A_eq.shape[0] else []
        if self.A_in.shape[0]:
            scale = np.maximum(np.linalg.norm(self.A_in, axis=1), 1e-300)
            at = (self.A_in @ x - self.b_in) >= -eps * scale
            if d is not None:
                at &= (self.A_in @ d) > 0
            if np.any(at):
                rows.append(self.A_in[at])
        return np.concatenate(rows, axis=0) if rows else np.zeros((0, x.size))

    def null_project(self, x, d, eps: float = 1e-9):
        """Project ``d`` onto the null space of the active constraint rows."""
        A = self.active_rows(x, d, eps=eps)
        if A.shape[0] == 0:
            return d
        corr, *_ = np.linalg.lstsq(A @ A.T, A @ d, rcond=None)
        return d - A.T @ corr

    def max_step(self, x, d):
        """Largest alpha with A_in (x + alpha d) <= b_in."""
        if self.A_in.shape[0] == 0:
            return np.inf
        Ad = self.A_in @ d
        slack = self.b_in - self.A_in @ x
        pos = Ad > 1e-300
        if not np.any(pos):
            return np.inf
        return float(max(np.min(slack[pos] / Ad[pos]), 0.0))


def unit_box_bfgs(x0, f_and_g, maximize: bool = False,
                  max_iterations: int = 100, memory: int = 10,
                  grad_tol: float = 1e-8, obj_change_tol: float = 1e-12,
                  step_tol: float = 1e-12, c1: float = 1e-4,
                  max_line_search: int = 25, verbose: bool = False,
                  lin_eq=None, lin_ineq=None,
                  enforce_feasible: bool = True):
    """Box-constrained L-BFGS on [0,1]^n (reference
    constrained_optimizer.jl:62). Returns (value, x, history).

    ``lin_eq`` / ``lin_ineq`` add linear constraints ``A x = b`` /
    ``A x <= b`` as ``(A, b)`` tuples or ``{"A":, "b":}`` dicts (reference
    keywords of the same names). Directions are projected onto the active
    constraints' null space; infeasible iterates are repaired by projection
    when ``enforce_feasible`` (reference ``check_feasible``)."""
    sign = -1.0 if maximize else 1.0
    x = np.clip(np.asarray(x0, dtype=np.float64), 0.0, 1.0)
    con = LinearConstraints(x.size, lin_eq, lin_ineq)
    if not con.empty:
        if con.violation(x) > 1e-8:
            if not enforce_feasible:
                raise ValueError("infeasible initial guess "
                                 f"(violation {con.violation(x):.3e})")
            x = con.project(x)

    def constrain_direction(xq, d, gq):
        """Box-active zeroing interleaved with active-set null projection
        (each can reintroduce what the other removed; a few rounds settle)."""
        for _ in range(3 if not con.empty else 1):
            d = d.copy()
            d[(xq <= 1e-12) & (d < 0)] = 0.0
            d[(xq >= 1 - 1e-12) & (d > 0)] = 0.0
            if con.empty:
                break
            d = con.null_project(xq, d)
        return d

    def eval_fg(xq):
        v, g = f_and_g(xq)
        return sign * float(v), sign * np.asarray(g, dtype=np.float64)

    v, g = eval_fg(x)
    hist = OptimizationHistory([sign * v], [_projected_grad_norm(x, g)], [0.0])
    S: list[np.ndarray] = []
    Y: list[np.ndarray] = []

    for it in range(max_iterations):
        if con.empty:
            pgn = _projected_grad_norm(x, g)
        else:  # stationarity = projected steepest-descent magnitude
            pgn = float(np.max(np.abs(constrain_direction(x, -g, g)),
                               initial=0.0))
        if pgn <= grad_tol:
            break
        d = constrain_direction(x, -_two_loop(g, S, Y), g)
        if np.dot(d, g) >= 0:  # not a descent direction: steepest descent
            d = constrain_direction(x, -g, g)
        dn = np.max(np.abs(d))
        if dn <= step_tol:
            break
        # cap alpha so x + alpha d remains in the box
        with np.errstate(divide="ignore", invalid="ignore"):
            hi = np.where(d > 0, (1.0 - x) / np.where(d > 0, d, 1.0), np.inf)
            lo = np.where(d < 0, (0.0 - x) / np.where(d < 0, d, 1.0), np.inf)
        alpha_max = float(min(np.min(hi), np.min(lo), con.max_step(x, d)))
        alpha = min(1.0, alpha_max)
        if alpha <= 0:
            break
        gtd = np.dot(g, d)
        ok = False
        for _ in range(max_line_search):
            x_new = np.clip(x + alpha * d, 0.0, 1.0)
            if not con.empty:
                x_new = con.project(x_new)
            v_new, g_new = eval_fg(x_new)
            if v_new <= v + c1 * alpha * gtd or abs(v_new - v) <= (
                    obj_change_tol * max(abs(v), 1e-300)):
                ok = True
                break
            alpha *= 0.5
        if not ok:
            break
        s = x_new - x
        y = g_new - g
        if np.dot(s, y) > 1e-10 * np.linalg.norm(s) * np.linalg.norm(y):
            S.append(s)
            Y.append(y)
            if len(S) > memory:
                S.pop(0)
                Y.pop(0)
        obj_change = abs(v_new - v)
        x, v, g = x_new, v_new, g_new
        hist.values.append(sign * v)
        hist.grad_norms.append(_projected_grad_norm(x, g))
        hist.steps.append(alpha)
        if verbose:
            print(f"LBFGS it {it + 1}: f={sign * v:.6e} "
                  f"|pg|={hist.grad_norms[-1]:.3e} alpha={alpha:.3e}")
        if obj_change <= obj_change_tol * max(abs(v), 1e-300):
            break
    return sign * v, x, hist


def lbfgsb_optimize(x0, f_and_g, maximize: bool = False,
                    max_iterations: int = 100, grad_tol: float = 1e-8,
                    verbose: bool = False):
    """Box-constrained L-BFGS-B on [0,1]^n via scipy (the counterpart of the
    reference's LBFGSB extension binding the Fortran L-BFGS-B —
    ext/JutulLBFGSBExt, src/ext/lbfgsb_ext.jl). Same return convention as
    :func:`unit_box_bfgs`."""
    import numpy as np
    from scipy.optimize import minimize

    sign = -1.0 if maximize else 1.0
    hist = OptimizationHistory()

    def fun(x):
        v, g = f_and_g(x)
        hist.values.append(float(v))
        hist.grad_norms.append(float(np.max(np.abs(g))) if np.size(g) else 0.0)
        return sign * float(v), sign * np.asarray(g, dtype=np.float64)

    res = minimize(fun, np.clip(np.asarray(x0, dtype=np.float64), 0, 1),
                   jac=True, method="L-BFGS-B",
                   bounds=[(0.0, 1.0)] * np.size(x0),
                   options={"maxiter": max_iterations, "gtol": grad_tol,
                            "disp": verbose})
    return sign * float(res.fun), np.asarray(res.x), hist
