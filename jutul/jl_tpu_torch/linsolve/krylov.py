"""Krylov solvers: restarted GMRES and right-preconditioned BiCGStab, the
choice between BiCGStab's plain chain and the fused body
(``resolve_bicgstab``), and ``GenericKrylov`` for BlockELL systems.

Port of the JAX package's ``linsolve/krylov.py`` (reference:
src/linsolve/krylov.jl — ``GenericKrylov`` :34, ``linear_solve!``
:71-240 with Krylov.jl's solvers). The JAX versions are
``lax.while_loop`` programs; here the loops run on the host and read one
value back per iteration for their stopping tests — the same rules
(BiCGStab ``res > tol and it < maxiter``; GMRES's Arnoldi ``k < m and
res > tol``, its restarts ``res > tol and it < maxiter``), so iteration
counts match. Vectors, the Arnoldi basis and every product with them stay
on the device; GMRES's Hessenberg bookkeeping (m+1 numbers per step:
Givens rotations and the back-substitution) runs on the host in the
working precision, from the one read per step.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils.timing import host_array, host_read


def _identity(x):
    return x


def _tolerance(rtol, bnorm, atol):
    """The stopping threshold max(rtol |b|, atol) as a Python float:
    ``rtol`` a Python float (rounded in the working dtype, as the JAX
    loops' weakly typed tolerance) or a 0-d tensor (a per-call forcing
    tolerance, float64 as the reference's traced Eisenstat-Walker eta:
    the product is formed in double)."""
    if torch.is_tensor(rtol):
        return max(float(rtol) * host_read(bnorm), atol)
    return host_read(torch.clamp(rtol * bnorm, min=atol))


def gmres(matvec: Callable, b, x0=None, restart: int = 20,
          maxiter: int = 200, rtol: float = 1e-8, atol: float = 0.0,
          precond: Callable | None = None, orth: str = "cgs2"):
    """Right-preconditioned restarted GMRES(m) on flat vectors.

    ``orth``: "cgs2" (classical Gram-Schmidt twice: each pass is one
    (m+1, N) product with the basis and one combine, the rows beyond the
    current step masked out of the coefficients) or "mgs" (modified
    Gram-Schmidt, sequential). Returns (x, stats) with stats =
    dict(iterations, residual, converged, cycles)."""
    if orth not in ("cgs2", "mgs"):
        raise ValueError(f"unknown orthogonalization {orth!r}")
    N = b.shape[0]
    dtype = b.dtype
    hdt = np.float32 if dtype == torch.float32 else np.float64
    if precond is None:
        precond = _identity
    if x0 is None:
        x0 = torch.zeros_like(b)
    m = restart

    def norm(v):
        return torch.sqrt(torch.dot(v, v))

    tol = _tolerance(rtol, norm(b), atol)
    steps = torch.arange(m + 1, device=b.device)

    def inner_cycle(x):
        """One GMRES(m) cycle from x. Returns (x_new, resnorm, steps)."""
        r = b - matvec(x)
        beta = norm(r)
        V = b.new_zeros((m + 1, N))
        V[0] = r / torch.where(beta > 0, beta, torch.ones_like(beta))
        H = np.zeros((m + 1, m), hdt)
        cs = np.zeros(m, hdt)
        sn = np.zeros(m, hdt)
        g = np.zeros(m + 1, hdt)
        g[0] = hdt(host_read(beta))
        res, k = g[0], 0
        while k < m and float(res) > tol:  # one host read per step
            w = matvec(precond(V[k]))
            if orth == "cgs2":
                mask = (steps <= k).to(dtype)
                h1 = (V @ w) * mask
                w = w - V.T @ h1
                h2 = (V @ w) * mask
                w = w - V.T @ h2
                hcol = h1 + h2
            else:
                hs = []
                for j in range(k + 1):  # the masked steps beyond k are no-ops
                    hij = torch.dot(V[j], w)
                    w = w - hij * V[j]
                    hs.append(hij)
                hcol = torch.cat([torch.stack(hs), b.new_zeros(m - k)])
            hk1 = norm(w)
            V[k + 1] = w / torch.where(hk1 > 0, hk1, torch.ones_like(hk1))
            col = host_array(torch.cat([hcol, hk1[None]])).astype(hdt)
            col[k + 1] = col[m + 1]
            col = col[:m + 1]
            # previous Givens rotations on the new column
            for j in range(k):
                c, s = cs[j], sn[j]
                hj = c * col[j] + s * col[j + 1]
                hj1 = -s * col[j] + c * col[j + 1]
                col[j], col[j + 1] = hj, hj1
            denom = np.sqrt(col[k] ** 2 + col[k + 1] ** 2)
            c_new = col[k] / denom if denom > 0 else hdt(1.0)
            s_new = col[k + 1] / denom if denom > 0 else hdt(0.0)
            cs[k], sn[k] = c_new, s_new
            col[k], col[k + 1] = denom, 0.0
            H[:, k] = col
            g_k = g[k]
            g[k] = c_new * g_k
            g[k + 1] = -s_new * g_k
            res = abs(g[k + 1])
            k += 1
        # back-substitute H[:k, :k] y = g[:k]
        y = np.zeros(m, hdt)
        for i in range(k - 1, -1, -1):
            s_i = g[i] - np.dot(H[i, :], y)
            y[i] = s_i / (H[i, i] if H[i, i] != 0 else hdt(1.0))
        dx = precond(V[:m].T @ torch.as_tensor(y, device=b.device))
        return x + dx, res, k

    x = x0
    res = host_read(norm(b - matvec(x0)))
    its = cycles = 0
    while res > tol and its < maxiter:
        x, res_h, k = inner_cycle(x)
        res = float(res_h)
        its += k
        cycles += 1
    return x, {"iterations": its, "residual": res,
               "converged": res <= tol, "cycles": cycles}


def bicgstab(matvec: Callable, b, maxiter: int = 200, rtol: float = 1e-8,
             atol: float = 0.0, precond: Callable | None = None,
             dot_fn: Callable | None = None):
    """Right-preconditioned BiCGStab from the zero initial guess.

    Shape-generic: every operation is elementwise or a full-reduction dot,
    so vectors may be any shape that ``matvec``/``precond`` consume and
    produce (the stencil path keeps (n, neq) blocks). ``rtol``: a Python
    float, or a 0-d tensor for a per-call tolerance. ``dot_fn`` overrides
    the inner product: a shard passes a psum-reducing dot to make the
    solve distributed (the reference's PVector dots over MPI, ext
    krylov.jl). Returns ``(x, stats)`` with stats = dict(iterations,
    residual, converged).
    """
    if precond is None:
        precond = _identity

    def dot(a, v):
        return torch.sum(a * v)

    if dot_fn is not None:
        dot = dot_fn

    def norm(v):
        return torch.sqrt(dot(v, v))

    tol = _tolerance(rtol, norm(b), atol)
    # breakdown guards representable in the WORKING dtype: a 1e-300
    # literal flushes to 0 in f32 and turns every guard into 0/0
    tiny = torch.finfo(b.dtype).tiny

    def guard(v):
        return torch.where(v != 0, v, torch.full_like(v, tiny))

    x = torch.zeros_like(b)
    r = b - matvec(x)
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho, alpha, omega = one, one, one
    res = norm(r)
    it = 0
    while host_read(res) > tol and it < maxiter:  # one host sync per iteration
        rho_new = dot(rhat, r)
        beta = (rho_new / guard(rho)) * (alpha / guard(omega))
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = matvec(phat)
        alpha = rho_new / guard(dot(rhat, v))
        s = r - alpha * v
        shat = precond(s)
        t = matvec(shat)
        omega = dot(t, s) / guard(dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        res = norm(r)
        rho = rho_new
        it += 1
    return x, {"iterations": it, "residual": res,
               "converged": host_read(res) <= tol}


def resolve_bicgstab(dtype, use_fused: bool | None):
    """The BiCGStab implementation: the fused body on K6/K7
    (``ops/cuda/krylov_kernels.py`` ``bicgstab_fused``) or the plain
    chain. Counterpart of the JAX package's ``resolve_bicgstab``, with its
    auto rule: ``None`` is always the plain chain. Forcing the fused body
    on a non-float32 system raises — it computes in float32 and would
    silently lose the precision the float64 paths rely on."""
    if use_fused and dtype != torch.float32:
        raise ValueError(
            "use_fused_body=True requires a float32 system (the fused body "
            "computes in float32 and would silently downcast); cast the "
            "system or leave use_fused_body=None")
    if use_fused:
        from ..ops.cuda.krylov_kernels import bicgstab_fused

        return bicgstab_fused
    return bicgstab


class GenericKrylov:
    """Krylov linear solver for the generic engine's BlockELL systems
    (reference linsolve/krylov.jl:34 GenericKrylov).

    Parameters mirror the reference: ``solver`` in {"gmres", "bicgstab"},
    a preconditioner object, relative/absolute tolerances and max
    iterations (IterativeSolverConfig, linsolve/utils.jl:3), GMRES's
    ``restart`` and ``orth``. ``use_fused_body`` picks BiCGStab's body
    through ``resolve_bicgstab`` (True: K6/K7 on the flat vectors, float32
    only)."""

    def __init__(self, solver: str = "gmres", preconditioner=None,
                 rtol: float = 1e-6, atol: float = 0.0,
                 max_iterations: int = 200, restart: int = 20,
                 verbose: bool = False, use_fused_body: bool | None = None,
                 orth: str = "cgs2"):
        from .precond import TrivialPreconditioner

        if solver not in ("gmres", "bicgstab"):
            raise ValueError(f"unknown solver {solver!r}")
        self.solver = solver
        self.preconditioner = preconditioner or TrivialPreconditioner()
        self.rtol = rtol
        self.atol = atol
        self.max_iterations = max_iterations
        self.restart = restart
        self.verbose = verbose
        self.orth = orth
        self.use_fused_body = use_fused_body

    def solve(self, J, r, rtol=None):
        """Solve J du = -r; shapes (n, neq) -> (n, ndof). ``rtol``
        overrides the configured relative tolerance (a 0-d float64 tensor
        under Eisenstat-Walker forcing). A coupled MultiLinearizedSystem
        (dict-valued ``r`` and ``du``) solves over the flat concatenated
        vector (``_solve_multi``)."""
        from ..ops.blockell import BlockELL

        if isinstance(r, dict):
            return self._solve_multi(J, r, rtol)
        if not isinstance(J, BlockELL):
            raise TypeError(
                f"GenericKrylov solves the generic engine's BlockELL "
                f"Jacobian, not a {type(J).__name__}: the stencil engine "
                f"takes a StencilKrylovSolver")
        rtol = self.rtol if rtol is None else rtol
        n, _, neq, ndof = J.blocks.shape
        pstate = self.preconditioner.update(J)

        def matvec(x_flat):
            return J.matvec(x_flat.reshape(n, ndof)).reshape(n * neq)

        def precond(x_flat):
            y = self.preconditioner.apply(pstate, J, x_flat.reshape(n, neq))
            return y.reshape(n * ndof)

        x, stats = self._krylov(matvec, (-r).reshape(n * neq).contiguous(),
                                rtol, precond)
        return x.reshape(n, ndof), stats

    def _krylov(self, matvec, b, rtol, precond):
        if self.solver == "gmres":
            return gmres(matvec, b, restart=self.restart,
                         maxiter=self.max_iterations, rtol=rtol,
                         atol=self.atol, precond=precond, orth=self.orth)
        return resolve_bicgstab(b.dtype, self.use_fused_body)(
            matvec, b, maxiter=self.max_iterations, rtol=rtol,
            atol=self.atol, precond=precond)

    def _solve_multi(self, J, r, rtol=None):
        """The coupled MultiLinearizedSystem solve (the JAX package's
        ``_solve_multi``): one Krylov space over the concatenated vector;
        a ``GroupWisePreconditioner`` applies per submodel, the default
        (Trivial) becomes GroupWise(BlockJacobi) and any other
        preconditioner is not applied, as there."""
        from ..multimodel.core import MultiLinearizedSystem
        from .precond import (
            BlockJacobiPreconditioner,
            GroupWisePreconditioner,
            TrivialPreconditioner,
        )

        if not isinstance(J, MultiLinearizedSystem):
            raise TypeError(
                f"GenericKrylov: dict residuals need a coupled "
                f"MultiLinearizedSystem, not a {type(J).__name__}")
        rtol = self.rtol if rtol is None else rtol
        p = self.preconditioner
        if isinstance(p, TrivialPreconditioner):
            p = GroupWisePreconditioner(BlockJacobiPreconditioner())
        precond = None
        if isinstance(p, GroupWisePreconditioner):
            pstate = p.update(J)

            def precond(v):
                return J.flatten_dofs(p.apply(pstate, J, J.unflatten_res(v)))

        x, stats = self._krylov(J.matvec_flat,
                                -J.flatten_res(r).contiguous(), rtol, precond)
        return J.unflatten_dofs(x), stats
