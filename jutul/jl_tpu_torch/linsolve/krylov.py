"""Krylov solver: right-preconditioned BiCGStab, and the choice between its
plain chain and the fused body (``resolve_bicgstab``).

Port of the JAX package's ``linsolve/krylov.py`` ``bicgstab`` (reference:
src/linsolve/krylov.jl ``linear_solve!`` with Krylov.jl's BiCGStab). The
JAX version is one ``lax.while_loop``; here the loop runs on the host and
reads the residual norm back once per iteration for its stopping test
``res > tol and it < maxiter`` — the same rule, so iteration counts match.
"""

from __future__ import annotations

from typing import Callable

import torch


def _identity(x):
    return x


def bicgstab(matvec: Callable, b, maxiter: int = 200, rtol: float = 1e-8,
             atol: float = 0.0, precond: Callable | None = None):
    """Right-preconditioned BiCGStab from the zero initial guess.

    Shape-generic: every operation is elementwise or a full-reduction dot,
    so vectors may be any shape that ``matvec``/``precond`` consume and
    produce (the stencil path keeps (n, neq) blocks). ``rtol``: a Python
    float, or a 0-d tensor for a per-call tolerance. Returns
    ``(x, stats)`` with stats = dict(iterations, residual, converged).
    """
    if precond is None:
        precond = _identity

    def dot(a, v):
        return torch.sum(a * v)

    def norm(v):
        return torch.sqrt(dot(v, v))

    if torch.is_tensor(rtol):
        # a per-call forcing tolerance (a float64 scalar, as the reference's
        # traced Eisenstat-Walker eta): rtol * |b| is formed in double
        tol = max(float(rtol) * float(norm(b)), atol)
    else:
        # a Python rtol: rounded in the working dtype, as the JAX loop's
        # weakly typed tolerance
        tol = float(torch.clamp(rtol * norm(b), min=atol))
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
    while float(res) > tol and it < maxiter:  # one host sync per iteration
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
               "converged": float(res) <= tol}


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
