"""Fused BiCGStab body kernels K6 (``fused_alpha_s``) and K7
(``fused_omega_update``), and the BiCGStab loop that runs on them.

Wrappers around ``csrc/krylov_kernels.cu``, with the plain PyTorch version
of each kernel beside it and a launch counter on each wrapper. A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
the kernel or raises — there is no fallback.

- K6 ``fused_alpha_s`` replaces jutul/jl_tpu/ops/pallas/krylov_kernels.py
  ``fused_alpha_s`` (B10): ``denom = <rhat, v>``, ``alpha = rho/denom``,
  ``s = r - alpha v``.
- K7 ``fused_omega_update`` replaces ``fused_omega_update`` (B11): the
  closing kernel of an iteration — ``omega = <t,s>/<t,t>``,
  ``x' = x + alpha phat + omega shat``, ``r' = s - omega t``,
  ``rho' = <rhat,r'>``, ``res2 = <r',r'>``, ``beta = (rho'/rho)(alpha/omega)``,
  ``p' = r' + beta (p - omega v)``.

Both are bound by HBM bytes, sum in a fixed order (deterministic: no
float atomics) and guard every division with the reference's
``v != 0 ? v : 1e-30`` (``_TINY``), not the unfused chain's ``finfo.tiny``.
Vectors are flat and contiguous: the stencil solver's (n, neq) blocks
flatten as views, so there is no (R, 128) tile padding. Scalars in and out
are 0-d device tensors; the loop reads only ``res2`` on the host, once per
iteration.
"""

from __future__ import annotations

import torch

from ...utils.timing import host_read
from ._build import check, dtype_suffix, load_library, stream_handle
from .stencil_kernels import _is_cpu, _require

_TINY = 1e-30  # krylov_kernels.py _TINY
# partial sums per value held for the grid-wide reductions: the kernels use
# at most 1024 blocks (4 per SM on the card), K7 keeps 4 values per block
_PARTIALS = 1024


def _guard(v):
    return torch.where(v != 0, v, torch.full_like(v, _TINY))


def _dot(a, b):
    return torch.sum(a * b)


def _vectors(name, like, *vs):
    """Each of ``vs`` contiguous, flat and shaped, typed and placed like
    ``like``."""
    out = []
    for v in vs:
        v = v.contiguous()
        _require(v, like, name)
        if v.shape != like.shape:
            raise ValueError(f"{name}: shape {tuple(v.shape)}, expected "
                             f"{tuple(like.shape)}")
        out.append(v)
    return out


def _scalars(name, like, *vs):
    out = []
    for v in vs:
        _require(v, like, name)
        if v.numel() != 1:
            raise ValueError(f"{name}: scalar expected, got {tuple(v.shape)}")
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# K6: s = r - (rho/<rhat,v>) v
# ---------------------------------------------------------------------------
def fused_alpha_s_plain(rhat, r, v, rho):
    """Plain version of K6. Returns (s, alpha)."""
    alpha = rho / _guard(_dot(rhat, v))
    return r - alpha * v, alpha


def fused_alpha_s(rhat, r, v, rho):
    """K6 wrapper: (s, alpha) for flat vectors and a 0-d ``rho``."""
    if _is_cpu(r):
        return fused_alpha_s_plain(rhat, r, v, rho)
    r = r.contiguous()
    if r.ndim != 1:
        raise ValueError(f"fused_alpha_s: flat vectors, got {tuple(r.shape)}")
    rhat, v = _vectors("fused_alpha_s", r, rhat, v)
    (rho,) = _scalars("fused_alpha_s rho", r, rho)
    s = torch.empty_like(r)
    alpha = torch.empty((), dtype=r.dtype, device=r.device)
    part = torch.empty(_PARTIALS, dtype=r.dtype, device=r.device)
    check(load_library().fn("jt_fused_alpha_s", dtype_suffix(r))(
        rhat.data_ptr(), r.data_ptr(), v.data_ptr(), rho.data_ptr(),
        s.data_ptr(), alpha.data_ptr(), part.data_ptr(), r.numel(),
        _PARTIALS, stream_handle()), "fused_alpha_s")
    fused_alpha_s.launches += 1
    return s, alpha


fused_alpha_s.launches = 0


# ---------------------------------------------------------------------------
# K7: the closing update of an iteration
# ---------------------------------------------------------------------------
def fused_omega_update_plain(rhat, t, s, phat, shat, x, p, v, rho, alpha):
    """Plain version of K7. Returns (x', r', p', omega, rho', res2)."""
    omega = _dot(t, s) / _guard(_dot(t, t))
    x_new = x + alpha * phat + omega * shat
    r_new = s - omega * t
    rho_new = _dot(rhat, r_new)
    res2 = _dot(r_new, r_new)
    beta = (rho_new / _guard(rho)) * (alpha / _guard(omega))
    return (x_new, r_new, r_new + beta * (p - omega * v), omega, rho_new,
            res2)


def fused_omega_update(rhat, t, s, phat, shat, x, p, v, rho, alpha):
    """K7 wrapper: (x', r', p', omega, rho', res2) for flat vectors and
    0-d ``rho``, ``alpha``; the scalars come back as 0-d device tensors."""
    if _is_cpu(x):
        return fused_omega_update_plain(rhat, t, s, phat, shat, x, p, v, rho,
                                        alpha)
    x = x.contiguous()
    if x.ndim != 1:
        raise ValueError(f"fused_omega_update: flat vectors, got "
                         f"{tuple(x.shape)}")
    vecs = _vectors("fused_omega_update", x, rhat, t, s, phat, shat, p, v)
    rho, alpha = _scalars("fused_omega_update scalars", x, rho, alpha)
    x_out, r_out, p_out = (torch.empty_like(x) for _ in range(3))
    scal = torch.empty(3, dtype=x.dtype, device=x.device)
    part = torch.empty(4 * _PARTIALS, dtype=x.dtype, device=x.device)
    rhat, t, s, phat, shat, p, v = vecs
    check(load_library().fn("jt_fused_omega_update", dtype_suffix(x))(
        rhat.data_ptr(), t.data_ptr(), s.data_ptr(), phat.data_ptr(),
        shat.data_ptr(), x.data_ptr(), p.data_ptr(), v.data_ptr(),
        rho.data_ptr(), alpha.data_ptr(), x_out.data_ptr(), r_out.data_ptr(),
        p_out.data_ptr(), scal.data_ptr(), part.data_ptr(), x.numel(),
        4 * _PARTIALS, stream_handle()), "fused_omega_update")
    fused_omega_update.launches += 1
    return x_out, r_out, p_out, scal[0], scal[1], scal[2]


fused_omega_update.launches = 0


# ---------------------------------------------------------------------------
# BiCGStab on the fused body
# ---------------------------------------------------------------------------
def bicgstab_fused(matvec, b, x0=None, maxiter: int = 200, rtol: float = 1e-8,
                   atol: float = 0.0, precond=None):
    """Right-preconditioned BiCGStab on K6/K7: port of the JAX package's
    ``ops/pallas/krylov_kernels.py`` ``bicgstab_fused`` — float32, flat
    vectors, the same update formulas as ``linsolve.krylov.bicgstab`` with
    the leading rho/beta/p group folded into the previous iteration's K7.
    The loop runs on the host with one read of ``res2`` per iteration
    (``res2 > tol^2 and it < maxiter``). Returns (x, {iterations,
    residual, converged})."""
    if precond is None:
        precond = lambda z: z  # noqa: E731
    b = b.to(torch.float32)
    x0 = torch.zeros_like(b) if x0 is None else x0.to(torch.float32)
    bnorm = torch.sqrt(torch.dot(b, b))
    if torch.is_tensor(rtol):
        # a per-call forcing tolerance (float64 scalar): the product is
        # formed in double, as with the reference's traced float64 rtol
        tol = max(float(rtol) * host_read(bnorm), atol)
        tol2 = tol * tol
    else:
        tol = torch.clamp(rtol * bnorm, min=atol)
        tol2 = host_read(tol * tol)  # float32, as the reference's traced tol2
    r = (b - matvec(x0)).to(torch.float32)
    rhat = r
    rho = torch.dot(rhat, r)
    res2 = torch.dot(r, r)
    # p_1 = r_0 (the folded p-update's first output), rho_1 = <rhat, r0>
    x, p = x0, r
    it = 0
    while host_read(res2) > tol2 and it < maxiter:  # one read per iteration
        phat = precond(p).to(torch.float32)
        v = matvec(phat).to(torch.float32)
        s, alpha = fused_alpha_s(rhat, r, v, rho)
        shat = precond(s).to(torch.float32)
        t = matvec(shat).to(torch.float32)
        x, r, p, _, rho, res2 = fused_omega_update(rhat, t, s, phat, shat, x,
                                                   p, v, rho, alpha)
        it += 1
    res = torch.sqrt(res2)
    return x, {"iterations": it, "residual": res,
               "converged": host_read(res) <= (
                   host_read(tol) if torch.is_tensor(tol) else tol)}
