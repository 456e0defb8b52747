"""Stencil kernels K1 (block-stencil SpMV), K2 (scalar Jacobi pass) and K4
(scalar Chebyshev step).

Wrappers around ``csrc/stencil_kernels.cu``, with the plain PyTorch version
of each kernel beside it and a launch counter on each wrapper. A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
the kernel or raises — there is no fallback.

- K1 ``stencil_matvec`` replaces jutul/jl_tpu/ops/pallas/stencil_kernels.py
  ``_kernel`` (B1): the 7-point C×K block-stencil SpMV, used as the Krylov
  operator (C = K = ndof) and as CPR stage 2's pressure-column matvec
  (C = ndof, K = 1). Bound by HBM bytes: 7·C·K coefficient streams per
  cell against 2 flops each; the kernel reads each coefficient once and
  leaves neighbour reuse of ``x`` to L1/L2.
- K2 ``scalar_jacobi`` replaces ``_kernel_slab_sweeps`` (B2),
  ``_kernel_sweeps`` (B3) and ``_kernel_fused`` (B4): one fused residual or
  weighted-Jacobi pass on a scalar stencil. Bound by HBM bytes (7
  coefficient streams + 2–3 vectors per pass). The TPU kernels read the
  coefficients once per smoothing PHASE (deep-halo slabs or VMEM-resident
  levels); here a phase is a loop of single-pass launches, so the
  coefficients stream once per sweep. Temporal blocking that restores
  once-per-phase reads is later work.
- K4 ``scalar_chebyshev`` replaces ``_kernel_sweeps_cheby`` (B6) and
  ``_kernel_slab_sweeps_cheby`` (B7): one step of the Chebyshev
  recurrence on a scalar stencil, per-step scalars read from a small
  device table. Bound by HBM bytes as K2 (plus the direction vector d in
  and out); one launch per step, so the coefficients stream once per step.

The lattice is the natural contiguous (nz, ny, nx) one: coefficients are
embedded once per matrix as ``(7, C·K, n)`` with zero boundary entries
(``lattice_coefficients``), and neighbours outside the lattice are skipped
by bounds checks — no lane padding, no wrapped reads.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ._build import check, dtype_suffix, load_library, stream_handle

TERMS = 7  # diag, +x, -x, +y, -y, +z, -z
# per lattice axis a (0=x, 1=y, 2=z): the cells left and right of its
# faces on (nz, ny, nx); terms 2a+1 / 2a+2 are the +a / -a neighbours
AXIS_SLICES = {
    0: (np.s_[:, :, :-1], np.s_[:, :, 1:]),
    1: (np.s_[:, :-1, :], np.s_[:, 1:, :]),
    2: (np.s_[:-1, :, :], np.s_[1:, :, :]),
}


def _is_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {t.device}")
    return False


def _require(t, like, name):
    """``t`` must be contiguous, with ``like``'s dtype and device."""
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"{name}: expected {like.dtype} on {like.device}, "
                         f"got {t.dtype} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def lattice_coefficients(L, diag, plus: dict, minus: dict):
    """Embed face-lattice stencil coefficients on the cell lattice.

    ``diag`` (C, K, n); ``plus[a]``/``minus[a]`` (C, K, *face_lat) as in
    StencilMatrix (axis 0=x, 1=y, 2=z on the (nz, ny, nx) lattice).
    Returns contiguous ``(7, C*K, n)`` with zeros where a neighbour lies
    outside the lattice.
    """
    nz, ny, nx = L
    C, K = diag.shape[0], diag.shape[1]
    full = diag.new_zeros((TERMS, C * K, nz, ny, nx))
    full[0] = diag.reshape(C * K, nz, ny, nx)
    for a, arr in plus.items():
        left, right = AXIS_SLICES[a]
        # row = left cell couples to its +a neighbour; row = right cell to
        # its -a neighbour
        full[(2 * a + 1, slice(None)) + left] = arr.reshape(
            (C * K,) + arr.shape[2:])
        full[(2 * a + 2, slice(None)) + right] = minus[a].reshape(
            (C * K,) + minus[a].shape[2:])
    return full.reshape(TERMS, C * K, nz * ny * nx)


def _neighbour_views(v_lat):
    """The 7 stencil views (diag, +x, -x, +y, -y, +z, -z) of a
    (..., nz, ny, nx) lattice, zero outside it."""
    vp = F.pad(v_lat, (1, 1, 1, 1, 1, 1))
    c = slice(1, -1)
    return (v_lat,
            vp[..., c, c, 2:], vp[..., c, c, :-2],
            vp[..., c, 2:, c], vp[..., c, :-2, c],
            vp[..., 2:, c, c], vp[..., :-2, c, c])


# ---------------------------------------------------------------------------
# K1: block-stencil SpMV
# ---------------------------------------------------------------------------
def stencil_matvec_plain(coef, x, L, C: int, K: int):
    """Plain version of K1: y (n, C) = A x for x (n, K), the same term and
    dof order as the kernel."""
    nz, ny, nx = L
    views = _neighbour_views(x.T.reshape(K, nz, ny, nx))
    cf = coef.reshape(TERMS, C, K, nz, ny, nx)
    acc = None
    for t in range(TERMS):
        for k in range(K):
            term = cf[t, :, k] * views[t][k]
            acc = term if acc is None else acc + term
    return acc.reshape(C, -1).T


def stencil_matvec(coef, x, L, C: int, K: int):
    """K1 wrapper: y (n, C) = A x for x (n, K) with ``coef`` from
    ``lattice_coefficients``."""
    if _is_cpu(x):
        return stencil_matvec_plain(coef, x, L, C, K)
    nz, ny, nx = L
    x = x.contiguous()
    _require(coef, x, "stencil_matvec coef")
    if x.shape != (nz * ny * nx, K) or coef.shape != (TERMS, C * K, x.shape[0]):
        raise ValueError(f"stencil_matvec: bad shapes x {tuple(x.shape)}, "
                         f"coef {tuple(coef.shape)} for L={L}, C={C}, K={K}")
    y = torch.empty((x.shape[0], C), dtype=x.dtype, device=x.device)
    lib = load_library()
    check(lib.fn("jt_stencil_matvec", dtype_suffix(x))(
        coef.data_ptr(), x.data_ptr(), y.data_ptr(), C, K, nz, ny, nx,
        stream_handle()), "stencil_matvec")
    stencil_matvec.launches += 1
    return y


stencil_matvec.launches = 0


def embed(A):
    """(C, K, coef) of a StencilMatrix (C, K blocks) or a ScalarStencil
    (C = K = 1), coefficients from ``lattice_coefficients``."""
    if A.diag.ndim == 3:  # StencilMatrix (C, K, n)
        C, K = A.diag.shape[0], A.diag.shape[1]
        diag, plus, minus = A.diag, A.plus, A.minus
    else:  # ScalarStencil
        C = K = 1
        diag = A.diag.reshape(1, 1, -1)
        plus = {a: v[None, None] for a, v in A.plus.items()}
        minus = {a: v[None, None] for a, v in A.minus.items()}
    return C, K, lattice_coefficients(tuple(A.L), diag, plus, minus)


class StencilMatvec:
    """Matvec for a StencilMatrix / ScalarStencil through K1: embeds the
    coefficients once (per Jacobian), then maps (n, K) or (n,) vectors."""

    def __init__(self, A):
        self.L = tuple(A.L)
        self.C, self.K, self.coef = embed(A)

    def __call__(self, x):
        if x.ndim == 1:
            return stencil_matvec(self.coef, x[:, None], self.L, self.C,
                                  self.K)[:, 0]
        return stencil_matvec(self.coef, x, self.L, self.C, self.K)


# ---------------------------------------------------------------------------
# K2: fused scalar residual / weighted-Jacobi pass
# ---------------------------------------------------------------------------
MODE_INIT, MODE_RESIDUAL, MODE_SMOOTH = 0, 1, 2


def scalar_jacobi_plain(coef, b, u, omega: float, mode: int, L):
    """Plain version of K2 with B2/B3's arithmetic (``coef`` (7, 1, n)):
    mode 0 ``omega*b*dinv``; mode 1 ``b - A u``; mode 2
    ``u + omega*(b - A u)*dinv``; ``dinv = where(d != 0, 1/d, 0)``."""
    d = coef[0, 0]
    dinv = torch.where(d != 0, 1.0 / d, torch.zeros_like(d))
    if mode == MODE_INIT:
        return omega * b * dinv
    res = b - stencil_matvec_plain(coef, u[:, None], L, 1, 1)[:, 0]
    if mode == MODE_RESIDUAL:
        return res
    return u + omega * res * dinv


def scalar_jacobi(coef, b, u, omega: float, mode: int, L):
    """K2 wrapper: one fused pass (see ``scalar_jacobi_plain``); ``u`` is
    ignored (may be None) in mode 0."""
    if _is_cpu(b):
        return scalar_jacobi_plain(coef, b, u, omega, mode, L)
    nz, ny, nx = L
    n = nz * ny * nx
    b = b.contiguous()
    _require(coef, b, "scalar_jacobi coef")
    if b.shape != (n,) or coef.shape != (TERMS, 1, n):
        raise ValueError(f"scalar_jacobi: bad shapes b {tuple(b.shape)}, "
                         f"coef {tuple(coef.shape)} for L={L}")
    u_ptr = None
    if mode != MODE_INIT:
        u = u.contiguous()
        _require(u, b, "scalar_jacobi u")
        if u.shape != (n,):
            raise ValueError(f"scalar_jacobi: bad shape u {tuple(u.shape)}")
        u_ptr = u.data_ptr()
    out = torch.empty_like(b)
    lib = load_library()
    check(lib.fn("jt_scalar_jacobi", dtype_suffix(b))(
        coef.data_ptr(), b.data_ptr(), u_ptr, out.data_ptr(), float(omega),
        int(mode), nz, ny, nx, stream_handle()), "scalar_jacobi")
    scalar_jacobi.launches += 1
    return out


scalar_jacobi.launches = 0


# ---------------------------------------------------------------------------
# K4: one Chebyshev step on a scalar stencil
# ---------------------------------------------------------------------------
CHEB_ZERO, CHEB_FIRST, CHEB_STEP = 0, 1, 2


def scalar_chebyshev_plain(coef, b, u, d, steps, step: int, mode: int, L):
    """Plain version of K4 with B6/B7's arithmetic (``coef`` (7, 1, n),
    ``steps`` (>= step+1, 2) from ``linsolve.cheby.chebyshev_steps``):
    mode 0 ``d' = (dinv*b)/theta``, ``u' = d'``; mode 1
    ``d' = (dinv*(b - A u))/theta``, ``u' = u + d'``; mode 2
    ``d' = c1*d + c2*(dinv*(b - A u))``, ``u' = u + d'`` with
    ``(c1, c2) = steps[step]``. Returns (u', d')."""
    d0 = coef[0, 0]
    dinv = torch.where(d0 != 0, 1.0 / d0, torch.zeros_like(d0))
    if mode == CHEB_ZERO:
        dn = (dinv * b) / steps[0, 0]
        return dn, dn
    r = dinv * (b - stencil_matvec_plain(coef, u[:, None], L, 1, 1)[:, 0])
    if mode == CHEB_FIRST:
        dn = r / steps[0, 0]
    else:
        dn = steps[step, 0] * d + steps[step, 1] * r
    return u + dn, dn


def scalar_chebyshev(coef, b, u, d, steps, step: int, mode: int, L):
    """K4 wrapper: one Chebyshev step (see ``scalar_chebyshev_plain``);
    ``u`` is ignored in mode 0 and ``d`` outside mode 2 (either may be
    None there). Returns (u', d')."""
    if _is_cpu(b):
        return scalar_chebyshev_plain(coef, b, u, d, steps, step, mode, L)
    nz, ny, nx = L
    n = nz * ny * nx
    b = b.contiguous()
    _require(coef, b, "scalar_chebyshev coef")
    _require(steps, b, "scalar_chebyshev steps")
    if b.shape != (n,) or coef.shape != (TERMS, 1, n) or steps.ndim != 2 \
            or steps.shape[1] != 2 or not 0 <= step < steps.shape[0]:
        raise ValueError(f"scalar_chebyshev: bad shapes b {tuple(b.shape)}, "
                         f"coef {tuple(coef.shape)}, steps "
                         f"{tuple(steps.shape)} for L={L}, step={step}")
    ptrs = []
    for name, v, used in (("u", u, mode != CHEB_ZERO),
                          ("d", d, mode == CHEB_STEP)):
        if not used:
            ptrs.append(None)
            continue
        v = v.contiguous()
        _require(v, b, f"scalar_chebyshev {name}")
        if v.shape != (n,):
            raise ValueError(f"scalar_chebyshev: bad shape {name} "
                             f"{tuple(v.shape)}")
        ptrs.append(v.data_ptr())
    d_out = torch.empty_like(b)
    u_out = None if mode == CHEB_ZERO else torch.empty_like(b)
    lib = load_library()
    check(lib.fn("jt_scalar_chebyshev", dtype_suffix(b))(
        coef.data_ptr(), b.data_ptr(), ptrs[0], ptrs[1], steps.data_ptr(),
        None if u_out is None else u_out.data_ptr(), d_out.data_ptr(),
        int(step), int(mode), nz, ny, nx, stream_handle()),
        "scalar_chebyshev")
    scalar_chebyshev.launches += 1
    return (d_out if u_out is None else u_out), d_out


scalar_chebyshev.launches = 0


class ScalarLevel:
    """GMG level ops for a ScalarStencil through K2 and K4 — the JAX
    package's level interface (``smooth0``/``smooth``/``residual``, the
    fused Jacobi phase hooks ``presmooth_residual``/``postsmooth``/
    ``sweep_n`` and their Chebyshev variants ``*_cheby``), each phase a
    loop of single-pass launches.

    The Chebyshev hooks take the level's per-step scalar table
    (``linsolve.cheby.chebyshev_steps``, built once per CPR update) where
    the JAX hooks take ``lmax`` and ``lower``; the residual after a
    Chebyshev presmooth is K2's residual pass."""

    def __init__(self, A):
        self.L = tuple(A.L)
        _, _, self.coef = embed(A)  # (7, 1, n)

    def _pass(self, b, u, omega, mode):
        return scalar_jacobi(self.coef, b, u, omega, mode, self.L)

    def smooth0(self, b, omega):
        """One sweep from the zero guess: elementwise, no stencil pass."""
        return self._pass(b, None, omega, MODE_INIT)

    def smooth(self, u, b, omega):
        return self._pass(b, u, omega, MODE_SMOOTH)

    def residual(self, u, b):
        return self._pass(b, u, 0.0, MODE_RESIDUAL)

    def sweep_n(self, b, omega, n_sweep):
        u = self.smooth0(b, omega)
        for _ in range(n_sweep - 1):
            u = self.smooth(u, b, omega)
        return u

    def presmooth_residual(self, b, omega, n_sweep):
        u = self.sweep_n(b, omega, n_sweep)
        return u, self.residual(u, b)

    def postsmooth(self, u, b, omega, n_sweep):
        for _ in range(n_sweep):
            u = self.smooth(u, b, omega)
        return u

    # -- Chebyshev (GMG(smoother="chebyshev")) ---------------------------
    def _cheby(self, b, u, steps, n_sweep):
        """``n_sweep`` Chebyshev steps from ``u`` (None: from zero)."""
        mode = CHEB_ZERO if u is None else CHEB_FIRST
        u, d = scalar_chebyshev(self.coef, b, u, None, steps, 0, mode, self.L)
        for k in range(1, n_sweep):
            u, d = scalar_chebyshev(self.coef, b, u, d, steps, k, CHEB_STEP,
                                    self.L)
        return u

    def sweep_n_cheby(self, b, steps, n_sweep):
        return self._cheby(b, None, steps, n_sweep)

    def presmooth_residual_cheby(self, b, steps, n_sweep):
        u = self._cheby(b, None, steps, n_sweep)
        return u, self.residual(u, b)

    def postsmooth_cheby(self, u, b, steps, n_sweep):
        return self._cheby(b, u, steps, n_sweep)
