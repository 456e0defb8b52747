"""Stencil kernels K1 (block-stencil SpMV), K2 (scalar Jacobi pass), K4
(scalar Chebyshev step) and K5 (a whole scalar Jacobi smoothing phase).

Wrappers around ``csrc/stencil_kernels.cu``, with the plain PyTorch version
of each kernel beside it and a launch counter on each wrapper. A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
the kernel or raises — there is no fallback.

- K1 ``stencil_matvec`` replaces jutul/jl_tpu/ops/pallas/stencil_kernels.py
  ``_kernel`` (B1): the 7-point C×K block-stencil SpMV, used as the Krylov
  operator (C = K = ndof) and as CPR stage 2's pressure-column matvec
  (C = ndof, K = 1). Bound by HBM bytes: 7·C·K coefficient streams per
  cell against 2 flops each; the kernel reads each coefficient once and
  leaves neighbour reuse of ``x`` to L1/L2. A thread computes every
  component of a few consecutive cells of a row with compile-time (C, K)
  and all its loads issued first; its sums are those of its original
  mapping (one thread per output) bit for bit, which stays as
  ``stencil_matvec_reference`` for the card tests.
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
- K5 ``scalar_jacobi_phase`` replaces ``_kernel_slab_sweeps_db`` (B8, the
  double-buffered deep-halo slab kernel): a whole weighted-Jacobi phase
  (up to ``PHASE_MAX_DEPTH`` stencil applications: the sweeps from zero
  or from u, plus an optional residual) in one launch, by 2.5-D
  z-marching with a register wavefront, so the coefficients stream once
  per phase. A ring of plane stages in shared memory, filled by
  ``cp.async`` several planes ahead, hides the per-step HBM latency, and
  the z-chunk depth is chosen per level (``phase_plan``) for the least
  work on the busiest SM. Its plain version is K2's plain loop; it keeps K2's per-cell
  arithmetic. ``ScalarLevel(phase_kernel=True)`` runs its Jacobi hooks on
  it (``GMG.slab_double_buffer``).

Coefficient dtype (replaces the ``coef_dtype=bfloat16`` form of B1-B4 and
B6-B8, jutul/jl_tpu/ops/pallas/stencil_kernels.py:177-231, :323, :819,
:922-955): every wrapper and plain version takes its coefficients in the
vector dtype or in ``torch.bfloat16``. bfloat16 coefficients are widened to
the vector dtype on load and the arithmetic is unchanged, so a call on
``c.to(bfloat16)`` equals the same call on ``c.to(bfloat16).to(vector
dtype)`` bit for bit; ``b``, ``u``, ``x``, ``d``, ``steps`` and every output
stay in the vector dtype. ``embed(A, coef_dtype)`` rounds once per
preconditioner update. The plain versions take bfloat16 coefficients with
float32 or float64 vectors; the CUDA entries are built for bfloat16 x
float32 only and raise on bfloat16 x float64. The bfloat16 entries count
their launches apart (``<wrapper>.launches_bf16c``).

The lattice is the natural contiguous (nz, ny, nx) one: coefficients are
embedded once per matrix as ``(7, C·K, n)`` with zero boundary entries
(``lattice_coefficients``), and neighbours outside the lattice are skipped
by bounds checks — no lane padding, no wrapped reads.
"""

from __future__ import annotations

import ctypes

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


def _coef_entry(coef, like, name, word_reads=False):
    """The CUDA entry's suffix for coefficients ``coef`` with vectors like
    ``like``: the pair (coefficient dtype, vector dtype) must be (T, T) or
    (bfloat16, float32); ``coef`` contiguous on ``like``'s device.
    ``word_reads``: the kernel reads bfloat16 coefficients as aligned 4-byte
    words (K5), so an odd count needs its padding element (``embed`` gives
    one). Returns (suffix, counts as bfloat16)."""
    if coef.dtype != torch.bfloat16:
        _require(coef, like, name)
        return dtype_suffix(like), False
    if coef.device != like.device or not coef.is_contiguous():
        raise ValueError(f"{name}: expected contiguous coefficients on "
                         f"{like.device}, got {coef.device}")
    if like.dtype != torch.float32:
        raise TypeError(
            f"{name}: the CUDA kernels take bfloat16 coefficients with "
            f"float32 vectors only, got {like.dtype} vectors (the plain "
            "versions take float64 too)")
    if coef.data_ptr() % 4:
        raise ValueError(f"{name}: bfloat16 coefficients must start on a "
                         "4-byte boundary")
    if word_reads and coef.numel() % 2 and \
            coef.untyped_storage().nbytes() < \
            2 * (coef.storage_offset() + coef.numel() + 1):
        raise ValueError(f"{name}: an odd number of bfloat16 coefficients "
                         "needs one padding element after it in its "
                         "storage (embed(A, torch.bfloat16) allocates it)")
    return "bf16c_f32", True


def _count(wrapper, narrow: bool):
    """One more launch of ``wrapper``'s kernel, by coefficient dtype."""
    if narrow:
        wrapper.launches_bf16c += 1
    else:
        wrapper.launches += 1


def _wide(coef, like):
    """``coef`` in ``like``'s dtype: bfloat16 coefficients widen (exact)."""
    return coef if coef.dtype == like.dtype else coef.to(like.dtype)


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
    cf = _wide(coef, x).reshape(TERMS, C, K, nz, ny, nx)
    acc = None
    for t in range(TERMS):
        for k in range(K):
            term = cf[t, :, k] * views[t][k]
            acc = term if acc is None else acc + term
    return acc.reshape(C, -1).T


def stencil_matvec(coef, x, L, C: int, K: int):
    """K1 wrapper: y (n, C) = A x for x (n, K) with ``coef`` from
    ``lattice_coefficients``. The kernel indexes cells in 32 bits: on the
    card a lattice holds at most 2**31 - 1 cells (a ValueError beyond).
    Each launch also counts in ``launches_by_shape[(entry, C, K)]``."""
    if _is_cpu(x):
        return stencil_matvec_plain(coef, x, L, C, K)
    nz, ny, nx = L
    if nz * ny * nx > _MAX_CELLS:
        raise ValueError(f"stencil_matvec: {nz * ny * nx} cells; the kernel "
                         f"indexes at most {_MAX_CELLS}")
    x = x.contiguous()
    entry, narrow = _coef_entry(coef, x, "stencil_matvec coef")
    if x.shape != (nz * ny * nx, K) or coef.shape != (TERMS, C * K, x.shape[0]):
        raise ValueError(f"stencil_matvec: bad shapes x {tuple(x.shape)}, "
                         f"coef {tuple(coef.shape)} for L={L}, C={C}, K={K}")
    y = torch.empty((x.shape[0], C), dtype=x.dtype, device=x.device)
    lib = load_library()
    check(lib.fn("jt_stencil_matvec", entry)(
        coef.data_ptr(), x.data_ptr(), y.data_ptr(), C, K, nz, ny, nx,
        stream_handle()), "stencil_matvec")
    _count(stencil_matvec, narrow)
    shape = (entry, C, K)
    stencil_matvec.launches_by_shape[shape] = \
        stencil_matvec.launches_by_shape.get(shape, 0) + 1
    return y


stencil_matvec.launches = stencil_matvec.launches_bf16c = 0
stencil_matvec.launches_by_shape = {}
_MAX_CELLS = 2 ** 31 - 1  # K1's 32-bit cell indices


def stencil_matvec_reference(coef, x, L, C: int, K: int):
    """K1's original mapping (one thread per cell and component) on CUDA
    tensors, float32 or float64: the card tests and chip_smoke.py hold
    ``stencil_matvec`` to it bit for bit. No simulate path calls it; it
    counts no launch."""
    nz, ny, nx = L
    if _is_cpu(x):
        raise RuntimeError("stencil_matvec_reference runs on the card only")
    x = x.contiguous()
    _require(coef, x, "stencil_matvec_reference coef")
    if x.shape != (nz * ny * nx, K) or \
            coef.shape != (TERMS, C * K, x.shape[0]):
        raise ValueError(f"stencil_matvec_reference: bad shapes x "
                         f"{tuple(x.shape)}, coef {tuple(coef.shape)} for "
                         f"L={L}, C={C}, K={K}")
    y = torch.empty((x.shape[0], C), dtype=x.dtype, device=x.device)
    check(load_library().fn("jt_stencil_matvec_ref", dtype_suffix(x))(
        coef.data_ptr(), x.data_ptr(), y.data_ptr(), C, K, nz, ny, nx,
        stream_handle()), "stencil_matvec_reference")
    return y


def embed(A, coef_dtype=None):
    """(C, K, coef) of a StencilMatrix (C, K blocks) or a ScalarStencil
    (C = K = 1), coefficients from ``lattice_coefficients``, cast once to
    ``coef_dtype`` (None: as assembled; ``torch.bfloat16`` halves the
    block)."""
    if A.diag.ndim == 3:  # StencilMatrix (C, K, n)
        C, K = A.diag.shape[0], A.diag.shape[1]
        diag, plus, minus = A.diag, A.plus, A.minus
    else:  # ScalarStencil
        C = K = 1
        diag = A.diag.reshape(1, 1, -1)
        plus = {a: v[None, None] for a, v in A.plus.items()}
        minus = {a: v[None, None] for a, v in A.minus.items()}
    coef = lattice_coefficients(tuple(A.L), diag, plus, minus)
    if coef_dtype is not None and coef_dtype != coef.dtype:
        # an even number of elements in the storage: K5 reads bfloat16
        # coefficients as 4-byte words, the last one may hold a padding half
        n = coef.numel()
        buf = torch.zeros(n + n % 2, dtype=coef_dtype, device=coef.device)
        buf[:n] = coef.reshape(-1)
        coef = buf[:n].view(coef.shape)
    return C, K, coef


class StencilMatvec:
    """Matvec for a StencilMatrix / ScalarStencil through K1: embeds the
    coefficients once (per Jacobian), in ``coef_dtype`` if given, then
    maps (n, K) or (n,) vectors."""

    def __init__(self, A, coef_dtype=None):
        self.L = tuple(A.L)
        self.C, self.K, self.coef = embed(A, coef_dtype)

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
    coef = _wide(coef, b)
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
    entry, narrow = _coef_entry(coef, b, "scalar_jacobi coef")
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
    check(lib.fn("jt_scalar_jacobi", entry)(
        coef.data_ptr(), b.data_ptr(), u_ptr, out.data_ptr(), float(omega),
        int(mode), nz, ny, nx, stream_handle()), "scalar_jacobi")
    _count(scalar_jacobi, narrow)
    return out


scalar_jacobi.launches = scalar_jacobi.launches_bf16c = 0


# ---------------------------------------------------------------------------
# K5: a whole weighted-Jacobi smoothing phase on a scalar stencil
# ---------------------------------------------------------------------------
PHASE_MAX_DEPTH = 4  # stencil applications per K5 launch (csrc kPhaseMaxDepth)


def _phase_depth(u, n_sweep: int, emit_residual: bool) -> int:
    """Stencil applications of a phase: the sweeps (the first one from
    zero is elementwise) plus the residual."""
    return (n_sweep - 1 if u is None else n_sweep) + int(emit_residual)


def scalar_jacobi_phase_plain(coef, b, u, omega: float, n_sweep: int,
                              emit_residual: bool, L):
    """Plain version of K5: K2's plain loop — ``n_sweep`` weighted-Jacobi
    sweeps from ``u`` (None: from zero, the first sweep ``omega*b*dinv``),
    then the residual ``b - A u`` if asked. Returns (u, r or None)."""
    coef = _wide(coef, b)
    if u is None:
        u = scalar_jacobi_plain(coef, b, None, omega, MODE_INIT, L)
        n_sweep -= 1
    for _ in range(n_sweep):
        u = scalar_jacobi_plain(coef, b, u, omega, MODE_SMOOTH, L)
    r = scalar_jacobi_plain(coef, b, u, 0.0, MODE_RESIDUAL, L) \
        if emit_residual else None
    return u, r


def scalar_jacobi_phase(coef, b, u, omega: float, n_sweep: int,
                        emit_residual: bool, L):
    """K5 wrapper: one smoothing phase (see ``scalar_jacobi_phase_plain``)
    of at most ``PHASE_MAX_DEPTH`` stencil applications. Returns
    (u, r or None)."""
    if _is_cpu(b):
        return scalar_jacobi_phase_plain(coef, b, u, omega, n_sweep,
                                         emit_residual, L)
    return _launch_phase(coef, b, u, omega, n_sweep, emit_residual, L)


def _launch_phase(coef, b, u, omega, n_sweep, emit_residual, L, tz=0):
    """K5's launch on CUDA tensors. ``tz`` pins the z-chunk depth the
    kernel's planner otherwise picks (0): the card tests use it to reach
    ragged chunkings."""
    nz, ny, nx = L
    n = nz * ny * nx
    depth = _phase_depth(u, n_sweep, emit_residual)
    if not 0 <= depth <= PHASE_MAX_DEPTH:
        raise ValueError(f"scalar_jacobi_phase: {depth} stencil applications "
                         f"(n_sweep={n_sweep}, residual={emit_residual}); "
                         f"one launch takes 0..{PHASE_MAX_DEPTH}")
    b = b.contiguous()
    entry, narrow = _coef_entry(coef, b, "scalar_jacobi_phase coef",
                                word_reads=True)
    if b.shape != (n,) or coef.shape != (TERMS, 1, n):
        raise ValueError(f"scalar_jacobi_phase: bad shapes b {tuple(b.shape)},"
                         f" coef {tuple(coef.shape)} for L={L}")
    u_ptr = None
    if u is not None:
        u = u.contiguous()
        _require(u, b, "scalar_jacobi_phase u")
        if u.shape != (n,):
            raise ValueError(f"scalar_jacobi_phase: bad shape u "
                             f"{tuple(u.shape)}")
        u_ptr = u.data_ptr()
    u_out = torch.empty_like(b)
    r_out = torch.empty_like(b) if emit_residual else None
    lib = load_library()
    check(lib.fn("jt_scalar_jacobi_phase", entry)(
        coef.data_ptr(), b.data_ptr(), u_ptr, u_out.data_ptr(),
        None if r_out is None else r_out.data_ptr(), float(omega),
        int(n_sweep), int(u is None), nz, ny, nx, int(tz), stream_handle()),
        "scalar_jacobi_phase")
    _count(scalar_jacobi_phase, narrow)
    return u_out, r_out


def phase_plan(dtype, n_sweep: int, from_zero: bool, emit_residual: bool, L,
               coef_dtype=None):
    """(z-chunk depth tz, blocks, resident blocks per SM) of the plan K5's
    planner picks for a phase on the card (csrc ``choose_phase_plan``), for
    reports. ``coef_dtype=torch.bfloat16``: the bfloat16-coefficient entry's
    plan (float32 vectors)."""
    out = (ctypes.c_int * 3)()
    suffix = dtype_suffix(torch.empty(0, dtype=dtype))
    if coef_dtype == torch.bfloat16:
        if dtype != torch.float32:
            raise TypeError("bfloat16 coefficients: float32 vectors only")
        suffix = "bf16c_f32"
    check(load_library().fn("jt_scalar_jacobi_phase_plan", suffix)(
        int(n_sweep), int(from_zero), int(emit_residual), *L,
        ctypes.cast(out, ctypes.c_void_p)), "phase_plan")
    return tuple(out)


scalar_jacobi_phase.launches = scalar_jacobi_phase.launches_bf16c = 0


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
    coef = _wide(coef, b)
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
    entry, narrow = _coef_entry(coef, b, "scalar_chebyshev coef")
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
    check(lib.fn("jt_scalar_chebyshev", entry)(
        coef.data_ptr(), b.data_ptr(), ptrs[0], ptrs[1], steps.data_ptr(),
        None if u_out is None else u_out.data_ptr(), d_out.data_ptr(),
        int(step), int(mode), nz, ny, nx, stream_handle()),
        "scalar_chebyshev")
    _count(scalar_chebyshev, narrow)
    return (d_out if u_out is None else u_out), d_out


scalar_chebyshev.launches = scalar_chebyshev.launches_bf16c = 0


class ScalarLevel:
    """GMG level ops for a ScalarStencil through K2, K4 and K5 — the JAX
    package's level interface (``smooth0``/``smooth``/``residual``, the
    fused Jacobi phase hooks ``presmooth_residual``/``postsmooth``/
    ``sweep_n`` and their Chebyshev variants ``*_cheby``).

    The Jacobi phase hooks are a loop of single-pass K2 launches, or with
    ``phase_kernel`` (``GMG.slab_double_buffer``) K5 launches of whole
    phases, chunked to ``PHASE_MAX_DEPTH`` stencil applications as the JAX
    slab level chunks ``sweep_n`` to its halo depth. Both give the same
    values: K5 keeps K2's arithmetic.

    The Chebyshev hooks take the level's per-step scalar table
    (``linsolve.cheby.chebyshev_steps``, built once per CPR update) where
    the JAX hooks take ``lmax`` and ``lower``; the residual after a
    Chebyshev presmooth is K2's residual pass.

    ``coef_dtype=torch.bfloat16`` stores the level's coefficients in
    bfloat16 (``GMG(coef_dtype="bf16")``): every hook then reads half the
    coefficient bytes and computes in the vectors' dtype."""

    def __init__(self, A, phase_kernel: bool = False, coef_dtype=None):
        self.L = tuple(A.L)
        _, _, self.coef = embed(A, coef_dtype)  # (7, 1, n)
        self.phase_kernel = bool(phase_kernel)

    def _pass(self, b, u, omega, mode):
        return scalar_jacobi(self.coef, b, u, omega, mode, self.L)

    def smooth0(self, b, omega):
        """One sweep from the zero guess: elementwise, no stencil pass."""
        return self._pass(b, None, omega, MODE_INIT)

    def smooth(self, u, b, omega):
        return self._pass(b, u, omega, MODE_SMOOTH)

    def residual(self, u, b):
        return self._pass(b, u, 0.0, MODE_RESIDUAL)

    def _phase(self, b, u, omega, n_sweep, emit_residual):
        """``n_sweep`` sweeps from ``u`` (None: zero), then the residual if
        asked, in K5 launches of at most PHASE_MAX_DEPTH applications."""
        r = None
        while True:
            k = min(n_sweep, PHASE_MAX_DEPTH + int(u is None))
            n_sweep -= k
            res = emit_residual and n_sweep == 0 and \
                _phase_depth(u, k, True) <= PHASE_MAX_DEPTH
            u, r = scalar_jacobi_phase(self.coef, b, u, omega, k, res,
                                       self.L)
            if n_sweep == 0:
                break
        if emit_residual and r is None:
            u, r = scalar_jacobi_phase(self.coef, b, u, omega, 0, True,
                                       self.L)
        return u, r

    def sweep_n(self, b, omega, n_sweep):
        if self.phase_kernel:
            return self._phase(b, None, omega, n_sweep, False)[0]
        u = self.smooth0(b, omega)
        for _ in range(n_sweep - 1):
            u = self.smooth(u, b, omega)
        return u

    def presmooth_residual(self, b, omega, n_sweep):
        if self.phase_kernel:
            return self._phase(b, None, omega, n_sweep, True)
        u = self.sweep_n(b, omega, n_sweep)
        return u, self.residual(u, b)

    def postsmooth(self, u, b, omega, n_sweep):
        if self.phase_kernel:
            return self._phase(b, u, omega, n_sweep, False)[0]
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
