"""Stencil kernels K1 (block-stencil SpMV), K2 (scalar Jacobi pass), K4
(scalar Chebyshev step), K8/K9 (a whole GMG level's Jacobi / Chebyshev
phase held on chip) and K10/K11 (a whole Jacobi / Chebyshev phase of a
large level, tiled and marched in z).

Wrappers around ``csrc/stencil_kernels.cu``, ``csrc/level_kernels.cu`` and
``csrc/slab_kernels.cu``,
with the plain PyTorch version of each kernel beside it and a launch
counter on each wrapper. A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel or raises — there is no
fallback.

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
- K2 ``scalar_jacobi`` replaces ``_kernel_fused`` (B4): one fused
  residual or weighted-Jacobi pass on a scalar stencil; chains of it run
  the phases no other kernel takes (levels under ``SLAB_MIN_CELLS``,
  ``ScalarLevel(resident=False, slab=False)``). Bound by HBM bytes (7
  coefficient streams + 2–3 vectors per pass); a phase is a loop of
  launches, so the coefficients stream once per sweep.
- K4 ``scalar_chebyshev``: one step of the Chebyshev recurrence on a
  scalar stencil, per-step scalars read from a small device table. Bound
  by HBM bytes as K2 (plus the direction vector d in and out); one launch
  per step. Chains of it (and K2's residual) run the Chebyshev phases no
  other kernel takes (levels under ``SLAB_MIN_CELLS`` outside the coarse
  solve, ``sweep_n_cheby`` on a large level, ``ScalarLevel(resident=False,
  slab=False)``); K9 and K11 are held to them.
- K8 ``scalar_sweeps_resident`` replaces ``_kernel_sweeps`` (B3) and K9
  ``scalar_chebyshev_resident`` replaces ``_kernel_sweeps_cheby`` (B6): a
  whole level's Jacobi (K2's arithmetic) or Chebyshev (K4's) phase, with
  the optional residual, in ONE launch that keeps the level in registers
  and shared memory — as a thread-block cluster whose CTAs exchange their
  boundary planes through distributed shared memory, or as a cooperative
  grid that exchanges them through L2 (``resident_plan``). Bound by the
  launch and the sweeps' serial dependence, not bytes. Each equals the
  chain it replaces (K2's, K4's) bit for bit; their plain versions are
  those chains' plain loops. ``ScalarLevel`` routes the coarse solve to
  the cluster form (``RESIDENT_HOOKS``), as the JAX package routes every
  level whose streams fit VMEM to B3/B6 (``scalar_level_ops``).
- K10 ``scalar_jacobi_slab`` replaces ``_kernel_slab_sweeps`` (B2) and
  ``_kernel_slab_sweeps_db`` (B8): a whole weighted-Jacobi phase (up to
  ``SLAB_MAX_DEPTH`` applications) in one launch on a level of at least
  ``SLAB_MIN_CELLS`` cells, the JAX package's slab level. B2 and B8 are
  one function (``_slab_jacobi_compute``) under two DMA schedules; B8
  starts the next slab's copies before the current slab's sweeps, which
  K10's plane rings do for every launch, so ``GMG.slab_double_buffer``
  changes no route. Bound by the bytes its CTAs load (halos included) and
  its z-steps: a thread owns V cells of a lattice row, a CTA an xy tile
  and a z-chunk, marched as a wavefront with each plane's streams copied
  into shared rings ahead of the sweeps; the outer halo loads only its
  first sweep's inputs (``slab_plan`` picks the tile per level). Its plain
  version is K2's plain loop (``scalar_jacobi_phase_plain``); it keeps
  K2's per-cell arithmetic, so it equals the K2 chain bit for bit.
- K11 ``scalar_chebyshev_slab`` replaces ``_kernel_slab_sweeps_cheby``
  (B7): a whole Chebyshev phase (from zero or from u, at most
  ``SLAB_MAX_DEPTH`` applications, the residual if asked) in one launch on
  K10's kernel template, tiles and planner. The direction d is elementwise
  in the recurrence, so it stays in registers beside u and never touches
  HBM; the step scalars are read once per CTA from the level's device
  table. It keeps K4's per-cell arithmetic (and K2's residual), so it
  equals the K4 chain bit for bit; its plain version is K4's plain loop
  (``scalar_chebyshev_phase_plain``).

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
import functools

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


def _coef_entry(coef, like, name):
    """The CUDA entry's suffix for coefficients ``coef`` with vectors like
    ``like``: the pair (coefficient dtype, vector dtype) must be (T, T) or
    (bfloat16, float32); ``coef`` contiguous on ``like``'s device.
    Returns (suffix, counts as bfloat16)."""
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
    if coef_dtype is not None:
        coef = coef.to(coef_dtype)
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
# A whole weighted-Jacobi phase: the plain version K8 and K10 share
# ---------------------------------------------------------------------------
def _phase_depth(u, n_sweep: int, emit_residual: bool) -> int:
    """Stencil applications of a phase: the sweeps (the first one from
    zero is elementwise) plus the residual."""
    return (n_sweep - 1 if u is None else n_sweep) + int(emit_residual)


def scalar_jacobi_phase_plain(coef, b, u, omega: float, n_sweep: int,
                              emit_residual: bool, L):
    """A Jacobi phase as K2's plain loop: ``n_sweep`` weighted-Jacobi
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


def scalar_chebyshev_phase_plain(coef, b, u, steps, n_sweep: int,
                                 emit_residual: bool, L):
    """A Chebyshev phase as K4's plain loop — step 0 from zero (mode 0) or
    from ``u`` (mode 1), then steps 1..n_sweep-1 (mode 2) with the scalars
    of ``steps`` — and K2's plain residual if asked. Returns
    (u, r or None)."""
    mode = CHEB_ZERO if u is None else CHEB_FIRST
    u, d = scalar_chebyshev_plain(coef, b, u, None, steps, 0, mode, L)
    for k in range(1, n_sweep):
        u, d = scalar_chebyshev_plain(coef, b, u, d, steps, k, CHEB_STEP, L)
    r = scalar_jacobi_plain(coef, b, u, 0.0, MODE_RESIDUAL, L) \
        if emit_residual else None
    return u, r


# ---------------------------------------------------------------------------
# K8 / K9: a whole level's smoothing phase held on chip, one launch
# ---------------------------------------------------------------------------
RESIDENT_CELLS = 2  # cells per thread (csrc/level_kernels.cu kCells)
RESIDENT_THREADS = 512  # threads per CTA at most (kThreads)
RESIDENT_MAX_CLUSTER = 16  # CTAs of the cluster form (non-portable size)
RESIDENT_MAX_SMEM = 200 * 1024  # bytes of shared memory a CTA (kMaxSmem)
_FORM_CODE = {"cluster": 1, "grid": 2}
# The card's properties the plan reads (``device_props``): multiprocessors,
# the largest cluster the cluster form launches, and CTAs of the grid form
# co-resident on one SM. CPU tensors route as on an H100 SXM, so that a CPU
# run takes the same hooks as the card.
H100_PROPS = {"sms": 132, "max_cluster": 16, "grid_ctas_per_sm": 1}
# The hooks K8/K9 serve, by form: each True entry measured faster than its
# chain, and each False one slower or no faster, in one call on the card
# (graph ms, PERF.md §6 and scripts/level_resident_probe.py; NVIDIA H100
# 80GB HBM3). A one-launch phase pays ~3 us of launch and load and, per
# sweep after the first, one exchange (~1 us in a cluster, ~3 us through
# L2 in the grid form), so it wins where it replaces many launches — the
# coarse solve's 12 sweeps — and not at the V-cycle's 2 sweeps, whose
# chains of 2-3 launches were as fast or faster. A hook set False takes the
# level's next route (``level_route``: K10 on the mid level, or the chain).
# The JAX package runs the mid level on B3 (its streams fit VMEM); the port
# runs its Jacobi phases on K10, faster there than K8's grid form (graph ms
# 0.0064 / 0.0063 against 0.0076 / 0.0072, PERF.md §6).
RESIDENT_HOOKS = {
    "cluster": {"sweep_n": True, "presmooth_residual": False,
                "postsmooth": False, "sweep_n_cheby": True,
                "presmooth_residual_cheby": False, "postsmooth_cheby": False},
    "grid": {"sweep_n": False, "presmooth_residual": False,
             "postsmooth": False, "sweep_n_cheby": False,
             "presmooth_residual_cheby": False, "postsmooth_cheby": False},
}


def resident_plan(L, dtype, coef_dtype, props, form=None):
    """The launch K8/K9 takes for a level: ``(form, ctas, threads, cells
    per CTA)``, or None where no form holds the level. A pure function of
    the lattice ``L`` (nz, ny, nx), the vector and coefficient dtypes and
    the card's ``props`` (``H100_PROPS``' keys); ``form`` ("cluster" or
    "grid") asks for that form alone.

    A thread holds ``RESIDENT_CELLS`` cells, so a CTA at most
    ``RESIDENT_CELLS * RESIDENT_THREADS``. The cluster form (taken
    first) gives each of at most ``props["max_cluster"]`` CTAs whole
    z-planes; the grid form cuts the lattice into at most ``props["sms"]``
    contiguous chunks (one CTA on each SM, all co-resident). bfloat16
    coefficients have CUDA entries with float32 vectors only."""
    if form not in (None, "cluster", "grid"):
        raise ValueError(f"unknown form {form!r}")
    if dtype not in (torch.float32, torch.float64) or (
            coef_dtype not in (None, dtype) and not (
                coef_dtype == torch.bfloat16 and dtype == torch.float32)):
        return None
    nz, ny, nx = (int(v) for v in L)
    plane = ny * nx
    n = nz * plane
    if n <= 0:
        return None
    cap = RESIDENT_CELLS * RESIDENT_THREADS
    per_warp = 32 * RESIDENT_CELLS
    size = torch.empty(0, dtype=dtype).element_size()

    def threads(cpc):  # whole warps of RESIDENT_CELLS cells a thread
        return 32 * -(-cpc // per_warp)

    def fits(cpc, planes):
        # u twice, ``planes`` planes outside the chunk (csrc resident_smem)
        return cpc <= cap and \
            16 + (2 * cpc + planes * plane) * size <= RESIDENT_MAX_SMEM

    if form in (None, "cluster"):
        ctas = min(nz, int(props["max_cluster"]))
        ppc = -(-nz // ctas)
        ctas = -(-nz // ppc)
        cpc = ppc * plane
        if fits(cpc, 4):
            return "cluster", ctas, threads(cpc), cpc
    if form in (None, "grid") and props["grid_ctas_per_sm"] >= 1:
        cpc = per_warp * -(-n // (per_warp * int(props["sms"])))
        if fits(cpc, 2):
            return "grid", -(-n // cpc), threads(cpc), cpc
    return None


_PROPS = {}
_GRID_EXCHANGE = {}


def _grid_exchange(device, words: int):
    """The grid form's buffers on ``device``: its launch tag and finished-CTA
    count (two zeroed words), and at least ``words`` exchange words (tagged
    values, csrc ``Exchange``) set to the tag 0xffffffff that no launch
    uses. Allocated once, outside any graph capture, and grown when a
    launch needs more; every launch leaves them valid for the next.
    Launches on one device share them, so they must not overlap: the port
    issues them on one stream."""
    have = _GRID_EXCHANGE.get(device.index)
    if have is None or have[1].numel() < words:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the grid form's exchange buffers are "
                               "allocated outside a CUDA graph capture: "
                               "run the launch once before capturing it")
        tag = have[0] if have else torch.zeros(2, dtype=torch.int32,
                                               device=device)
        have = (tag, torch.full((max(words, 1),), -1, dtype=torch.int64,
                                device=device))
        _GRID_EXCHANGE[device.index] = have
    return have


def device_props(device, dtype=torch.float32, coef_dtype=None) -> dict:
    """``resident_plan``'s card properties for the CUDA entry of (vector,
    coefficient) dtype on ``device``, queried once; ``H100_PROPS`` for the
    CPU."""
    if device.type == "cpu":
        return H100_PROPS
    like = torch.empty(0, dtype=dtype)
    suffix = "bf16c_f32" if coef_dtype == torch.bfloat16 else \
        dtype_suffix(like)
    key = (device.index, suffix)
    if key not in _PROPS:
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            check(load_library().fn("jt_level_resident_props", suffix)(
                ctypes.cast(out, ctypes.c_void_p)), "device_props")
        _PROPS[key] = {"sms": out[0], "max_cluster": out[1],
                       "grid_ctas_per_sm": out[2]}
    return _PROPS[key]


# Plain version of K8: K2's plain loop, ``n_sweep`` weighted-Jacobi sweeps
# from ``u`` (None: from zero) and the residual if asked -> (u, r or None)
scalar_sweeps_resident_plain = scalar_jacobi_phase_plain


# Plain version of K9: K4's plain loop and K2's residual -> (u, r or None)
scalar_chebyshev_resident_plain = scalar_chebyshev_phase_plain


def scalar_sweeps_resident(coef, b, u, omega: float, n_sweep: int,
                           emit_residual: bool, L, form=None):
    """K8 wrapper: a whole weighted-Jacobi phase of a level (see
    ``scalar_sweeps_resident_plain``) in one launch, in ``form`` ("cluster"
    or "grid"; None: ``resident_plan``'s choice). A lattice the form cannot
    hold raises. Returns (u, r or None)."""
    if _is_cpu(b):
        return scalar_sweeps_resident_plain(coef, b, u, omega, n_sweep,
                                            emit_residual, L)
    return _launch_resident(scalar_sweeps_resident, coef, b, u, None,
                            omega, n_sweep, emit_residual, L, form)


def scalar_chebyshev_resident(coef, b, u, steps, n_sweep: int,
                              emit_residual: bool, L, form=None):
    """K9 wrapper: ``n_sweep`` Chebyshev steps of a level (see
    ``scalar_chebyshev_resident_plain``; ``steps`` holds at least
    ``n_sweep`` rows) and the residual if asked, in one launch, in
    ``form`` as K8. Returns (u, r or None)."""
    if _is_cpu(b):
        return scalar_chebyshev_resident_plain(coef, b, u, steps, n_sweep,
                                               emit_residual, L)
    return _launch_resident(scalar_chebyshev_resident, coef, b, u, steps,
                            0.0, n_sweep, emit_residual, L, form)


def _launch_resident(wrapper, coef, b, u, steps, omega, n_sweep,
                     emit_residual, L, form):
    """K8's (``steps`` None) or K9's launch on CUDA tensors."""
    name = wrapper.__name__
    nz, ny, nx = L
    n = nz * ny * nx
    if n_sweep < 1:
        raise ValueError(f"{name}: n_sweep={n_sweep}; one launch runs 1 or "
                         "more sweeps")
    b = b.contiguous()
    entry, narrow = _coef_entry(coef, b, f"{name} coef")
    if b.shape != (n,) or coef.shape != (TERMS, 1, n):
        raise ValueError(f"{name}: bad shapes b {tuple(b.shape)}, coef "
                         f"{tuple(coef.shape)} for L={L}")
    plan = resident_plan(L, b.dtype, coef.dtype,
                         device_props(b.device, b.dtype, coef.dtype), form)
    if plan is None:
        raise ValueError(f"{name}: L={L} ({b.dtype}) exceeds the "
                         f"{form or 'cluster and grid'} form's capacity")
    kind, ctas, threads, cpc = plan
    u_ptr = None
    if u is not None:
        u = u.contiguous()
        _require(u, b, f"{name} u")
        if u.shape != (n,):
            raise ValueError(f"{name}: bad shape u {tuple(u.shape)}")
        u_ptr = u.data_ptr()
    if steps is not None:
        _require(steps, b, f"{name} steps")
        if steps.ndim != 2 or steps.shape[1] != 2 or \
                steps.shape[0] < n_sweep:
            raise ValueError(f"{name}: steps {tuple(steps.shape)} for "
                             f"{n_sweep} steps")
    u_out = torch.empty_like(b)
    r_out = torch.empty_like(b) if emit_residual else None
    # the grid form's exchange: a slot of n tagged values (64-bit words, a
    # float64 value in two) for each sweep after the first application
    xs = gsync = None
    napp = _phase_depth(u, n_sweep, emit_residual)
    if kind == "grid" and napp > 1:
        gsync, xs = _grid_exchange(
            b.device, (napp - 1) * n * (b.element_size() // 4))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    head = [coef.data_ptr(), b.data_ptr(), u_ptr]
    if steps is None:
        args = head + [u_out.data_ptr(), ptr(r_out), ptr(xs), ptr(gsync),
                       float(omega)]
    else:
        args = head + [steps.data_ptr(), u_out.data_ptr(), ptr(r_out),
                       ptr(xs), ptr(gsync)]
    check(load_library().fn(f"jt_{name}", entry)(
        *args, int(n_sweep), int(u is None), _FORM_CODE[kind], ctas,
        threads, cpc, nz, ny, nx, stream_handle()), name)
    _count(wrapper, narrow)
    return u_out, r_out


scalar_sweeps_resident.launches = scalar_sweeps_resident.launches_bf16c = 0
scalar_chebyshev_resident.launches = \
    scalar_chebyshev_resident.launches_bf16c = 0


# ---------------------------------------------------------------------------
# K10 / K11: a whole Jacobi / Chebyshev phase of a large level, tiles
# marched in z (one kernel template, csrc/slab_kernels.cu)
# ---------------------------------------------------------------------------
SLAB_MAX_DEPTH = 4  # stencil applications per launch (csrc kSlabMaxDepth)
SLAB_THREADS = 512  # threads per CTA at most (kSlabThreads)
SLAB_MAX_SMEM = 227 * 1024  # dynamic shared memory per CTA (kSlabMaxSmem)
SLAB_SM_SMEM = 228 * 1024  # shared memory of one SM
SLAB_PREFETCH = 1  # planes copied ahead (csrc kSlabPrefetch)
# The JAX package's slab threshold (``scalar_level_ops``' ``min_cells``; it
# takes B2, or B8, or B7, only where a level's streams also miss VMEM: the
# flagship's fine level). ScalarLevel routes every level of at least this
# many cells to K10 and K11: the fine and the mid level.
SLAB_MIN_CELLS = 65536
# The planner's cost model (``slab_plan``), fitted to K10's times over a
# grid of tiles on both flagship levels (scripts/slab_sweeps_probe.py,
# NVIDIA H100 80GB HBM3, 700 W): ns per z-step of a CTA (its barrier, the
# wait for its plane and the sweeps), and the rates at which the card
# delivers the bytes every CTA loads (its halo included) in all and into
# one SM.
SLAB_STEP_NS = 800.0
SLAB_LOAD_BYTES_PER_NS = 3500.0
SLAB_SM_BYTES_PER_NS = 30.0


def _a16(v: int) -> int:
    return -(-v // 16) * 16


def slab_smem(cells: int, napp: int, csize: int, tsize: int,
              from_u: bool, cheby: bool = False) -> int:
    """Dynamic shared memory of a K10 (or, ``cheby``, K11) CTA whose tile
    holds ``cells`` cells of a plane (csrc ``slab_smem_bytes``): the
    published sweeps, a ring of ``napp + SLAB_PREFETCH + 1`` stages of the
    7 coefficient streams and one of ``SLAB_PREFETCH + 1`` stages of b (and
    u0); K11 adds its step scalars (its direction d lives in registers)."""
    return _a16(2 * max(napp, 1) * cells * tsize) + \
        (napp + SLAB_PREFETCH + 1) * _a16(7 * cells * csize) + \
        (SLAB_PREFETCH + 1) * (2 if from_u else 1) * _a16(cells * tsize) + \
        (_a16(2 * (SLAB_MAX_DEPTH + 1) * tsize) if cheby else 0)


def slab_tile(L, napp: int, vec: int, ox: int, oy: int):
    """K10's and K11's tile for own columns ``ox`` and rows ``oy`` (csrc
    ``launch_slab``): ``(tiles along x, along y, tile columns, tile rows)``.
    A tile that does not cover its axis carries a halo on each side:
    ``napp`` rows, and ``napp`` columns rounded up to ``vec``."""
    _, ny, nx = L
    tiles_x, tiles_y = -(-nx // ox), -(-ny // oy)
    hx = -(-napp // vec) * vec if tiles_x > 1 else 0
    hy = napp if tiles_y > 1 else 0
    return (tiles_x, tiles_y, (ox if tiles_x > 1 else nx) + 2 * hx,
            (oy if tiles_y > 1 else ny) + 2 * hy)


@functools.cache
def _halo_cells(length: int, own: int, halo: int, unit: int):
    """Cells loaded along an axis of ``length`` by chunks of ``own`` with
    ``halo`` more on each side (clipped to the axis), counted by their
    distance from the chunk's own cells in runs of ``unit`` (a run's
    distance is its nearest cell's): (distance -> cells summed over the
    chunks, the same for the chunk that loads the most)."""
    total, worst = {}, {}
    for t0 in range(0, length, own):
        hi = min(length, t0 + own)
        h = {}
        for c in range(max(0, t0 - halo), min(length, hi + halo), unit):
            d = t0 - (c + unit - 1) if c + unit <= t0 else \
                c - hi + 1 if c >= hi else 0
            h[d] = h.get(d, 0) + unit
        for d, k in h.items():
            total[d] = total.get(d, 0) + k
        if sum(h.values()) > sum(worst.values()):
            worst = h
    return total, worst


def _slab_bytes(hx, hy, hz, napp, full, thin):
    """Bytes of the loaded cells with distance histograms ``hx``, ``hy``,
    ``hz``: a cell at distance (x + y + z) ``napp`` or more loads only the
    first sweep's inputs (``thin``), the others every stream (``full``)."""
    out = 0
    for a, ka in hx.items():
        for b, kb in hy.items():
            for c, kc in hz.items():
                out += ka * kb * kc * (full if a + b + c < napp else thin)
    return out


def slab_vec(nx: int, dtype) -> int:
    """K10's and K11's cells per thread: one 16-byte copy of a float32 or
    float64 stream (4 or 2 cells) where ``nx`` is a multiple of it, else
    1."""
    v = 2 if dtype == torch.float64 else 4
    return v if nx % v == 0 else 1


_SLAB_PLANS = {}


def slab_plan(L, dtype, coef_dtype, napp: int, from_u: bool,
              props=None, vec=None, cheby: bool = False):
    """K10's (``cheby``: K11's) launch for a phase of ``napp`` stencil
    applications on ``L`` (nz, ny, nx): ``(vec, ox, oy, tz)`` — cells a
    thread, a tile's own columns and rows, a chunk's own planes — or None
    where no tile fits (threads or shared memory, ``slab_tile``) or for
    more than ``SLAB_MAX_DEPTH`` applications. A pure function of its
    arguments (``props``: ``H100_PROPS``' keys, None for them). ``vec``
    pins the cells a thread (1 for misaligned streams). Both kernels are
    capped at 128 registers a thread (``__launch_bounds__(512, 1)``), which
    the occupancy term assumes; K11's d adds registers, not bytes.

    Among the tiles that fit, the least of the cost model's largest term:
    the busiest SM's z-steps (waves x the longest chunk's loaded planes
    plus ``napp``) at ``SLAB_STEP_NS``, its loaded bytes at
    ``SLAB_SM_BYTES_PER_NS``, and every CTA's loaded bytes at
    ``SLAB_LOAD_BYTES_PER_NS`` (the thin halo's bytes counted as such)."""
    if dtype not in (torch.float32, torch.float64) or (
            coef_dtype not in (None, dtype) and not (
                coef_dtype == torch.bfloat16 and dtype == torch.float32)):
        return None
    if not 0 <= napp <= SLAB_MAX_DEPTH:
        return None
    nz, ny, nx = (int(v) for v in L)
    sms = int((props or H100_PROPS)["sms"])
    key = (nz, ny, nx, dtype, coef_dtype, napp, bool(from_u), sms, vec,
           bool(cheby))
    if key in _SLAB_PLANS:
        return _SLAB_PLANS[key]
    tsize = torch.empty(0, dtype=dtype).element_size()
    csize = 2 if coef_dtype == torch.bfloat16 else tsize
    vec = slab_vec(nx, dtype) if vec is None else int(vec)
    full = 7 * csize + (2 if from_u else 1) * tsize
    # a halo cell at distance napp or more loads only its first sweep's
    # inputs: u0, or b and the diagonal
    thin = tsize if from_u else csize + tsize
    best, best_cost = None, 0.0
    if nz * ny * nx > 0 and nx % vec == 0:
        oxs = sorted({vec * -(-(-(-nx // k)) // vec)
                      for k in range(1, nx // vec + 1)}, reverse=True)
        oys = sorted({-(-ny // k) for k in range(1, ny + 1)}, reverse=True)
        tzs = sorted({-(-nz // k) for k in range(1, nz + 1)}, reverse=True)
        for ox in oxs:
            for oy in oys:
                tiles_x, tiles_y, tx, ty = slab_tile(L, napp, vec, ox, oy)
                threads = tx // vec * ty
                if threads > SLAB_THREADS:
                    continue
                smem = slab_smem(tx * ty, napp, csize, tsize, from_u,
                                 cheby)
                if smem > SLAB_MAX_SMEM:
                    continue
                per_sm = max(1, min(SLAB_SM_SMEM // (smem + 1024),
                                    65536 // (128 * 32 * -(-threads // 32))))
                hx = _halo_cells(nx, min(ox, nx), (tx - min(ox, nx)) // 2,
                                 vec)
                hy = _halo_cells(ny, min(oy, ny), (ty - min(oy, ny)) // 2, 1)
                for tz in tzs:
                    hz = _halo_cells(nz, tz, napp, 1)
                    blocks = tiles_x * tiles_y * -(-nz // tz)
                    waves = -(-blocks // (sms * per_sm))
                    planes = min(nz, tz + 2 * napp)
                    loaded = _slab_bytes(hx[0], hy[0], hz[0], napp, full,
                                         thin)
                    on_sm = min(blocks, per_sm) * _slab_bytes(
                        hx[1], hy[1], hz[1], napp, full, thin)
                    cost = max(waves * (planes + napp) * SLAB_STEP_NS,
                               waves * on_sm / SLAB_SM_BYTES_PER_NS,
                               loaded / SLAB_LOAD_BYTES_PER_NS)
                    if best is None or cost < best_cost:
                        best, best_cost = (vec, ox, oy, tz), cost
    _SLAB_PLANS[key] = best
    return best


# Plain version of K10: K2's plain loop, ``n_sweep`` weighted-Jacobi sweeps
# from ``u`` (None: from zero) and the residual if asked -> (u, r or None).
scalar_jacobi_slab_plain = scalar_jacobi_phase_plain
# Plain version of K11: K4's plain steps and K2's residual -> (u, r or None).
scalar_chebyshev_slab_plain = scalar_chebyshev_phase_plain


def scalar_jacobi_slab(coef, b, u, omega: float, n_sweep: int,
                       emit_residual: bool, L, plan=None):
    """K10 wrapper: one smoothing phase (see ``scalar_jacobi_slab_plain``)
    of at most ``SLAB_MAX_DEPTH`` stencil applications in one launch, tiled
    as ``slab_plan`` chooses (``plan`` = (vec, ox, oy, tz) pins it). A
    lattice no tile fits raises. Returns (u, r or None)."""
    if _is_cpu(b):
        return scalar_jacobi_slab_plain(coef, b, u, omega, n_sweep,
                                        emit_residual, L)
    return _launch_slab(scalar_jacobi_slab, coef, b, u, None, omega,
                        n_sweep, emit_residual, L, plan)


def scalar_chebyshev_slab(coef, b, u, steps, n_sweep: int,
                          emit_residual: bool, L, plan=None):
    """K11 wrapper: ``n_sweep`` Chebyshev steps from ``u`` (None: from
    zero) and the residual if asked (see ``scalar_chebyshev_slab_plain``;
    ``steps`` holds at least ``n_sweep`` rows), at most ``SLAB_MAX_DEPTH``
    stencil applications in one launch, tiled as ``slab_plan`` chooses
    (``plan`` pins it). A deeper phase raises on every device (no launch
    can carry d to the next), a lattice no tile fits on the card. Returns
    (u, r or None)."""
    _slab_napp("scalar_chebyshev_slab", u, n_sweep, emit_residual, True)
    if _is_cpu(b):
        return scalar_chebyshev_slab_plain(coef, b, u, steps, n_sweep,
                                           emit_residual, L)
    return _launch_slab(scalar_chebyshev_slab, coef, b, u, steps, 0.0,
                        n_sweep, emit_residual, L, plan)


def _slab_napp(name, u, n_sweep, emit_residual, cheby) -> int:
    """The stencil applications of a K10 or (``cheby``) K11 launch; raises
    beyond ``SLAB_MAX_DEPTH`` or for no sweep where one is needed (from
    zero, or any Chebyshev phase)."""
    napp = _phase_depth(u, n_sweep, emit_residual)
    if not 0 <= napp <= SLAB_MAX_DEPTH or (u is None or cheby) and \
            n_sweep < 1:
        raise ValueError(f"{name}: {napp} stencil applications "
                         f"(n_sweep={n_sweep}, residual={emit_residual}); "
                         f"one launch takes 0..{SLAB_MAX_DEPTH}")
    return napp


def _launch_slab(wrapper, coef, b, u, steps, omega, n_sweep, emit_residual,
                 L, plan):
    """K10's (``steps`` None) or K11's launch on CUDA tensors."""
    name = wrapper.__name__
    cheby = steps is not None
    nz, ny, nx = L
    n = nz * ny * nx
    napp = _slab_napp(name, u, n_sweep, emit_residual, cheby)
    b = b.contiguous()
    entry, narrow = _coef_entry(coef, b, f"{name} coef")
    if b.shape != (n,) or coef.shape != (TERMS, 1, n):
        raise ValueError(f"{name}: bad shapes b {tuple(b.shape)},"
                         f" coef {tuple(coef.shape)} for L={L}")
    u_ptr = None
    if u is not None:
        u = u.contiguous()
        _require(u, b, f"{name} u")
        if u.shape != (n,):
            raise ValueError(f"{name}: bad shape u {tuple(u.shape)}")
        u_ptr = u.data_ptr()
    if cheby:
        _require(steps, b, f"{name} steps")
        if steps.ndim != 2 or steps.shape[1] != 2 or \
                steps.shape[0] < n_sweep:
            raise ValueError(f"{name}: steps {tuple(steps.shape)} for "
                             f"{n_sweep} steps")
    u_out = torch.empty_like(b)
    r_out = torch.empty_like(b) if emit_residual else None
    if plan is None:
        # V cells a thread copy 16 bytes of a vector stream at once (V
        # coefficients): every stream aligned alike, or V = 1. The pointers
        # are OR-ed: this test runs on every launch of the eager main path
        ptrs = b.data_ptr() | u_out.data_ptr() | (u_ptr or 0) | \
            (0 if r_out is None else r_out.data_ptr())
        aligned = ptrs % 16 == 0 and coef.data_ptr() % (
            16 // b.element_size() * coef.element_size()) == 0
        plan = _slab_launch_plan(tuple(L), b.dtype, coef.dtype, napp,
                                 u is not None, aligned, b.device, cheby)
    vec, ox, oy, tz = plan
    head = [coef.data_ptr(), b.data_ptr(), u_ptr]
    outs = [u_out.data_ptr(), None if r_out is None else r_out.data_ptr()]
    args = head + [steps.data_ptr()] + outs if cheby else \
        head + outs + [float(omega)]
    check(load_library().fn(f"jt_{name}", entry)(
        *args, int(n_sweep), int(u is None), nz, ny, nx, vec, ox, oy, tz,
        stream_handle()), name)
    _count(wrapper, narrow)
    return u_out, r_out


@functools.cache
def _slab_launch_plan(L, dtype, coef_dtype, napp, from_u, aligned, device,
                      cheby):
    """``slab_plan`` on ``device`` for a launch whose streams are ``aligned``
    for the type's V cells a thread (else V = 1); raises where no tile
    fits. Cached: the eager main path asks for the same few again and
    again."""
    vec = slab_vec(L[2], dtype) if aligned else 1
    plan = slab_plan(L, dtype, coef_dtype, napp, from_u,
                     device_props(device, dtype, coef_dtype), vec, cheby)
    if plan is None:
        raise ValueError(f"scalar_{'chebyshev' if cheby else 'jacobi'}_slab"
                         f": no tile of L={L} ({dtype}, {napp} applications)"
                         " fits a CTA")
    return plan


scalar_jacobi_slab.launches = scalar_jacobi_slab.launches_bf16c = 0
scalar_chebyshev_slab.launches = scalar_chebyshev_slab.launches_bf16c = 0


@functools.cache
def phase_chunks(n_sweep: int, from_zero: bool, emit_residual: bool,
                 depth: int) -> tuple:
    """The launches of a Jacobi phase cut to ``depth`` stencil applications
    each, as the JAX slab level chunks ``sweep_n`` to its halo depth:
    ``(sweeps, from zero, residual)`` per launch (a from-zero launch takes
    ``depth + 1`` sweeps: its first is elementwise)."""
    out, zero = [], from_zero
    while True:
        k = min(n_sweep, depth + int(zero))
        n_sweep -= k
        res = emit_residual and n_sweep == 0 and \
            (k - int(zero)) + 1 <= depth
        out.append((k, zero, res))
        zero = False
        if n_sweep == 0:
            break
    if emit_residual and not out[-1][2]:
        out.append((0, False, True))
    return tuple(out)


def level_route(L, hook: str, dtype, coef_dtype, props,
                resident: bool = True, slab: bool = True,
                depth: int = 2) -> str:
    """Where ``ScalarLevel`` runs ``hook`` on a level of lattice ``L`` with
    vectors of ``dtype`` and coefficients of ``coef_dtype`` on a card with
    ``props``: "resident" (one K8/K9 launch: ``resident_plan`` holds the
    level and ``RESIDENT_HOOKS`` marks the hook), else "slab" (K10 launches
    of a Jacobi hook, one K11 launch of ``presmooth_residual_cheby`` or
    ``postsmooth_cheby``: at least ``SLAB_MIN_CELLS`` cells and a tile of
    ``depth`` applications from u that fits), else "chain" (single K2 / K4
    passes). A pure function of its arguments; ``resident=False`` and
    ``slab=False`` keep the chains.

    ``sweep_n_cheby`` has no slab route: its d would have to cross
    launches, and the reference's slab level has no such hook either (it
    leaves a long Chebyshev solve on a large level to the per-step chain).
    The fine and mid levels' V-cycle Chebyshev hooks take K11 on eager ms
    measured beside the K4 chain in one call of chip_smoke.py (NVIDIA H100
    80GB HBM3, 700 W; presmooth+residual / postsmooth at 2 steps, f32):
    fine 0.0265 / 0.0335 against the chain's 0.0595 / 0.0471, mid
    0.0420 / 0.0356 against 0.0956 / 0.0678. On the device alone the mid
    level's chain is the faster (graph ms 0.0073 / 0.0057 against K11's
    0.0079 / 0.0078), but each of its 2-3 launches costs more host time
    than that (PERF.md §6)."""
    plan = resident_plan(L, dtype, coef_dtype, props) if resident else None
    if plan is not None and RESIDENT_HOOKS[plan[0]][hook]:
        return "resident"
    if hook == "sweep_n_cheby":
        return "chain"
    if slab and int(np.prod(L)) >= SLAB_MIN_CELLS and slab_plan(
            L, dtype, coef_dtype, depth, True, props,
            cheby=hook.endswith("_cheby")) is not None:
        return "slab"
    return "chain"


class ScalarLevel:
    """GMG level ops for a ScalarStencil through K8/K9, K10/K11, K2 and
    K4 — the JAX package's level interface (``smooth0``/``smooth``/
    ``residual``, the fused Jacobi phase hooks ``presmooth_residual``/
    ``postsmooth``/``sweep_n`` and their Chebyshev variants ``*_cheby``).

    Each hook runs where ``level_route`` sends it, as the JAX package's
    ``scalar_level_ops`` picks a level's kernels: a level that K8/K9 can
    hold (``resident_plan``, with ``resident``) runs each hook that
    ``RESIDENT_HOOKS`` marks — the coarse solve — as one K8 (Jacobi) or K9
    (Chebyshev) launch (B3/B6 take every level whose streams fit VMEM).
    Otherwise the Jacobi hooks of a level of at least ``SLAB_MIN_CELLS``
    cells (with ``slab``: the flagship's fine level, which the reference
    gives B2, or B8 under ``GMG.slab_double_buffer``, and its mid level,
    which the reference gives B3) run as K10 launches of whole phases,
    chunked to ``depth`` stencil applications as the JAX slab level chunks
    ``sweep_n`` to its halo depth, and its ``presmooth_residual_cheby`` and
    ``postsmooth_cheby`` phases of at most ``depth`` applications as one
    K11 launch each (the reference gives the fine level B7 and the mid
    level B6). The rest keep the chains: the Jacobi hooks as a loop of
    single-pass K2 launches, the Chebyshev hooks as one K4 launch per step
    and the residual after a Chebyshev presmooth as K2's residual pass.
    Every route gives the same values: K8 and K10 keep K2's arithmetic, K9
    and K11 K4's. ``resident=False, slab=False`` runs every hook on its
    chain (the card tests hold K8/K9 and K10/K11 to it).

    ``depth``: K10's and K11's applications per launch, ``max(n_smooth,
    2)`` as the reference sizes its slab halo (``GMG.matvecs`` passes it),
    at most ``SLAB_MAX_DEPTH``.

    The Chebyshev hooks take the level's per-step scalar table
    (``linsolve.cheby.chebyshev_steps``, built once per CPR update) where
    the JAX hooks take ``lmax`` and ``lower``.

    ``coef_dtype=torch.bfloat16`` stores the level's coefficients in
    bfloat16 (``GMG(coef_dtype="bf16")``): every hook then reads half the
    coefficient bytes and computes in the vectors' dtype."""

    def __init__(self, A, coef_dtype=None, resident: bool = True,
                 slab: bool = True, depth: int = 2):
        self.L = tuple(A.L)
        _, _, self.coef = embed(A, coef_dtype)  # (7, 1, n)
        self.resident = bool(resident)
        self.slab = bool(slab)
        if not 1 <= depth <= SLAB_MAX_DEPTH:
            raise ValueError(f"depth={depth}: K10 takes 1..{SLAB_MAX_DEPTH} "
                             "applications a launch")
        self.depth = int(depth)
        self._plans = {}
        self._routes = {}

    def plan(self, like):
        """K8/K9's plan (``resident_plan``) for this level with vectors like
        ``like``, or None: the level keeps the chains."""
        key = (like.device, like.dtype)
        if key not in self._plans:
            self._plans[key] = resident_plan(
                self.L, like.dtype, self.coef.dtype,
                device_props(like.device, like.dtype, self.coef.dtype)) \
                if self.resident else None
        return self._plans[key]

    def route(self, hook: str, like) -> str:
        """``level_route`` for ``hook`` with vectors like ``like``."""
        key = (hook, like.device, like.dtype)
        if key not in self._routes:
            self._routes[key] = level_route(
                self.L, hook, like.dtype, self.coef.dtype,
                device_props(like.device, like.dtype, self.coef.dtype),
                self.resident, self.slab, self.depth)
        return self._routes[key]

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
        asked, as the K10 launches of ``phase_chunks`` (``depth``
        applications each). Returns (u, r or None)."""
        r = None
        for k, _, res in phase_chunks(n_sweep, u is None, emit_residual,
                                      self.depth):
            u, r = scalar_jacobi_slab(self.coef, b, u, omega, k, res, self.L)
        return u, r

    def _sweeps(self, b, u, omega, n_sweep, emit_residual):
        return scalar_sweeps_resident(self.coef, b, u, omega, n_sweep,
                                      emit_residual, self.L, self.plan(b)[0])

    def _sweep_chain(self, b, omega, n_sweep):
        """``n_sweep`` sweeps from zero as single K2 passes."""
        u = self.smooth0(b, omega)
        for _ in range(n_sweep - 1):
            u = self.smooth(u, b, omega)
        return u

    def _jacobi(self, hook, b, u, omega, n_sweep, emit_residual):
        """A Jacobi hook on its route. Returns (u, r or None)."""
        route = self.route(hook, b) if n_sweep >= 1 else "chain"
        if route == "resident":
            return self._sweeps(b, u, omega, n_sweep, emit_residual)
        if route == "slab":
            return self._phase(b, u, omega, n_sweep, emit_residual)
        if u is None:
            u = self._sweep_chain(b, omega, n_sweep)
        else:
            for _ in range(n_sweep):
                u = self.smooth(u, b, omega)
        return u, self.residual(u, b) if emit_residual else None

    def sweep_n(self, b, omega, n_sweep):
        return self._jacobi("sweep_n", b, None, omega, n_sweep, False)[0]

    def presmooth_residual(self, b, omega, n_sweep):
        return self._jacobi("presmooth_residual", b, None, omega, n_sweep,
                            True)

    def postsmooth(self, u, b, omega, n_sweep):
        return self._jacobi("postsmooth", b, u, omega, n_sweep, False)[0]

    # -- Chebyshev (GMG(smoother="chebyshev")) ---------------------------
    def _cheby(self, b, u, steps, n_sweep):
        """``n_sweep`` Chebyshev steps from ``u`` (None: from zero)."""
        mode = CHEB_ZERO if u is None else CHEB_FIRST
        u, d = scalar_chebyshev(self.coef, b, u, None, steps, 0, mode, self.L)
        for k in range(1, n_sweep):
            u, d = scalar_chebyshev(self.coef, b, u, d, steps, k, CHEB_STEP,
                                    self.L)
        return u

    def _cheby_hook(self, hook, b, u, steps, n_sweep, emit_residual):
        """A Chebyshev hook on its route: one K9 or K11 launch, or K4 steps
        (and K2's residual) — also for a slab-routed phase deeper than
        ``depth``, since d cannot cross launches. Returns (u, r or None)."""
        route = self.route(hook, b) if n_sweep >= 1 else "chain"
        if route == "resident":
            return scalar_chebyshev_resident(self.coef, b, u, steps, n_sweep,
                                             emit_residual, self.L,
                                             self.plan(b)[0])
        if route == "slab" and \
                _phase_depth(u, n_sweep, emit_residual) <= self.depth:
            return scalar_chebyshev_slab(self.coef, b, u, steps, n_sweep,
                                         emit_residual, self.L)
        u = self._cheby(b, u, steps, n_sweep)
        return u, self.residual(u, b) if emit_residual else None

    def sweep_n_cheby(self, b, steps, n_sweep):
        return self._cheby_hook("sweep_n_cheby", b, None, steps, n_sweep,
                                False)[0]

    def presmooth_residual_cheby(self, b, steps, n_sweep):
        return self._cheby_hook("presmooth_residual_cheby", b, None, steps,
                                n_sweep, True)

    def postsmooth_cheby(self, u, b, steps, n_sweep):
        return self._cheby_hook("postsmooth_cheby", b, u, steps, n_sweep,
                                False)[0]
