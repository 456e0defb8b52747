// 7-point lattice stencil kernels for Hopper (sm_90a): K1 stencil_matvec,
// K2 scalar_jacobi, K4 scalar_chebyshev and K5 scalar_jacobi_phase. Built by
// nvcc into one shared library with a plain C
// interface (ops/cuda/_build.py) and bound with ctypes
// (ops/cuda/stencil_kernels.py, which also holds the plain PyTorch versions).
//
// Lattice: cells in natural C order on (nz, ny, nx), i = (z*ny + y)*nx + x.
// Coefficients are embedded once per Jacobian as coef[t][c*K + k][i] with the
// terms t = diag, +x, -x, +y, -y, +z, -z; a term whose neighbour lies outside
// the lattice is skipped by an explicit bounds check (its coefficient is zero
// anyway). There is no lane padding and no wrap-around read.
//
// The kernels read 7*C*K coefficient streams plus the neighbour values and
// write one value per cell and component: they are bound by HBM bytes, ~4
// bytes of coefficients per flop. K1 gives a thread a few cells of a row and
// all their components, K2 and K4 one thread per output value; all three
// rely on L1/L2 for the neighbour reuse. K5 blocks a whole Jacobi smoothing
// phase in time (several sweeps per coefficient read).
//
// Coefficient type CT (replaces the coef_dtype=bfloat16 form of the TPU
// kernels, stencil_kernels.py:177-231, 323, 819, 922-955): every kernel takes
// its coefficient stream in the vector type T or in bfloat16. A bfloat16
// coefficient is widened to T at its load (exact) and every operation after
// the load is the same, in the same order, so the bfloat16 entry on
// coefficients c equals the T entry on c rounded to bfloat16 and widened,
// bit for bit; dinv comes from the WIDENED diagonal. Vectors, scalars and
// outputs stay T. Only the coefficient bytes halve.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;

// Linear index of term t's neighbour of cell i at (z, y, x); false when
// that neighbour lies outside the lattice.
__device__ __forceinline__ bool neighbour(int t, int z, int y, int x, int nz,
                                          int ny, int nx, long long i,
                                          long long* j) {
  const long long plane = static_cast<long long>(nx) * ny;
  switch (t) {
    case 0: *j = i; return true;
    case 1: *j = i + 1; return x + 1 < nx;
    case 2: *j = i - 1; return x > 0;
    case 3: *j = i + nx; return y + 1 < ny;
    case 4: *j = i - nx; return y > 0;
    case 5: *j = i + plane; return z + 1 < nz;
    default: *j = i - plane; return z > 0;
  }
}

// Coefficient i of a stream of type CT, as T.
template <typename T, typename CT>
struct Coef {
  static __device__ __forceinline__ T load(const CT* __restrict__ p,
                                           long long i) {
    return p[i];
  }
};

template <typename T>
struct Coef<T, __nv_bfloat16> {
  static __device__ __forceinline__ T load(
      const __nv_bfloat16* __restrict__ p, long long i) {
    return static_cast<T>(__bfloat162float(p[i]));
  }
};

// K1's original mapping, kept as a private reference entry
// (jt_stencil_matvec_ref_*) that only the card tests and chip_smoke.py's
// kernel phase call, to show the redesigned K1 below equal to it bit for
// bit: y[i, c] = sum_t sum_k coef[t][c*K+k][i] x[j_t(i), k], one thread per
// cell and output component, one fused multiply-add per term and block entry,
// t = 0..6 outer, k inner, skipped terms left out.
template <typename T, typename CT>
__global__ void stencil_matvec_kernel(const CT* __restrict__ coef,
                                      const T* __restrict__ xv,
                                      T* __restrict__ yv, int C, int K,
                                      int nz, int ny, int nx) {
  const long long n = static_cast<long long>(nz) * ny * nx;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n * C) return;
  const long long i = tid / C;
  const int c = static_cast<int>(tid - i * C);
  const int x = static_cast<int>(i % nx);
  const int y = static_cast<int>((i / nx) % ny);
  const int z = static_cast<int>(i / (static_cast<long long>(nx) * ny));
  const int CK = C * K;
  T acc = T(0);
#pragma unroll
  for (int t = 0; t < 7; ++t) {
    long long j;
    if (!neighbour(t, z, y, x, nz, ny, nx, i, &j)) continue;
    for (int k = 0; k < K; ++k) {
      acc += Coef<T, CT>::load(
                 coef, (static_cast<long long>(t) * CK + c * K + k) * n + i) *
             xv[j * K + k];
    }
  }
  yv[tid] = acc;
}

// K1 (replaces jutul/jl_tpu/ops/pallas/stencil_kernels.py:_kernel, B1, called
// by _stencil_matvec_call :106/:122): the C x K block-stencil SpMV
//   y[i, c] = sum_t sum_k coef[t][c*K+k][i] x[j_t(i), k]
// with x (n, K) and y (n, C) in the cell-major layout of the Krylov vectors,
// for the Krylov operator (C = K = 2), CPR's stage-2 pressure column (C = 2,
// K = 1) and scalar stencils (C = K = 1).
//
// What bounds it: HBM bytes. Each cell reads 7*C*K coefficient streams once
// (4 bytes each at float32, 2 at bfloat16) against 2 flops per
// coefficient, plus K values of x and C of y; x's neighbour reuse is served
// by L1/L2. A bandwidth-bound kernel needs ~3.35 TB/s x ~0.7 us of loads in
// flight, ~18 KB per SM.
//
// What the original mapping (stencil_matvec_kernel above) did about it,
// and this design instead:
// - one thread per (cell, component) gathered x C times and recomputed the
//   neighbours per component: here one thread owns V consecutive x-cells of
//   one lattice row and computes all V*C outputs, reading each neighbour's
//   x once (the row segment x0-1 .. x0+V in one vector load plus two, the
//   four +-y/+-z runs in one vector load each) and storing V*C values in
//   one vector store;
// - three 64-bit divisions per thread: here a 3-D grid (x-tiles, y rows, z
//   planes) gives the lattice coordinates, cell indices are 32-bit and only
//   the stream offsets (t*C*K + c*K + k)*n are 64-bit. So a lattice holds
//   at most INT_MAX cells (launch_matvec refuses more; the original mapping
//   had no such limit);
// - a run-time K loop kept each load behind the sum that uses it: here
//   (C, K) are compile-time for the three shapes the engine launches and
//   every coefficient and x load is issued before the first FMA. Loads of a
//   neighbour outside the lattice read the cell's own x instead (always in
//   bounds) and the FMA is left out, so nothing is branched around;
// - coefficients, read once, go through the non-coherent path with no L1
//   allocation (ld.global.nc.L1::no_allocate), V at a time (8 or 16 bytes),
//   so that L1 keeps x for the neighbours.
// Each output is the same chain as in stencil_matvec_kernel: acc = 0, then
// one fused multiply-add per kept term t = 0..6 and k = 0..K-1 in that
// order, so the two agree bit for bit for every (C, K), dtype and lattice.
// A lattice whose nx is not a multiple of V, or a pointer not aligned for
// the vector width, runs the same body with V = 1; any other (C, K) runs
// stencil_matvec_any_kernel, the same chain with run-time loops.

// B bytes (2, 4, 8, 16 or a multiple of 16, aligned to min(B, 16)) at p
// into dst through the read-only path; kStream: without L1 allocation.
template <int B, bool kStream>
__device__ __forceinline__ void load_ro(const void* p, void* dst) {
  if constexpr (B > 16) {
    static_assert(B % 16 == 0, "load_ro: B > 16 must be a multiple of 16");
#pragma unroll
    for (int o = 0; o < B; o += 16)
      load_ro<16, kStream>(static_cast<const char*>(p) + o,
                           static_cast<char*>(dst) + o);
  } else if constexpr (B == 16) {
    uint4 v;
    if constexpr (kStream)
      asm("ld.global.nc.L1::no_allocate.v4.b32 {%0, %1, %2, %3}, [%4];"
          : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
          : "l"(p));
    else
      v = __ldg(static_cast<const uint4*>(p));
    memcpy(dst, &v, 16);
  } else if constexpr (B == 8) {
    uint2 v;
    if constexpr (kStream)
      asm("ld.global.nc.L1::no_allocate.v2.b32 {%0, %1}, [%2];"
          : "=r"(v.x), "=r"(v.y)
          : "l"(p));
    else
      v = __ldg(static_cast<const uint2*>(p));
    memcpy(dst, &v, 8);
  } else if constexpr (B == 4) {
    unsigned v;
    if constexpr (kStream)
      asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
    else
      v = __ldg(static_cast<const unsigned*>(p));
    memcpy(dst, &v, 4);
  } else {
    static_assert(B == 2, "load_ro: 2, 4, 8, 16 or k*16 bytes");
    unsigned short v;
    if constexpr (kStream)
      asm("ld.global.nc.L1::no_allocate.b16 %0, [%1];" : "=h"(v) : "l"(p));
    else
      v = __ldg(static_cast<const unsigned short*>(p));
    memcpy(dst, &v, 2);
  }
}

// B bytes (4, 8, 16 or a multiple of 16, aligned alike) from src to p.
template <int B>
__device__ __forceinline__ void store_words(void* p, const void* src) {
  if constexpr (B > 16) {
#pragma unroll
    for (int o = 0; o < B; o += 16)
      store_words<16>(static_cast<char*>(p) + o,
                      static_cast<const char*>(src) + o);
  } else if constexpr (B == 16) {
    uint4 v;
    memcpy(&v, src, 16);
    *static_cast<uint4*>(p) = v;
  } else if constexpr (B == 8) {
    uint2 v;
    memcpy(&v, src, 8);
    *static_cast<uint2*>(p) = v;
  } else {
    static_assert(B == 4, "store_words: 4, 8, 16 or k*16 bytes");
    unsigned v;
    memcpy(&v, src, 4);
    *static_cast<unsigned*>(p) = v;
  }
}

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

__device__ __forceinline__ float widen(float c, float) { return c; }
__device__ __forceinline__ double widen(double c, double) { return c; }
__device__ __forceinline__ float widen(__nv_bfloat16 c, float) {
  return __bfloat162float(c);
}

template <typename T, typename CT, int C, int K, int V>
__global__ void __launch_bounds__(kThreads)
    stencil_matvec_block_kernel(const CT* __restrict__ coef,
                                const T* __restrict__ xv,
                                T* __restrict__ yv, int nz, int ny, int nx) {
  constexpr int CK = C * K;
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (x0 >= nx) return;
  const int plane = nx * ny;
  const long long n = static_cast<long long>(plane) * nz;
  const bool xm = x0 > 0, xp = x0 + V < nx;
  for (int z = blockIdx.z; z < nz; z += gridDim.z) {
    const bool zm = z > 0, zp = z + 1 < nz;
    for (int y = blockIdx.y * blockDim.y + threadIdx.y; y < ny;
         y += gridDim.y * blockDim.y) {
      const bool ym = y > 0, yp = y + 1 < ny;
      const int i0 = (z * ny + y) * nx + x0;
      // every load first: 7*C*K coefficient vectors, then x
      CT raw[7][CK][V];
      const CT* cp = coef + i0;
#pragma unroll
      for (int s = 0; s < 7 * CK; ++s)
        load_ro<V * sizeof(CT), true>(cp + s * n, raw[s / CK][s % CK]);
      // x of the row x0-1 .. x0+V (seg[1 + v] is cell v's own) and of the
      // +y, -y, +z, -z runs; a neighbour outside reads the cell's own x
      T seg[V + 2][K], run[4][V][K];
      const T* xc = xv + static_cast<size_t>(i0) * K;
      load_ro<V * K * sizeof(T), false>(xc, seg[1]);
      load_ro<K * sizeof(T), false>(xm ? xc - K : xc, seg[0]);
      load_ro<K * sizeof(T), false>(xp ? xc + V * K : xc, seg[V + 1]);
      const size_t dy = static_cast<size_t>(nx) * K;
      const size_t dz = static_cast<size_t>(plane) * K;
      load_ro<V * K * sizeof(T), false>(yp ? xc + dy : xc, run[0]);
      load_ro<V * K * sizeof(T), false>(ym ? xc - dy : xc, run[1]);
      load_ro<V * K * sizeof(T), false>(zp ? xc + dz : xc, run[2]);
      load_ro<V * K * sizeof(T), false>(zm ? xc - dz : xc, run[3]);
      T out[V][C];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        // terms diag, +x, -x, +y, -y, +z, -z: kept?, and their x
        const bool ok[7] = {true, v + 1 < V || xp, v > 0 || xm, yp, ym, zp,
                            zm};
        auto xj = [&](int t, int k) -> T {
          switch (t) {
            case 0: return seg[1 + v][k];
            case 1: return seg[2 + v][k];
            case 2: return seg[v][k];
            default: return run[t - 3][v][k];
          }
        };
#pragma unroll
        for (int c = 0; c < C; ++c) {
          T acc = T(0);
#pragma unroll
          for (int t = 0; t < 7; ++t) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              // a select, not a branch: the loads stay ahead of the sums
              const T f = fmadd(widen(raw[t][c * K + k][v], T()), xj(t, k),
                                acc);
              acc = ok[t] ? f : acc;
            }
          }
          out[v][c] = acc;
        }
      }
      store_words<V * C * sizeof(T)>(yv + static_cast<size_t>(i0) * C, out);
    }
  }
}

// K1 for any (C, K): one thread per cell, the same chain with run-time loops
// and element loads (no alignment asked).
template <typename T, typename CT>
__global__ void __launch_bounds__(kThreads)
    stencil_matvec_any_kernel(const CT* __restrict__ coef,
                              const T* __restrict__ xv, T* __restrict__ yv,
                              int C, int K, int nz, int ny, int nx) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= nx) return;
  const int plane = nx * ny;
  const long long n = static_cast<long long>(plane) * nz;
  const int CK = C * K;
  for (int z = blockIdx.z; z < nz; z += gridDim.z) {
    for (int y = blockIdx.y * blockDim.y + threadIdx.y; y < ny;
         y += gridDim.y * blockDim.y) {
      const int i = (z * ny + y) * nx + x;
      const bool ok[7] = {true, x + 1 < nx, x > 0, y + 1 < ny, y > 0,
                          z + 1 < nz, z > 0};
      const long long ii = i;  // neighbours outside may leave int's range
      const long long j[7] = {ii,      ii + 1,     ii - 1,    ii + nx,
                              ii - nx, ii + plane, ii - plane};
      for (int c = 0; c < C; ++c) {
        T acc = T(0);
#pragma unroll
        for (int t = 0; t < 7; ++t) {
          if (!ok[t]) continue;
          const CT* cs =
              coef + (static_cast<long long>(t) * CK + c * K) * n + i;
          const T* xj = xv + static_cast<size_t>(j[t]) * K;
          for (int k = 0; k < K; ++k)
            acc = fmadd(widen(cs[k * n], T()), xj[k], acc);
        }
        yv[static_cast<size_t>(i) * C + c] = acc;
      }
    }
  }
}

// K2 (replaces stencil_kernels.py:_kernel_slab_sweeps/_slab_jacobi_compute,
// _kernel_sweeps and _kernel_fused): one fused pass on a scalar stencil,
// with B2/B3's arithmetic and dinv = (d != 0 ? 1/d : 0) from the diagonal:
//   mode 0: out = omega * b * dinv               (first sweep from u = 0)
//   mode 1: out = b - A u                         (residual)
//   mode 2: out = u + omega * (b - A u) * dinv    (weighted Jacobi)
template <typename T, typename CT>
__global__ void scalar_jacobi_kernel(const CT* __restrict__ coef,
                                     const T* __restrict__ b,
                                     const T* __restrict__ u,
                                     T* __restrict__ out, T omega, int mode,
                                     int nz, int ny, int nx) {
  const long long n = static_cast<long long>(nz) * ny * nx;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T d = Coef<T, CT>::load(coef, i);
  const T dinv = d != T(0) ? T(1) / d : T(0);
  if (mode == 0) {
    out[i] = omega * b[i] * dinv;
    return;
  }
  const int x = static_cast<int>(i % nx);
  const int y = static_cast<int>((i / nx) % ny);
  const int z = static_cast<int>(i / (static_cast<long long>(nx) * ny));
  T acc = T(0);
#pragma unroll
  for (int t = 0; t < 7; ++t) {
    long long j;
    if (!neighbour(t, z, y, x, nz, ny, nx, i, &j)) continue;
    acc += Coef<T, CT>::load(coef, static_cast<long long>(t) * n + i) * u[j];
  }
  const T res = b[i] - acc;
  out[i] = mode == 1 ? res : u[i] + omega * res * dinv;
}

// K4 (replaces stencil_kernels.py:_kernel_sweeps_cheby (B6, whole level) and
// _kernel_slab_sweeps_cheby (B7, deep-halo z-slabs)): ONE step of the
// Chebyshev recurrence on [lower*lmax, lmax] for a scalar stencil, with B6/B7's
// arithmetic (jutul/jl_tpu/linsolve/cheby.py):
//   mode 0: d' = (dinv * b) / theta; u' = d'    (first step from u = 0; no
//                                                 stencil pass, u' not written)
//   mode 1: d' = (dinv * (b - A u)) / theta; u' = u + d'   (first step from u)
//   mode 2: d' = c1 * d + c2 * (dinv * (b - A u)); u' = u + d'   (step k >= 1)
// with dinv = (d0 != 0 ? 1/d0 : 0) from the diagonal. The per-step scalars sit
// on the device in steps[k] = (c1, c2) = (rho_k rho_{k-1}, 2 rho_k / delta),
// steps[0] = (theta, 0), computed once per level per CPR update from lmax with
// the recurrence's own operations (linsolve/cheby.py chebyshev_steps), so no
// launch needs a host sync. Bound by HBM bytes like K2: 7 coefficient streams
// plus b, u and d in, u' and d' out, ~48 B per cell at f32; one thread per
// cell, one launch per step. The TPU kernels run a whole smoothing phase per
// call; temporal blocking is later work here, as for K2. One kernel serves
// every level: there is no slab/whole-level split and no halo limit.
template <typename T, typename CT>
__global__ void scalar_chebyshev_kernel(const CT* __restrict__ coef,
                                        const T* __restrict__ b,
                                        const T* __restrict__ u,
                                        const T* __restrict__ d,
                                        const T* __restrict__ steps,
                                        T* __restrict__ u_out,
                                        T* __restrict__ d_out, int step,
                                        int mode, int nz, int ny, int nx) {
  const long long n = static_cast<long long>(nz) * ny * nx;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T d0 = Coef<T, CT>::load(coef, i);
  const T dinv = d0 != T(0) ? T(1) / d0 : T(0);
  if (mode == 0) {
    d_out[i] = (dinv * b[i]) / steps[0];
    return;
  }
  const int x = static_cast<int>(i % nx);
  const int y = static_cast<int>((i / nx) % ny);
  const int z = static_cast<int>(i / (static_cast<long long>(nx) * ny));
  T acc = T(0);
#pragma unroll
  for (int t = 0; t < 7; ++t) {
    long long j;
    if (!neighbour(t, z, y, x, nz, ny, nx, i, &j)) continue;
    acc += Coef<T, CT>::load(coef, static_cast<long long>(t) * n + i) * u[j];
  }
  const T r = dinv * (b[i] - acc);
  const T dn = mode == 1 ? r / steps[0]
                         : steps[2 * step] * d[i] + steps[2 * step + 1] * r;
  d_out[i] = dn;
  u_out[i] = u[i] + dn;
}

// K5 (replaces stencil_kernels.py:_kernel_slab_sweeps_db / _slab_jacobi_compute,
// B8): a whole weighted-Jacobi smoothing PHASE in one launch — from zero (the
// first sweep is omega*b*dinv) or from u0, then the sweeps, then optionally the
// residual b - A u — with K2's per-cell arithmetic, term order and skips, so
// it equals the chain of K2 launches bit for bit.
//
// B8 runs a z-slab with a deep row halo from VMEM and starts slab i+1's DMAs
// before slab i's sweeps. A (64, 256) plane of 9 streams does not fit a
// block's shared memory here, so K5 is 2.5-D z-marching instead:
// - a block is a (16, 32) tile of lattice columns, NAPP of them on each
//   side a halo (NAPP = stencil applications in the phase), and a chunk of
//   tz planes (plus NAPP halo planes below and above);
// - each thread owns one column and walks z. Sweep k runs on plane s - k
//   while plane s arrives (a wavefront), so each sweep's +-z neighbours are
//   the thread's own earlier values and its +-x/+-y neighbours come from
//   one shared plane per sweep, double buffered so that one barrier per step
//   suffices;
// - coefficients are only ever needed at the thread's own cell, so they
//   live in registers and are read from HBM once per phase (plus the halo's
//   share), not once per sweep.
// What bounds it on this card: instructions per thread and z-step, not
// bytes. Every cell of the tile and its halo is swept by its own thread at
// every step, so a z-step costs ~1.2 ns per thread on an SM with 32
// resident warps whatever the level's size (scripts/k5_tiling_probe.py),
// and a sweep written with a branch around each skipped neighbour's shared
// load and a register ring shifted by moves every step costs more than a
// whole K2 pass. The design therefore
// - reads the four in-plane neighbours unconditionally (every index lies in
//   the tile) and predicates the FMAs that K2's skip rule leaves out;
// - unrolls the z loop by the register rings' period P, so that every ring
//   slot is a constant and nothing is moved;
// - fills a ring of kPhaseStages planes in shared memory with cp.async
//   groups, kPhaseStages - 1 planes ahead of the sweeps (each thread copies
//   and later reads only its own column's words, so the ring needs no
//   barrier of its own; the step's barrier orders a slot's reuse);
// - chooses the chunk depth tz per level (choose_phase_plan) from what the
//   card measured: the busiest SM's thread-steps, or the halo-amplified
//   bytes where those dominate. Large levels get long chunks; small levels,
//   where bytes cost nothing, get short chunks and few serial steps.
// The tile is 32x16: a 32x32 tile (a smaller xy halo at depth 2) measured
// slower on every level, with half the blocks per SM.
// Wrong values creep in one cell per application from the tile's edges and
// from the chunk's first and last loaded planes; only owner threads (NAPP
// from every tile edge) write, and only planes of their chunk. Neighbours
// outside the lattice are skipped, as in K2, so halo cells there are never
// read.
constexpr int kPhaseBX = 32;
constexpr int kPhaseBY = 16;
constexpr int kPhaseThreads = kPhaseBX * kPhaseBY;
constexpr int kPhaseStages = 4;    // ring depth: planes in flight + 1
constexpr int kPhaseMaxDepth = 4;  // stencil applications per launch
// planner (choose_phase_plan): ns per thread-step on an SM, with >= 32 and
// with fewer resident warps (H100 SXM, scripts/k5_tiling_probe.py), and a
// sustained HBM rate
constexpr double kPhaseStepNs32 = 1.2;
constexpr double kPhaseStepNs16 = 1.5;
constexpr double kHbmBytesPerNs = 3000.0;

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// K5's ring slot of one coefficient: a T-wide word per thread. A coefficient
// of type T is copied as it is. A bfloat16 coefficient cannot be: cp.async
// moves 4, 8 or 16 bytes from an address aligned alike, so each thread
// copies the aligned 4-byte word that holds its element e (element e ^ 1
// rides along; neighbouring threads ask for the same word and L1 merges
// them, so HBM serves each word once), and picks its half — by e's parity —
// when it reads the slot. The coefficient tensor starts on a 4-byte
// boundary and an odd count is followed by one padding element (the
// wrapper checks both), so every word lies inside its storage. Shared
// memory stays T-wide; HBM bytes halve. K5 is bound by instructions per
// thread and z-step, so the parity is kept to a few 32-bit operations.
template <typename T, typename CT>
struct RingCoef {
  static __device__ __forceinline__ void fetch(T* slot, const CT* coef,
                                               long long e) {
    cp_async<sizeof(T)>(slot, coef + e);
  }
  static __device__ __forceinline__ T read(const T* slot, unsigned) {
    return *slot;
  }
};

template <typename T>
struct RingCoef<T, __nv_bfloat16> {
  static __device__ __forceinline__ void fetch(T* slot,
                                               const __nv_bfloat16* coef,
                                               long long e) {
    cp_async<4>(slot, reinterpret_cast<const unsigned*>(coef) + (e >> 1));
  }
  // odd: e & 1. The bfloat16's two bytes become the float's high half.
  static __device__ __forceinline__ T read(const T* slot, unsigned odd) {
    const unsigned w = *reinterpret_cast<const unsigned*>(slot);
    return static_cast<T>(
        __uint_as_float(__byte_perm(w, 0u, 0x1044u + odd * 0x2200u)));
  }
};

// Dynamic shared memory of one block: the double-buffered sweep planes
// [2][max(NAPP, 1)][threads] and the ring [kPhaseStages][nstream][threads].
template <typename T>
size_t phase_smem_bytes(int napp, int threads, int nstream) {
  return static_cast<size_t>(2 * (napp > 0 ? napp : 1) +
                             kPhaseStages * nstream) *
         threads * sizeof(T);
}

template <typename T, typename CT, int NAPP>
__global__ void __launch_bounds__(kPhaseThreads,
                                  (sizeof(T) == 4 && NAPP <= 2) ? 2 : 1)
scalar_jacobi_phase_kernel(const CT* __restrict__ coef, const T* __restrict__ b,
                           const T* __restrict__ u0, T* __restrict__ u_out,
                           T* __restrict__ r_out, T omega, int init_zero,
                           int nz, int ny, int nx, int tz) {
  constexpr int BX = kPhaseBX, BY = kPhaseBY, NT = kPhaseThreads;
  constexpr int S = kPhaseStages;
  constexpr int NS = NAPP > 0 ? NAPP : 1;
  extern __shared__ __align__(16) unsigned char phase_smem[];
  T* sh = reinterpret_cast<T*>(phase_smem);  // [2][NS][NT]
  T* ring = sh + 2 * NS * NT;                // [S][nstream][NT]
  const int nstream = init_zero ? 8 : 9;     // 7 coef, b (, u0)
  const int tx = threadIdx.x, ty = threadIdx.y, lt = ty * BX + tx;
  const int gx = static_cast<int>(blockIdx.x) * (BX - 2 * NAPP) - NAPP + tx;
  const int gy = static_cast<int>(blockIdx.y) * (BY - 2 * NAPP) - NAPP + ty;
  const bool in_lat = gx >= 0 && gx < nx && gy >= 0 && gy < ny;
  const bool owner = in_lat && tx >= NAPP && tx < BX - NAPP &&
                     ty >= NAPP && ty < BY - NAPP;
  const bool emit_residual = r_out != nullptr;
  const long long plane = static_cast<long long>(ny) * nx;
  const long long n = plane * nz;
  const long long col = in_lat ? static_cast<long long>(gy) * nx + gx : 0;
  const unsigned n_odd = static_cast<unsigned>(n) & 1u;
  const unsigned plane_odd = static_cast<unsigned>(plane) & 1u;
  const unsigned col_odd = static_cast<unsigned>(col) & 1u;
  // lattice neighbours (else the term is skipped, as in K2); their values
  // come from the tile, clamped at its edge (edge values are never used by
  // an owner)
  const bool xp = gx + 1 < nx, xm = gx > 0, yp = gy + 1 < ny, ym = gy > 0;
  const int lxp = ty * BX + min(tx + 1, BX - 1);
  const int lxm = ty * BX + max(tx - 1, 0);
  const int lyp = min(ty + 1, BY - 1) * BX + tx;
  const int lym = max(ty - 1, 0) * BX + tx;
  const int z0 = static_cast<int>(blockIdx.z) * tz;
  const int z1 = min(nz, z0 + tz);  // written planes [z0, z1)
  const int zs = max(0, z0 - NAPP);  // loaded planes [zs, ze]
  const int ze = min(nz - 1, z1 - 1 + NAPP);

  // plane s's streams into ring slot (s - zs) % S: one commit group per
  // plane (empty beyond ze or outside the lattice) keeps the count uniform
  auto fetch = [&](int s) {
    if (in_lat && s <= ze) {
      const long long i = s * plane + col;
      T* slot = ring + ((s - zs) % S) * nstream * NT + lt;
#pragma unroll
      for (int t = 0; t < 7; ++t)
        RingCoef<T, CT>::fetch(slot + t * NT, coef, t * n + i);
      cp_async<sizeof(T)>(slot + 7 * NT, b + i);
      if (!init_zero) cp_async<sizeof(T)>(slot + 8 * NT, u0 + i);
    }
    cp_async_commit();
  };

  // Register rings of period P, indexed by plane: cf/bv/dv hold planes
  // s - NAPP .. s (slot (plane - zs) % P), hist[j] sweep j's values on the
  // same slots. The step loop is unrolled by P below, so every slot index
  // is a constant and no ring is ever shifted.
  constexpr int P = NAPP + 1 > 3 ? NAPP + 1 : 3;
  T cf[P][7], bv[P], dv[P];
  T hist[NS][P];
#pragma unroll
  for (int m = 0; m < P; ++m) {
#pragma unroll
    for (int t = 0; t < 7; ++t) cf[m][t] = T(0);
    bv[m] = dv[m] = T(0);
#pragma unroll
    for (int j = 0; j < NS; ++j) hist[j][m] = T(0);
  }
#pragma unroll
  for (int q = 0; q < S; ++q) fetch(zs + q);

  const int s_end = ze + NAPP;
  for (int s0 = zs; s0 <= s_end; s0 += P) {
#pragma unroll
    for (int r = 0; r < P; ++r) {  // r = (s - zs) % P
      const int s = s0 + r;
      if (s > s_end) break;
      const int q = s - zs;
      const T* sh_r = sh + ((q + 1) & 1) * NS * NT;  // the previous step's
      T* sh_w = sh + (q & 1) * NS * NT;
      T v0 = T(0);  // sweep 0 (the start) on plane s
      if (s <= ze) {
        cp_async_wait<S - 1>();  // this thread's copies of plane s landed
        T nu = T(0);
        if (in_lat) {
          const T* slot = ring + (q % S) * nstream * NT + lt;
#pragma unroll
          for (int t = 0; t < 7; ++t)  // parity of t * n + s * plane + col
            cf[r][t] = RingCoef<T, CT>::read(
                slot + t * NT,
                ((t & n_odd) ^ (static_cast<unsigned>(s) & plane_odd) ^
                 col_odd) & 1u);
          bv[r] = slot[7 * NT];
          if (!init_zero) nu = slot[8 * NT];
        } else {
#pragma unroll
          for (int t = 0; t < 7; ++t) cf[r][t] = T(0);
          bv[r] = T(0);
        }
        dv[r] = cf[r][0] != T(0) ? T(1) / cf[r][0] : T(0);
        v0 = init_zero ? omega * bv[r] * dv[r] : nu;
      } else {
#pragma unroll
        for (int t = 0; t < 7; ++t) cf[r][t] = T(0);
        bv[r] = dv[r] = T(0);
      }
      hist[0][r] = v0;
      if (NAPP == 0 && owner && s >= z0 && s < z1)
        u_out[s * plane + col] = v0;
#pragma unroll
      for (int k = 1; k <= NAPP; ++k) {
        const int p = s - k;            // sweep k's plane this step
        const int m = (r - k + 2 * P) % P;  // its slot (a constant)
        // the four in-plane neighbours, read unconditionally (every index
        // lies in the tile) so that the skips below predicate the FMAs
        // instead of branching around the loads
        const T* prev = sh_r + (k - 1) * NT;
        const T vxp = prev[lxp], vxm = prev[lxm], vyp = prev[lyp],
                vym = prev[lym];
        T val = T(0);
        if (in_lat && p >= zs && p <= ze) {
          const T c = hist[k - 1][m];
          T acc = T(0);
          acc += cf[m][0] * c;
          if (xp) acc += cf[m][1] * vxp;
          if (xm) acc += cf[m][2] * vxm;
          if (yp) acc += cf[m][3] * vyp;
          if (ym) acc += cf[m][4] * vym;
          if (p + 1 < nz) acc += cf[m][5] * hist[k - 1][(m + 1) % P];
          if (p > 0) acc += cf[m][6] * hist[k - 1][(m + P - 1) % P];
          const T res = bv[m] - acc;
          val = (emit_residual && k == NAPP) ? res : c + omega * res * dv[m];
          if (k == NAPP && owner && p >= z0 && p < z1) {
            const long long i = p * plane + col;
            if (emit_residual) {
              u_out[i] = c;
              r_out[i] = res;
            } else {
              u_out[i] = val;
            }
          }
        }
        if (k < NAPP) hist[k][m] = val;
      }
#pragma unroll
      for (int j = 0; j < NAPP; ++j)
        sh_w[j * NT + lt] = hist[j][(r - j + 2 * P) % P];
      // sh_w is complete for the next step, every read of sh_r and of ring
      // slot q % S is done: the slot may be refilled
      __syncthreads();
      fetch(s + S);
    }
  }
}

int multiprocessors() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

// Resident blocks per SM of one instantiation at its shared-memory size
// (0: it cannot launch). Raises the dynamic shared-memory limit first.
template <typename T, typename CT, int NAPP>
int phase_blocks_per_sm(int nstream) {
  static int cached[2] = {-1, -1};  // nstream 8, 9
  int& c = cached[nstream - 8];
  if (c < 0) {
    auto kern = scalar_jacobi_phase_kernel<T, CT, NAPP>;
    const size_t most = phase_smem_bytes<T>(NAPP, kPhaseThreads, 9);
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(most));
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kern, kPhaseThreads,
            phase_smem_bytes<T>(NAPP, kPhaseThreads, nstream)) != cudaSuccess)
      blocks = 0;
    cudaGetLastError();  // a refused query leaves no sticky error
    c = blocks;
  }
  return c;
}

// Cells loaded along one axis of length len by tiles owning `own` cells
// with `halo` more on each side, clipped to the lattice.
long long loaded_extent(int len, int own, int halo) {
  long long total = 0;
  for (int t0 = 0; t0 < len; t0 += own)
    total += min(len, t0 + own + halo) - max(0, t0 - halo);
  return total;
}

struct PhasePlan {
  int tz = 0;
  long long blocks = 0;
  int per_sm = 0;  // resident blocks per SM
};

// The chunk depth tz of a phase launch on this lattice: the least of the
// larger of (a) the busiest SM's thread-steps (blocks per SM x threads x
// serial steps tz + 3 NAPP) times what one costs and (b) the halo-amplified
// bytes over the HBM rate of the SMs in use. (a) is what the card measured
// (scripts/k5_tiling_probe.py): the kernel executes ~200 instructions per
// thread and step, so a step costs ~kPhaseStepNs32 per thread-step on an SM
// holding >= 32 warps and ~kPhaseStepNs16 with fewer to hide latency.
// Cached per shape (a V-cycle asks for the same few again and again).
template <typename T, typename CT, int NAPP>
PhasePlan choose_phase_plan(int init_zero, int residual, int nz, int ny,
                            int nx) {
  struct Entry {
    int key[5];
    PhasePlan plan;
  };
  static Entry cache[32];
  static int used = 0, next = 0;
  const int key[5] = {init_zero, residual, nz, ny, nx};
  for (int e = 0; e < used; ++e) {
    bool same = true;
    for (int q = 0; q < 5; ++q) same = same && cache[e].key[q] == key[q];
    if (same) return cache[e].plan;
  }
  const int nstream = init_zero ? 8 : 9;
  const int nout = residual ? 2 : 1;
  const int per_sm = max(1, phase_blocks_per_sm<T, CT, NAPP>(nstream));
  constexpr int TX = kPhaseBX - 2 * NAPP, TY = kPhaseBY - 2 * NAPP;
  const long long tiles =
      static_cast<long long>((nx + TX - 1) / TX) * ((ny + TY - 1) / TY);
  const double cols = static_cast<double>(loaded_extent(nx, TX, NAPP)) *
                      static_cast<double>(loaded_extent(ny, TY, NAPP));
  const double n = static_cast<double>(nz) * ny * nx;
  const int sms = multiprocessors();
  PhasePlan best;
  best.per_sm = per_sm;
  double best_cost = 0.0;
  for (int t = 1; t <= nz; ++t) {
    long long planes = 0;
    int steps = 0;
    for (int z0 = 0; z0 < nz; z0 += t) {
      const int l = min(nz, z0 + t + NAPP) - max(0, z0 - NAPP);
      planes += l;
      steps = max(steps, l + NAPP);
    }
    const long long blocks = tiles * ((nz + t - 1) / t);
    const long long per_sm_load = (blocks + sms - 1) / sms;
    const int warps =
        static_cast<int>(per_sm_load < per_sm ? per_sm_load : per_sm) *
        kPhaseThreads / 32;
    const double step_ns = warps >= 32 ? kPhaseStepNs32 : kPhaseStepNs16;
    const double busy = min(1.0, static_cast<double>(blocks) / sms);
    const double bytes =
        cols * planes * (7 * sizeof(CT) + (nstream - 7) * sizeof(T)) +
        n * nout * sizeof(T);
    const double cost =
        max(per_sm_load * kPhaseThreads * steps * step_ns,
            bytes / (kHbmBytesPerNs * busy));
    if (best.tz == 0 || cost < best_cost) {
      best.tz = t;
      best.blocks = blocks;
      best_cost = cost;
    }
  }
  Entry& slot = cache[next];
  next = (next + 1) % 32;
  if (used < 32) ++used;
  for (int q = 0; q < 5; ++q) slot.key[q] = key[q];
  slot.plan = best;
  return best;
}

// tz: the z-chunk depth; 0 lets the planner choose (the tests pin it to
// reach ragged chunkings).
template <typename T, typename CT, int NAPP>
int launch_phase_depth(const CT* coef, const T* b, const T* u0, T* u_out,
                       T* r_out, double omega, int init_zero, int nz, int ny,
                       int nx, int tz, void* stream) {
  constexpr int TX = kPhaseBX - 2 * NAPP, TY = kPhaseBY - 2 * NAPP;
  const int nstream = init_zero ? 8 : 9;
  if (tz == 0)
    tz = choose_phase_plan<T, CT, NAPP>(init_zero, r_out != nullptr, nz, ny,
                                        nx)
             .tz;
  if (tz < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (phase_blocks_per_sm<T, CT, NAPP>(nstream) <= 0)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, (nz + tz - 1) / tz);
  const dim3 block(kPhaseBX, kPhaseBY);
  scalar_jacobi_phase_kernel<T, CT, NAPP>
      <<<grid, block, phase_smem_bytes<T>(NAPP, kPhaseThreads, nstream),
         static_cast<cudaStream_t>(stream)>>>(
          coef, b, u0, u_out, r_out, static_cast<T>(omega), init_zero, nz,
          ny, nx, tz);
  return static_cast<int>(cudaGetLastError());
}

int phase_depth(int n_sweep, int init_zero, int residual) {
  return (init_zero ? n_sweep - 1 : n_sweep) + (residual ? 1 : 0);
}

template <typename T, typename CT>
int launch_phase(const CT* coef, const T* b, const T* u0, T* u_out, T* r_out,
                 double omega, int n_sweep, int init_zero, int nz, int ny,
                 int nx, int tz, void* stream) {
  const int napp = phase_depth(n_sweep, init_zero, r_out != nullptr);
  if (napp < 0 || napp > kPhaseMaxDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(nz) * ny * nx == 0) return 0;
  switch (napp) {
    case 0: return launch_phase_depth<T, CT, 0>(coef, b, u0, u_out, r_out, omega,
                                            init_zero, nz, ny, nx, tz, stream);
    case 1: return launch_phase_depth<T, CT, 1>(coef, b, u0, u_out, r_out, omega,
                                            init_zero, nz, ny, nx, tz, stream);
    case 2: return launch_phase_depth<T, CT, 2>(coef, b, u0, u_out, r_out, omega,
                                            init_zero, nz, ny, nx, tz, stream);
    case 3: return launch_phase_depth<T, CT, 3>(coef, b, u0, u_out, r_out, omega,
                                            init_zero, nz, ny, nx, tz, stream);
    case 4: return launch_phase_depth<T, CT, 4>(coef, b, u0, u_out, r_out, omega,
                                            init_zero, nz, ny, nx, tz, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The planner's (tz, blocks, resident blocks per SM) for a phase launch.
template <typename T, typename CT>
int plan_phase(int n_sweep, int init_zero, int residual, int nz, int ny,
               int nx, int* out) {
  const int napp = phase_depth(n_sweep, init_zero, residual);
  PhasePlan p;
  switch (napp) {
    case 0: p = choose_phase_plan<T, CT, 0>(init_zero, residual, nz, ny, nx); break;
    case 1: p = choose_phase_plan<T, CT, 1>(init_zero, residual, nz, ny, nx); break;
    case 2: p = choose_phase_plan<T, CT, 2>(init_zero, residual, nz, ny, nx); break;
    case 3: p = choose_phase_plan<T, CT, 3>(init_zero, residual, nz, ny, nx); break;
    case 4: p = choose_phase_plan<T, CT, 4>(init_zero, residual, nz, ny, nx); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = p.tz;
  out[1] = static_cast<int>(p.blocks);
  out[2] = p.per_sm;
  return 0;
}

template <typename T, typename CT>
int launch_chebyshev(const CT* coef, const T* b, const T* u, const T* d,
                     const T* steps, T* u_out, T* d_out, int step, int mode,
                     int nz, int ny, int nx, void* stream) {
  const long long n = static_cast<long long>(nz) * ny * nx;
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    scalar_chebyshev_kernel<T, CT><<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        coef, b, u, d, steps, u_out, d_out, step, mode, nz, ny, nx);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1's original launch: the reference entry.
template <typename T>
int launch_matvec_ref(const T* coef, const T* x, T* y, int C, int K, int nz,
                      int ny, int nx, void* stream) {
  const long long total = static_cast<long long>(nz) * ny * nx * C;
  if (total > 0) {
    const unsigned blocks =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    stencil_matvec_kernel<T, T><<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        coef, x, y, C, K, nz, ny, nx);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1's cells per thread: consecutive x-cells whose coefficients one load
// brings: 4 at f32 coefficients and 2 at f64 (16-byte loads), 4 at bf16
// (8-byte loads).
template <typename T, typename CT>
struct MatvecVec {
  static constexpr int V = sizeof(CT) == 8 ? 2 : 4;
};

// A 3-D grid of (tx, ty)-thread blocks over (nx / V, ny, nz): tx covers a
// row's threads up to kThreads, ty rows fill the block; y and z beyond the
// grid's limits are walked by the kernels' loops.
inline void matvec_grid(int nxv, int ny, int nz, dim3* grid, dim3* block) {
  int tx = 1;
  while (tx < nxv && tx < kThreads) tx *= 2;
  const int ty = kThreads / tx;
  *block = dim3(tx, ty);
  *grid = dim3((nxv + tx - 1) / tx, std::min((ny + ty - 1) / ty, 65535),
               std::min(nz, 65535));
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % std::min<size_t>(bytes, 16) == 0;
}

template <typename T, typename CT, int C, int K, int V>
void launch_block(const CT* coef, const T* x, T* y, int nz, int ny, int nx,
                  cudaStream_t st) {
  dim3 grid, block;
  matvec_grid(nx / V, ny, nz, &grid, &block);
  stencil_matvec_block_kernel<T, CT, C, K, V><<<grid, block, 0, st>>>(
      coef, x, y, nz, ny, nx);
}

// (C, K) known at compile time: V cells per thread where nx and the
// pointers allow it, else one. False where x or y is not aligned to a
// cell's K or C values.
template <typename T, typename CT, int C, int K>
bool launch_shape(const CT* coef, const T* x, T* y, int nz, int ny, int nx,
                  cudaStream_t st) {
  constexpr int V = MatvecVec<T, CT>::V;
  if (V > 1 && nx % V == 0 && aligned(coef, V * sizeof(CT)) &&
      aligned(x, V * K * sizeof(T)) && aligned(y, V * C * sizeof(T))) {
    launch_block<T, CT, C, K, V>(coef, x, y, nz, ny, nx, st);
    return true;
  }
  if (!aligned(x, K * sizeof(T)) || !aligned(y, C * sizeof(T))) return false;
  launch_block<T, CT, C, K, 1>(coef, x, y, nz, ny, nx, st);
  return true;
}

template <typename T, typename CT>
int launch_matvec(const CT* coef, const T* x, T* y, int C, int K, int nz,
                  int ny, int nx, void* stream) {
  const long long n = static_cast<long long>(nz) * ny * nx;
  if (n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || C <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the shapes CPR launches: operator, stage-2 column, scalar
  bool done = false;
  if (C == 2 && K == 2)
    done = launch_shape<T, CT, 2, 2>(coef, x, y, nz, ny, nx, st);
  else if (C == 2 && K == 1)
    done = launch_shape<T, CT, 2, 1>(coef, x, y, nz, ny, nx, st);
  else if (C == 1 && K == 1)
    done = launch_shape<T, CT, 1, 1>(coef, x, y, nz, ny, nx, st);
  if (!done) {
    dim3 grid, block;
    matvec_grid(nx, ny, nz, &grid, &block);
    stencil_matvec_any_kernel<T, CT><<<grid, block, 0, st>>>(
        coef, x, y, C, K, nz, ny, nx);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename CT>
int launch_jacobi(const CT* coef, const T* b, const T* u, T* out, double omega,
                  int mode, int nz, int ny, int nx, void* stream) {
  const long long n = static_cast<long long>(nz) * ny * nx;
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    scalar_jacobi_kernel<T, CT><<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        coef, b, u, out, static_cast<T>(omega), mode, nz, ny, nx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int jt_stencil_matvec_f32(const float* coef, const float* x, float* y, int C,
                          int K, int nz, int ny, int nx, void* stream) {
  return launch_matvec<float, float>(coef, x, y, C, K, nz, ny, nx, stream);
}

int jt_stencil_matvec_f64(const double* coef, const double* x, double* y,
                          int C, int K, int nz, int ny, int nx, void* stream) {
  return launch_matvec<double, double>(coef, x, y, C, K, nz, ny, nx, stream);
}

// K1's original mapping, for the card tests and chip_smoke.py's bitwise
// check only.
int jt_stencil_matvec_ref_f32(const float* coef, const float* x, float* y,
                              int C, int K, int nz, int ny, int nx,
                              void* stream) {
  return launch_matvec_ref<float>(coef, x, y, C, K, nz, ny, nx, stream);
}

int jt_stencil_matvec_ref_f64(const double* coef, const double* x, double* y,
                              int C, int K, int nz, int ny, int nx,
                              void* stream) {
  return launch_matvec_ref<double>(coef, x, y, C, K, nz, ny, nx, stream);
}

int jt_scalar_jacobi_f32(const float* coef, const float* b, const float* u,
                         float* out, double omega, int mode, int nz, int ny,
                         int nx, void* stream) {
  return launch_jacobi<float, float>(coef, b, u, out, omega, mode, nz, ny, nx,
                              stream);
}

int jt_scalar_jacobi_f64(const double* coef, const double* b, const double* u,
                         double* out, double omega, int mode, int nz, int ny,
                         int nx, void* stream) {
  return launch_jacobi<double, double>(coef, b, u, out, omega, mode, nz, ny, nx,
                               stream);
}

int jt_scalar_chebyshev_f32(const float* coef, const float* b, const float* u,
                            const float* d, const float* steps, float* u_out,
                            float* d_out, int step, int mode, int nz, int ny,
                            int nx, void* stream) {
  return launch_chebyshev<float, float>(coef, b, u, d, steps, u_out, d_out, step,
                                 mode, nz, ny, nx, stream);
}

int jt_scalar_chebyshev_f64(const double* coef, const double* b,
                            const double* u, const double* d,
                            const double* steps, double* u_out, double* d_out,
                            int step, int mode, int nz, int ny, int nx,
                            void* stream) {
  return launch_chebyshev<double, double>(coef, b, u, d, steps, u_out, d_out, step,
                                  mode, nz, ny, nx, stream);
}

int jt_scalar_jacobi_phase_f32(const float* coef, const float* b,
                               const float* u0, float* u_out, float* r_out,
                               double omega, int n_sweep, int init_zero,
                               int nz, int ny, int nx, int tz, void* stream) {
  return launch_phase<float, float>(coef, b, u0, u_out, r_out, omega, n_sweep,
                             init_zero, nz, ny, nx, tz, stream);
}

int jt_scalar_jacobi_phase_f64(const double* coef, const double* b,
                               const double* u0, double* u_out, double* r_out,
                               double omega, int n_sweep, int init_zero,
                               int nz, int ny, int nx, int tz, void* stream) {
  return launch_phase<double, double>(coef, b, u0, u_out, r_out, omega, n_sweep,
                              init_zero, nz, ny, nx, tz, stream);
}

// out[3] = (chunk depth, blocks, resident blocks per SM) of a phase's plan.
int jt_scalar_jacobi_phase_plan_f32(int n_sweep, int init_zero, int residual,
                                    int nz, int ny, int nx, int* out) {
  return plan_phase<float, float>(n_sweep, init_zero, residual, nz, ny, nx, out);
}

int jt_scalar_jacobi_phase_plan_f64(int n_sweep, int init_zero, int residual,
                                    int nz, int ny, int nx, int* out) {
  return plan_phase<double, double>(n_sweep, init_zero, residual, nz, ny, nx, out);
}

// The same kernels with bfloat16 coefficients and float32 vectors.
int jt_stencil_matvec_bf16c_f32(const __nv_bfloat16* coef, const float* x,
                                float* y, int C, int K, int nz, int ny,
                                int nx, void* stream) {
  return launch_matvec<float, __nv_bfloat16>(coef, x, y, C, K, nz, ny, nx,
                                             stream);
}

int jt_scalar_jacobi_bf16c_f32(const __nv_bfloat16* coef, const float* b,
                               const float* u, float* out, double omega,
                               int mode, int nz, int ny, int nx,
                               void* stream) {
  return launch_jacobi<float, __nv_bfloat16>(coef, b, u, out, omega, mode, nz,
                                             ny, nx, stream);
}

int jt_scalar_chebyshev_bf16c_f32(const __nv_bfloat16* coef, const float* b,
                                  const float* u, const float* d,
                                  const float* steps, float* u_out,
                                  float* d_out, int step, int mode, int nz,
                                  int ny, int nx, void* stream) {
  return launch_chebyshev<float, __nv_bfloat16>(
      coef, b, u, d, steps, u_out, d_out, step, mode, nz, ny, nx, stream);
}

int jt_scalar_jacobi_phase_bf16c_f32(const __nv_bfloat16* coef, const float* b,
                                     const float* u0, float* u_out,
                                     float* r_out, double omega, int n_sweep,
                                     int init_zero, int nz, int ny, int nx,
                                     int tz, void* stream) {
  return launch_phase<float, __nv_bfloat16>(coef, b, u0, u_out, r_out, omega,
                                            n_sweep, init_zero, nz, ny, nx, tz,
                                            stream);
}

int jt_scalar_jacobi_phase_plan_bf16c_f32(int n_sweep, int init_zero,
                                          int residual, int nz, int ny, int nx,
                                          int* out) {
  return plan_phase<float, __nv_bfloat16>(n_sweep, init_zero, residual, nz, ny,
                                          nx, out);
}

}  // extern "C"
