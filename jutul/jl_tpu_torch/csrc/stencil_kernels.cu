// 7-point lattice stencil kernels for Hopper (sm_90a): K1 stencil_matvec,
// K2 scalar_jacobi and K4 scalar_chebyshev. Built by nvcc into one shared
// library with a plain C interface (ops/cuda/_build.py) and bound with ctypes
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
// rely on L1/L2 for the neighbour reuse. A whole Jacobi smoothing phase in
// one launch is K8's or K10's (level_kernels.cu, slab_kernels.cu).
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

}  // extern "C"
