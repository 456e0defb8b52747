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
// bytes of coefficients per flop. K1, K2 and K4 keep one thread per output
// value and rely on L1/L2 for the neighbour reuse; K5 blocks a whole Jacobi
// smoothing phase in time (several sweeps per coefficient read).

#include <cuda_runtime.h>

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

// K1 (replaces jutul/jl_tpu/ops/pallas/stencil_kernels.py:_kernel): the
// C x K block-stencil SpMV y[i, c] = sum_t sum_k coef[t][c*K+k][i] x[j_t(i), k]
// with x (n, K) and y (n, C) in the cell-major layout of the Krylov vectors.
// One thread per cell and output component.
template <typename T>
__global__ void stencil_matvec_kernel(const T* __restrict__ coef,
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
      acc += coef[(static_cast<long long>(t) * CK + c * K + k) * n + i] *
             xv[j * K + k];
    }
  }
  yv[tid] = acc;
}

// K2 (replaces stencil_kernels.py:_kernel_slab_sweeps/_slab_jacobi_compute,
// _kernel_sweeps and _kernel_fused): one fused pass on a scalar stencil,
// with B2/B3's arithmetic and dinv = (d != 0 ? 1/d : 0) from the diagonal:
//   mode 0: out = omega * b * dinv               (first sweep from u = 0)
//   mode 1: out = b - A u                         (residual)
//   mode 2: out = u + omega * (b - A u) * dinv    (weighted Jacobi)
template <typename T>
__global__ void scalar_jacobi_kernel(const T* __restrict__ coef,
                                     const T* __restrict__ b,
                                     const T* __restrict__ u,
                                     T* __restrict__ out, T omega, int mode,
                                     int nz, int ny, int nx) {
  const long long n = static_cast<long long>(nz) * ny * nx;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T d = coef[i];
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
    acc += coef[static_cast<long long>(t) * n + i] * u[j];
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
template <typename T>
__global__ void scalar_chebyshev_kernel(const T* __restrict__ coef,
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
  const T d0 = coef[i];
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
    acc += coef[static_cast<long long>(t) * n + i] * u[j];
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
// residual b - A u — with K2's per-cell arithmetic, term order and skips.
//
// B8 runs a z-slab with a deep row halo from VMEM and starts slab i+1's DMAs
// before slab i's sweeps. A (64, 256) plane of 9 streams does not fit a
// block's shared memory here, so K5 is 2.5-D z-marching instead:
// - a block is a (kPhaseBY, kPhaseBX) tile of lattice columns, NAPP of them
//   on each side a halo (NAPP = stencil applications in the phase), and a
//   chunk of tz planes (plus NAPP halo planes below and above);
// - each thread owns one column and walks z. Plane s's coefficients, b and
//   u0 arrive in registers; sweep k then runs on plane s - k (a wavefront),
//   so each sweep's +-z neighbours are the thread's own earlier values
//   (a 3-deep register ring per sweep) and its +-x/+-y neighbours come
//   from one shared-memory plane per sweep, written once per step;
// - coefficients are only ever needed at the thread's own cell, so they
//   live in a register ring of NAPP + 1 planes and are read from HBM once
//   per phase (plus the halo's share), not once per sweep;
// - plane s+1's loads are issued before plane s's sweeps run (the register
//   form of B8's "next slab's streams start first").
// Wrong values creep in one cell per application from the tile's edges and
// from the chunk's first and last loaded planes; only owner threads (NAPP
// from every tile edge) write, and only planes of their chunk. Neighbours
// outside the lattice are skipped, as in K2, so halo cells there are never
// read. Bound by HBM bytes: 7 coefficient streams + b (+ u0) in, u (+ r)
// out, times the halo's read amplification ((32*16)/(TX*TY) in xy, about
// (tz + 2*NAPP)/tz in z).
constexpr int kPhaseBX = 32;
constexpr int kPhaseBY = 16;
constexpr int kPhaseMaxDepth = 4;  // stencil applications per launch

template <typename T, int NAPP>
__global__ void __launch_bounds__(kPhaseBX * kPhaseBY,
                                  (sizeof(T) == 4 && NAPP <= 2) ? 2 : 1)
scalar_jacobi_phase_kernel(const T* __restrict__ coef, const T* __restrict__ b,
                           const T* __restrict__ u0, T* __restrict__ u_out,
                           T* __restrict__ r_out, T omega, int init_zero,
                           int nz, int ny, int nx, int tz) {
  constexpr int TX = kPhaseBX - 2 * NAPP;
  constexpr int TY = kPhaseBY - 2 * NAPP;
  constexpr int NS = NAPP > 0 ? NAPP : 1;
  // sh[j]: sweep j's values on the plane sweep j+1 works on (previous step)
  __shared__ T sh[NS][kPhaseBY][kPhaseBX];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int gx = static_cast<int>(blockIdx.x) * TX - NAPP + tx;
  const int gy = static_cast<int>(blockIdx.y) * TY - NAPP + ty;
  const bool in_lat = gx >= 0 && gx < nx && gy >= 0 && gy < ny;
  const bool owner = in_lat && tx >= NAPP && tx < kPhaseBX - NAPP &&
                     ty >= NAPP && ty < kPhaseBY - NAPP;
  const bool emit_residual = r_out != nullptr;
  const long long plane = static_cast<long long>(ny) * nx;
  const long long n = plane * nz;
  const long long col = in_lat ? static_cast<long long>(gy) * nx + gx : 0;
  // lattice neighbours (else the term is skipped, as in K2); their values
  // come from the tile, clamped at its edge (edge values are never used by
  // an owner)
  const bool xp = gx + 1 < nx, xm = gx > 0, yp = gy + 1 < ny, ym = gy > 0;
  const int txp = min(tx + 1, kPhaseBX - 1), txm = max(tx - 1, 0);
  const int typ = min(ty + 1, kPhaseBY - 1), tym = max(ty - 1, 0);
  const int z0 = static_cast<int>(blockIdx.z) * tz;
  const int z1 = min(nz, z0 + tz);  // written planes [z0, z1)
  const int zs = max(0, z0 - NAPP);  // loaded planes [zs, ze]
  const int ze = min(nz - 1, z1 - 1 + NAPP);

  T cf[NAPP + 1][7];  // cf[m], bv[m], dv[m]: plane s - m
  T bv[NAPP + 1], dv[NAPP + 1];
  T hist[NS][3];  // hist[j] = sweep j on planes s-j-2, s-j-1, s-j
  T nc[7], nb = T(0), nu = T(0);  // plane s + 1, in flight
#pragma unroll
  for (int m = 0; m <= NAPP; ++m) {
#pragma unroll
    for (int t = 0; t < 7; ++t) cf[m][t] = T(0);
    bv[m] = dv[m] = T(0);
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) hist[j][0] = hist[j][1] = hist[j][2] = T(0);
#pragma unroll
  for (int t = 0; t < 7; ++t) nc[t] = T(0);
  if (in_lat) {
    const long long i = zs * plane + col;
#pragma unroll
    for (int t = 0; t < 7; ++t) nc[t] = coef[t * n + i];
    nb = b[i];
    if (!init_zero) nu = u0[i];
  }

  for (int s = zs; s <= ze + NAPP; ++s) {
#pragma unroll
    for (int m = NAPP; m > 0; --m) {
#pragma unroll
      for (int t = 0; t < 7; ++t) cf[m][t] = cf[m - 1][t];
      bv[m] = bv[m - 1];
      dv[m] = dv[m - 1];
    }
    T v0 = T(0);  // sweep 0 (the start) on plane s
    if (s <= ze) {
#pragma unroll
      for (int t = 0; t < 7; ++t) cf[0][t] = nc[t];
      bv[0] = nb;
      dv[0] = nc[0] != T(0) ? T(1) / nc[0] : T(0);
      v0 = init_zero ? omega * nb * dv[0] : nu;
      if (s + 1 <= ze && in_lat) {  // start plane s+1's loads
        const long long i = (s + 1) * plane + col;
#pragma unroll
        for (int t = 0; t < 7; ++t) nc[t] = coef[t * n + i];
        nb = b[i];
        if (!init_zero) nu = u0[i];
      }
    } else {
#pragma unroll
      for (int t = 0; t < 7; ++t) cf[0][t] = T(0);
      bv[0] = dv[0] = T(0);
    }
    hist[0][0] = hist[0][1];
    hist[0][1] = hist[0][2];
    hist[0][2] = v0;
    if (NAPP == 0 && owner && s >= z0 && s < z1) u_out[s * plane + col] = v0;
#pragma unroll
    for (int k = 1; k <= NAPP; ++k) {
      const int p = s - k;  // sweep k's plane this step
      T val = T(0);
      if (in_lat && p >= zs && p <= ze) {
        const T c = hist[k - 1][1];
        T acc = T(0);
        acc += cf[k][0] * c;
        if (xp) acc += cf[k][1] * sh[k - 1][ty][txp];
        if (xm) acc += cf[k][2] * sh[k - 1][ty][txm];
        if (yp) acc += cf[k][3] * sh[k - 1][typ][tx];
        if (ym) acc += cf[k][4] * sh[k - 1][tym][tx];
        if (p + 1 < nz) acc += cf[k][5] * hist[k - 1][2];
        if (p > 0) acc += cf[k][6] * hist[k - 1][0];
        const T res = bv[k] - acc;
        val = (emit_residual && k == NAPP) ? res : c + omega * res * dv[k];
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
      if (k < NAPP) {
        hist[k][0] = hist[k][1];
        hist[k][1] = hist[k][2];
        hist[k][2] = val;
      }
    }
    if (NAPP > 0) {
      __syncthreads();  // every sweep of this step has read sh
#pragma unroll
      for (int j = 0; j < NAPP; ++j) sh[j][ty][tx] = hist[j][2];
      __syncthreads();
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

template <typename T, int NAPP>
int launch_phase_depth(const T* coef, const T* b, const T* u0, T* u_out,
                       T* r_out, double omega, int init_zero, int nz, int ny,
                       int nx, void* stream) {
  constexpr int TX = kPhaseBX - 2 * NAPP;
  constexpr int TY = kPhaseBY - 2 * NAPP;
  const long long tiles =
      static_cast<long long>((nx + TX - 1) / TX) * ((ny + TY - 1) / TY);
  // split z until there are two blocks per SM (down to 4-plane chunks)
  int tz = nz;
  while (tz > 4 && tiles * ((nz + tz - 1) / tz) < 2LL * multiprocessors())
    tz = (tz + 1) / 2;
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, (nz + tz - 1) / tz);
  const dim3 block(kPhaseBX, kPhaseBY);
  scalar_jacobi_phase_kernel<T, NAPP>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          coef, b, u0, u_out, r_out, static_cast<T>(omega), init_zero, nz, ny,
          nx, tz);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_phase(const T* coef, const T* b, const T* u0, T* u_out, T* r_out,
                 double omega, int n_sweep, int init_zero, int nz, int ny,
                 int nx, void* stream) {
  const int napp = (init_zero ? n_sweep - 1 : n_sweep) + (r_out ? 1 : 0);
  if (napp < 0 || napp > kPhaseMaxDepth)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(nz) * ny * nx == 0) return 0;
  switch (napp) {
    case 0: return launch_phase_depth<T, 0>(coef, b, u0, u_out, r_out, omega,
                                            init_zero, nz, ny, nx, stream);
    case 1: return launch_phase_depth<T, 1>(coef, b, u0, u_out, r_out, omega,
                                            init_zero, nz, ny, nx, stream);
    case 2: return launch_phase_depth<T, 2>(coef, b, u0, u_out, r_out, omega,
                                            init_zero, nz, ny, nx, stream);
    case 3: return launch_phase_depth<T, 3>(coef, b, u0, u_out, r_out, omega,
                                            init_zero, nz, ny, nx, stream);
    case 4: return launch_phase_depth<T, 4>(coef, b, u0, u_out, r_out, omega,
                                            init_zero, nz, ny, nx, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_chebyshev(const T* coef, const T* b, const T* u, const T* d,
                     const T* steps, T* u_out, T* d_out, int step, int mode,
                     int nz, int ny, int nx, void* stream) {
  const long long n = static_cast<long long>(nz) * ny * nx;
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    scalar_chebyshev_kernel<T><<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        coef, b, u, d, steps, u_out, d_out, step, mode, nz, ny, nx);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_matvec(const T* coef, const T* x, T* y, int C, int K, int nz,
                  int ny, int nx, void* stream) {
  const long long total = static_cast<long long>(nz) * ny * nx * C;
  if (total > 0) {
    const unsigned blocks =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    stencil_matvec_kernel<T><<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        coef, x, y, C, K, nz, ny, nx);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_jacobi(const T* coef, const T* b, const T* u, T* out, double omega,
                  int mode, int nz, int ny, int nx, void* stream) {
  const long long n = static_cast<long long>(nz) * ny * nx;
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    scalar_jacobi_kernel<T><<<blocks, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        coef, b, u, out, static_cast<T>(omega), mode, nz, ny, nx);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int jt_stencil_matvec_f32(const float* coef, const float* x, float* y, int C,
                          int K, int nz, int ny, int nx, void* stream) {
  return launch_matvec<float>(coef, x, y, C, K, nz, ny, nx, stream);
}

int jt_stencil_matvec_f64(const double* coef, const double* x, double* y,
                          int C, int K, int nz, int ny, int nx, void* stream) {
  return launch_matvec<double>(coef, x, y, C, K, nz, ny, nx, stream);
}

int jt_scalar_jacobi_f32(const float* coef, const float* b, const float* u,
                         float* out, double omega, int mode, int nz, int ny,
                         int nx, void* stream) {
  return launch_jacobi<float>(coef, b, u, out, omega, mode, nz, ny, nx,
                              stream);
}

int jt_scalar_jacobi_f64(const double* coef, const double* b, const double* u,
                         double* out, double omega, int mode, int nz, int ny,
                         int nx, void* stream) {
  return launch_jacobi<double>(coef, b, u, out, omega, mode, nz, ny, nx,
                               stream);
}

int jt_scalar_chebyshev_f32(const float* coef, const float* b, const float* u,
                            const float* d, const float* steps, float* u_out,
                            float* d_out, int step, int mode, int nz, int ny,
                            int nx, void* stream) {
  return launch_chebyshev<float>(coef, b, u, d, steps, u_out, d_out, step,
                                 mode, nz, ny, nx, stream);
}

int jt_scalar_chebyshev_f64(const double* coef, const double* b,
                            const double* u, const double* d,
                            const double* steps, double* u_out, double* d_out,
                            int step, int mode, int nz, int ny, int nx,
                            void* stream) {
  return launch_chebyshev<double>(coef, b, u, d, steps, u_out, d_out, step,
                                  mode, nz, ny, nx, stream);
}

int jt_scalar_jacobi_phase_f32(const float* coef, const float* b,
                               const float* u0, float* u_out, float* r_out,
                               double omega, int n_sweep, int init_zero,
                               int nz, int ny, int nx, void* stream) {
  return launch_phase<float>(coef, b, u0, u_out, r_out, omega, n_sweep,
                             init_zero, nz, ny, nx, stream);
}

int jt_scalar_jacobi_phase_f64(const double* coef, const double* b,
                               const double* u0, double* u_out, double* r_out,
                               double omega, int n_sweep, int init_zero,
                               int nz, int ny, int nx, void* stream) {
  return launch_phase<double>(coef, b, u0, u_out, r_out, omega, n_sweep,
                              init_zero, nz, ny, nx, stream);
}

}  // extern "C"
