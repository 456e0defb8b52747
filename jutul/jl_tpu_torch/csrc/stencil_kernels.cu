// 7-point lattice stencil kernels for Hopper (sm_90a): K1 stencil_matvec,
// K2 scalar_jacobi and K4 scalar_chebyshev. Built by nvcc into one shared library with a plain C
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
// bytes of coefficients per flop. The first design keeps one thread per
// output value and relies on L1/L2 for the neighbour reuse; temporal
// blocking (several sweeps per coefficient read) is later work.

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

}  // extern "C"
