// Fused BiCGStab body kernels for Hopper (sm_90a): K6 fused_alpha_s and K7
// fused_omega_update. Built by nvcc with the other csrc/*.cu files into one
// shared library with a plain C interface (ops/cuda/_build.py) and bound with
// ctypes (ops/cuda/krylov_kernels.py, which also holds the plain versions).
//
// They replace jutul/jl_tpu/ops/pallas/krylov_kernels.py _kernel_alpha_s (B10)
// and _kernel_omega_update (B11). The TPU kernels run their phases as the
// leading axis of a SEQUENTIAL grid and carry each dot product across phases
// in SMEM. Blocks run in parallel and in no order here, so each phase that
// needs a grid-wide sum is split at the sum: a launch ends with every block's
// partial sum in a buffer, and the next launch starts with every block summing
// those partials itself. The sums are deterministic: each block reduces its
// threads' values by a fixed tree, and every reader sums the partials in
// block-index order — no float atomics, so repeated calls give identical bits
// (the Newton and linear iteration counts depend on that).
//
// K6 = 2 launches in one call: <rhat, v> partials; then alpha = rho / denom
//      and s = r - alpha v.
// K7 = 3 launches in one call: <t, t>, <t, s> partials; then omega = ts / tt,
//      x' = x + alpha phat + omega shat, r' = s - omega t and the <rhat, r'>,
//      <r', r'> partials; then beta = (rho'/rho)(alpha/omega) and
//      p' = r' + beta (p - omega v).
// Passes over the vectors: K6 reads rhat, v, r, v and writes s (5; 4 is the
// least). K7 reads t, s | t, s, x, phat, shat, rhat | r', p, v and writes
// x', r' | p' (14; 11 is the least: the first phase's t and s are read again
// because no block can hold them across launches). Both are bound by HBM
// bytes (2 flops per 8-byte pair at f32). Every division has the
// reference's guard, v != 0 ? v : 1e-30 (krylov_kernels.py _TINY). The
// scalars stay on the device: alpha (K6) and omega, rho', res2 (K7).

#include <cuda_runtime.h>

namespace {

constexpr int kRedThreads = 256;
constexpr double kTiny = 1e-30;

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

// Blocks per launch: 4 per SM, at most the partials buffer's capacity and
// the number of 256-value tiles. Fixed for a given n and card, so the sums'
// order is too.
int reduction_blocks(long long n, int capacity) {
  const long long tiles = (n + kRedThreads - 1) / kRedThreads;
  long long g = 4LL * multiprocessors();
  if (g > capacity) g = capacity;
  if (g > tiles) g = tiles;
  return static_cast<int>(g < 1 ? 1 : g);
}

template <typename T>
__device__ __forceinline__ T guard(T v) {
  return v != T(0) ? v : T(kTiny);
}

// Every thread's NV values summed over the block by a fixed tree; the sums
// end in v[] of every thread.
template <typename T, int NV>
__device__ __forceinline__ void block_sum(T (&v)[NV],
                                          T (*sh)[kRedThreads]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < NV; ++j) sh[j][tid] = v[j];
  __syncthreads();
#pragma unroll
  for (int stride = kRedThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int j = 0; j < NV; ++j) sh[j][tid] += sh[j][tid + stride];
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = sh[j][0];
  __syncthreads();
}

// The grid-wide sums from the previous launch's G partials per value
// (part[j * G + block]), the same in every block.
template <typename T, int NV>
__device__ __forceinline__ void finish_sums(const T* __restrict__ part, int G,
                                            T (&v)[NV],
                                            T (*sh)[kRedThreads]) {
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = T(0);
  for (int k = threadIdx.x; k < G; k += kRedThreads) {
#pragma unroll
    for (int j = 0; j < NV; ++j) v[j] += part[j * G + k];
  }
  block_sum<T, NV>(v, sh);
}

template <typename T, int NV>
__device__ __forceinline__ void store_partials(T (&v)[NV],
                                               T (*sh)[kRedThreads],
                                               T* __restrict__ part) {
  block_sum<T, NV>(v, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) part[j * gridDim.x + blockIdx.x] = v[j];
  }
}

#define GRID_STRIDE(i, n)                                                  \
  for (long long i = static_cast<long long>(blockIdx.x) * kRedThreads +   \
                     threadIdx.x;                                          \
       i < (n); i += static_cast<long long>(gridDim.x) * kRedThreads)

// K6, launch 1: partials of <rhat, v>.
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
alpha_dot_kernel(const T* __restrict__ rhat, const T* __restrict__ v,
                 T* __restrict__ part, long long n) {
  __shared__ T sh[1][kRedThreads];
  T acc[1] = {T(0)};
  GRID_STRIDE(i, n) acc[0] += rhat[i] * v[i];
  store_partials<T, 1>(acc, sh, part);
}

// K6, launch 2: alpha = rho / <rhat, v>; s = r - alpha v.
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
alpha_s_kernel(const T* __restrict__ r, const T* __restrict__ v,
               const T* __restrict__ rho, const T* __restrict__ part,
               T* __restrict__ s, T* __restrict__ alpha_out, long long n) {
  __shared__ T sh[1][kRedThreads];
  T d[1];
  finish_sums<T, 1>(part, gridDim.x, d, sh);
  const T alpha = rho[0] / guard(d[0]);
  GRID_STRIDE(i, n) s[i] = r[i] - alpha * v[i];
  if (blockIdx.x == 0 && threadIdx.x == 0) *alpha_out = alpha;
}

// K7, launch 1: partials of <t, t> and <t, s>.
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
omega_dot_kernel(const T* __restrict__ t, const T* __restrict__ s,
                 T* __restrict__ part, long long n) {
  __shared__ T sh[2][kRedThreads];
  T acc[2] = {T(0), T(0)};
  GRID_STRIDE(i, n) {
    const T ti = t[i];
    acc[0] += ti * ti;
    acc[1] += ti * s[i];
  }
  store_partials<T, 2>(acc, sh, part);
}

// K7, launch 2: omega; x' and r'; partials of <rhat, r'> and <r', r'>.
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
omega_update_kernel(const T* __restrict__ rhat, const T* __restrict__ t,
                    const T* __restrict__ s, const T* __restrict__ phat,
                    const T* __restrict__ shat, const T* __restrict__ x,
                    const T* __restrict__ alpha_in, T* __restrict__ part,
                    T* __restrict__ x_out, T* __restrict__ r_out,
                    T* __restrict__ scal, long long n) {
  __shared__ T sh[2][kRedThreads];
  T d[2];
  finish_sums<T, 2>(part, gridDim.x, d, sh);
  const T omega = d[1] / guard(d[0]);
  const T alpha = alpha_in[0];
  T acc[2] = {T(0), T(0)};
  GRID_STRIDE(i, n) {
    const T rn = s[i] - omega * t[i];
    x_out[i] = x[i] + alpha * phat[i] + omega * shat[i];
    r_out[i] = rn;
    acc[0] += rhat[i] * rn;
    acc[1] += rn * rn;
  }
  store_partials<T, 2>(acc, sh, part + 2 * gridDim.x);
  if (blockIdx.x == 0 && threadIdx.x == 0) scal[0] = omega;
}

// K7, launch 3: rho', res2, beta; p' = r' + beta (p - omega v).
template <typename T>
__global__ void __launch_bounds__(kRedThreads)
p_update_kernel(const T* __restrict__ r_new, const T* __restrict__ p,
                const T* __restrict__ v, const T* __restrict__ rho_in,
                const T* __restrict__ alpha_in, const T* __restrict__ part,
                T* __restrict__ p_out, T* __restrict__ scal, long long n) {
  __shared__ T sh[2][kRedThreads];
  T d[2];
  finish_sums<T, 2>(part + 2 * gridDim.x, gridDim.x, d, sh);
  const T omega = scal[0];
  const T beta = (d[0] / guard(rho_in[0])) * (alpha_in[0] / guard(omega));
  GRID_STRIDE(i, n) p_out[i] = r_new[i] + beta * (p[i] - omega * v[i]);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scal[1] = d[0];
    scal[2] = d[1];
  }
}

template <typename T>
int launch_alpha_s(const T* rhat, const T* r, const T* v, const T* rho, T* s,
                   T* alpha, T* part, int n, int capacity, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = reduction_blocks(n, capacity);
  alpha_dot_kernel<T><<<G, kRedThreads, 0, st>>>(rhat, v, part, n);
  alpha_s_kernel<T><<<G, kRedThreads, 0, st>>>(r, v, rho, part, s, alpha, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_omega_update(const T* rhat, const T* t, const T* s, const T* phat,
                        const T* shat, const T* x, const T* p, const T* v,
                        const T* rho, const T* alpha, T* x_out, T* r_out,
                        T* p_out, T* scal, T* part, int n, int capacity,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = reduction_blocks(n, capacity / 4);
  omega_dot_kernel<T><<<G, kRedThreads, 0, st>>>(t, s, part, n);
  omega_update_kernel<T><<<G, kRedThreads, 0, st>>>(
      rhat, t, s, phat, shat, x, alpha, part, x_out, r_out, scal, n);
  p_update_kernel<T><<<G, kRedThreads, 0, st>>>(r_out, p, v, rho, alpha,
                                                part, p_out, scal, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// capacity: values the partials buffer holds (K6 needs G, K7 4 G)
int jt_fused_alpha_s_f32(const float* rhat, const float* r, const float* v,
                         const float* rho, float* s, float* alpha,
                         float* part, int n, int capacity, void* stream) {
  return launch_alpha_s<float>(rhat, r, v, rho, s, alpha, part, n, capacity,
                               stream);
}

int jt_fused_alpha_s_f64(const double* rhat, const double* r, const double* v,
                         const double* rho, double* s, double* alpha,
                         double* part, int n, int capacity, void* stream) {
  return launch_alpha_s<double>(rhat, r, v, rho, s, alpha, part, n, capacity,
                                stream);
}

// scal: (omega, rho', res2) out
int jt_fused_omega_update_f32(const float* rhat, const float* t,
                              const float* s, const float* phat,
                              const float* shat, const float* x,
                              const float* p, const float* v,
                              const float* rho, const float* alpha,
                              float* x_out, float* r_out, float* p_out,
                              float* scal, float* part, int n, int capacity,
                              void* stream) {
  return launch_omega_update<float>(rhat, t, s, phat, shat, x, p, v, rho,
                                    alpha, x_out, r_out, p_out, scal, part, n,
                                    capacity, stream);
}

int jt_fused_omega_update_f64(const double* rhat, const double* t,
                              const double* s, const double* phat,
                              const double* shat, const double* x,
                              const double* p, const double* v,
                              const double* rho, const double* alpha,
                              double* x_out, double* r_out, double* p_out,
                              double* scal, double* part, int n, int capacity,
                              void* stream) {
  return launch_omega_update<double>(rhat, t, s, phat, shat, x, p, v, rho,
                                     alpha, x_out, r_out, p_out, scal, part,
                                     n, capacity, stream);
}

}  // extern "C"
