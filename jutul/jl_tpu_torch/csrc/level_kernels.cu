// Whole-level GMG smoothing kernels for Hopper (sm_90a): K8
// scalar_sweeps_resident and K9 scalar_chebyshev_resident. Built by nvcc
// beside csrc/stencil_kernels.cu into the same shared library
// (ops/cuda/_build.py) and bound with ctypes (ops/cuda/stencil_kernels.py,
// which also holds the plain PyTorch versions and the routing of GMG levels).
//
// K8 replaces jutul/jl_tpu/ops/pallas/stencil_kernels.py:_kernel_sweeps
// (B3, called by _scalar_sweeps_call :412, pallas_call :422): n_sweep
// weighted-Jacobi sweeps of a scalar 7-point stencil, from zero (the first
// sweep is omega*b*dinv) or from u, then optionally the residual b - A u, in
// ONE launch. K9 replaces _kernel_sweeps_cheby (B6, :431, called by
// _scalar_sweeps_cheby_call :468, pallas_call :479): the Chebyshev
// recurrence of K4's three modes (from zero, from u, step k) with the
// per-step scalars read from the level's device table
// (linsolve/cheby.py chebyshev_steps), and the same optional residual.
//
// Values: each cell keeps K2's arithmetic (K9: K4's, and K2's residual):
// dinv = d != 0 ? 1/d : 0, acc = 0 then acc += c_t * u_j for t = 0..6 with
// the terms whose neighbour lies outside the lattice left out, res = b -
// acc, u + omega*res*dinv, written as the same expressions as K2 and K4 so
// that nvcc contracts them alike (K4's step c1*d + c2*r is pinned with an
// explicit fma: written out here it contracts the other way). So K8 equals
// the chain of K2 launches and K9 the chain of K4 launches (and K2's
// residual) bit for bit; a bfloat16 coefficient is widened once, when the
// level is loaded. No float atomics.
//
// What bounds it: the launch and the sweeps' serial dependence, not bytes.
// A level the JAX package sends here (its 11 streams fit 12 MiB of VMEM)
// moves a few MB once, but each sweep needs its neighbours' previous sweep.
// A chain of single-pass launches pays a launch and a full HBM/L2 pass of
// the coefficients per sweep; here every cell's 7 coefficients, b and dinv
// (and K9's direction d) live in the registers of the thread that owns it
// for the whole launch, u lives in shared memory (double buffered), and a
// sweep costs a block barrier plus the exchange of the chunk's boundary
// values. Two forms of one kernel body, chosen per level by the host
// (stencil_kernels.resident_plan):
// - cluster: one thread-block cluster (up to 16 CTAs, non-portable size),
//   each CTA owning whole z-planes. After each sweep (and for the start
//   vector) the threads owning a CTA's first and last plane push those
//   values into the neighbouring CTAs' halo slots with st.async, each store
//   completing its bytes on the receiver's mbarrier; a CTA waits only on
//   its own mbarrier (its two neighbours), not on a cluster-wide barrier.
//   Halo slots and mbarriers are double buffered by sweep parity; a slot is
//   refilled only after its reader pushed the values the writer needed, so
//   no empty barrier is needed. One cluster barrier orders the mbarriers'
//   initialisation before the first remote store. (Plain remote stores
//   with one remote mbarrier arrival per CTA measured slower: the
//   arrival's release waits for every store.)
// - grid: one cooperative launch (every CTA co-resident), each CTA owning
//   a contiguous chunk of cells. After each sweep every value goes to L2
//   as one 64-bit word with its launch's tag (a float64 value as two), in a
//   slot of its own for that sweep; a neighbour outside the chunk is read
//   by spinning on its word until the tag is this launch's. No barrier and
//   no fence: each value carries its own readiness, and a CTA waits only
//   for the values it reads. (A flag per CTA, released after the chunk's
//   stores and acquired by the neighbours, measured ~3 us per sweep.) The
//   start vector outside the chunk is u itself or, from zero, the
//   elementwise first sweep, which a CTA recomputes for the halo cells it
//   reads with the owner's arithmetic.
// Each thread owns kCells cells (lattice order, strided by the block size,
// so loads coalesce); the level's loads are all issued before the first
// sweep.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kCells = 2;        // cells per thread
constexpr int kThreads = 512;    // threads per CTA at most (128 registers)
constexpr int kMaxCluster = 16;  // CTAs of the cluster form (non-portable)
constexpr int kBarBytes = 16;    // two mbarriers at the start of shared memory
constexpr int kFill = 8;         // halo cells a thread loads at once (grid)

__device__ __forceinline__ float widen(float c, float) { return c; }
__device__ __forceinline__ double widen(double c, double) { return c; }
__device__ __forceinline__ float widen(__nv_bfloat16 c, float) {
  return __bfloat162float(c);
}

template <typename T, typename CT>
struct Level {
  const CT* coef;   // (7, n): diag, +x, -x, +y, -y, +z, -z
  const T* b;
  const T* u0;      // the start vector (from u), else unused
  const T* steps;   // K9: (n_sweep, 2) per-step scalars, else unused
  T* u_out;
  T* r_out;         // the residual, or null
  // grid form: the exchange slots, one a sweep of (n x words a value)
  // tagged 64-bit words, and the device's [launch tag, finished CTAs]
  unsigned long long* xs;
  unsigned* gsync;
  T omega;          // K8's weight
  int n_sweep, init_zero, nz, ny, nx;
  int cpc;          // cells per CTA (cluster form: whole planes)
};

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
__device__ __forceinline__ T inv_diag(T d) {
  return d != T(0) ? T(1) / d : T(0);
}

// The start vector at a cell from its b and diagonal d, with the owner's
// arithmetic (K2 mode 0 / K4 mode 0): from zero, the first application's
// halo values.
template <bool CHEB, typename T, typename CT>
__device__ __forceinline__ T start_from(const Level<T, CT>& p, T b, T d) {
  const T dinv = inv_diag(d);
  if constexpr (CHEB) return (dinv * b) / p.steps[0];
  return p.omega * b * dinv;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_map(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned addr, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(addr),
               "r"(count)
               : "memory");
}

// A spin that outlasts kSpinCycles (~2.5 s) is a broken exchange, not a
// slow neighbour: the kernel traps, so that the launch fails instead of
// hanging the card.
constexpr long long kSpinCycles = 1LL << 32;

__device__ __forceinline__ void spin_check(long long t0) {
  if (clock64() - t0 > kSpinCycles) __trap();
}

__device__ __forceinline__ void mbar_wait(unsigned addr, unsigned parity) {
  unsigned done = 0;
  const long long t0 = clock64();
  while (!done) {
    spin_check(t0);
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_expect(unsigned addr, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(addr),
      "r"(bytes)
      : "memory");
}

// v into another CTA's shared memory, its bytes completing on that CTA's
// mbarrier (no fence: the mbarrier's phase orders it)
__device__ __forceinline__ void push(unsigned remote, float v,
                                     unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(remote),
      "r"(__float_as_uint(v)), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ void push(unsigned remote, double v,
                                     unsigned remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];" ::"r"(remote),
      "l"(__double_as_longlong(v)), "r"(remote_bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// The grid form's exchange words: a value's 32-bit halves, each in the low
// half of a word whose high half is the launch's tag (float32: one word,
// float64: two). The tag is the device's launch counter, which the last
// CTA of every grid launch advances, and the slots start at the tag
// 0xffffffff, which the counter never reaches in practice (2^32 launches);
// so a word holds this launch's value exactly when its tag matches.
template <typename T>
struct Exchange {
  static constexpr int kWords = sizeof(T) / 4;

  static __device__ __forceinline__ void put(unsigned long long* w, T v,
                                             unsigned tag) {
    unsigned bits[kWords];
    memcpy(bits, &v, sizeof(T));
#pragma unroll
    for (int k = 0; k < kWords; ++k)
      store_relaxed(w + k, (static_cast<unsigned long long>(tag) << 32) |
                               bits[k]);
  }

  static __device__ __forceinline__ T get(const unsigned long long* w,
                                          unsigned tag) {
    unsigned bits[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      unsigned long long x = load_relaxed(w + k);
      if (static_cast<unsigned>(x >> 32) != tag) {
        const long long t0 = clock64();
        do {
          spin_check(t0);
          x = load_relaxed(w + k);
        } while (static_cast<unsigned>(x >> 32) != tag);
      }
      bits[k] = static_cast<unsigned>(x);
    }
    T v;
    memcpy(&v, bits, sizeof(T));
    return v;
  }
};

// One launch of a whole smoothing phase on a level (see the note above).
// CLUSTER: the cluster form, else the grid form; CHEB: K9, else K8.
template <typename T, typename CT, bool CLUSTER, bool CHEB>
__global__ void __launch_bounds__(kThreads)
    level_resident_kernel(const Level<T, CT> p, int emit_residual) {
  extern __shared__ __align__(16) unsigned char level_smem[];
  using X = Exchange<T>;
  const int NT = blockDim.x, tid = threadIdx.x;
  const int g = blockIdx.x, G = gridDim.x;  // the cluster form: one cluster
  const int nx = p.nx, plane = p.ny * p.nx;
  const long long n = static_cast<long long>(plane) * p.nz;
  const long long i0 = static_cast<long long>(g) * p.cpc;
  const int nloc = static_cast<int>(
      n - i0 < static_cast<long long>(p.cpc) ? n - i0 : p.cpc);
  const long long i1 = i0 + nloc;
  // shared memory: [2 mbarriers][u: 2 x cpc][cells [i0 - plane, i0): slots
  // x plane][cells [i1, i1 + plane): slots x plane]; two slots by sweep
  // parity in the cluster form, one (the start vector's) in the grid form
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(level_smem);
  T* ubuf = reinterpret_cast<T*>(level_smem + kBarBytes);
  constexpr int kSlots = CLUSTER ? 2 : 1;
  T* lo = ubuf + 2 * p.cpc;
  T* hi = lo + kSlots * plane;
  const bool linked = CLUSTER && G > 1;
  const bool has_lo = g > 0, has_hi = g + 1 < G;
  const int napp = p.n_sweep - p.init_zero + emit_residual;

  // the level, loaded once: every load issued before the first sweep
  T cf[kCells][7], bv[kCells], dv[kCells], uo[kCells], dd[kCells];
  unsigned kept[kCells];  // bit t: term t's neighbour lies in the lattice
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const int l = tid + c * NT;
    kept[c] = 0u;
    uo[c] = dd[c] = bv[c] = T(0);
#pragma unroll
    for (int t = 0; t < 7; ++t) cf[c][t] = T(0);
    if (l < nloc) {
      const long long i = i0 + l;
#pragma unroll
      for (int t = 0; t < 7; ++t)
        cf[c][t] = widen(__ldg(p.coef + t * n + i), T());
      bv[c] = __ldg(p.b + i);
      if (!p.init_zero) uo[c] = __ldg(p.u0 + i);
      const int z = static_cast<int>(i / plane);
      const int r = static_cast<int>(i - static_cast<long long>(z) * plane);
      const int y = r / nx, x = r - y * nx;
      kept[c] = 1u | (x + 1 < nx ? 2u : 0u) | (x > 0 ? 4u : 0u) |
                (y + 1 < p.ny ? 8u : 0u) | (y > 0 ? 16u : 0u) |
                (z + 1 < p.nz ? 32u : 0u) | (z > 0 ? 64u : 0u);
    }
  }
  // grid form: the start vector outside the chunk, where the first
  // application reads it: of [i0 - plane, i0) the -z run under the chunk
  // and the -y/-x run before it, of [i1, i1 + plane) the +y/+x run after
  // it and the +z run over it; kFill cells a thread and pass, the first
  // pass's loads issued with the level's
  const int zrun = nloc < plane ? nloc : plane;
  const int runs = zrun + (nx < plane ? nx : plane);  // a side's cells
  long long fj[kFill];
  T fb[kFill], fd[kFill];  // b and the diagonal (from zero), or u
  auto fill_load = [&](int q0) {
#pragma unroll
    for (int k = 0; k < kFill; ++k) {
      const int q = q0 + tid + k * NT;
      const int side = q >= runs, r = side ? q - runs : q;
      // low side: positions [0, zrun) then [plane - nx, plane); high
      // side: [0, nx) then [plane - zrun, plane)
      const int h = side ? (r < nx ? r : plane - zrun + (r - nx))
                         : (r < zrun ? r : plane - nx + (r - zrun));
      fj[k] = side ? i1 + h : i0 - plane + h;
      if (q >= 2 * runs || fj[k] < 0 || fj[k] >= n) fj[k] = -1;
      fb[k] = fd[k] = T(0);
      if (fj[k] >= 0) {
        fb[k] = __ldg((p.init_zero ? p.b : p.u0) + fj[k]);
        if (p.init_zero) fd[k] = widen(__ldg(p.coef + fj[k]), T());
      }
    }
  };
  auto fill_store = [&]() {
#pragma unroll
    for (int k = 0; k < kFill; ++k)
      if (fj[k] >= 0)
        (fj[k] < i0 ? lo[fj[k] - (i0 - plane)] : hi[fj[k] - i1]) =
            p.init_zero ? start_from<CHEB>(p, fb[k], fd[k]) : fb[k];
  };
  const bool fill = !CLUSTER && napp > 0;
  if (fill) fill_load(0);
  const T s0 = CHEB ? p.steps[0] : T(0);

#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    dv[c] = inv_diag(cf[c][0]);
    if (p.init_zero) {  // K2 mode 0 / K4 mode 0
      uo[c] = start_from<CHEB>(p, bv[c], cf[c][0]);
      if constexpr (CHEB) dd[c] = uo[c];
    }
    const int l = tid + c * NT;
    if (l < nloc) ubuf[l] = uo[c];
  }
  if (fill) {
    fill_store();
    for (int q0 = kFill * NT; q0 < 2 * runs; q0 += kFill * NT) {
      fill_load(q0);
      fill_store();
    }
  }

  // cluster form: the mbarriers (a phase: this CTA's own arrival with the
  // bytes it expects, and the neighbours' pushed planes) and the remote
  // addresses this CTA pushes its boundary planes to
  unsigned bar0 = 0, lo_push = 0, hi_push = 0, lo_bar = 0, hi_bar = 0;
  const unsigned in_bytes =
      static_cast<unsigned>((has_lo ? plane : 0) + (has_hi ? plane : 0)) *
      sizeof(T);
  // u_a of the chunk's boundary planes into the neighbours' slots a & 1
  auto push_planes = [&](int a) {
    const unsigned off = static_cast<unsigned>((a & 1) * plane) * sizeof(T);
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      const int l = tid + c * NT;
      if (l >= nloc) continue;
      if (has_lo && l < plane)
        push(hi_push + off + l * sizeof(T), uo[c], hi_bar + 8 * (a & 1));
      if (has_hi && l >= nloc - plane)
        push(lo_push + off + (l - (nloc - plane)) * sizeof(T), uo[c],
             lo_bar + 8 * (a & 1));
    }
  };
  if constexpr (CLUSTER) {
    bar0 = smem_addr(bar);
    if (tid == 0 && linked) {
      mbar_init(bar0, 1);
      mbar_init(bar0 + 8, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      // the first two pushed vectors: the start vector u_0 into slot 0,
      // u_1 into slot 1
      if (napp > 0) mbar_expect(bar0, in_bytes);
      if (napp > 1) mbar_expect(bar0 + 8, in_bytes);
    }
    cluster_arrive();  // this CTA's mbarriers exist
    if (linked) {
      // CTA g - 1 keeps cells [i0, i0 + plane) in its high slots, CTA g + 1
      // cells [i1 - plane, i1) in its low ones
      if (has_lo) {
        hi_push = cluster_map(smem_addr(hi), g - 1);
        hi_bar = cluster_map(bar0, g - 1);
      }
      if (has_hi) {
        lo_push = cluster_map(smem_addr(lo), g + 1);
        lo_bar = cluster_map(bar0, g + 1);
      }
    }
    cluster_wait();  // every CTA's mbarriers are initialised
    if (linked && napp > 0) push_planes(0);
  }
  // grid form: this launch's tag (stable until every CTA is done)
  const unsigned tag =
      CLUSTER || napp < 2 ? 0u
                          : static_cast<unsigned>(load_relaxed(
                                reinterpret_cast<const unsigned long long*>(
                                    p.gsync)));
  __syncthreads();

  for (int a = 1; a <= napp; ++a) {
    const bool last = a == napp;
    const bool residual = emit_residual && last;
    const int rs = (a - 1) & 1, ws = a & 1;  // read / write parity
    const T* src = ubuf + rs * p.cpc;
    T* dst = ubuf + ws * p.cpc;
    const T* lo_s = lo + (CLUSTER ? rs : 0) * plane;
    const T* hi_s = hi + (CLUSTER ? rs : 0) * plane;
    // grid form: u_{a-1}'s slot (a >= 2)
    const unsigned long long* xs_r =
        p.xs + static_cast<long long>(a - 2) * n * X::kWords;
    // cluster form: u_{a-1} outside the chunk, pushed by the neighbours
    if constexpr (CLUSTER) {
      if (linked) mbar_wait(bar0 + 8 * rs, ((a - 1) >> 1) & 1);
    }
    // K9's step: from zero, applications 1.. are steps 1..; from u,
    // application 1 is step 0 (mode 1)
    const bool first = CHEB && !p.init_zero && a == 1;
    T c1 = T(0), c2 = T(0);
    if (CHEB && !residual && !first) {
      const int st = p.init_zero ? a : a - 1;
      c1 = p.steps[2 * st];
      c2 = p.steps[2 * st + 1];
    }
#pragma unroll
    for (int c = 0; c < kCells; ++c) {
      const int l = tid + c * NT;
      if (l >= nloc) continue;
      const long long i = i0 + l;
      // u_{a-1} at the cell's neighbour l + d (local offsets)
      auto at = [&](int d) -> T {
        const int m = l + d;
        if (static_cast<unsigned>(m) < static_cast<unsigned>(nloc))
          return src[m];
        if (CLUSTER || a == 1)
          return m < 0 ? lo_s[m + plane] : hi_s[m - nloc];
        return X::get(xs_r + (i + d) * X::kWords, tag);
      };
      // the cluster form's CTAs hold whole planes: only +-z leaves them
      auto in_plane = [&](int d) -> T {
        if constexpr (CLUSTER) return src[l + d];
        return at(d);
      };
      const unsigned k = kept[c];
      T acc = T(0);
      acc += cf[c][0] * uo[c];
      if (k & 2u) acc += cf[c][1] * in_plane(1);
      if (k & 4u) acc += cf[c][2] * in_plane(-1);
      if (k & 8u) acc += cf[c][3] * in_plane(nx);
      if (k & 16u) acc += cf[c][4] * in_plane(-nx);
      if (k & 32u) acc += cf[c][5] * at(plane);
      if (k & 64u) acc += cf[c][6] * at(-plane);
      if (residual) {  // K2 mode 1
        p.r_out[i] = bv[c] - acc;
        continue;
      }
      T un;
      if constexpr (CHEB) {  // K4 modes 1 and 2
        const T r = dv[c] * (bv[c] - acc);
        // K4's c1 * d + c2 * r as nvcc contracts it there (the
        // expression written out here contracts the other way)
        const T dn = first ? r / s0 : fmadd(c1, dd[c], c2 * r);
        dd[c] = dn;
        un = uo[c] + dn;
      } else {  // K2 mode 2
        const T res = bv[c] - acc;
        un = uo[c] + p.omega * res * dv[c];
      }
      uo[c] = un;
      dst[l] = un;
      // grid form: publish u_a at once, in its own slot
      if (!CLUSTER && !last)
        X::put(p.xs + (static_cast<long long>(a - 1) * n + i) * X::kWords,
               un, tag);
    }
    if (last) break;
    // cluster form: publish u_a into the neighbours' slots
    if constexpr (CLUSTER) {
      if (linked) push_planes(a);
    }
    __syncthreads();
    if constexpr (CLUSTER) {
      // every thread has passed its wait on slot rs: arm it for u_{a+1}
      if (tid == 0 && linked && a + 1 < napp)
        mbar_expect(bar0 + 8 * rs, in_bytes);
    }
  }
  if constexpr (!CLUSTER) {
    // the last CTA to finish advances the launch tag for the next launch
    if (napp > 1 && tid == 0 && atomicAdd(p.gsync + 1, 1u) == G - 1) {
      atomicExch(p.gsync + 1, 0u);
      atomicAdd(p.gsync, 1u);
    }
  }
#pragma unroll
  for (int c = 0; c < kCells; ++c) {
    const int l = tid + c * NT;
    if (l < nloc) p.u_out[i0 + l] = uo[c];
  }
}

enum Form { kCluster = 1, kGrid = 2 };

// u (two buffers of a chunk) and the cells outside it (two slots of two
// planes in the cluster form, one in the grid form)
template <typename T>
size_t resident_smem(int form, int cpc, int plane) {
  return kBarBytes +
         static_cast<size_t>(2 * cpc + (form == kCluster ? 4 : 2) * plane) *
             sizeof(T);
}

constexpr size_t kMaxSmem = 200 * 1024;

// The kernel of (form, K8/K9) with its attributes raised once: dynamic
// shared memory up to kMaxSmem, clusters beyond the portable 8 CTAs.
template <typename T, typename CT, bool CLUSTER, bool CHEB>
auto resident_kernel() {
  auto kern = level_resident_kernel<T, CT, CLUSTER, CHEB>;
  static bool ready = false;
  if (!ready) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kMaxSmem));
    if (CLUSTER)
      cudaFuncSetAttribute(kern,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaGetLastError();
    ready = true;
  }
  return kern;
}

template <typename T, typename CT, bool CLUSTER, bool CHEB>
cudaError_t launch_form(const Level<T, CT>& p, int emit_residual, int ctas,
                        int threads, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (CLUSTER) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  } else {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, resident_kernel<T, CT, CLUSTER, CHEB>(), p,
                            emit_residual);
}

// One K8/K9 launch on the plan (form, ctas, threads, cpc) that
// stencil_kernels.resident_plan chose; a plan the kernel cannot run is
// refused (cudaErrorInvalidValue), never cut down. The grid form needs its
// exchange slots (one a sweep after the first application) and the
// device's tag words whenever it synchronises.
template <typename T, typename CT, bool CHEB>
int launch_resident(Level<T, CT> p, int emit_residual, int form, int ctas,
                    int threads, void* stream) {
  const int plane = p.ny * p.nx;
  const long long n = static_cast<long long>(plane) * p.nz;
  const int napp = p.n_sweep - p.init_zero + emit_residual;
  if (p.nz <= 0 || plane <= 0 || n > INT_MAX || p.n_sweep < 1 ||
      napp < 0 || threads <= 0 || threads % 32 || threads > kThreads ||
      ctas <= 0 || p.cpc <= 0 || p.cpc > kCells * threads ||
      static_cast<long long>(ctas) * p.cpc < n ||
      static_cast<long long>(ctas - 1) * p.cpc >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == kCluster && (ctas > kMaxCluster || p.cpc % plane))
    return static_cast<int>(cudaErrorInvalidValue);
  if (form != kCluster && form != kGrid)
    return static_cast<int>(cudaErrorInvalidValue);
  if (form == kGrid && napp > 1 && (p.xs == nullptr || p.gsync == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = resident_smem<T>(form, p.cpc, plane);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      form == kCluster
          ? launch_form<T, CT, true, CHEB>(p, emit_residual, ctas, threads,
                                           smem, st)
          : launch_form<T, CT, false, CHEB>(p, emit_residual, ctas, threads,
                                            smem, st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[0] = multiprocessors, out[1] = the largest cluster the cluster form
// launches (16 where the card schedules one, else the portable 8), out[2]
// = CTAs of the grid form co-resident on one SM at the most threads.
template <typename T, typename CT>
int resident_props(int* out) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int cells = kCells * kThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = resident_smem<T>(kCluster, cells, cells);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kMaxCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(
          &clusters, resident_kernel<T, CT, true, true>(), &cfg) !=
      cudaSuccess)
    clusters = 0;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, resident_kernel<T, CT, false, true>(), kThreads,
          resident_smem<T>(kGrid, cells, cells)) != cudaSuccess)
    per_sm = 0;
  cudaGetLastError();
  out[0] = sms;
  out[1] = clusters >= 1 ? kMaxCluster : 8;
  out[2] = per_sm;
  return 0;
}

template <typename T, typename CT>
Level<T, CT> level_args(const CT* coef, const T* b, const T* u0,
                        const T* steps, T* u_out, T* r_out,
                        unsigned long long* xs, unsigned* gsync,
                        double omega, int n_sweep, int init_zero, int cpc,
                        int nz, int ny, int nx) {
  Level<T, CT> p;
  p.coef = coef;
  p.b = b;
  p.u0 = u0;
  p.steps = steps;
  p.u_out = u_out;
  p.r_out = r_out;
  p.xs = xs;
  p.gsync = gsync;
  p.omega = static_cast<T>(omega);
  p.n_sweep = n_sweep;
  p.init_zero = init_zero;
  p.nz = nz;
  p.ny = ny;
  p.nx = nx;
  p.cpc = cpc;
  return p;
}

}  // namespace

extern "C" {

#define JT_RESIDENT_ENTRIES(SUFFIX, T, CT)                                    \
  int jt_scalar_sweeps_resident_##SUFFIX(                                     \
      const CT* coef, const T* b, const T* u0, T* u_out, T* r_out,            \
      unsigned long long* xs, unsigned* gsync, double omega, int n_sweep,     \
      int init_zero, int form, int ctas, int threads, int cpc, int nz,        \
      int ny, int nx, void* stream) {                                         \
    return launch_resident<T, CT, false>(                                     \
        level_args<T, CT>(coef, b, u0, nullptr, u_out, r_out, xs, gsync,      \
                          omega, n_sweep, init_zero, cpc, nz, ny, nx),        \
        r_out != nullptr, form, ctas, threads, stream);                       \
  }                                                                           \
  int jt_scalar_chebyshev_resident_##SUFFIX(                                  \
      const CT* coef, const T* b, const T* u0, const T* steps, T* u_out,      \
      T* r_out, unsigned long long* xs, unsigned* gsync, int n_sweep,         \
      int init_zero, int form, int ctas, int threads, int cpc, int nz,        \
      int ny, int nx, void* stream) {                                         \
    return launch_resident<T, CT, true>(                                      \
        level_args<T, CT>(coef, b, u0, steps, u_out, r_out, xs, gsync, 0.0,   \
                          n_sweep, init_zero, cpc, nz, ny, nx),               \
        r_out != nullptr, form, ctas, threads, stream);                       \
  }                                                                           \
  int jt_level_resident_props_##SUFFIX(int* out) {                            \
    return resident_props<T, CT>(out);                                        \
  }

JT_RESIDENT_ENTRIES(f32, float, float)
JT_RESIDENT_ENTRIES(f64, double, double)
JT_RESIDENT_ENTRIES(bf16c_f32, float, __nv_bfloat16)

#undef JT_RESIDENT_ENTRIES

}  // extern "C"
