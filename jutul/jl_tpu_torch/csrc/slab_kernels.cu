// K10 scalar_jacobi_slab and K11 scalar_chebyshev_slab for Hopper (sm_90a):
// a whole weighted-Jacobi (K10) or Chebyshev (K11) smoothing phase of a
// large GMG level in one launch, on one kernel template. Built by nvcc beside
// the other sources into one shared library with a plain C interface
// (ops/cuda/_build.py) and bound with ctypes (ops/cuda/stencil_kernels.py,
// which also holds the plain PyTorch versions, the launch planner
// slab_plan and the routing of GMG levels).
//
// K10 replaces jutul/jl_tpu/ops/pallas/stencil_kernels.py:_kernel_slab_sweeps
// (B2, :555, with _slab_jacobi_compute :582; called by
// _scalar_slab_sweeps_call :683, pallas_call :697) and
// _kernel_slab_sweeps_db (B8, :602, the same compute; called by
// _scalar_slab_sweeps_db_call :648, pallas_call :663), which the JAX package
// runs on every level of at least 65,536 cells whose streams do not fit
// VMEM (scalar_level_ops :922-955), B8 under double_buffer: a z-slab with a
// deep row halo, every stencil application of a phase on it, the
// coefficients read once per phase. B8 only starts slab i+1's copies before
// slab i's sweeps; K10's rings copy the next plane while the current one is
// swept in every launch, so both take this kernel. Here: from zero (the
// first sweep is omega*b*dinv) or from u0, then the sweeps, then optionally
// the residual b - A u, in ONE launch.
//
// K11 replaces _kernel_slab_sweeps_cheby (B7, :716; called by
// _scalar_slab_sweeps_cheby_call :773, pallas_call :789), the same slab
// level's Chebyshev phase: from zero (the first step is elementwise) or
// from u0, n_sweep steps of the three-term recurrence, then optionally the
// residual, in ONE launch. The direction d is elementwise in the
// recurrence, so the halo math is the Jacobi phase's: d never needs a
// neighbour and lives in the thread's registers beside its u values, one
// plane per step in flight; it is never loaded or stored. The per-step
// scalars (theta, then (c1, c2) of each step: linsolve/cheby.py
// chebyshev_steps, on the device) are read once per CTA into shared memory.
//
// Values: each cell keeps the chain's arithmetic. K10 keeps K2's
// (csrc/stencil_kernels.cu scalar_jacobi_kernel): dinv = d != 0 ? 1/d : 0
// from the widened diagonal, acc = 0 then one fused multiply-add per term
// t = 0..6 (diag, +x, -x, +y, -y, +z, -z) with the terms whose neighbour
// lies outside the lattice left out, res = b - acc, u + omega*res*dinv
// written as K2 writes it so that nvcc contracts it alike. K11 keeps K4's
// (scalar_chebyshev_kernel) on the same acc: from zero d = (dinv*b)/theta;
// r = dinv*(b - acc); the first step from u d = r/theta, step k
// d = fma(c1, d, c2*r) (K4's c1*d + c2*r as nvcc contracts it there, as K9
// pins it); u' = u + d. The residual is K2's b - acc. So K10 equals the
// chain of K2 launches and K11 the chain of K4 steps (and K2's residual)
// bit for bit, as K8 and K9 do. A bfloat16 coefficient is widened where it
// is read.
//
// What bounds them on this card: the bytes their CTAs load (halos
// included) and the z-march's serial steps. A phase must read 7
// coefficient streams and b (and u0) once and write u (and r): ~10 values a
// cell, 41.9 MB at float32 on the flagship's 1,048,576-cell fine level
// (12.5 us at 3.35 TB/s). The K2 and K4 chains read the coefficients once
// per application (K4 also d in and out); a z-march with one thread per
// cell (the port's first B8 kernel, retired) read them once per phase but
// was bound by instructions: 32x16 tiles with a 2-deep xy halo, each thread
// issuing nine 4-byte copies per plane. This kernel instead:
// - gives a thread V consecutive cells of a lattice row (4 at float32
//   vectors and at bfloat16 coefficients, 2 at float64): one 16-byte copy
//   per stream (8 for bfloat16), one 16-byte shared load per term and
//   sweep; an nx that is not a multiple of V runs V = 1;
// - tiles each plane into ox x oy own cells with a halo of NAPP rows and
//   NAPP columns rounded up to V (so that every copy stays aligned) where a
//   tile does not cover its axis, and z into chunks of tz own planes plus
//   NAPP halo planes below and above, chosen per level by the host's
//   planner (stencil_kernels.slab_plan) from a cost model fitted to the
//   card's times over a grid of tiles (scripts/slab_sweeps_probe.py): the
//   flagship's fine (64, 64, 256) level gets 72x20-cell tiles of 8 planes,
//   128 CTAs; the mid (32, 32, 128) level whole rows;
// - marches z as a wavefront: at step j plane zs + j arrives
//   and sweep k runs on plane zs + j - k, so the +-z neighbours of each
//   sweep are the thread's own register values and the in-plane neighbours
//   come from one shared copy of the previous step's values, double
//   buffered, so one barrier a step suffices;
// - streams each plane's coefficients, b and u0 into rings of stages in
//   shared memory with cp.async, one plane ahead (kSlabPrefetch), each
//   thread copying and later reading only its own cells (the rings need no
//   barrier of their own). A plane's coefficients are held until its last
//   sweep (NAPP + 2 stages), its b and u0 only until it arrives (2
//   stages); the ring slots advance by one a step, with no division in the
//   step loop;
// - runs sweep k only on cells within NAPP - k steps (x + y + z) of the
//   tile's own cells, the only ones an owner's last application reads,
//   so warps of halo rows and the chunk's halo planes skip the sweeps no
//   owner needs; a halo cell at distance NAPP or more loads only what its
//   first sweep needs: b and the diagonal from zero, u0 from u.
// Wrong values creep in one cell per application from a tile's edges;
// only owner threads write, and only planes of their chunk. Neighbours
// outside the lattice are skipped, as in K2, so cells outside it are never
// read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kSlabThreads = 512;       // threads per CTA at most
constexpr int kSlabMaxDepth = 4;        // stencil applications per launch
// planes copied ahead: two or three measured no faster, and each costs a
// ring stage of shared memory
constexpr int kSlabPrefetch = 1;
constexpr int kSlabMaxSmem = 227 * 1024;  // dynamic shared memory per CTA

__host__ __device__ constexpr long long align16(long long v) {
  return (v + 15) / 16 * 16;
}

// Shared memory of one CTA whose tile holds `cells` cells of a plane: the
// published sweep values [2][max(NAPP, 1)][cells] of T; the coefficient
// ring of NAPP + kSlabPrefetch + 1 stages [7][cells] of CT (a plane's
// coefficients are read by each of its sweeps); the vector ring of
// kSlabPrefetch + 1 stages of b [cells] and, from u, u0 [cells] of T (read
// when the plane arrives); K11's step scalars, (theta, 0) and (c1, c2) of
// at most kSlabMaxDepth + 1 steps.
__host__ __device__ constexpr long long slab_steps_bytes(int tsize) {
  return align16(2LL * (kSlabMaxDepth + 1) * tsize);
}
__host__ __device__ constexpr long long slab_smem_bytes(long long cells,
                                                        int napp, int csize,
                                                        int tsize,
                                                        int from_u,
                                                        bool cheby) {
  return align16(2LL * (napp > 0 ? napp : 1) * cells * tsize) +
         (napp + kSlabPrefetch + 1) * align16(7 * cells * csize) +
         (kSlabPrefetch + 1) * (from_u ? 2 : 1) * align16(cells * tsize) +
         (cheby ? slab_steps_bytes(tsize) : 0);
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

// B bytes (2, 4, 8 or 16, aligned alike) from p into dst.
template <int B>
__device__ __forceinline__ void load_words(const void* p, void* dst) {
  if constexpr (B == 16) {
    const uint4 v = *static_cast<const uint4*>(p);
    memcpy(dst, &v, 16);
  } else if constexpr (B == 8) {
    const uint2 v = *static_cast<const uint2*>(p);
    memcpy(dst, &v, 8);
  } else if constexpr (B == 4) {
    const unsigned v = *static_cast<const unsigned*>(p);
    memcpy(dst, &v, 4);
  } else {
    static_assert(B == 2, "load_words: 2, 4, 8 or 16 bytes");
    const unsigned short v = *static_cast<const unsigned short*>(p);
    memcpy(dst, &v, 2);
  }
}

// B bytes from src to p.
template <int B>
__device__ __forceinline__ void store_words(void* p, const void* src) {
  if constexpr (B == 16) {
    uint4 v;
    memcpy(&v, src, 16);
    *static_cast<uint4*>(p) = v;
  } else if constexpr (B == 8) {
    uint2 v;
    memcpy(&v, src, 8);
    *static_cast<uint2*>(p) = v;
  } else if constexpr (B == 4) {
    unsigned v;
    memcpy(&v, src, 4);
    *static_cast<unsigned*>(p) = v;
  } else {
    static_assert(B == 2, "store_words: 2, 4, 8 or 16 bytes");
    unsigned short v;
    memcpy(&v, src, 2);
    *static_cast<unsigned short*>(p) = v;
  }
}

// B bytes from global memory into shared memory: cp.async for 4, 8 and 16
// bytes (16 bypassing L1: a stream is read once per CTA); the two bytes of
// one bfloat16 coefficient (V = 1), which cp.async cannot move, by a plain
// load and store.
template <int B>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem) {
  if constexpr (B == 2) {
    store_words<2>(smem, gmem);
  } else {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    if constexpr (B == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(gmem)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
                   "l"(gmem), "n"(B)
                   : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, typename CT>
struct SlabArgs {
  const CT* coef;  // (7, n): diag, +x, -x, +y, -y, +z, -z
  const T* b;
  const T* u0;     // the start vector (from u), else unused
  const T* steps;  // K11: (n_sweep, 2) step scalars, else unused
  T* u_out;
  T* r_out;        // the residual, or null
  T omega;         // K10's weight, else unused
  int n_sweep, init_zero, nz, ny, nx;
  int ox, hx, tiles_x;  // a tile's own columns, its halo columns on each
                        // side (a multiple of V), tiles along x
  int oy, hy;           // a tile's own rows and its halo rows on each side
  int tz;               // a chunk's own planes
};

// CHEB: K11's per-cell update (K4's), else K10's (K2's).
template <bool CHEB, typename T, typename CT, int V, int NAPP>
__global__ void __launch_bounds__(kSlabThreads, 1)
    scalar_slab_kernel(const SlabArgs<T, CT> p) {
  constexpr int NS = NAPP > 0 ? NAPP : 1;
  // register rings of period P, indexed by plane: bv/dv hold planes
  // s - NAPP .. s, hist[j] sweep j's values on the same slots; the step
  // loop is unrolled by P, so every slot index is a constant
  constexpr int P = NAPP + 1 > 3 ? NAPP + 1 : 3;
  constexpr int CB = V * static_cast<int>(sizeof(CT));
  constexpr int TB = V * static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char slab_smem[];
  const int nx = p.nx, ny = p.ny, nz = p.nz;
  const int TX = static_cast<int>(blockDim.x) * V;  // the tile's columns
  const int TY = static_cast<int>(blockDim.y);      // and rows
  const int cells = TY * TX;  // the tile's cells in one plane
  const int tx = static_cast<int>(threadIdx.x);
  const int ty = static_cast<int>(threadIdx.y);
  const int x0 = tx * V;        // the thread's first column in the tile
  const int lc = ty * TX + x0;  // and its first cell
  const int bx = static_cast<int>(blockIdx.x) % p.tiles_x;
  const int by = static_cast<int>(blockIdx.x) / p.tiles_x;
  const int gx = bx * p.ox - p.hx + x0;  // in the lattice
  const int gy = by * p.oy - p.hy + ty;
  // ox, hx and nx are multiples of V: a thread's cells are all in or out
  const bool in_lat = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
  const bool owner = in_lat && ty >= p.hy && ty < p.hy + p.oy &&
                     x0 >= p.hx && x0 < p.hx + p.ox;
  const bool residual = p.r_out != nullptr;
  const bool from_u = !p.init_zero;
  // lattice neighbours (else the term is skipped, as in K2); in-plane
  // values come from the tile, clamped at its edge (edge values are never
  // used by an owner)
  const bool xp = gx + V < nx, xm = gx > 0, yp = gy + 1 < ny, ym = gy > 0;
  const int lyp = min(ty + 1, TY - 1) * TX + x0;
  const int lym = max(ty - 1, 0) * TX + x0;
  const int lxp = ty * TX + min(x0 + V, TX - 1);
  const int lxm = ty * TX + max(x0 - 1, 0);
  const long long plane = static_cast<long long>(ny) * nx;
  const long long n = plane * nz;
  const long long col = in_lat ? static_cast<long long>(gy) * nx + gx : 0;
  const int z0 = static_cast<int>(blockIdx.y) * p.tz;
  const int z1 = min(nz, z0 + p.tz);       // written planes [z0, z1)
  const int zs = max(0, z0 - NAPP);         // loaded planes [zs, ze]
  const int ze = min(nz - 1, z1 - 1 + NAPP);
  // A cell at distance d (x + y + z steps) from the tile's own cells feeds
  // an owner's last application through sweep NAPP - d at most: it runs
  // sweep k only if d <= NAPP - k, and a cell at distance NAPP or more
  // loads only what the first sweep needs (b and the diagonal from zero,
  // u0 from u). dxy: the thread's x + y distance (of its nearest cell).
  const int dx = x0 + V <= p.hx ? p.hx - (x0 + V - 1)
                 : x0 >= p.hx + p.ox ? x0 - (p.hx + p.ox) + 1 : 0;
  const int dxy = dx + max(max(p.hy - ty, ty - (p.hy + p.oy - 1)), 0);
  auto dz = [&](int pz) { return max(max(z0 - pz, pz - (z1 - 1)), 0); };
  constexpr int RC = NAPP + kSlabPrefetch + 1;  // coefficient ring stages
  constexpr int RV = kSlabPrefetch + 1;         // vector ring stages
  T* exch = reinterpret_cast<T*>(slab_smem);  // [2][NS][cells]
  unsigned char* cring = slab_smem + align16(2LL * NS * cells * sizeof(T));
  const long long cstage = align16(7LL * cells * sizeof(CT));
  const long long vbytes = align16(static_cast<long long>(cells) * sizeof(T));
  const long long vstage = (from_u ? 2 : 1) * vbytes;
  unsigned char* vring = cring + RC * cstage;
  // K11: theta, and the (c1, c2) of application k (1..NAPP) where it is a
  // step (from zero, step k; from u, step k - 1, step 0 being r / theta)
  T theta = T(0), c1[NS + 1], c2[NS + 1];
  if constexpr (CHEB) {
    T* sc = reinterpret_cast<T*>(vring + RV * vstage);
    const int nt = static_cast<int>(blockDim.x * blockDim.y);
    for (int i = ty * static_cast<int>(blockDim.x) + tx; i < 2 * p.n_sweep;
         i += nt)
      sc[i] = p.steps[i];
    __syncthreads();
    theta = sc[0];
#pragma unroll
    for (int k = 0; k <= NS; ++k) {
      const int st = from_u ? k - 1 : k;
      c1[k] = k >= 1 && st >= 1 && st < p.n_sweep ? sc[2 * st] : T(0);
      c2[k] = k >= 1 && st >= 1 && st < p.n_sweep ? sc[2 * st + 1] : T(0);
    }
  }
  // the thread's coefficient t and vector i (b, u0) in ring slot c / v
  auto coef_at = [&](int c, int t) {
    return reinterpret_cast<CT*>(cring + c * cstage) + t * cells + lc;
  };
  auto vec_at = [&](int v, int i) {
    return reinterpret_cast<T*>(vring + v * vstage + i * vbytes) + lc;
  };
  // ring slots advance by one a step; no division in the step loop
  auto wrap = [](int slot, int stages) {
    return slot >= stages ? slot - stages : slot;
  };
  const int nsteps = ze - zs + 1;  // planes loaded
  const CT* coef_col = p.coef + col;
  const T* b_col = p.b + col;
  const T* u0_col = from_u ? p.u0 + col : nullptr;

  // step j's streams into ring slots c and v: one commit group per plane
  // (empty beyond the last plane or outside the lattice) keeps every
  // thread's count uniform
  auto fetch = [&](int j, int c, int v) {
    if (in_lat && j < nsteps) {
      const int pz = zs + j;
      const long long i = pz * plane;
      const bool thin = NAPP > 0 && dxy + dz(pz) >= NAPP;
      if (!thin) {
#pragma unroll
        for (int t = 0; t < 7; ++t)
          copy_async<CB>(coef_at(c, t), coef_col + t * n + i);
        copy_async<TB>(vec_at(v, 0), b_col + i);
        if (from_u) copy_async<TB>(vec_at(v, 1), u0_col + i);
      } else if (from_u) {
        copy_async<TB>(vec_at(v, 1), u0_col + i);
      } else {
        copy_async<CB>(coef_at(c, 0), coef_col + i);
        copy_async<TB>(vec_at(v, 0), b_col + i);
      }
    }
    cp_async_commit();
  };

  // dh[j]: K11's direction after sweep j, on the same slots as hist
  T bv[P][V], dv[P][V], hist[NS][P][V], dh[NS][P][V];
#pragma unroll
  for (int m = 0; m < P; ++m) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      bv[m][v] = dv[m][v] = T(0);
#pragma unroll
      for (int j = 0; j < NS; ++j) hist[j][m][v] = dh[j][m][v] = T(0);
    }
  }
  for (int j = 0; j <= kSlabPrefetch; ++j) fetch(j, j % RC, j % RV);
  // the slots of step j (cj, vj) and of step j + kSlabPrefetch + 1 (cf, vf)
  int cj = 0, vj = 0, cf = (kSlabPrefetch + 1) % RC,
      vf = (kSlabPrefetch + 1) % RV;

  const int j_end = nsteps - 1 + NAPP;
  for (int j0 = 0; j0 <= j_end; j0 += P) {
#pragma unroll
    for (int r = 0; r < P; ++r) {  // r = j % P
      const int j = j0 + r;
      if (j > j_end) break;
      const int s = zs + j;  // the plane arriving (beyond ze: none)
      const T* sh_r = exch + ((j + 1) & 1) * NS * cells;  // the previous step's
      T* sh_w = exch + (j & 1) * NS * cells;
      T v0[V];  // sweep 0 (the start) on plane s
#pragma unroll
      for (int v = 0; v < V; ++v) v0[v] = bv[r][v] = dv[r][v] = T(0);
      if (j < nsteps) {
        cp_async_wait<kSlabPrefetch>();  // this thread's copies of plane s
        if (in_lat) {
          CT dr[V];
          T bb[V], uu[V];
          load_words<CB>(coef_at(cj, 0), dr);
          load_words<TB>(vec_at(vj, 0), bb);
          if (from_u) load_words<TB>(vec_at(vj, 1), uu);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const T d = widen(dr[v], T());
            dv[r][v] = d != T(0) ? T(1) / d : T(0);
            bv[r][v] = bb[v];
            // from zero: K2 mode 0, or K4 mode 0 (d = u)
            if constexpr (CHEB)
              v0[v] = from_u ? uu[v] : (dv[r][v] * bb[v]) / theta;
            else
              v0[v] = from_u ? uu[v] : p.omega * bb[v] * dv[r][v];
          }
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) hist[0][r][v] = dh[0][r][v] = v0[v];
      if (NAPP == 0 && owner && j < nsteps && s >= z0 && s < z1)
        store_words<TB>(p.u_out + s * plane + col, v0);
#pragma unroll
      for (int k = 1; k <= NAPP; ++k) {
        const int jk = j - k;                  // sweep k's step this step
        const int m = (r - k + 2 * P) % P;     // its slot (a constant)
        const int mp = (m + 1) % P, mm = (m + P - 1) % P;  // +z, -z
        const int pl = zs + jk;  // sweep k's plane
        T val[V], dk[V];  // sweep k's values and, K11, its direction
#pragma unroll
        for (int v = 0; v < V; ++v) val[v] = dk[v] = T(0);
        if (in_lat && jk >= 0 && jk < nsteps && dxy + dz(pl) <= NAPP - k) {
          // the in-plane neighbours of sweep k - 1, read unconditionally
          // (every index lies in the tile) so that the skips below select
          // instead of branching around the loads
          const T* prev = sh_r + (k - 1) * cells;
          T up[V], dn[V];
          load_words<TB>(prev + lyp, up);
          load_words<TB>(prev + lym, dn);
          const T right = prev[lxp], left = prev[lxm];
          const int ck = cj - k < 0 ? cj - k + RC : cj - k;  // its slot
          CT cr[7][V];
#pragma unroll
          for (int t = 0; t < 7; ++t) load_words<CB>(coef_at(ck, t), cr[t]);
          const bool zp = pl + 1 < nz, zm = pl > 0;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const T c = hist[k - 1][m][v];
            const T xr = v + 1 < V ? hist[k - 1][m][(v + 1) % V] : right;
            const T xl = v > 0 ? hist[k - 1][m][(v + V - 1) % V] : left;
            const bool ok[7] = {true, v + 1 < V || xp, v > 0 || xm, yp, ym,
                                zp, zm};
            const T nb[7] = {c, xr, xl, up[v], dn[v], hist[k - 1][mp][v],
                             hist[k - 1][mm][v]};
            T acc = T(0);
#pragma unroll
            for (int t = 0; t < 7; ++t) {
              // a select, not a branch: the loads stay ahead of the sums
              const T f = fmadd(widen(cr[t][v], T()), nb[t], acc);
              acc = ok[t] ? f : acc;
            }
            const T res = bv[m][v] - acc;
            if (residual && k == NAPP) {
              val[v] = res;  // K2 mode 1
            } else if constexpr (CHEB) {  // K4 modes 1 and 2
              const T pr = dv[m][v] * res;  // K4's r
              dk[v] = (from_u && k == 1) ? pr / theta
                                         : fmadd(c1[k], dh[k - 1][m][v],
                                                 c2[k] * pr);
              val[v] = c + dk[v];
            } else {  // K2 mode 2
              val[v] = c + p.omega * res * dv[m][v];
            }
          }
          if (k == NAPP && owner && pl >= z0 && pl < z1) {
            const long long i = pl * plane + col;
            if (residual) {
              store_words<TB>(p.u_out + i, hist[k - 1][m]);
              store_words<TB>(p.r_out + i, val);
            } else {
              store_words<TB>(p.u_out + i, val);
            }
          }
        }
        if (k < NAPP) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            hist[k][m][v] = val[v];
            dh[k][m][v] = dk[v];
          }
        }
      }
      // publish sweeps 0..NAPP-1 (steps j .. j - NAPP + 1) for the next
      // step's in-plane neighbours
#pragma unroll
      for (int i = 0; i < NAPP; ++i)
        store_words<TB>(sh_w + i * cells + lc, hist[i][(r - i + 2 * P) % P]);
      // sh_w is complete for the next step, every read of sh_r, of step
      // j - NAPP's coefficients and of step j's vectors is done: their
      // stages may be refilled
      __syncthreads();
      fetch(j + kSlabPrefetch + 1, cf, vf);
      cj = wrap(cj + 1, RC);
      vj = wrap(vj + 1, RV);
      cf = wrap(cf + 1, RC);
      vf = wrap(vf + 1, RV);
    }
  }
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <bool CHEB, typename T, typename CT, int V, int NAPP>
int launch_slab_depth(const SlabArgs<T, CT>& a, int tiles, int chunks,
                      int tx, int ty, long long smem, cudaStream_t st) {
  auto kern = scalar_slab_kernel<CHEB, T, CT, V, NAPP>;
  static long long raised = 48 * 1024;  // the dynamic limit set so far
  if (smem > raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSlabMaxSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = kSlabMaxSmem;
  }
  kern<<<dim3(tiles, chunks), dim3(tx / V, ty), smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool CHEB, typename T, typename CT, int V>
int launch_slab_vec(const SlabArgs<T, CT>& a, int napp, int tiles,
                    int chunks, int tx, int ty, long long smem,
                    cudaStream_t st) {
  switch (napp) {
    case 0: return launch_slab_depth<CHEB, T, CT, V, 0>(a, tiles, chunks, tx, ty, smem, st);
    case 1: return launch_slab_depth<CHEB, T, CT, V, 1>(a, tiles, chunks, tx, ty, smem, st);
    case 2: return launch_slab_depth<CHEB, T, CT, V, 2>(a, tiles, chunks, tx, ty, smem, st);
    case 3: return launch_slab_depth<CHEB, T, CT, V, 3>(a, tiles, chunks, tx, ty, smem, st);
    case 4: return launch_slab_depth<CHEB, T, CT, V, 4>(a, tiles, chunks, tx, ty, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One phase on (nz, ny, nx) with the host's plan: vec cells a thread (the
// type's widest, or 1), tiles of ox columns and oy rows, z-chunks of tz
// planes. A tile that does not cover its axis has
// a halo on each side: napp rows, and napp columns rounded up to vec (so
// that every copy stays aligned). Refuses (cudaErrorInvalidValue) a plan
// the kernel cannot run: a tile over the block's threads or the
// shared-memory limit, a misaligned stream, more than kSlabMaxDepth
// applications; for K11 (CHEB) no step or no step table.
template <bool CHEB, typename T, typename CT>
int launch_slab(const CT* coef, const T* b, const T* u0, const T* steps,
                T* u_out, T* r_out, double omega, int n_sweep, int init_zero,
                int nz, int ny, int nx, int vec, int ox, int oy, int tz,
                void* stream) {
  constexpr int VMAX = sizeof(T) == 8 ? 2 : 4;
  const int napp = (init_zero ? n_sweep - 1 : n_sweep) + (r_out ? 1 : 0);
  const long long n = static_cast<long long>(nz) * ny * nx;
  if (napp < 0 || napp > kSlabMaxDepth || (init_zero && n_sweep < 1) ||
      (CHEB && (n_sweep < 1 || steps == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  if ((vec != 1 && vec != VMAX) || nx % vec || ox < 1 || ox % vec ||
      oy < 1 || tz < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (nx + ox - 1) / ox;
  const int bands = (ny + oy - 1) / oy;
  const int chunks = (nz + tz - 1) / tz;
  const int hx = tiles_x > 1 ? (napp + vec - 1) / vec * vec : 0;
  const int hy = bands > 1 ? napp : 0;
  const int tx = (tiles_x > 1 ? ox : nx) + 2 * hx;
  const int ty = (bands > 1 ? oy : ny) + 2 * hy;
  const long long cells = static_cast<long long>(ty) * tx;
  const long long smem = slab_smem_bytes(cells, napp, sizeof(CT), sizeof(T),
                                         !init_zero, CHEB);
  const long long tiles = static_cast<long long>(tiles_x) * bands;
  if (cells / vec > kSlabThreads || smem > kSlabMaxSmem || chunks > 65535 ||
      tiles > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cb = vec * sizeof(CT), tb = vec * sizeof(T);
  if (!aligned(coef, cb) || !aligned(b, tb) || !aligned(u_out, tb) ||
      (!init_zero && !aligned(u0, tb)) || (r_out && !aligned(r_out, tb)))
    return static_cast<int>(cudaErrorInvalidValue);
  SlabArgs<T, CT> a;
  a.coef = coef;
  a.b = b;
  a.u0 = u0;
  a.steps = steps;
  a.u_out = u_out;
  a.r_out = r_out;
  a.omega = static_cast<T>(omega);
  a.n_sweep = n_sweep;
  a.init_zero = init_zero;
  a.nz = nz;
  a.ny = ny;
  a.nx = nx;
  a.ox = tiles_x > 1 ? ox : nx;
  a.hx = hx;
  a.tiles_x = tiles_x;
  a.oy = bands > 1 ? oy : ny;
  a.hy = hy;
  a.tz = tz;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = static_cast<int>(tiles);
  if (vec == 1)
    return launch_slab_vec<CHEB, T, CT, 1>(a, napp, nt, chunks, tx, ty, smem,
                                           st);
  return launch_slab_vec<CHEB, T, CT, VMAX>(a, napp, nt, chunks, tx, ty,
                                            smem, st);
}

}  // namespace

extern "C" {

int jt_scalar_jacobi_slab_f32(const float* coef, const float* b,
                              const float* u0, float* u_out, float* r_out,
                              double omega, int n_sweep, int init_zero,
                              int nz, int ny, int nx, int vec, int ox, int oy,
                              int tz, void* stream) {
  return launch_slab<false, float, float>(coef, b, u0, nullptr, u_out, r_out,
                                          omega, n_sweep, init_zero, nz, ny,
                                          nx, vec, ox, oy, tz, stream);
}

int jt_scalar_jacobi_slab_f64(const double* coef, const double* b,
                              const double* u0, double* u_out, double* r_out,
                              double omega, int n_sweep, int init_zero,
                              int nz, int ny, int nx, int vec, int ox, int oy,
                              int tz, void* stream) {
  return launch_slab<false, double, double>(coef, b, u0, nullptr, u_out,
                                            r_out, omega, n_sweep, init_zero,
                                            nz, ny, nx, vec, ox, oy, tz,
                                            stream);
}

// bfloat16 coefficients, float32 vectors (B9 via B2).
int jt_scalar_jacobi_slab_bf16c_f32(const __nv_bfloat16* coef, const float* b,
                                    const float* u0, float* u_out,
                                    float* r_out, double omega, int n_sweep,
                                    int init_zero, int nz, int ny, int nx,
                                    int vec, int ox, int oy, int tz,
                                    void* stream) {
  return launch_slab<false, float, __nv_bfloat16>(
      coef, b, u0, nullptr, u_out, r_out, omega, n_sweep, init_zero, nz, ny,
      nx, vec, ox, oy, tz, stream);
}

// K11: steps holds at least n_sweep rows (theta, 0), (c1, c2), ...
int jt_scalar_chebyshev_slab_f32(const float* coef, const float* b,
                                 const float* u0, const float* steps,
                                 float* u_out, float* r_out, int n_sweep,
                                 int init_zero, int nz, int ny, int nx,
                                 int vec, int ox, int oy, int tz,
                                 void* stream) {
  return launch_slab<true, float, float>(coef, b, u0, steps, u_out, r_out,
                                         0.0, n_sweep, init_zero, nz, ny, nx,
                                         vec, ox, oy, tz, stream);
}

int jt_scalar_chebyshev_slab_f64(const double* coef, const double* b,
                                 const double* u0, const double* steps,
                                 double* u_out, double* r_out, int n_sweep,
                                 int init_zero, int nz, int ny, int nx,
                                 int vec, int ox, int oy, int tz,
                                 void* stream) {
  return launch_slab<true, double, double>(coef, b, u0, steps, u_out, r_out,
                                           0.0, n_sweep, init_zero, nz, ny,
                                           nx, vec, ox, oy, tz, stream);
}

// bfloat16 coefficients, float32 vectors (B9 via B7).
int jt_scalar_chebyshev_slab_bf16c_f32(const __nv_bfloat16* coef,
                                       const float* b, const float* u0,
                                       const float* steps, float* u_out,
                                       float* r_out, int n_sweep,
                                       int init_zero, int nz, int ny, int nx,
                                       int vec, int ox, int oy, int tz,
                                       void* stream) {
  return launch_slab<true, float, __nv_bfloat16>(
      coef, b, u0, steps, u_out, r_out, 0.0, n_sweep, init_zero, nz, ny, nx,
      vec, ox, oy, tz, stream);
}

}  // extern "C"
