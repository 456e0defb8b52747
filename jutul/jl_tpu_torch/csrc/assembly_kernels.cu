// K3 darcy_flux_jacobian for Hopper (sm_90a). Replaces
// jutul/jl_tpu/ops/pallas/assembly_kernels.py:_kernel_axis, which traced the
// ScalarAssemblyForm flux of models/darcy.py:329-343 and ran four jvps of it.
// Here the two-phase Darcy flux is written by hand over a forward-mode dual
// number with four partials, (p_L, s_L, p_R, s_R), so the flux and both
// (neq x ndof) Jacobian blocks come out of one evaluation.
//
// Two kernels, one face arithmetic:
// - darcy_flux_jacobian_kernel: one thread per face of one axis. It serves
//   the well perforations' (1, 2, np) lattice, where a tile has nothing to
//   share, and on the card it is the bitwise reference of
// - darcy_flux_jacobian_lattice_kernel: all three axes of a lattice in one
//   launch, each cell's exp/pow evaluated once (its note below says what
//   bounds the per-axis kernel and what this design does about it).
// Inputs: the packed dofs u (n, 2) =
// (pressure, water saturation) per cell on the natural (nz, ny, nx) lattice,
// and the face parameters trans/gdz on each axis's face lattice
// (nz, ny, nx-1) / (nz, ny-1, nx) / (nz-1, ny, nx) in C order. Output per
// axis (10, n_faces) in the Pallas kernel's stream order:
//   out[e]              flux of phase e
//   out[2 + 2*j + e]    dF_e / du_L[j]
//   out[6 + 2*j + e]    dF_e / du_R[j]
//
// Derivative conventions are JAX's, so the Jacobian matches the JAX
// package's: clip has weight 0.5 exactly at a bound (saturations sit on 0
// or 1 after the update's chopping), a select differentiates the chosen
// branch, and the upwind tie dpot >= 0 takes the left cell.
//
// Bound: 2 dofs per cell plus 2 face parameters in and 10 outputs per face
// (157.6 MB for the flagship's three axes in f32, 0.047 ms at 3.35 TB/s)
// against ~150 flops per face and 6 transcendentals per cell: bytes. Both
// kernels keep all partials in registers and write every stream once,
// coalesced along x.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kP = 4;  // partials: p_L, s_L, p_R, s_R

template <typename T>
struct Dual {
  T v;
  T d[kP];
};

template <typename T>
__device__ __forceinline__ Dual<T> seed(T v, int slot) {
  Dual<T> r;
  r.v = v;
#pragma unroll
  for (int q = 0; q < kP; ++q) r.d[q] = q == slot ? T(1) : T(0);
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator+(const Dual<T>& a,
                                             const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int q = 0; q < kP; ++q) r.d[q] = a.d[q] + b.d[q];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator-(const Dual<T>& a,
                                             const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int q = 0; q < kP; ++q) r.d[q] = a.d[q] - b.d[q];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> operator*(const Dual<T>& a,
                                             const Dual<T>& b) {
  Dual<T> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int q = 0; q < kP; ++q) r.d[q] = a.d[q] * b.v + a.v * b.d[q];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> scale(T s, const Dual<T>& a) {
  Dual<T> r;
  r.v = s * a.v;
#pragma unroll
  for (int q = 0; q < kP; ++q) r.d[q] = s * a.d[q];
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> shift(const Dual<T>& a, T s) {
  Dual<T> r = a;
  r.v = a.v + s;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> divide(const Dual<T>& a, T s) {
  Dual<T> r;
  r.v = a.v / s;
#pragma unroll
  for (int q = 0; q < kP; ++q) r.d[q] = a.d[q] / s;
  return r;
}

template <typename T>
__device__ __forceinline__ Dual<T> dexp(const Dual<T>& a) {
  Dual<T> r;
  r.v = exp(a.v);
#pragma unroll
  for (int q = 0; q < kP; ++q) r.d[q] = a.d[q] * r.v;
  return r;
}

// x ** e for a constant exponent: d = e * x^(e-1) dx (JAX's lax.pow rule).
template <typename T>
__device__ __forceinline__ Dual<T> dpow(const Dual<T>& a, T e) {
  Dual<T> r;
  r.v = pow(a.v, e);
  const T g = e == T(0) ? T(0) : e * pow(a.v, e - T(1));
#pragma unroll
  for (int q = 0; q < kP; ++q) r.d[q] = a.d[q] * g;
  return r;
}

// min(max(x, lo), hi) with JAX's tie rule: weight 0.5 where x == lo or hi.
template <typename T>
__device__ __forceinline__ Dual<T> clip(const Dual<T>& a, T lo, T hi) {
  const T m = a.v > lo ? a.v : lo;
  const T w1 = a.v > lo ? T(1) : (a.v == lo ? T(0.5) : T(0));
  const T w2 = m < hi ? T(1) : (m == hi ? T(0.5) : T(0));
  Dual<T> r;
  r.v = m < hi ? m : hi;
#pragma unroll
  for (int q = 0; q < kP; ++q) r.d[q] = a.d[q] * (w1 * w2);
  return r;
}

template <typename T>
__device__ __forceinline__ const Dual<T>& pick(bool c, const Dual<T>& a,
                                                 const Dual<T>& b) {
  return c ? a : b;
}

// Fluid constants, phase 0 = water (dof 1 is its saturation), 1 = oil.
template <typename T>
struct Fluid {
  T rho0[2], comp[2], pref, sr[2], one_minus_sr_tot, nexp[2], mu[2];
};

template <typename T>
__device__ __forceinline__ Dual<T> density(const Fluid<T>& f, int a,
                                           const Dual<T>& p) {
  return scale(f.rho0[a], dexp(scale(f.comp[a], shift(p, -f.pref))));
}

template <typename T>
__device__ __forceinline__ Dual<T> mobility(const Fluid<T>& f, int a,
                                            const Dual<T>& s) {
  const Dual<T> s_eff =
      clip(divide(shift(s, -f.sr[a]), f.one_minus_sr_tot), T(0), T(1));
  return divide(dpow(s_eff, f.nexp[a]), f.mu[a]);
}

template <typename T>
__global__ void darcy_flux_jacobian_kernel(const T* __restrict__ u,
                                           const T* __restrict__ trans,
                                           const T* __restrict__ gdz,
                                           T* __restrict__ out, Fluid<T> f,
                                           int axis, int nz, int ny, int nx) {
  const int fx = nx - (axis == 0), fy = ny - (axis == 1),
            fz = nz - (axis == 2);
  const long long nf = static_cast<long long>(fz) * fy * fx;
  const long long face =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (face >= nf) return;
  const int x = static_cast<int>(face % fx);
  const int y = static_cast<int>((face / fx) % fy);
  const int z = static_cast<int>(face / (static_cast<long long>(fx) * fy));
  const long long left = (static_cast<long long>(z) * ny + y) * nx + x;
  const long long step =
      axis == 0 ? 1 : (axis == 1 ? nx : static_cast<long long>(nx) * ny);
  const long long right = left + step;

  const Dual<T> p_l = seed(u[2 * left], 0), s_l = seed(u[2 * left + 1], 1);
  const Dual<T> p_r = seed(u[2 * right], 2), s_r = seed(u[2 * right + 1], 3);
  const Dual<T> one = seed(T(1), -1);
  const T T_f = trans[face], g = gdz[face];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    // the last phase's saturation closes the unit sum
    const Dual<T> sat_l = a == 0 ? s_l : one - s_l;
    const Dual<T> sat_r = a == 0 ? s_r : one - s_r;
    const Dual<T> rho_l = density(f, a, p_l), rho_r = density(f, a, p_r);
    const Dual<T> mob_l = mobility(f, a, sat_l);
    const Dual<T> mob_r = mobility(f, a, sat_r);
    const Dual<T> rho_avg = scale(T(0.5), rho_l + rho_r);
    const Dual<T> dpot = (p_l - p_r) - scale(g, rho_avg);
    const bool up = dpot.v >= T(0);
    const Dual<T> flux = scale(T_f, pick(up, rho_l, rho_r) *
                                        pick(up, mob_l, mob_r)) * dpot;
    out[a * nf + face] = flux.v;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      out[(2 + 2 * j + a) * nf + face] = flux.d[j];
      out[(6 + 2 * j + a) * nf + face] = flux.d[2 + j];
    }
  }
}

// ---------------------------------------------------------------------------
// The three-axis lattice kernel (darcy_flux_jacobian_lattice): every face of
// the lattice in one launch, each cell's properties evaluated once.
//
// What bounds the per-axis kernel on this card: instructions, not bytes.
// Each thread evaluates the density (one exp) and the mobility (two pow and
// ten divisions) of both cells for both phases, so every cell's 6
// transcendentals and 40 divisions are recomputed by each of its 6 faces;
// it derives (x, y, z) with 64-bit divisions; and the three launches have
// three tails. It ran at 26 % of its 157.6 MB bound. Here:
// - a 2-D grid of 32x8 xy tiles marches in z over a chunk of planes; x and
//   y come from blockIdx/threadIdx and z is the loop counter;
// - two threads per cell, one per phase (the phases are independent from
//   the properties to the outputs), evaluate the cell's density exp and
//   mobility with its one nonzero partial once per plane (CellProps) and
//   keep them in registers for the +z face and in a double-buffered shared
//   plane for the -x/-y neighbours' +x/+y faces; a row of extra threads
//   evaluates the +y halo row and a few more the +x halo column;
// - each owner thread emits its cell's +x, +y and +z faces with the per-axis
//   kernel's face arithmetic on the partials that are not structurally zero
//   (emit_face): most of the Dual<4> arithmetic drops out, and each
//   remaining operation is the per-axis kernel's on the same values, so the
//   outputs equal those of three per-axis launches (where the per-axis
//   partials are finite);
// - the owned columns start at multiples of 32, so a warp writes each
//   output row in whole 128-byte lines. The card showed this was the limit:
//   with tiles overlapping by one cell (31 owned columns), the same kernel
//   took 0.115 ms whatever was done to its arithmetic, and 0.091 ms with
//   aligned tiles (scripts/k5_tiling_probe.py --k3, H100 SXM);
// - the chunk depth is chosen from the kernel's occupancy for the fewest
//   serial planes (launch_flux_lattice).
// The redundant work left: one extra plane of properties per z chunk and
// the halo row and column (~16 % of the per-cell work).
constexpr int kFluxBX = 32;   // owned columns of a tile (aligned to 32)
constexpr int kFluxBY = 8;    // owned rows
constexpr int kFluxProps = 5;  // p, s, e, mob, dmob of one phase
// a tile's properties plane: its owned cells plus the +y halo row and the
// +x halo column
constexpr int kFluxSX = kFluxBX + 1, kFluxSY = kFluxBY + 1;
constexpr int kFluxPlane = kFluxSX * kFluxSY;

// One phase's part of what density() and mobility() compute for a cell.
template <typename T>
struct CellProps {
  T p, s;
  T e;     // exp(comp_a (p - p_ref)): density() / rho0_a
  T mob;   // mobility()
  T dmob;  // its derivative in the cell's own water saturation
};

// One plane of a tile's CellProps of one phase in shared memory, a field
// per row (kFluxProps rows of kFluxSY x kFluxSX).
template <typename T>
__device__ __forceinline__ void store_props(T* plane, int c,
                                            const CellProps<T>& v) {
  constexpr int R = kFluxPlane;
  plane[c] = v.p;
  plane[R + c] = v.s;
  plane[2 * R + c] = v.e;
  plane[3 * R + c] = v.mob;
  plane[4 * R + c] = v.dmob;
}

template <typename T>
__device__ __forceinline__ CellProps<T> load_props(const T* plane, int c) {
  constexpr int R = kFluxPlane;
  CellProps<T> v;
  v.p = plane[c];
  v.s = plane[R + c];
  v.e = plane[2 * R + c];
  v.mob = plane[3 * R + c];
  v.dmob = plane[4 * R + c];
  return v;
}

// Phase a's constants, chosen without indexing the kernel parameter by a
// runtime value (which would copy it to local memory).
template <typename T>
struct Phase {
  T rho0, comp, sr, nexp, mu;
};

template <typename T>
__device__ __forceinline__ Phase<T> phase_of(const Fluid<T>& f, int a) {
  Phase<T> ph;
  ph.rho0 = a == 0 ? f.rho0[0] : f.rho0[1];
  ph.comp = a == 0 ? f.comp[0] : f.comp[1];
  ph.sr = a == 0 ? f.sr[0] : f.sr[1];
  ph.nexp = a == 0 ? f.nexp[0] : f.nexp[1];
  ph.mu = a == 0 ? f.mu[0] : f.mu[1];
  return ph;
}

// What density() and mobility() of phase a compute for a cell with dofs
// (p, s): density's exp(.) result, from the same argument expression, and
// mobility()'s value and its one nonzero partial (the cell's own
// saturation), by the same operations in the same order: shift, divide by
// 1 - sum(s_r), clip with JAX's weights, pow, divide by mu. Mobility has no
// addition, so nothing of it can be contracted into the face arithmetic;
// its other partials are 0/omt*w*g/mu = 0 wherever the per-axis kernel's
// are finite.
template <typename T>
__device__ __forceinline__ CellProps<T> cell_props(const Fluid<T>& f,
                                                   const Phase<T>& ph, int a,
                                                   T p, T s) {
  CellProps<T> c;
  c.p = p;
  c.s = s;
  c.e = exp(ph.comp * (p + -f.pref));
  // the last phase's saturation closes the unit sum: 1 - s, d = 0 - 1
  const T sat = a == 0 ? s : T(1) - s;
  const T dsat = a == 0 ? T(1) : T(-1);
  const T x = (sat + -ph.sr) / f.one_minus_sr_tot;
  const T dx = dsat / f.one_minus_sr_tot;
  const T m0 = x > T(0) ? x : T(0);
  const T w1 = x > T(0) ? T(1) : (x == T(0) ? T(0.5) : T(0));
  const T w2 = m0 < T(1) ? T(1) : (m0 == T(1) ? T(0.5) : T(0));
  const T m = m0 < T(1) ? m0 : T(1);
  const T g = ph.nexp == T(0) ? T(0) : ph.nexp * pow(m, ph.nexp - T(1));
  c.mob = pow(m, ph.nexp) / ph.mu;
  c.dmob = ((dx * (w1 * w2)) * g) / ph.mu;
  return c;
}

// One face (left cell l, right cell r), phase a: darcy_flux_jacobian_kernel's
// face arithmetic with the Dual numbers' structural zeros left out. Each
// partial the per-axis kernel computes is here the same operations on the
// same values: density's (rho0 e, rho0 (comp e)), the upwind product rule,
// scale and the product with dpot keep their operand order wherever both
// terms are nonzero (so the compiler contracts them alike), and where the
// per-axis kernel adds an exact zero to a product (a partial of the other
// cell) the product stands alone, which rounds the same. Structural zeros
// are written as +0, which the per-axis kernel also gives where T_f, the
// densities and mobilities are positive and the values finite.
template <typename T>
__device__ __forceinline__ void emit_face(const Phase<T>& ph, int a,
                                          const CellProps<T>& l,
                                          const CellProps<T>& r, T T_f, T g,
                                          T* __restrict__ out, long long nf,
                                          long long face) {
  const T rho_l = ph.rho0 * l.e;
  const T rho_r = ph.rho0 * r.e;
  const T drho_l = ph.rho0 * (ph.comp * l.e);  // d/dp_L
  const T drho_r = ph.rho0 * (ph.comp * r.e);  // d/dp_R
  const T rho_avg = T(0.5) * (rho_l + rho_r);
  const T dpot = (l.p - r.p) - g * rho_avg;
  const T dpot_l = T(1) - g * (T(0.5) * drho_l);
  const T dpot_r = T(-1) - g * (T(0.5) * drho_r);
  const bool up = dpot >= T(0);
  const T rho = up ? rho_l : rho_r, drho = up ? drho_l : drho_r;
  const T mob = up ? l.mob : r.mob, dmob = up ? l.dmob : r.dmob;
  const T sv = T_f * (rho * mob);
  const T sp = T_f * (drho * mob);  // d/dp of the upwind cell
  const T ss = T_f * (rho * dmob);  // d/ds of the upwind cell
  // out[e], dF_e/du_L[j] at 2 + 2j + e, dF_e/du_R[j] at 6 + 2j + e
  out[a * nf + face] = sv * dpot;
  out[(2 + a) * nf + face] = up ? sp * dpot + sv * dpot_l : sv * dpot_l;
  out[(4 + a) * nf + face] = up ? ss * dpot : T(0);
  out[(6 + a) * nf + face] = up ? sv * dpot_r : sp * dpot + sv * dpot_r;
  out[(8 + a) * nf + face] = up ? T(0) : ss * dpot;
}

// threadIdx.z is the phase: a cell's two phases are independent from the
// properties to the outputs, so two threads share a cell. Rows ty < kFluxBY
// own the tile's cells, row kFluxBY evaluates the +y halo row and row
// kFluxBY + 1 (its first kFluxBY lanes) the +x halo column, so the owned
// columns start at multiples of 32 and the outputs' rows are written in
// whole 128-byte lines where the face lattice's rows are.
template <typename T>
__global__ void __launch_bounds__(kFluxBX * (kFluxBY + 2) * 2)
darcy_flux_jacobian_lattice_kernel(
    const T* __restrict__ u, const T* __restrict__ trans0,
    const T* __restrict__ gdz0, const T* __restrict__ trans1,
    const T* __restrict__ gdz1, const T* __restrict__ trans2,
    const T* __restrict__ gdz2, T* __restrict__ out0, T* __restrict__ out1,
    T* __restrict__ out2, Fluid<T> f, int nz, int ny, int nx, int tz) {
  // sh[buf][phase]: the tile's CellProps on one plane (store_props' layout)
  __shared__ T sh[2][2][kFluxProps * kFluxPlane];
  const int tx = threadIdx.x, ty = threadIdx.y, a = threadIdx.z;
  const Phase<T> ph = phase_of(f, a);
  const int x0 = static_cast<int>(blockIdx.x) * kFluxBX;
  const int y0 = static_cast<int>(blockIdx.y) * kFluxBY;
  const bool column = ty == kFluxBY + 1;  // the +x halo column
  const int sx = column ? kFluxBX : tx, sy = column ? tx : ty;
  const int x = x0 + sx, y = y0 + sy;
  const int slot = sy * kFluxSX + sx;
  const bool in_lat = x < nx && y < ny && (!column || tx < kFluxBY);
  const bool owner = in_lat && ty < kFluxBY;
  const bool has_xp = x + 1 < nx, has_yp = y + 1 < ny;
  const long long plane = static_cast<long long>(ny) * nx;
  const long long nf0 = static_cast<long long>(nz) * ny * (nx - 1);
  const long long nf1 = static_cast<long long>(nz) * (ny - 1) * nx;
  const long long nf2 = static_cast<long long>(nz - 1) * ny * nx;
  const int z0 = static_cast<int>(blockIdx.z) * tz;
  const int z1 = min(nz, z0 + tz);
  const long long col = static_cast<long long>(y) * nx + x;

  CellProps<T> cur{}, nxt{};
  if (in_lat) {
    const long long i = z0 * plane + col;
    cur = cell_props(f, ph, a, u[2 * i], u[2 * i + 1]);
  }
  for (int z = z0; z < z1; ++z) {
    T* shp = sh[(z - z0) & 1][a];
    if (in_lat) store_props(shp, slot, cur);
    const bool has_zp = in_lat && z + 1 < nz;
    // the next plane's properties (halo cells need no +z face)
    if (has_zp) {
      const long long i = (z + 1) * plane + col;
      nxt = cell_props(f, ph, a, u[2 * i], u[2 * i + 1]);
    }
    // shp is complete; the other plane was last read before the previous
    // step's barrier, so the next step may overwrite it
    __syncthreads();
    if (owner) {
      if (has_xp) {
        const CellProps<T> nb = load_props(shp, slot + 1);
        const long long face = (static_cast<long long>(z) * ny + y) *
                                   (nx - 1) + x;
        emit_face(ph, a, cur, nb, trans0[face], gdz0[face], out0, nf0, face);
      }
      if (has_yp) {
        const CellProps<T> nb = load_props(shp, slot + kFluxSX);
        const long long face = (static_cast<long long>(z) * (ny - 1) + y) *
                                   nx + x;
        emit_face(ph, a, cur, nb, trans1[face], gdz1[face], out1, nf1, face);
      }
      if (has_zp) {
        const long long face = z * plane + col;
        emit_face(ph, a, cur, nxt, trans2[face], gdz2[face], out2, nf2, face);
      }
    }
    cur = nxt;
  }
}

template <typename T>
Fluid<T> make_fluid(const double* c) {
  Fluid<T> f;
  f.rho0[0] = static_cast<T>(c[0]);
  f.rho0[1] = static_cast<T>(c[1]);
  f.comp[0] = static_cast<T>(c[2]);
  f.comp[1] = static_cast<T>(c[3]);
  f.pref = static_cast<T>(c[4]);
  f.sr[0] = static_cast<T>(c[5]);
  f.sr[1] = static_cast<T>(c[6]);
  f.one_minus_sr_tot = static_cast<T>(c[7]);
  f.nexp[0] = static_cast<T>(c[8]);
  f.nexp[1] = static_cast<T>(c[9]);
  f.mu[0] = static_cast<T>(c[10]);
  f.mu[1] = static_cast<T>(c[11]);
  return f;
}

template <typename T>
int launch_flux(const T* u, const T* trans, const T* gdz, T* out, int axis,
                int nz, int ny, int nx, const double* c, void* stream) {
  const Fluid<T> f = make_fluid<T>(c);
  const long long nf = static_cast<long long>(nz - (axis == 2)) *
                       (ny - (axis == 1)) * (nx - (axis == 0));
  if (nf > 0) {
    const unsigned blocks = static_cast<unsigned>((nf + kThreads - 1) / kThreads);
    darcy_flux_jacobian_kernel<T><<<blocks, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        u, trans, gdz, out, f, axis, nz, ny, nx);
  }
  return static_cast<int>(cudaGetLastError());
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

// The z-chunk depth: the fewest serial planes (waves x (tz + 1), the +1
// being the next plane each chunk re-evaluates for its last +z faces) at
// the kernel's occupancy.
template <typename T>
int launch_flux_lattice(const T* u, const T* trans0, const T* gdz0,
                        const T* trans1, const T* gdz1, const T* trans2,
                        const T* gdz2, T* out0, T* out1, T* out2, int nz,
                        int ny, int nx, const double* c, void* stream) {
  if (static_cast<long long>(nz) * ny * nx == 0) return 0;
  static int per_sm = 0;
  if (per_sm == 0) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, darcy_flux_jacobian_lattice_kernel<T>,
            kFluxBX * (kFluxBY + 2) * 2, 0) != cudaSuccess || per_sm < 1)
      per_sm = 1;
    cudaGetLastError();
  }
  const int bx = (nx + kFluxBX - 1) / kFluxBX;
  const int by = (ny + kFluxBY - 1) / kFluxBY;
  const long long tiles = static_cast<long long>(bx) * by;
  const long long resident = static_cast<long long>(per_sm) *
                             multiprocessors();
  int tz = nz;
  long long best = -1;
  for (int t = 1; t <= nz; ++t) {
    const long long chunks = (nz + t - 1) / t;
    const long long cost = (tiles * chunks + resident - 1) / resident * (t + 1);
    if (best < 0 || cost < best) {
      best = cost;
      tz = t;
    }
  }
  const dim3 grid(bx, by, (nz + tz - 1) / tz);
  const dim3 block(kFluxBX, kFluxBY + 2, 2);
  darcy_flux_jacobian_lattice_kernel<T>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          u, trans0, gdz0, trans1, gdz1, trans2, gdz2, out0, out1, out2,
          make_fluid<T>(c), nz, ny, nx, tz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// consts: rho0[2], compressibility[2], p_ref, s_r[2], 1 - sum(s_r),
// corey exponent[2], viscosity[2] (host memory, 12 doubles).
int jt_darcy_flux_jacobian_f32(const float* u, const float* trans,
                               const float* gdz, float* out, int axis, int nz,
                               int ny, int nx, const double* consts,
                               void* stream) {
  return launch_flux<float>(u, trans, gdz, out, axis, nz, ny, nx, consts,
                            stream);
}

int jt_darcy_flux_jacobian_f64(const double* u, const double* trans,
                               const double* gdz, double* out, int axis,
                               int nz, int ny, int nx, const double* consts,
                               void* stream) {
  return launch_flux<double>(u, trans, gdz, out, axis, nz, ny, nx, consts,
                             stream);
}

// The lattice's three axes in one launch: face parameters and outputs of
// axis a as for jt_darcy_flux_jacobian with axis = a (a pointer may be null
// where its axis has no faces).
int jt_darcy_flux_jacobian_lattice_f32(
    const float* u, const float* trans0, const float* gdz0,
    const float* trans1, const float* gdz1, const float* trans2,
    const float* gdz2, float* out0, float* out1, float* out2, int nz, int ny,
    int nx, const double* consts, void* stream) {
  return launch_flux_lattice<float>(u, trans0, gdz0, trans1, gdz1, trans2,
                                    gdz2, out0, out1, out2, nz, ny, nx,
                                    consts, stream);
}

int jt_darcy_flux_jacobian_lattice_f64(
    const double* u, const double* trans0, const double* gdz0,
    const double* trans1, const double* gdz1, const double* trans2,
    const double* gdz2, double* out0, double* out1, double* out2, int nz,
    int ny, int nx, const double* consts, void* stream) {
  return launch_flux_lattice<double>(u, trans0, gdz0, trans1, gdz1, trans2,
                                     gdz2, out0, out1, out2, nz, ny, nx,
                                     consts, stream);
}

}  // extern "C"
