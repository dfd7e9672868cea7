// The matmul form of Moller-Trumbore for Hopper (sm_90a): closest hit and
// any hit of every ray against every triangle of a small scene.
//
// Replaces XLA routines of royaltracer_dx_tpu/ops/mxu_trace.py (the JAX
// package traces them in XLA, not Pallas):
//   mxu_closest  <- closest_hit_mxu (:142-174): _products (:101-110),
//                   _decide (:113-124) and the one-hot epilogue of
//                   _closest_chunk (:127-139)
//   mxu_any      <- any_hit_mxu (:177-204) over _anyhit_chunk (:177-181)
// and holds bit for bit to the plain PyTorch versions in
// royaltracer_dx_tpu_torch/ops/mxu_trace.py (_closest_plain, _any_plain).
//
// What it computes.  A ray's features are f = [d, o x d, o, 1] with o
// re-centred (origin - centre; the cross product by components, as
// jnp.cross).  A triangle's coefficient block gives four bilinear forms,
// each a sum over its nonzero rows in increasing order:
//   det = f0 D0 + f1 D1 + f2 D2                  (rows 0-2)
//   a   = f0 A0 + ... + f5 A5   (u * det)        (rows 0-5)
//   b   = f0 B0 + ... + f5 B5   (v * det)        (rows 0-5)
//   c   = f6 C6 + f7 C7 + f8 C8 + C9 (t * det)   (rows 6-9)
// and the pair is accepted when |det| > 1e-12, a det >= 0, b det >= 0,
// (a + b - det) det <= 0, (c - t_min det) det > 0 and (c - t_max det) det
// < 0; then t = c / det (IEEE division).  Closest: the first argmin of t
// over the PADDED triangles, misses counting INF = 1e30, so a ray that
// hits nothing answers t = INF, triangle 0; u = (a + 0.0) inv and v =
// (b + 0.0) inv with inv = 1 / (|det| > 1e-12 ? det : 1) + 0.0 at the
// winner (the JAX one-hot sums fold -0.0).  Any hit: whether some pair is
// accepted, and (stats) the first accepted index + 1, or all real
// triangles.  Built with -fmad=false (stream_trace.build_library): every
// product and sum of the answer rounds as the plain version's tensor ops.
//
// What bounds it.  Every live ray meets every triangle: 19 multiply-adds
// for the four sums and 11 operations for the decision a pair (menger's
// 1080p batch is 1e10 pairs, from a 370 KB matrix that L2 holds), so the
// work is operations.  mxu_work counts both yardsticks: the 44 FP32
// operations of the plain order, and the filter's det, a and b sums on
// tensor cores (one TF32 pass, 2 x 15 operations a pair at the TF32
// peak) beside the decision on the FP32 cores.  The first design (a
// thread a ray, some 60 issued instructions a pair) was issue-bound: 22.3
// ms on menger's 1080p camera batch on an H100 80GB HBM3 at 700 W.
//
// How: the tensor cores filter, the FP32 cores confirm.
//   * Rays.  A CTA takes RAYS rays.  A dead ray (!(t_min < t_max), NaN
//     bounds included) writes its answer at once (a miss: tri 0 and
//     triangle 0's u, v; not occluded, 0 tests).  A live ray whose
//     features are all finite and at most 2^SAFE_LOG2 in magnitude is
//     packed (ballot and prefix) into warp tiles of ROWS rays; any other
//     live ray is left to the exact scan below.
//   * Triangles.  TILE triangles a round: their 19 exact nonzero
//     coefficients arrive by cp.async in a double buffer while the last
//     round is filtered (of the last round, only the steps that hold real
//     triangles: Cornell's 32 of 128); each round is then converted in
//     shared memory into the B fragments of mma.m16n8k8 (cvt.rna.tf32)
//     of the det, a and b planes and, per STEP triangles, the largest
//     sum of |coefficient| of each (Q_det, Q_ab = max(Q_a, Q_b)).  A
//     triangle with such a coefficient that is not finite or beyond
//     2^SAFE_LOG2 sets its step's Q to +inf: every pair of the step is
//     then a candidate.
//   * Sums.  A warp owns 16 packed rays.  Its A fragment holds the ray
//     features [d, o x d, 0, 0] in TF32 for the whole loop.  A step is
//     two 8-triangle groups: 3 planes x 2 groups mma.sync, one TF32 pass
//     each, and one thread then holds det, a and b of the same 8 pairs
//     (its C fragments), so the filter needs no shuffles.
//   * Filter (FP32 cores, directed rounding).  With margins M_p =
//     KAPPA F_p Q_p + MU (F_p the largest |feature| of the plane's rows,
//     Q_p the step's), a pair is dropped only when det's sign is certain
//     (|det'| > M_det) and, with a, b flipped by it, one of the three
//     barycentric tests of _decide fails for certain: a < -M_ab, b <
//     -M_ab or a + b - |det| > M_det + 2 M_ab.  The other three tests
//     (|det| > 1e-12 and the two t bounds, with c on the tensor cores
//     too) dropped few more of menger's pairs for a large share of the
//     filter's instructions, and are left to confirmation.  The filter is
//     the kernels' cost: its compares and selects, not the tensor cores,
//     bound them.  Most pairs kept are rays that run along a
//     triangle's plane (det's sign uncertain); on the rare path, where a
//     thread's step keeps some pair, a sign-free test also drops a pair
//     with |a'| or |b'| > |det'| + M_det + M_ab (an accepted pair has
//     |a|, |b| <= |det|, and these margins leave |a| - |det| > 2^-58).
//     Every test is written as "drop when a comparison holds", so a NaN
//     keeps the pair.
//   * Confirmation.  Kept pairs go to a per-warp queue in shared memory;
//     at 32 entries, and at the end of every round, the warp confirms
//     them lane-dense, 32 at a time, with the plain order (products,
//     accepted) on the exact staged coefficients.  Closest keeps each
//     row's first argmin as a shared 64-bit atomicMin of (t with -0.0
//     folded to +0.0 as an ordered integer, index): a miss (INF) loses to
//     any accepted t below INF, and ties go to the lower index.  Any keeps
//     the least accepted index, and a warp stops filtering once each of
//     its rays has one (the rest of the queue is still confirmed, so the
//     least index is exact).  A row whose best t is not below INF (t_max
//     beyond 1e30) goes to the exact scan.
//   * The exact scan.  A warp a ray, the lanes over the triangles in the
//     plain order: the first argmin with misses at INF (and the padded
//     column's fix-up), or the first accepted index by ballot.
//   The winner's t, u, v are recomputed from the coefficient matrix in
//   global memory, in the same order.
//
// The error bound (KAPPA).  For a plane with S = sum |f_k q_k| <= F Q:
//   * the plain version's sum of at most 6 rounded products: gamma_6 S
//     <= 2^-21.4 S (and at most 6 x 2^-150 from underflow);
//   * TF32 (cvt.rna, 11 significant bits): rounding both operands by at
//     most 2^-11 moves each product by at most 2^-10 + 2^-22;
//   * the tensor core's FP32 accumulation, assumed to align every term
//     of the mma to the largest and truncate, generously: at most 8 x
//     2^-22 of the sum of the magnitudes of its terms;
//   * subnormal operands flushed by TF32: at most 2^-126 x 2^40 a term,
//     inside MU.
// In all at most 1.0027 x 2^-10 S.  KAPPA = 2^-8 is 4x that, which also
// covers the decision's own rounding in the plain version (2.02 u a
// value; the filter's own rounds toward keeping).  Split TF32 (hi / lo
// operands, three mmas a plane, error 2^-18.35 S) kept fewer pairs but
// was slower at every size measured but one (PERF.md section 6), so the
// kernels make one pass (chip_smoke.py phase 8 prints the share kept).
// MU = 2^-59 covers the absolute errors (< 2^-80) with room, and makes
// |a'|, |det'| beyond their margins mean |a|, |det| > 2^-60 in the plain
// version: their product cannot underflow to a signed zero (-0.0 >= 0
// holds there).
// Features beyond 2^40 (and coefficients, through Q) would break those
// absolute bounds: such rays take the exact scan, such steps keep all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;               // warps a CTA, one tile of rays each
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 16;               // packed rays a warp (one m16 tile)
constexpr int RAYS = WARPS * ROWS;     // rays a CTA
constexpr int TILE = 128;              // triangles staged a round
constexpr int STEP = 16;               // triangles filtered at a time
constexpr int STEPS = TILE / STEP;
constexpr int NG = STEP / 8;           // 8-triangle groups (n8) a step
constexpr int MIN_CTAS = 4;            // CTAs an SM should hold (64 registers)
constexpr int KAPPA_LOG2 = -8;         // the margin's factor
constexpr int MU_LOG2 = -59;           // the margin's absolute term
constexpr int SAFE_LOG2 = 40;          // the filter's range of |f| and Q
constexpr int NZ = 19;                 // nonzero coefficients a triangle
constexpr int FLUSH = 32;              // queue entries that start a confirm
constexpr int QCAP = FLUSH + ROWS * STEP;
constexpr int FRAG4 = NG + NG / 2;     // uint4 of B fragments a lane and step
constexpr float INF = 1e30f;
constexpr float DET_EPS = 1e-12f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NONE = ~0ull;   // no accepted pair yet

static_assert(STEP % 16 == 0 && STEP <= 32 && TILE % STEP == 0,
              "two to four groups a step");
static_assert(STEPS * 32 <= THREADS && TILE <= THREADS, "one item a thread");

constexpr float pow2(int e) {
  float r = 1.0f;
  for (; e > 0; --e) r *= 2.0f;
  for (; e < 0; ++e) r *= 0.5f;
  return r;
}
constexpr float KAPPA = pow2(KAPPA_LOG2);
constexpr float MU = pow2(MU_LOG2);
constexpr float SAFE_MAX = pow2(SAFE_LOG2);

struct Smem {
  float raw[2][NZ][TILE];              // exact coefficients, two rounds
  uint4 frag[STEPS][FRAG4][32];        // B fragments, lane-major
  float2 qmax[STEPS];                  // Q_det, Q_ab of each step
  float feat[RAYS][12];                // f[9], t_min, t_max of packed rays
  unsigned long long best[RAYS];       // (t, index) key / least index
  int ray[RAYS];                       // batch lane of each packed ray
  int exact[RAYS];                     // lanes left to the exact scan
  unsigned queue[WARPS][QCAP];         // (row << 8) | index in the round
  int warp_count[2][RAYS / 32];
  int n_exact;
};

// staged value k of a triangle: its plane (det, a, b, c) and row
__device__ __forceinline__ int plane_of(int k) {
  return k < 3 ? 0 : k < 9 ? 1 : k < 15 ? 2 : 3;
}
__device__ __forceinline__ int row_of(int k) {
  return k < 3 ? k : k < 9 ? k - 3 : k - 9;
}

// the ray's features [d, o x d, o] (the constant 1 is implicit)
__device__ __forceinline__ void features(const float* origins,
                                         const float* dirs,
                                         const float* center, int64_t i,
                                         float f[9]) {
  const float ox = origins[3 * i] - center[0];
  const float oy = origins[3 * i + 1] - center[1];
  const float oz = origins[3 * i + 2] - center[2];
  const float dx = dirs[3 * i], dy = dirs[3 * i + 1], dz = dirs[3 * i + 2];
  f[0] = dx;
  f[1] = dy;
  f[2] = dz;
  f[3] = oy * dz - oz * dy;
  f[4] = oz * dx - ox * dz;
  f[5] = ox * dy - oy * dx;
  f[6] = ox;
  f[7] = oy;
  f[8] = oz;
}

// det, a, b, c of a pair: q holds the 19 nonzero coefficients in staged
// order (det rows 0-2, a rows 0-5, b rows 0-5, c rows 6-9)
__device__ __forceinline__ void products(const float f[9], const float* q,
                                         float& det, float& a, float& b,
                                         float& c) {
  det = f[0] * q[0];
  det = det + f[1] * q[1];
  det = det + f[2] * q[2];
  a = f[0] * q[3];
  b = f[0] * q[9];
#pragma unroll
  for (int k = 1; k < 6; ++k) {
    a = a + f[k] * q[3 + k];
    b = b + f[k] * q[9 + k];
  }
  c = f[6] * q[15];
  c = c + f[7] * q[16];
  c = c + f[8] * q[17];
  c = c + q[18];
}

__device__ __forceinline__ bool accepted(float det, float a, float b,
                                         float c, float t_min, float t_max) {
  const bool dok = fabsf(det) > DET_EPS;
  return dok & (a * det >= 0.0f) & (b * det >= 0.0f) &
         ((a + b - det) * det <= 0.0f) & ((c - t_min * det) * det > 0.0f) &
         ((c - t_max * det) * det < 0.0f);
}

// triangle j's 19 coefficients from the [10, 4 tp] matrix
__device__ __forceinline__ void load_tri(const float* coeff, int tp, int j,
                                         float q[NZ]) {
#pragma unroll
  for (int k = 0; k < NZ; ++k)
    q[k] = coeff[(int64_t)row_of(k) * 4 * tp + (int64_t)plane_of(k) * tp + j];
}

// the orderable key of (t, index): -0.0 folded into +0.0 so that the
// lexicographic minimum is the first argmin
__device__ __forceinline__ unsigned long long hit_key(float t, int j) {
  unsigned b = __float_as_uint(t + 0.0f);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << 32) | (unsigned)j;
}
__device__ __forceinline__ float key_time(unsigned long long key) {
  unsigned b = (unsigned)(key >> 32);
  b = (b & 0x80000000u) ? (b & 0x7fffffffu) : ~b;
  return __uint_as_float(b);
}

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// D (+)= A B on the tensor cores: A 16 x 8 (row), B 8 x 8 (col), TF32
__device__ __forceinline__ void mma8(float (&c)[4], unsigned a0, unsigned a1,
                                     unsigned a2, unsigned a3, unsigned b0,
                                     unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the steps of the round at base that hold real triangles
__device__ __forceinline__ int round_steps(int tris, int base) {
  return min(STEPS, (tris - base + STEP - 1) / STEP);
}

// the exact coefficients of the round at base into raw, its real steps
// only (columns past the real triangles are the matrix's zero padding)
__device__ __forceinline__ void stage_async(float (*raw)[TILE],
                                            const float* coeff, int tp,
                                            int tris, int base) {
  const int quads = round_steps(tris, base) * (STEP / 4);
  for (int idx = threadIdx.x; idx < NZ * (TILE / 4); idx += THREADS) {
    const int k = idx / (TILE / 4), c = idx % (TILE / 4);
    if (c < quads)
      cp_async16(&raw[k][4 * c], coeff + (int64_t)row_of(k) * 4 * tp +
                                     (int64_t)plane_of(k) * tp + base +
                                     4 * c);
  }
  cp_async_commit();
}

// a round's B fragments (an item = step x lane) and step maxima of Q,
// of its first nsteps steps
__device__ __forceinline__ void convert(Smem& sm, int buf, int nsteps) {
  const int tid = threadIdx.x;
  const float(*r)[TILE] = sm.raw[buf];
  if (tid < nsteps * 32) {
    const int s = tid >> 5, l = tid & 31, g = l >> 2, t4 = l & 3;
    // B[k][n] of triangle n: k = t4 (b0) and t4 + 4 (b1); each uint4
    // holds (b0, b1) register pairs of the mmas as they are loaded: {a b0,
    // a b1, b b0, b b1} of each group, then {det b0, 0, det b0, 0} of each
    // two groups (det's b1, rows 4-7, is zero)
    float v[4 * FRAG4];
#pragma unroll
    for (int h = 0; h < NG; ++h) {
      const int j = s * STEP + h * 8 + g;
      v[4 * h + 0] = r[3 + t4][j];                    // a, rows 0-3
      v[4 * h + 1] = t4 < 2 ? r[7 + t4][j] : 0.0f;    // a, rows 4-5
      v[4 * h + 2] = r[9 + t4][j];                    // b, rows 0-3
      v[4 * h + 3] = t4 < 2 ? r[13 + t4][j] : 0.0f;   // b, rows 4-5
      v[4 * NG + 2 * h] = t4 < 3 ? r[t4][j] : 0.0f;   // det, rows 0-2
      v[4 * NG + 2 * h + 1] = 0.0f;
    }
#pragma unroll
    for (int q = 0; q < FRAG4; ++q)
      sm.frag[s][q][l] = make_uint4(tf32(v[4 * q]), tf32(v[4 * q + 1]),
                                    tf32(v[4 * q + 2]), tf32(v[4 * q + 3]));
  }
  // whole warps, STEP lanes a step (a step past nsteps is never read)
  if (tid < ((nsteps * STEP + 31) & ~31)) {
    float qs[3] = {0.0f, 0.0f, 0.0f};   // det, a, b
#pragma unroll
    for (int k = 0; k < 15; ++k)
      qs[plane_of(k)] = __fadd_ru(qs[plane_of(k)], fabsf(r[k][tid]));
    float qd = qs[0], qab = fmaxf(qs[1], qs[2]);
    if (!(qd <= SAFE_MAX && qs[1] <= SAFE_MAX && qs[2] <= SAFE_MAX))
      qd = qab = __int_as_float(0x7f800000);
#pragma unroll
    for (int o = STEP / 2; o; o >>= 1) {
      qd = fmaxf(qd, __shfl_xor_sync(FULL, qd, o));
      qab = fmaxf(qab, __shfl_xor_sync(FULL, qab, o));
    }
    if ((tid & (STEP - 1)) == 0) sm.qmax[tid / STEP] = make_float2(qd, qab);
  }
}

// whether a pair may be accepted: det', a', b' from the tensor cores and
// the row's margins for this step (see the note at the top)
__device__ __forceinline__ bool keep_pair(float dd, float aa, float bb,
                                          float md, float mab, float r4) {
  const unsigned s = __float_as_uint(dd) & 0x80000000u;
  const float A = __uint_as_float(__float_as_uint(aa) ^ s);
  const float B = __uint_as_float(__float_as_uint(bb) ^ s);
  const float D = fabsf(dd);
  return !((D > md) & ((A < -mab) | (B < -mab) |
                       (__fsub_rd(__fadd_rd(A, B), D) > r4)));
}

struct Out {
  float* t;
  float* u;
  float* v;
  long long* tri;
  unsigned char* occ;
  int* tests;
};

// closest: the winner bi's u, v (and t, recomputed when it was accepted),
// its coefficients from the round still staged in raw when bi lies there
__device__ __forceinline__ void finish_closest(const Out& out,
                                               const float* coeff, int tp,
                                               int64_t i, const float f[9],
                                               int bi, float t, bool hit,
                                               const float (*raw)[TILE] =
                                                   nullptr,
                                               int raw_base = 0) {
  float q[NZ];
  if (raw && bi >= raw_base) {
#pragma unroll
    for (int k = 0; k < NZ; ++k) q[k] = raw[k][bi - raw_base];
  } else {
    load_tri(coeff, tp, bi, q);
  }
  float det, a, b, c;
  products(f, q, det, a, b, c);
  if (hit) t = c / det;
  const float inv = 1.0f / (fabsf(det) > DET_EPS ? det : 1.0f) + 0.0f;
  out.t[i] = t;
  out.u[i] = (a + 0.0f) * inv;
  out.v[i] = (b + 0.0f) * inv;
  out.tri[i] = bi;
}

// a warp's exact scan of ray i in the plain order (every pair tested)
template <bool CLOSEST>
__device__ void exact_scan(const float* origins, const float* dirs,
                           const float* t_min, const float* t_max,
                           const float* coeff, const float* center,
                           const Out& out, int64_t i, int tris, int tp) {
  const int lane = threadIdx.x & 31;
  float f[9];
  features(origins, dirs, center, i, f);
  const float lo = t_min[i], hi = t_max[i];
  if (CLOSEST) {
    float best = __int_as_float(0x7f800000);
    int bi = 0;
    for (int j = lane; j < tris; j += 32) {
      float q[NZ];
      load_tri(coeff, tp, j, q);
      float det, a, b, c;
      products(f, q, det, a, b, c);
      float t = INF;   // a miss competes as INF, as in the JAX argmin
      if (accepted(det, a, b, c, lo, hi)) t = c / det;
      if (t < best) {
        best = t;
        bi = j;
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float ot = __shfl_xor_sync(FULL, best, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
      if (ot < best || (ot == best && oi < bi)) {
        best = ot;
        bi = oi;
      }
    }
    if (best > INF && tris < tp) {
      best = INF;   // the first padded column's miss wins the argmin
      bi = tris;
    }
    if (lane == 0) finish_closest(out, coeff, tp, i, f, bi, best, false);
  } else {
    int first = -1;
    for (int base = 0; base < tris; base += 32) {
      const int j = base + lane;
      bool ok = false;
      if (j < tris) {
        float q[NZ];
        load_tri(coeff, tp, j, q);
        float det, a, b, c;
        products(f, q, det, a, b, c);
        ok = accepted(det, a, b, c, lo, hi);
      }
      const unsigned m = __ballot_sync(FULL, ok);
      if (m) {
        first = base + __ffs(m) - 1;
        break;
      }
    }
    if (lane == 0) {
      out.occ[i] = first >= 0 ? 1 : 0;
      if (out.tests) out.tests[i] = first >= 0 ? first + 1 : tris;
    }
  }
}

// counts (COUNT builds): pairs filtered on the tensor cores, pairs kept
// (queued), pairs accepted at confirmation, rays of the exact scan, rays
// packed
constexpr int N_COUNTS = 5;

template <bool CLOSEST, bool COUNT>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    trace_kernel(const float* __restrict__ origins,
                 const float* __restrict__ dirs,
                 const float* __restrict__ t_min,
                 const float* __restrict__ t_max,
                 const float* __restrict__ coeff,
                 const float* __restrict__ center, Out out,
                 unsigned long long* __restrict__ counts, int n, int tris,
                 int tp) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_bytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (tris + TILE - 1) / TILE;
  stage_async(sm.raw[0], coeff, tp, tris, 0);   // lands during set-up
  unsigned long long cnt[N_COUNTS] = {0, 0, 0, 0, 0};

  // ---- rays: features, class (1 packed, 2 exact scan), rank
  const int64_t i = (int64_t)blockIdx.x * RAYS + tid;
  int cls = 0;
  unsigned m1 = 0, m2 = 0;
  float f[9], lo = 0.0f, hi = 0.0f;
  if (tid < RAYS) {
    const bool in = i < n;
    if (in) {
      features(origins, dirs, center, i, f);
      lo = t_min[i];
      hi = t_max[i];
      if (lo < hi) {
        bool safe = true;
#pragma unroll
        for (int k = 0; k < 9; ++k) safe &= fabsf(f[k]) <= SAFE_MAX;
        cls = safe ? 1 : 2;
      } else if (CLOSEST) {
        finish_closest(out, coeff, tp, i, f, 0, INF, false);
      } else {
        out.occ[i] = 0;
        if (out.tests) out.tests[i] = 0;
      }
    }
    m1 = __ballot_sync(FULL, cls == 1);
    m2 = __ballot_sync(FULL, cls == 2);
    if (lane == 0) {
      sm.warp_count[0][warp] = __popc(m1);
      sm.warp_count[1][warp] = __popc(m2);
    }
  }
  __syncthreads();
  int n_safe = 0, n_exact = 0, off1 = 0, off2 = 0;
#pragma unroll
  for (int w = 0; w < RAYS / 32; ++w) {
    const int c1 = sm.warp_count[0][w], c2 = sm.warp_count[1][w];
    if (w < warp) {
      off1 += c1;
      off2 += c2;
    }
    n_safe += c1;
    n_exact += c2;
  }
  if (tid < RAYS) {
    const unsigned below = (1u << lane) - 1u;
    if (cls == 1) {
      const int slot = off1 + __popc(m1 & below);
#pragma unroll
      for (int k = 0; k < 9; ++k) sm.feat[slot][k] = f[k];
      sm.feat[slot][9] = lo;
      sm.feat[slot][10] = hi;
      sm.ray[slot] = (int)i;
      sm.best[slot] = CLOSEST ? hit_key(__int_as_float(0x7f800000), -1)
                              : NONE;
    } else if (cls == 2) {
      sm.exact[off2 + __popc(m2 & below)] = (int)i;
    }
  }
  if (tid == 0) sm.n_exact = n_exact;
  __syncthreads();

  // ---- the warp's tile: A fragments and per-row scalars, rows g, g + 8
  const int rows = min(ROWS, n_safe - warp * ROWS);   // <= 0: no tile
  const int g = lane >> 2, t4 = lane & 3;
  unsigned ah[4] = {0, 0, 0, 0};
  float kfd[2] = {0.0f, 0.0f}, kfab[2] = {0.0f, 0.0f};
  bool rok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    rok[h] = r < rows;
    const float* fr = sm.feat[warp * ROWS + (rok[h] ? r : 0)];
    float x1 = 0.0f, x2 = 0.0f;   // A[r][t4], A[r][t4 + 4]: [d, o x d, 0, 0]
    if (rok[h]) {
      x1 = fr[t4];
      x2 = t4 < 2 ? fr[t4 + 4] : 0.0f;
      const float fd = fmaxf(fmaxf(fabsf(fr[0]), fabsf(fr[1])), fabsf(fr[2]));
      const float fab = fmaxf(fmaxf(fd, fabsf(fr[3])),
                              fmaxf(fabsf(fr[4]), fabsf(fr[5])));
      kfd[h] = __fmul_ru(KAPPA, fd);
      kfab[h] = __fmul_ru(KAPPA, fab);
    }
    ah[h] = tf32(x1);       // a0 (row g), a1 (row g + 8)
    ah[2 + h] = tf32(x2);   // a2, a3
  }
  // mask bit 4 h + 2 r + j: group h, row g + 8 r, column 2 t4 + j
  constexpr unsigned ALL = NG == 4 ? 0xffffu : 0xffu;
  constexpr unsigned ROW0 = 0x33333333u & ALL, ROW1 = 0xccccccccu & ALL;
  const unsigned rowmask = (rok[0] ? ROW0 : 0u) | (rok[1] ? ROW1 : 0u);
  bool wdone = rows <= 0;           // warp-uniform
  bool rdone[2] = {false, false};   // any: the row has an accepted index
  int qn = 0;                       // queue entries (warp-uniform)
  unsigned* queue = sm.queue[warp];

  // confirm the queue lane-dense in the plain order; refresh the rows
  auto flush = [&](int buf, int base) {
    __syncwarp();
    for (int e0 = 0; e0 < qn; e0 += 32) {
      const int e = e0 + lane;
      bool ok = false;
      if (e < qn) {
        const unsigned en = queue[e];
        const int slot = warp * ROWS + (int)(en >> 8), loc = (int)(en & 255u);
        const float* fr = sm.feat[slot];
        float fe[9], q[NZ];
#pragma unroll
        for (int k = 0; k < 9; ++k) fe[k] = fr[k];
#pragma unroll
        for (int k = 0; k < NZ; ++k) q[k] = sm.raw[buf][k][loc];
        float det, a, b, c;
        products(fe, q, det, a, b, c);
        ok = accepted(det, a, b, c, fr[9], fr[10]);
        if (ok) {
          if (CLOSEST)
            atomicMin(&sm.best[slot], hit_key(c / det, base + loc));
          else
            atomicMin(&sm.best[slot], (unsigned long long)(base + loc));
        }
      }
      if (COUNT) cnt[2] += __popc(__ballot_sync(FULL, ok));
    }
    qn = 0;
    __syncwarp();
    if (!CLOSEST) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rdone[h] = rok[h] && sm.best[warp * ROWS + g + 8 * h] != NONE;
      wdone = __all_sync(FULL, (!rok[0] || rdone[0]) && (!rok[1] || rdone[1]));
    }
  };

  // ---- the rounds of triangles
  for (int k = 0; k < ntiles && n_safe > 0; ++k) {
    const int base = k * TILE, buf = k & 1;
    cp_async_wait_all();
    if (CLOSEST)
      __syncthreads();
    else if (!__syncthreads_or(!wdone))
      break;   // every ray of the CTA has its first hit
    if (k + 1 < ntiles)
      stage_async(sm.raw[buf ^ 1], coeff, tp, tris, base + TILE);
    const int nsteps = round_steps(tris, base);
    convert(sm, buf, nsteps);
    __syncthreads();
    if (wdone) continue;
    for (int s = 0; s < nsteps; ++s) {
      // B fragments: {a, b} of each group, then the det pairs
      uint4 bh[FRAG4];
#pragma unroll
      for (int q = 0; q < FRAG4; ++q) bh[q] = sm.frag[s][q][lane];
      float acc[NG][3][4];   // [group][det, a, b][C fragment]
#pragma unroll
      for (int h = 0; h < NG; ++h) {
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][p][e] = 0.0f;
        const uint4 dh = bh[NG + h / 2];
        const unsigned d0 = (h & 1) ? dh.z : dh.x;
        mma8(acc[h][0], ah[0], ah[1], ah[2], ah[3], d0, 0u);
        mma8(acc[h][1], ah[0], ah[1], ah[2], ah[3], bh[h].x, bh[h].y);
        mma8(acc[h][2], ah[0], ah[1], ah[2], ah[3], bh[h].z, bh[h].w);
      }
      const float2 Q = sm.qmax[s];
      unsigned mask = 0;
      float mdab[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float md = __fmaf_ru(kfd[r], Q.x, MU);
        const float mab = __fmaf_ru(kfab[r], Q.y, MU);
        const float r4 = __fmaf_ru(2.0f, mab, md);
        mdab[r] = __fadd_ru(md, mab);
#pragma unroll
        for (int h = 0; h < NG; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = 2 * r + j;
            if (keep_pair(acc[h][0][e], acc[h][1][e], acc[h][2][e], md, mab,
                          r4))
              mask |= 1u << (4 * h + 2 * r + j);
          }
      }
      mask &= rowmask;
      if (!CLOSEST)
        mask &= (rdone[0] ? ROW1 : ALL) & (rdone[1] ? ROW0 : ALL);
      const int lim = tris - (base + s * STEP);   // real triangles left
      if (lim < STEP) {
#pragma unroll
        for (int b = 0; b < 4 * NG; ++b)
          if ((b >> 2) * 8 + 2 * t4 + (b & 1) >= lim) mask &= ~(1u << b);
      }
      if (COUNT && lane == 0) {
        int live_rows = 0;
        for (int r = 0; r < rows; ++r)
          live_rows += CLOSEST || sm.best[warp * ROWS + r] == NONE;
        cnt[0] += (unsigned long long)live_rows * min(lim, STEP);
      }
      if (mask) {
        // the rare path: also drop what a sign-free test rules out, |a|
        // or |b| beyond |det| + M_det + M_ab (an accepted pair has |a|,
        // |b| <= |det|), mostly rays that run along the triangle's plane
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int h = 0; h < NG; ++h)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int e = 2 * r + j;
              const float lim_ab = __fadd_ru(fabsf(acc[h][0][e]), mdab[r]);
              if ((fabsf(acc[h][1][e]) > lim_ab) |
                  (fabsf(acc[h][2][e]) > lim_ab))
                mask &= ~(1u << (4 * h + 2 * r + j));
            }
      }
      if (__any_sync(FULL, mask)) {
        const int c = __popc(mask);
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += v;
        }
        const int total = __shfl_sync(FULL, incl, 31);
        int pos = qn + incl - c;
        for (unsigned mm = mask; mm; mm &= mm - 1u) {
          const int b = __ffs(mm) - 1;
          const int row = g + 8 * ((b >> 1) & 1);
          const int loc = s * STEP + (b >> 2) * 8 + 2 * t4 + (b & 1);
          queue[pos++] = ((unsigned)row << 8) | (unsigned)loc;
        }
        qn += total;
        if (COUNT) cnt[1] += total;
        if (qn >= FLUSH) flush(buf, base);
        if (wdone) break;
      }
    }
    if (qn) flush(buf, base);
  }
  cp_async_wait_all();

  // ---- answers of the packed rays
  if (lane < rows) {
    const int slot = warp * ROWS + lane;
    const int64_t ri = sm.ray[slot];
    const unsigned long long key = sm.best[slot];
    if (CLOSEST) {
      const float* fr = sm.feat[slot];
      float fe[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) fe[k] = fr[k];
      const bool hit =
          (key >> 32) != (hit_key(__int_as_float(0x7f800000), 0) >> 32);
      if (hit && !(key_time(key) < INF))
        sm.exact[atomicAdd(&sm.n_exact, 1)] = (int)ri;   // t beyond INF
      else
        finish_closest(out, coeff, tp, ri, fe, hit ? (int)(unsigned)key : 0,
                       INF, hit, sm.raw[(ntiles - 1) & 1],
                       (ntiles - 1) * TILE);
    } else {
      const bool hit = key != NONE;
      out.occ[ri] = hit ? 1 : 0;
      if (out.tests) out.tests[ri] = hit ? (int)key + 1 : tris;
    }
  }
  __syncthreads();
  const int ne = sm.n_exact;
  for (int e = warp; e < ne; e += WARPS)
    exact_scan<CLOSEST>(origins, dirs, t_min, t_max, coeff, center, out,
                        sm.exact[e], tris, tp);
  if (COUNT && lane == 0) {
    cnt[3] = warp == 0 ? ne : 0;
    cnt[4] = rows > 0 ? rows : 0;
#pragma unroll
    for (int c = 0; c < N_COUNTS; ++c)
      if (cnt[c]) atomicAdd(&counts[c], cnt[c]);
  }
}

// lets kernel fn take sizeof(Smem) of dynamic shared memory on the
// current device (once a device: the call costs host time at every launch)
cudaError_t allow_smem(const void* fn, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(Smem));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <bool CLOSEST, bool COUNT>
int launch(const float* origins, const float* dirs, const float* t_min,
           const float* t_max, const float* coeff, const float* center,
           const Out& out, unsigned long long* counts, int n, int tris,
           int tp, void* stream) {
  if (n <= 0) return 0;
  if (tris < 1 || tris > tp || tp % TILE) return (int)cudaErrorInvalidValue;
  static bool done[64] = {};
  const cudaError_t err =
      allow_smem((const void*)trace_kernel<CLOSEST, COUNT>, done);
  if (err != cudaSuccess) return (int)err;
  trace_kernel<CLOSEST, COUNT>
      <<<(unsigned)((n + RAYS - 1) / RAYS), THREADS, sizeof(Smem),
         (cudaStream_t)stream>>>(origins, dirs, t_min, t_max, coeff, center,
                                 out, counts, n, tris, tp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mxu_closest(const float* origins, const float* dirs, const float* t_min,
                const float* t_max, const float* coeff, const float* center,
                float* out_t, float* out_u, float* out_v, long long* out_tri,
                int n, int tris, int tp, void* stream) {
  return launch<true, false>(origins, dirs, t_min, t_max, coeff, center,
                             Out{out_t, out_u, out_v, out_tri, nullptr,
                                 nullptr},
                             nullptr, n, tris, tp, stream);
}

int mxu_any(const float* origins, const float* dirs, const float* t_min,
            const float* t_max, const float* coeff, const float* center,
            unsigned char* out_occ, int* out_tests, int n, int tris, int tp,
            void* stream) {
  return launch<false, false>(origins, dirs, t_min, t_max, coeff, center,
                              Out{nullptr, nullptr, nullptr, nullptr, out_occ,
                                  out_tests},
                              nullptr, n, tris, tp, stream);
}

// The same kernels built with counts (adds into counts[0..4]: pairs
// filtered on the tensor cores, pairs kept, pairs accepted at
// confirmation, rays of the exact scan, rays packed).
int mxu_closest_counted(const float* origins, const float* dirs,
                        const float* t_min, const float* t_max,
                        const float* coeff, const float* center, float* out_t,
                        float* out_u, float* out_v, long long* out_tri,
                        unsigned long long* counts, int n, int tris, int tp,
                        void* stream) {
  return launch<true, true>(origins, dirs, t_min, t_max, coeff, center,
                            Out{out_t, out_u, out_v, out_tri, nullptr,
                                nullptr},
                            counts, n, tris, tp, stream);
}

int mxu_any_counted(const float* origins, const float* dirs,
                    const float* t_min, const float* t_max,
                    const float* coeff, const float* center,
                    unsigned char* out_occ, int* out_tests,
                    unsigned long long* counts, int n, int tris, int tp,
                    void* stream) {
  return launch<false, true>(origins, dirs, t_min, t_max, coeff, center,
                             Out{nullptr, nullptr, nullptr, nullptr, out_occ,
                                 out_tests},
                             counts, n, tris, tp, stream);
}

// out[0..4]: resident CTAs per SM, registers per thread, threads per CTA,
// shared memory per CTA (static and dynamic) and spilled bytes per thread
// of the closest (which == 0) or any-hit (1) kernel.
int mxu_resources(int which, int* out) {
  const void* fn = which == 0 ? (const void*)trace_kernel<true, false>
                              : (const void*)trace_kernel<false, false>;
  bool done[64] = {};
  cudaError_t err = allow_smem(fn, done);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, THREADS,
                                                      sizeof(Smem));
  out[1] = attr.numRegs;
  out[2] = THREADS;
  out[3] = (int)(attr.sharedSizeBytes + sizeof(Smem));
  out[4] = (int)attr.localSizeBytes;
  return (int)err;
}

// out[0..4]: KAPPA_LOG2, MU_LOG2, SAFE_LOG2, STEP, RAYS: the filter this
// library was built with.
int mxu_filter_params(int* out) {
  out[0] = KAPPA_LOG2;
  out[1] = MU_LOG2;
  out[2] = SAFE_LOG2;
  out[3] = STEP;
  out[4] = RAYS;
  return 0;
}

}  // extern "C"
