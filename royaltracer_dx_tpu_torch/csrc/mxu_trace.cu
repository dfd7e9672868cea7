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
// accepted.  Built with -fmad=false (stream_trace.build_library): every
// product and sum rounds as the plain version's separate tensor ops do.
//
// What bounds it.  Every live ray meets every triangle: 44 FP32
// operations a pair (33 for the four sums, 11 for the decision; compares
// and selects besides), so the work is operations, not bytes (a 1080p
// batch against menger's 4,802 triangles is 1e10 pairs, 19 coefficients
// each, from a 370 KB matrix that L2 holds).  Without FMA the floor is
// one operation a lane and clock.
//
// How.  The JAX form writes four [4096, Tp] product planes a chunk and
// reduces them (320 MB a chunk at menger's size); here nothing but the
// answer leaves the chip.
//   * A thread per ray; CTAs of THREADS.  The ray's 9 features and bounds
//     sit in registers, computed once.
//   * The CTA stages TILE triangles at a time into shared memory: the 19
//     nonzero coefficients of a triangle as five float4 (the 20th float is
//     padding), so a pair costs five broadcast LDS.128 (every thread reads
//     the same triangle at the same time) and the arithmetic.
//   * Closest keeps (best t, its index) over t = c / det or INF for a
//     miss, with a strict < from +inf: the first argmin.  A ray whose
//     every real pair gave t > INF would have picked the first padded
//     column (t = INF) in the JAX form, which the end fixes up.  The
//     winner's products are then recomputed from the coefficient matrix
//     in global memory, in the same order, for u and v.
//   * Any hit leaves the loop at its first accepted pair; with a tests
//     pointer it writes the pairs it tested (its index + 1, or all real
//     triangles).
//   * A ray with !(t_min < t_max) never hits (rounding is monotone, so no
//     products-domain t lies between the bounds) and tests nothing; a CTA
//     stops staging once none of its rays is still testing.
// Tensor cores are not used: TF32 keeps 10 mantissa bits, which misses
// the tests' bars; 3xTF32 or FP64 DMMA is the redesign's question.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // rays a CTA
constexpr int TILE = 128;      // triangles staged a step
constexpr int NZ = 19;         // nonzero coefficients a triangle
constexpr int STRIDE = 20;     // floats a staged triangle (five float4)
constexpr float INF = 1e30f;
constexpr float DET_EPS = 1e-12f;

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

// Stage triangles [base, base + count) into s (zeros past count).
__device__ __forceinline__ void stage(float* s, const float* coeff, int tp,
                                      int base, int count) {
  for (int idx = threadIdx.x; idx < NZ * TILE; idx += THREADS) {
    const int k = idx / TILE, j = idx % TILE;
    float val = 0.0f;
    if (j < count)
      val = coeff[(int64_t)row_of(k) * 4 * tp + (int64_t)plane_of(k) * tp +
                  base + j];
    s[j * STRIDE + k] = val;
  }
}

__device__ __forceinline__ void load_staged(const float* s, int j,
                                            float q[STRIDE]) {
  const float4* q4 = reinterpret_cast<const float4*>(s + j * STRIDE);
#pragma unroll
  for (int w = 0; w < STRIDE / 4; ++w) {
    const float4 v = q4[w];
    q[4 * w] = v.x;
    q[4 * w + 1] = v.y;
    q[4 * w + 2] = v.z;
    q[4 * w + 3] = v.w;
  }
}

__global__ void __launch_bounds__(THREADS)
    closest_kernel(const float* __restrict__ origins,
                   const float* __restrict__ dirs,
                   const float* __restrict__ t_min,
                   const float* __restrict__ t_max,
                   const float* __restrict__ coeff,
                   const float* __restrict__ center, float* __restrict__ out_t,
                   float* __restrict__ out_u, float* __restrict__ out_v,
                   long long* __restrict__ out_tri, int n, int tris, int tp) {
  __shared__ __align__(16) float s[TILE * STRIDE];
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const bool in = i < n;
  float f[9];
  float lo = 0.0f, hi = 0.0f;
  if (in) {
    features(origins, dirs, center, i, f);
    lo = t_min[i];
    hi = t_max[i];
  }
  const bool live = in && lo < hi;
  float best = __int_as_float(0x7f800000);
  int best_i = 0;
  for (int base = 0; base < tris; base += TILE) {
    if (!__syncthreads_or(live)) break;   // also guards s's last readers
    const int count = min(TILE, tris - base);
    stage(s, coeff, tp, base, count);
    __syncthreads();
    if (live) {
      for (int j = 0; j < count; ++j) {
        float q[STRIDE];
        load_staged(s, j, q);
        float det, a, b, c;
        products(f, q, det, a, b, c);
        float t = INF;   // a miss competes as INF, as in the JAX argmin
        if (accepted(det, a, b, c, lo, hi)) t = c / det;
        if (t < best) {
          best = t;
          best_i = base + j;
        }
      }
    }
  }
  if (!in) return;
  if (!live) {
    best = INF;
    best_i = 0;
  } else if (best > INF && tris < tp) {
    best = INF;   // the first padded column's miss wins the argmin
    best_i = tris;
  }
  float q[NZ];
#pragma unroll
  for (int k = 0; k < NZ; ++k)
    q[k] = coeff[(int64_t)row_of(k) * 4 * tp + (int64_t)plane_of(k) * tp +
                 best_i];
  float det, a, b, c;
  products(f, q, det, a, b, c);
  const float inv = 1.0f / (fabsf(det) > DET_EPS ? det : 1.0f) + 0.0f;
  out_t[i] = best;
  out_u[i] = (a + 0.0f) * inv;
  out_v[i] = (b + 0.0f) * inv;
  out_tri[i] = best_i;
}

__global__ void __launch_bounds__(THREADS)
    any_kernel(const float* __restrict__ origins,
               const float* __restrict__ dirs, const float* __restrict__ t_min,
               const float* __restrict__ t_max,
               const float* __restrict__ coeff,
               const float* __restrict__ center,
               unsigned char* __restrict__ out_occ, int* __restrict__ out_tests,
               int n, int tris, int tp) {
  __shared__ __align__(16) float s[TILE * STRIDE];
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const bool in = i < n;
  float f[9];
  float lo = 0.0f, hi = 0.0f;
  if (in) {
    features(origins, dirs, center, i, f);
    lo = t_min[i];
    hi = t_max[i];
  }
  const bool live = in && lo < hi;
  bool testing = live, hit = false;
  int tested = 0;
  for (int base = 0; base < tris; base += TILE) {
    if (!__syncthreads_or(testing)) break;
    const int count = min(TILE, tris - base);
    stage(s, coeff, tp, base, count);
    __syncthreads();
    if (testing) {
      for (int j = 0; j < count; ++j) {
        float q[STRIDE];
        load_staged(s, j, q);
        float det, a, b, c;
        products(f, q, det, a, b, c);
        if (accepted(det, a, b, c, lo, hi)) {
          hit = true;
          tested = base + j + 1;
          break;
        }
      }
      testing = !hit;
    }
  }
  if (!in) return;
  if (live && !hit) tested = tris;
  out_occ[i] = hit ? 1 : 0;
  if (out_tests) out_tests[i] = tested;
}

inline unsigned blocks_for(int n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

int mxu_closest(const float* origins, const float* dirs, const float* t_min,
                const float* t_max, const float* coeff, const float* center,
                float* out_t, float* out_u, float* out_v, long long* out_tri,
                int n, int tris, int tp, void* stream) {
  if (n <= 0) return 0;
  if (tris < 1 || tris > tp || tp % TILE) return (int)cudaErrorInvalidValue;
  closest_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      origins, dirs, t_min, t_max, coeff, center, out_t, out_u, out_v,
      out_tri, n, tris, tp);
  return (int)cudaGetLastError();
}

int mxu_any(const float* origins, const float* dirs, const float* t_min,
            const float* t_max, const float* coeff, const float* center,
            unsigned char* out_occ, int* out_tests, int n, int tris, int tp,
            void* stream) {
  if (n <= 0) return 0;
  if (tris < 1 || tris > tp || tp % TILE) return (int)cudaErrorInvalidValue;
  any_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      origins, dirs, t_min, t_max, coeff, center, out_occ, out_tests, n,
      tris, tp);
  return (int)cudaGetLastError();
}

// out[0..4]: resident CTAs per SM, registers per thread, threads per CTA,
// static shared memory per CTA and spilled bytes per thread of the closest
// (which == 0) or any-hit (1) kernel.
int mxu_resources(int which, int* out) {
  const void* fn = which == 0 ? (const void*)closest_kernel
                              : (const void*)any_kernel;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, THREADS, 0);
  out[1] = attr.numRegs;
  out[2] = THREADS;
  out[3] = (int)attr.sharedSizeBytes;
  out[4] = (int)attr.localSizeBytes;
  return (int)err;
}

}  // extern "C"
