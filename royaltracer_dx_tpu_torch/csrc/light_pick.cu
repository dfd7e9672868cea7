// The NEE light pick for Hopper (sm_90a): select_light_records of
// royaltracer_dx_tpu_torch/ops/light_sampling.py, one launch a call.
//
// Replaces the eager form of that function for CUDA tensors: a count of
// cdf[l] <= u with one compare, one int64 convert and one int64 add per
// light (3 (L - 1) kernels a call, 1,149 on the 384-triangle atrium), a
// stack of the 16 record columns and a row gather.  The JAX package's
// royaltracer_dx_tpu/ops/light_sampling.py (select_light_records :76-98)
// has no Pallas kernel: XLA fuses the same loop.  The plain form stays in
// ops/light_sampling.py for CPU tensors and is what this kernel is held
// against.
//
// What it computes.  For every lane, the light index
//   idx = #{ l < L - 1 : cdf[l] <= u }
// (IEEE compares: a NaN u counts nothing and picks light 0; -0 == +0),
// then the lane's record, row idx of the packed float32 [L, 16] table
// (9 world vertex coordinates, 3 normal, pdf, 3 emission), written as 16
// planes: out[k * lanes + lane].  The index is never stored.
//
// What bounds it.  Bytes: 4 B read and 64 B written a lane, the table and
// the CDF staying in the caches: 141 MB at the frame's 2,073,600 lanes,
// 42 us at the H100 SXM's 3.35 TB/s.  chip_smoke.py's phase 2 times it
// there beside that bound.
//
// How.  One kernel, light_pick_kernel: a thread a lane, 256 threads a
// CTA, a 1D grid, so a warp's loads of u and each of its stores are
// coalesced.  The CDF is staged in shared memory TILE values at a time
// (one tile up to 4,097 lights).  A tile's count is the same whichever
// way it is taken, so the CTA first checks whether the tile is
// non-decreasing (no NaN), one __syncthreads_and: if it is, the values
// <= u are a prefix of the tile and a branch-free binary search over
// powers of two finds its length in ceil(log2(m + 1)) steps; otherwise
// every thread counts the tile value by value, each value a shared-memory
// broadcast.  The sum over tiles is the plain form's count bit for bit on
// every input, sorted or not.  The search's shared-memory latency is
// what a 384-light pick adds to a 2-light one: one lane a thread, with
// more warps resident to hide it, measured faster than 2, 4 or 8 lanes a
// thread.  The record row is read as four float4 through the read-only
// cache (the table is 64 B a light: 24.6 KB for 384 lights), and the 16
// planes are written one after another.  u may be any 2D-strided view
// (rows, cols, row stride, col stride): the wrapper folds u's shape to
// that or copies it.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;      // CDF values staged a round (16 KB)
constexpr int RECORD = 16;      // floats a light record

__global__ void __launch_bounds__(THREADS)
    light_pick_kernel(const float* __restrict__ u, long long lanes,
                      long long cols, long long row_stride,
                      long long col_stride, const float* __restrict__ cdf,
                      int n, const float4* __restrict__ table,
                      float* __restrict__ out) {
  __shared__ float s[TILE];
  const long long lane = (long long)blockIdx.x * THREADS + threadIdx.x;
  float x = 0.0f;
  if (lane < lanes) {
    const long long r = cols == lanes ? 0 : lane / cols;   // uniform
    x = u[r * row_stride + (lane - r * cols) * col_stride];
  }
  unsigned idx = 0;
  for (int base = 0; base < n; base += TILE) {
    const int m = min(TILE, n - base);
    __syncthreads();            // the previous tile is read
    for (int i = threadIdx.x; i < m; i += THREADS) s[i] = cdf[base + i];
    __syncthreads();
    int sorted = 1;
    for (int i = threadIdx.x; i + 1 < m; i += THREADS)
      sorted &= s[i] <= s[i + 1];
    if (__syncthreads_and(sorted)) {
      unsigned c = 0;
      for (unsigned step = 1u << (31 - __clz(m)); step > 0; step >>= 1)
        if (c + step <= (unsigned)m && s[c + step - 1] <= x) c += step;
      idx += c;
    } else {
      for (int l = 0; l < m; ++l) idx += s[l] <= x;
    }
  }
  if (lane >= lanes) return;
  const float4* row = table + (size_t)idx * (RECORD / 4);
  float* o = out + lane;
#pragma unroll
  for (int q = 0; q < RECORD / 4; ++q) {
    const float4 v = __ldg(row + q);
    o[(4 * q + 0) * lanes] = v.x;
    o[(4 * q + 1) * lanes] = v.y;
    o[(4 * q + 2) * lanes] = v.z;
    o[(4 * q + 3) * lanes] = v.w;
  }
}

}  // namespace

extern "C" {

// u: float32 lanes at u[r * row_stride + c * col_stride] for the lane r *
// cols + c; cdf: float32 [l_count], contiguous; table: float32 [l_count,
// 16], contiguous and 16-byte aligned; out: float32 [16, lanes].  Returns
// the launch's CUDA error (0: launched or nothing to do).
int light_pick(const float* u, long long lanes, long long cols,
               long long row_stride, long long col_stride, const float* cdf,
               int l_count, const void* table, float* out, void* stream) {
  if (lanes < 0 || l_count < 1 || (lanes > 0 && cols < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) return 0;
  const long long blocks = (lanes + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  light_pick_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      u, lanes, cols, row_stride, col_stride, cdf, l_count - 1,
      static_cast<const float4*>(table), out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
