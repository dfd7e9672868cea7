// Counter-based TEA draws for Hopper (sm_90a): tea_random, tea_batch,
// tea_batch_major and tea_batch_at of royaltracer_dx_tpu_torch/utils/rng.py,
// one launch a call.
//
// Replaces the eager form of utils/rng.py for CUDA tensors: _rounds (4 TEA
// rounds of masked int64 tensor ops), _to_unit and the seed's stack, some
// 88 elementwise kernels a call, each reading and writing whole int64
// planes.  The JAX package's royaltracer_dx_tpu/utils/rng.py (tea_random
// :42-62, tea_batch :79-100, tea_batch_major :103-122, tea_batch_at
// :125-143) has no Pallas kernel: XLA fuses it.  The plain form stays in
// utils/rng.py for CPU tensors and is what this kernel is held against.
//
// What it computes.  A seed is int64 [lanes, 2] holding uint32 words (s0,
// s1); the low 32 bits of each are read.  Draw j of a lane, at counter c =
// base + j (mod 2^32), all in uint32 arithmetic:
//   v0 = s0 + c * CTR_X, v1 = s1 ^ c * CTR_Y,
//   4 TEA rounds (Common_v6.hlsl:119-138) with DELTA and K0..K3,
//   u = float(v0) * 2^-32,
// the convert rounding to nearest (so u can be exactly 1.0) and the scale
// exact, as the plain form's int64 -> float32 convert and / 2^32 are.
// Counter 0 is tea_random's draw, and its (v0, v1) is the advanced seed,
// written back as an int64 pair: tea_random and the batches' trailing
// seed advance (their draws start at counter 0) come out of the same
// thread's rounds, in the same launch.
//
// What bounds it.  Bytes: 16 B read a lane, 4 B written a draw, plus 16
// B a lane for an advanced seed, against some 40 integer operations a
// draw (4 rounds of two halves: shift-add, add, shift-add, three-way xor,
// add; the counter; the convert).  At the frame's 2,073,600 lanes a
// tea_batch_at moves 41.5 MB (12.4 us at the H100 SXM's 3.35 TB/s), a
// tea_random 74.6 MB; chip_smoke.py's phase 2 times each entry point
// there beside that bound.
//
// How.  One kernel, tea_draws_kernel: 256 threads a CTA, a 1D grid of
// one thread a lane, nothing staged.  A thread loads its seed pair once,
// as one 16-byte load (the wrapper hands a contiguous, 16-byte aligned
// seed; on the frame path it always is: its seeds come from torch.stack
// and gathers), and writes draw j at lane * lane_stride + j * draw_stride:
// (n, 1) for the draw-minor [lanes, n] of tea_batch, (1, lanes) for the
// draw-major [n, lanes] of tea_batch_major, one plane for tea_batch_at and
// tea_random (n = 1).  The stores of one draw are coalesced across the
// warp in the draw-major layout and in a plane; the draw-minor layout's
// are n apart, which only tea_batch pays, and no port path calls it.
// The counter-0 draw also writes the advanced seed.  No shared memory, no
// synchronisation, no allocation: the wrapper allocates the outputs and
// launches on PyTorch's current stream.

#include <cuda_runtime.h>

namespace {

constexpr unsigned DELTA = 0x9E3779B9u;
constexpr unsigned K0 = 0xA341316Cu;
constexpr unsigned K1 = 0xC8013EA4u;
constexpr unsigned K2 = 0xAD90777Du;
constexpr unsigned K3 = 0x7E95761Eu;
constexpr unsigned CTR_X = 0x9E3779B9u;
constexpr unsigned CTR_Y = 0x85EBCA6Bu;
constexpr int THREADS = 256;

__device__ __forceinline__ void tea_rounds(unsigned& v0, unsigned& v1) {
  unsigned s = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    s += DELTA;
    v0 += ((v1 << 4) + K0) ^ (v1 + s) ^ ((v1 >> 5) + K1);
    v1 += ((v0 << 4) + K2) ^ (v0 + s) ^ ((v0 >> 5) + K3);
  }
}

__device__ __forceinline__ float draw(longlong2 s, unsigned c, unsigned& v0,
                                     unsigned& v1) {
  v0 = static_cast<unsigned>(s.x) + c * CTR_X;
  v1 = static_cast<unsigned>(s.y) ^ (c * CTR_Y);
  tea_rounds(v0, v1);
  return __uint2float_rn(v0) * 0x1p-32f;
}

// Draws base .. base + n - 1 of lane `lane` at out[lane * lane_stride +
// j * draw_stride].  new_seed: null, or [lanes, 2] int64 for the
// counter-0 draw's (v0, v1).
__global__ void __launch_bounds__(THREADS)
    tea_draws_kernel(const longlong2* __restrict__ seed, unsigned lanes,
                     unsigned n, unsigned base, unsigned lane_stride,
                     unsigned draw_stride, float* __restrict__ out,
                     longlong2* __restrict__ new_seed) {
  const unsigned lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= lanes) return;
  const longlong2 s = seed[lane];
  float* o = out + (size_t)lane * lane_stride;
  unsigned v0, v1;
  for (unsigned j = 0; j < n; ++j) {
    o[(size_t)j * draw_stride] = draw(s, base + j, v0, v1);
    if (new_seed != nullptr && j == 0)
      new_seed[lane] = make_longlong2(v0, v1);
  }
}

}  // namespace

extern "C" {

// seed: [lanes, 2] int64, contiguous and 16-byte aligned.  Draws base ..
// base + n - 1 of every lane into out (float32, draw j of a lane at
// lane * lane_stride + j * draw_stride); new_seed (null or [lanes, 2]
// int64) takes the counter-0 draw's words, so base must be 0 when it is
// given.  lanes * n below 2^31.  Returns the launch's CUDA error (0:
// launched or nothing to do).
int tea_draws(const void* seed, long long lanes, int n, unsigned base,
              unsigned lane_stride, unsigned draw_stride, float* out,
              void* new_seed, void* stream) {
  if (lanes < 0 || n < 0 || (long long)n * lanes >= (1LL << 31) ||
      (new_seed != nullptr && base != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0 || n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((lanes + THREADS - 1) /
                                                THREADS);
  tea_draws_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const longlong2*>(seed), (unsigned)lanes, (unsigned)n,
      base, lane_stride, draw_stride, out, static_cast<longlong2*>(new_seed));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
