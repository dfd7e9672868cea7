// Stream traversal kernels for Hopper (sm_90a): closest hit and any hit
// over the two-level StreamAccel.
//
// Replaces royaltracer_dx_tpu/ops/stream_trace.py::_make_kernel (the
// Pallas kernel launched by _run_kernel, :514-725) in both of its modes:
//   stream_closest  <- _make_kernel(occlusion=False)
//   stream_any      <- _make_kernel(occlusion=True)
//
// What it computes, per chunk of 128 rays (one CTA, one thread per ray):
// walk the chunk's near-to-far block worklist; per block, slab-test the
// ray against the block's 32 cluster boxes, then run Moller-Trumbore
// against the 64 triangles of every cluster that some ray of the chunk
// wants.  Within a cluster the first-minimum lane wins; a later cluster
// wins only if strictly closer (stream_trace.py:619-630).  The chunk stops
// when the next block's entry bound reaches the largest live best-t
// (closest) or once every valid ray is occluded (any hit).
//
// What bounds it on this card: FP32 arithmetic.  Each tested cluster costs
// 128 rays x 64 triangles x ~30 FP32 operations of Moller-Trumbore, with
// triangle data read from shared memory as warp-wide broadcasts; the block
// rows are read from device memory once per (chunk, block) pair.  What the
// design does about it:
//   * the block's triangle row (288 x 64 floats = 73,728 B) and its cluster
//     boxes are double-buffered in shared memory with cp.async, so the next
//     block's copy overlaps this block's arithmetic;
//   * a CTA-wide OR of the per-ray cluster masks skips every cluster that
//     no ray of the chunk wants (hot_cl, stream_trace.py:582), and a ray
//     skips clusters its own slab test rejected;
//   * the early exit is a CTA-wide reduction per block step:
//     __syncthreads_or for occlusion, a shared max of best-t for closest.
// With 147 KB of staging per CTA one CTA (4 warps) fits on an SM; more
// CTAs per SM, persistent CTAs and TMA multicast of shared block rows
// belong to the work that makes it fast.
//
// Numerics: built with -fmad=false and IEEE division, and written in the
// exact operation order of the Pallas kernel (the slab is blo*inv - o*inv,
// :526-527, :577-578), so the plain PyTorch version in
// royaltracer_dx_tpu_torch/ops/stream_trace.py matches it bit for bit.
// The hit slot is returned as int32 (the Pallas kernel carried it as a
// float value only to survive TPU denormal flushing, :679-681).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 64;            // triangles per cluster
constexpr int S = 32;            // clusters per block
constexpr int R = 128;           // rays per chunk (= threads per CTA)
constexpr int ROWF = 9 * S * G;  // floats per block triangle row
constexpr int BOXF = 6 * S;      // box floats staged per block (lanes < S)
constexpr float BIG = 3.0e38f;
constexpr float DET_EPS = 1e-12f;
constexpr size_t SMEM_BYTES = (size_t)(2 * ROWF + 2 * BOXF) * sizeof(float);

// NaN-propagating min/max, the semantics of torch.minimum/maximum and of
// XLA's min/max (fminf/fmaxf would drop a NaN operand).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((a > b) ? a : b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : ((a < b) ? a : b);
}

__device__ __forceinline__ float safe_inv(float d) {
  // stream_trace.py:692-694
  return (fabsf(d) > 1e-20f) ? 1.0f / d : ((d >= 0.0f) ? 1e30f : -1e30f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage block b: its [9S, G] triangle row and the first S lanes of its
// six [128]-lane box planes (lanes >= S are padding that never passes).
__device__ __forceinline__ void load_block(float* sm_t, float* sm_b,
                                           const float* __restrict__ tris,
                                           const float* __restrict__ boxes,
                                           int b, int tid) {
  const float4* src = reinterpret_cast<const float4*>(tris + (size_t)b * ROWF);
  float4* dst = reinterpret_cast<float4*>(sm_t);
  for (int i = tid; i < ROWF / 4; i += R) cp_async16(dst + i, src + i);
  if (tid < BOXF / 4) {
    const int plane = tid / (S / 4);
    const int q = tid % (S / 4);
    cp_async16(sm_b + plane * S + q * 4,
               boxes + (size_t)b * 6 * 128 + plane * 128 + q * 4);
  }
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < R / 32; ++i) m = fmaxf(m, red[i]);
  __syncthreads();
  return m;
}

template <bool OCC>
__global__ void __launch_bounds__(R)
    stream_kernel(const float* __restrict__ rows, const int* __restrict__ wl,
                  const float* __restrict__ went,
                  const int* __restrict__ cnt_arr,
                  const float* __restrict__ blk_tris,
                  const float* __restrict__ blk_boxes,
                  float* __restrict__ out_tuv, int* __restrict__ out_slot,
                  int* __restrict__ out_stats, int wb) {
  extern __shared__ __align__(16) float smem[];
  float* buf_t = smem;              // [2][ROWF]
  float* buf_b = smem + 2 * ROWF;   // [2][BOXF]
  __shared__ float red[R / 32];
  __shared__ unsigned hot_sh;

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const size_t ray = (size_t)chunk * R + tid;
  const float* row = rows + ray * 16;
  const float o[3] = {row[0], row[1], row[2]};
  const float d[3] = {row[3], row[4], row[5]};
  const float t_min = row[6];
  const float tcur = row[7];
  const bool valid = row[8] > 0.5f;
  float inv[3], oi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    inv[c] = safe_inv(d[c]);
    oi[c] = o[c] * inv[c];
  }
  const int cnt = cnt_arr[chunk];
  const int* wl_c = wl + (size_t)chunk * wb;
  const float* went_c = went + (size_t)chunk * wb;

  if (cnt > 0) {
    load_block(buf_t, buf_b, blk_tris, blk_boxes, wl_c[0], tid);
    cp_async_commit();
  }

  float tbest = tcur;
  int slot = -1;
  float bu = 0.0f, bv = 0.0f;
  float bound;
  if (OCC) {
    bound = __syncthreads_or(valid) ? 1.0f : -BIG;
  } else {
    bound = block_max(valid ? tcur : 0.0f, red);
  }

  int w = 0, ncl = 0;
  while (true) {
    const bool more =
        OCC ? (bound > 0.0f) : (went_c[min(w, wb - 1)] < bound);
    if (!(w < cnt && more)) break;  // CTA-uniform
    const int st = w & 1;
    if (w + 1 < cnt) {
      load_block(buf_t + (st ^ 1) * ROWF, buf_b + (st ^ 1) * BOXF, blk_tris,
                 blk_boxes, wl_c[w + 1], tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (tid == 0) hot_sh = 0u;
    __syncthreads();
    const float* bt = buf_t + st * ROWF;
    const float* bb = buf_b + st * BOXF;

    // per-ray slab test against the block's S cluster boxes, bounded by
    // the block-start best-t (stream_trace.py:570-581)
    unsigned cand = 0u;
    const float tbest0 = tbest;
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      float tn = t_min, tf = tbest0;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float t0 = bb[c * S + s] * inv[c] - oi[c];
        const float t1 = bb[(3 + c) * S + s] * inv[c] - oi[c];
        tn = max_nan(tn, min_nan(t0, t1));
        tf = min_nan(tf, max_nan(t0, t1));
      }
      if ((tn <= tf) && valid) cand |= (1u << s);
    }
    const unsigned wor = __reduce_or_sync(0xffffffffu, cand);
    if ((tid & 31) == 0) atomicOr(&hot_sh, wor);
    __syncthreads();
    const unsigned hot = hot_sh;
    ncl += __popc(hot);
    const int bid = wl_c[w];

    for (int s = 0; s < S; ++s) {
      if (!((hot >> s) & 1u)) continue;   // no ray of the chunk wants it
      if (!((cand >> s) & 1u)) continue;  // this ray's slab rejected it
      if (tbest <= t_min) break;          // no t in (t_min, tbest) is left
      const float* p = bt + s * 9 * G;
      const float tb = tbest;             // cluster-start best-t
      float best_c = BIG;
      int idx_c = 0;
      float uc = 0.0f, vc = 0.0f;
      for (int g = 0; g < G; ++g) {
        const float v0x = p[0 * G + g], v0y = p[1 * G + g], v0z = p[2 * G + g];
        const float e1x = p[3 * G + g], e1y = p[4 * G + g], e1z = p[5 * G + g];
        const float e2x = p[6 * G + g], e2y = p[7 * G + g], e2z = p[8 * G + g];
        const float px = d[1] * e2z - d[2] * e2y;
        const float py = d[2] * e2x - d[0] * e2z;
        const float pz = d[0] * e2y - d[1] * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool big = fabsf(det) > DET_EPS;
        const float inv_det = big ? 1.0f / det : 0.0f;
        const float tx = o[0] - v0x, ty = o[1] - v0y, tz = o[2] - v0z;
        const float uu = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float vv = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det;
        const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool ok = big && (uu >= 0.0f) && (vv >= 0.0f) &&
                        (uu + vv <= 1.0f) && (tt > t_min) && (tt < tb);
        if (OCC) {
          if (ok) {
            tbest = 0.0f;  // the t=0 "occluded" encoding (:615-618)
            break;
          }
        } else if (ok && tt < best_c) {  // first-minimum lane
          best_c = tt;
          idx_c = g;
          uc = uu;
          vc = vv;
        }
      }
      if (!OCC && best_c < tb) {  // strictly closer than earlier clusters
        tbest = best_c;
        slot = (bid * S + s) * G + idx_c;
        bu = uc;
        bv = vc;
      }
    }

    // early-exit bound for the next step (:636-649); the reduction's
    // barrier also retires this stage before it is refilled
    if (OCC) {
      bound = __syncthreads_or(valid && (tbest > 0.0f)) ? 1.0f : -BIG;
    } else {
      bound = block_max(valid ? tbest : 0.0f, red);
    }
    ++w;
  }
  cp_async_wait<0>();  // drain a prefetch left in flight by an early exit

  const bool improved = OCC ? (tbest <= 0.0f) : (tbest < tcur);
  out_tuv[ray * 3 + 0] = tbest;
  out_tuv[ray * 3 + 1] = bu;
  out_tuv[ray * 3 + 2] = bv;
  out_slot[ray] = improved ? (OCC ? 1 : slot) : -1;
  if (tid == 0) {
    out_stats[chunk * 2 + 0] = w;    // blocks visited
    out_stats[chunk * 2 + 1] = ncl;  // clusters tested
  }
}

template <bool OCC>
int launch(const float* rows, const int* wl, const float* went,
           const int* cnt, const float* blk_tris, const float* blk_boxes,
           float* out_tuv, int* out_slot, int* out_stats, int chunks, int wb,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stream_kernel<OCC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  if (chunks > 0) {
    stream_kernel<OCC><<<chunks, R, SMEM_BYTES, (cudaStream_t)stream>>>(
        rows, wl, went, cnt, blk_tris, blk_boxes, out_tuv, out_slot,
        out_stats, wb);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int stream_closest(const float* rows, const int* wl, const float* went,
                   const int* cnt, const float* blk_tris,
                   const float* blk_boxes, float* out_tuv, int* out_slot,
                   int* out_stats, int chunks, int wb, void* stream) {
  return launch<false>(rows, wl, went, cnt, blk_tris, blk_boxes, out_tuv,
                       out_slot, out_stats, chunks, wb, stream);
}

int stream_any(const float* rows, const int* wl, const float* went,
               const int* cnt, const float* blk_tris, const float* blk_boxes,
               float* out_tuv, int* out_slot, int* out_stats, int chunks,
               int wb, void* stream) {
  return launch<true>(rows, wl, went, cnt, blk_tris, blk_boxes, out_tuv,
                      out_slot, out_stats, chunks, wb, stream);
}

}  // extern "C"
