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
// against the 64 triangles of every cluster whose box the ray's own slab
// test passed.  Within a cluster the first-minimum lane wins; a later
// cluster wins only if strictly closer (stream_trace.py:619-630).  The
// chunk stops when the next block's entry bound reaches the largest live
// best-t (closest) or once every valid ray is occluded (any hit).
//
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700 W; measured with
// tools/stream_study.py on the batches of a 1920x1080 menger frame): in all
// but the primary-ray batch, 86-95% of the chunks have an empty worklist and
// 1-10% of the lanes are live, so most of a batch is a stream of 52 bytes a
// lane and its bound is bytes.  The chunks that do walk are sparse: a live
// chunk visits 1.5 to 4 blocks, some ray of it wants 3 to 28 clusters in
// all, but each cluster is wanted by a handful of its 128 rays (50 to 360
// ray-cluster pairs a chunk).  The TPU kernel's shape -- one thread per ray
// walking all 64 triangles of every cluster some ray of the chunk wants,
// behind a double-buffered 73,728-byte block row that leaves one CTA of 4
// warps on an SM -- spent its time in that hit test: with the test compiled
// out it took under a third of its time, with the staging compiled out no
// less.  A live chunk is a chain of short dependent steps (worklist entry
// -> boxes -> slab test -> hit tests -> CTA-wide bound), so what is left is
// latency and instruction slots, not the FP32 rate.  What this design does:
//   * nothing is staged in shared memory.  A ring of 2,304-byte cluster
//     tiles filled by bulk asynchronous copies (cp.async.bulk on mbarriers)
//     was built and measured: it was 0-9% slower than reading the tiles in
//     place on every batch timed, a 75 MB soup that the L2 does not hold
//     included, because each tile is read by the few warps that want it and
//     by each only once.  Boxes and tiles are read through the read-only
//     cache;
//   * a warp looks at how many of its rays want a cluster.  If most do,
//     each ray walks the 64 triangles itself, four neighbouring triangles
//     of a plane per load (float4), in lane order.  If few do (fewer than
//     COOP_MAX), the warp takes those rays one at a time: lane l tests
//     triangles l and l + 32 against the ray, and two redux instructions
//     find the smallest t and its lowest triangle -- the first minimum, as
//     before -- so a sparse pair costs 2 tests a lane, not 64.  The slab
//     test has the same two forms (lane s tests box s, and the ballot is
//     the ray's cluster mask);
//   * a warp walks only the clusters its own rays want; the chunk-wide hot
//     mask is needed for the stats alone and rides on the step's one
//     barrier;
//   * 96 bytes of shared memory a CTA, and the registers are capped by
//     __launch_bounds__(128, MIN_CTAS), so 8 CTAs are resident per SM
//     (stream_resources reports the count) and other chunks' work hides a
//     chunk's load latency and its barrier;
//   * one CTA-wide barrier per block step instead of four: the warps'
//     early-exit bounds (a redux max on order-preserving bits for closest,
//     __syncthreads_or for any hit), hot masks and candidate counts cross
//     in one double-buffered exchange;
//   * a ray that is invalid, or whose best-t already lies below t_min,
//     skips the slab test (it can pass no box); a chunk with an empty
//     worklist touches no shared memory and no barrier; rows and outputs
//     use streaming loads and stores.
// Measured choices: 6, 10 and 11 CTAs per SM (80, 48, 40 registers) were no
// faster than 8 (more spills above 8); one or two triangles per load no
// faster than four; COOP_MAX 0 (always thread per ray) and 33 (always warp
// per ray) both slower than 20.
//
// Numerics: built with -fmad=false and IEEE division, and written in the
// exact operation order of the Pallas kernel (the slab is blo*inv - o*inv,
// :526-527, :577-578), so the plain PyTorch version in
// royaltracer_dx_tpu_torch/ops/stream_trace.py matches it bit for bit in
// either form of the tests.  Without FMA contraction every counted
// operation takes an instruction slot of its own, so the reachable floor
// is twice the bound reckoned at the FMA rate.  The hit slot is returned
// as int32 (the Pallas kernel carried it as a float value only to survive
// TPU denormal flushing, :679-681).
//
// Per-chunk stats, 3 ints: blocks visited, clusters tested, and ray-cluster
// candidate pairs (the sum over valid rays and visited blocks of the
// popcount of the ray's own cluster mask).  Where ``totals`` is not null,
// each chunk that walked also adds its three stats to totals[0..2] (int64,
// one atomicAdd each): the running counter of the program's telemetry.

#include <cuda_runtime.h>

namespace {

constexpr int G = 64;             // triangles per cluster
constexpr int S = 32;             // clusters per block
constexpr int R = 128;            // rays per chunk (= threads per CTA)
constexpr int WARPS = R / 32;
constexpr int TILEF = 9 * G;      // floats per cluster tile (v0/e1/e2 planes)
constexpr int MIN_CTAS = 8;       // resident CTAs per SM the registers allow
constexpr int COOP_MAX = 20;      // a warp with fewer wanting rays takes them
                                  // one at a time
constexpr int BOXP = 128;         // lanes per box plane in blk_boxes
constexpr float BIG = 3.0e38f;
constexpr float DET_EPS = 1e-12f;
constexpr unsigned FULL = 0xffffffffu;

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

// ---- order-preserving bits of a float, for integer redux min/max ----

__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_ordered_bits(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

// The one CTA-wide exchange of a block step.  Every warp hands in its
// hot-cluster mask and candidate count of the step and its rays' part of
// the early-exit bound (:636-649): closest, the largest live best-t (tval);
// any hit, whether a ray is still unoccluded (open).  x is the step's half
// of the double-buffered exchange, so a warp that runs ahead into the next
// step does not overwrite what a slower one still reads.  Returns the
// bound; thread 0 adds the step's stats.
template <bool OCC>
__device__ __forceinline__ float cta_step(float tval, bool open, unsigned wor,
                                          unsigned wpc, unsigned (*x)[3],
                                          int& ncl, int& npairs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned m = 0u;
  if (!OCC) m = __reduce_max_sync(FULL, ordered_bits(tval));
  if (lane == 0) {
    x[warp][0] = m;
    x[warp][1] = wor;
    x[warp][2] = wpc;
  }
  float bound;
  if (OCC) {
    bound = __syncthreads_or(open) ? 1.0f : -BIG;
  } else {
    __syncthreads();
    unsigned r = x[0][0];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) r = max(r, x[i][0]);
    bound = from_ordered_bits(r);
  }
  if (threadIdx.x == 0) {
    unsigned hot = 0u;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      hot |= x[i][1];
      npairs += (int)x[i][2];
    }
    ncl += __popc(hot);
  }
  return bound;
}

// One Moller-Trumbore test in the Pallas kernel's operation order
// (stream_trace.py:590-612).  tb is the cluster-start best-t.
__device__ __forceinline__ bool mt_test(const float o[3], const float d[3],
                                        float t_min, float tb, float v0x,
                                        float v0y, float v0z, float e1x,
                                        float e1y, float e1z, float e2x,
                                        float e2y, float e2z, float& tt,
                                        float& uu, float& vv) {
  const float px = d[1] * e2z - d[2] * e2y;
  const float py = d[2] * e2x - d[0] * e2z;
  const float pz = d[0] * e2y - d[1] * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool big = fabsf(det) > DET_EPS;
  const float inv_det = big ? 1.0f / det : 0.0f;
  const float tx = o[0] - v0x, ty = o[1] - v0y, tz = o[2] - v0z;
  uu = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  vv = (d[0] * qx + d[1] * qy + d[2] * qz) * inv_det;
  tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return big && (uu >= 0.0f) && (vv >= 0.0f) && (uu + vv <= 1.0f) &&
         (tt > t_min) && (tt < tb);
}

// One slab test of a ray against a cluster box, bounded by [t_min, tfar]
// (stream_trace.py:570-581): the slab is blo*inv - o*inv.
__device__ __forceinline__ bool slab_test(const float inv[3],
                                          const float oi[3], float t_min,
                                          float tfar, const float lo[3],
                                          const float hi[3]) {
  float tn = t_min, tf = tfar;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t0 = lo[c] * inv[c] - oi[c];
    const float t1 = hi[c] * inv[c] - oi[c];
    tn = max_nan(tn, min_nan(t0, t1));
    tf = min_nan(tf, max_nan(t0, t1));
  }
  return tn <= tf;
}

template <bool OCC>
__global__ void __launch_bounds__(R, MIN_CTAS)
    stream_kernel(const float* __restrict__ rows, const int* __restrict__ wl,
                  const float* __restrict__ went,
                  const int* __restrict__ cnt_arr,
                  const float* __restrict__ blk_tris,
                  const float* __restrict__ blk_boxes,
                  float* __restrict__ out_tuv, int* __restrict__ out_slot,
                  int* __restrict__ out_stats, int wb,
                  unsigned long long* __restrict__ totals) {
  // per step parity and warp: early-exit bound, hot mask, candidate pairs
  __shared__ unsigned xch[2][WARPS][3];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int chunk = blockIdx.x;
  const size_t ray = (size_t)chunk * R + tid;
  const float4* row4 = reinterpret_cast<const float4*>(rows + ray * 16);
  // rows are read once: streaming loads keep them from evicting the
  // boxes and worklists the SM's chunks share in L1
  const float4 ra = __ldcs(row4);
  const float4 rb = __ldcs(row4 + 1);
  const float o[3] = {ra.x, ra.y, ra.z};
  const float d[3] = {ra.w, rb.x, rb.y};
  const float t_min = rb.z;
  const float tcur = rb.w;
  const bool valid = __ldcs(rows + ray * 16 + 8) > 0.5f;
  const int cnt = __ldg(cnt_arr + chunk);

  float tbest = tcur;
  int slot = -1;
  float bu = 0.0f, bv = 0.0f;
  int w = 0, ncl = 0, npairs = 0;

  if (cnt > 0) {  // CTA-uniform: a chunk with an empty worklist ends here
    float inv[3], oi[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      inv[c] = safe_inv(d[c]);
      oi[c] = o[c] * inv[c];
    }
    const int* wl_c = wl + (size_t)chunk * wb;
    const float* went_c = went + (size_t)chunk * wb;
    int nb = __ldg(wl_c);
    float ne = __ldg(went_c);
    float bound = cta_step<OCC>(valid ? tcur : 0.0f, valid, 0u, 0u, xch[1],
                                ncl, npairs);

    while (true) {
      const bool more = OCC ? (bound > 0.0f) : (ne < bound);
      if (!(w < cnt && more)) break;  // CTA-uniform
      const int bid = nb;
      if (w + 1 < cnt) {  // the next step's worklist entry, ahead of its use
        nb = __ldg(wl_c + w + 1);
        ne = __ldg(went_c + w + 1);
      }

      // per-ray slab test against the block's S cluster boxes, bounded by
      // the block-start best-t (stream_trace.py:570-581).  With
      // tbest0 < t_min no box can pass: tn >= t_min > tbest0 >= tf.
      unsigned cand = 0u;
      const float tbest0 = tbest;
      const bool slab_live = valid && !(tbest0 < t_min);
      unsigned lm = __ballot_sync(FULL, slab_live);
      const float* bx = blk_boxes + (size_t)bid * 6 * BOXP;
      if (__popc(lm) >= COOP_MAX) {
        // most rays of the warp are live: each ray tests the 32 boxes,
        // read four clusters of a plane per load
        if (slab_live) {
          const float4* bx4 = reinterpret_cast<const float4*>(bx);
#pragma unroll 2
          for (int q = 0; q < S / 4; ++q) {
            float lo[4][3], hi[4][3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float4 l = __ldg(bx4 + c * (BOXP / 4) + q);
              const float4 h = __ldg(bx4 + (3 + c) * (BOXP / 4) + q);
              lo[0][c] = l.x; lo[1][c] = l.y; lo[2][c] = l.z; lo[3][c] = l.w;
              hi[0][c] = h.x; hi[1][c] = h.y; hi[2][c] = h.z; hi[3][c] = h.w;
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (slab_test(inv, oi, t_min, tbest0, lo[k], hi[k]))
                cand |= 1u << (q * 4 + k);
            }
          }
        }
      } else if (lm) {
        // few live rays: the warp takes them one at a time, lane s testing
        // the box of cluster s, and the ballot is the ray's cluster mask
        float lo[3], hi[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          lo[c] = __ldg(bx + c * BOXP + lane);
          hi[c] = __ldg(bx + (3 + c) * BOXP + lane);
        }
        while (lm) {  // warp-uniform
          const int src = __ffs(lm) - 1;
          lm &= lm - 1u;
          float rinv[3], roi[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            rinv[c] = __shfl_sync(FULL, inv[c], src);
            roi[c] = __shfl_sync(FULL, oi[c], src);
          }
          const float rtmin = __shfl_sync(FULL, t_min, src);
          const float rtfar = __shfl_sync(FULL, tbest0, src);
          const unsigned mask = __ballot_sync(
              FULL, slab_test(rinv, roi, rtmin, rtfar, lo, hi));
          if (lane == src) cand = mask;
        }
      }

      // the clusters some ray of this warp wants, in cluster order
      const unsigned wor = __reduce_or_sync(FULL, cand);
      const unsigned wpc = __reduce_add_sync(FULL, (unsigned)__popc(cand));
      unsigned m = wor;
      while (m) {  // warp-uniform
        const int s = __ffs(m) - 1;
        m &= m - 1u;
        // this ray's slab passed the cluster, and some t in
        // (t_min, tbest) is left
        const bool want = ((cand >> s) & 1u) && !(tbest <= t_min);
        unsigned wm = __ballot_sync(FULL, want);
        if (wm == 0u) continue;
        const float* p = blk_tris + ((size_t)bid * S + s) * TILEF;
        const int slot0 = (bid * S + s) * G;
        if (__popc(wm) >= COOP_MAX) {
          // most rays of the warp want the cluster: each ray walks its
          // 64 triangles, four of a plane per load
          if (want) {
            const float tb = tbest;  // cluster-start best-t
            float best_c = BIG;
            int idx_c = 0;
            float uc = 0.0f, vc = 0.0f;
            const float4* p4 = reinterpret_cast<const float4*>(p);
            for (int j = 0; j < G / 4; ++j) {
              float tri[9][4];  // triangles 4j .. 4j+3, plane by plane
#pragma unroll
              for (int c = 0; c < 9; ++c) {
                const float4 t4 = __ldg(p4 + c * (G / 4) + j);
                tri[c][0] = t4.x; tri[c][1] = t4.y;
                tri[c][2] = t4.z; tri[c][3] = t4.w;
              }
              bool any_ok = false;
#pragma unroll
              for (int k = 0; k < 4; ++k) {  // in lane order
                float tt, uu, vv;
                const bool ok = mt_test(
                    o, d, t_min, tb, tri[0][k], tri[1][k], tri[2][k],
                    tri[3][k], tri[4][k], tri[5][k], tri[6][k], tri[7][k],
                    tri[8][k], tt, uu, vv);
                if (OCC) {
                  any_ok |= ok;
                } else if (ok && tt < best_c) {  // first-minimum lane
                  best_c = tt;
                  idx_c = 4 * j + k;
                  uc = uu;
                  vc = vv;
                }
              }
              if (OCC && any_ok) {
                tbest = 0.0f;  // the t=0 "occluded" encoding (:615-618)
                break;
              }
            }
            if (!OCC && best_c < tb) {  // strictly closer than before
              tbest = best_c;
              slot = slot0 + idx_c;
              bu = uc;
              bv = vc;
            }
          }
        } else {
          // few rays want it: the warp takes them one at a time, lane l
          // testing triangles l and l + 32, and reduces to the smallest
          // t, the lowest triangle among equals (the first minimum)
          float tri[2][9];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
#pragma unroll
            for (int c = 0; c < 9; ++c)
              tri[k][c] = __ldg(p + c * G + k * 32 + lane);
          }
          while (wm) {  // warp-uniform
            const int src = __ffs(wm) - 1;
            wm &= wm - 1u;
            float ro[3], rd[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              ro[c] = __shfl_sync(FULL, o[c], src);
              rd[c] = __shfl_sync(FULL, d[c], src);
            }
            const float rtmin = __shfl_sync(FULL, t_min, src);
            const float rtb = __shfl_sync(FULL, tbest, src);
            float bt = BIG, lu = 0.0f, lv = 0.0f;
            int bi = 0;
            bool any_ok = false;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              float tt, uu, vv;
              const bool ok = mt_test(
                  ro, rd, rtmin, rtb, tri[k][0], tri[k][1], tri[k][2],
                  tri[k][3], tri[k][4], tri[k][5], tri[k][6], tri[k][7],
                  tri[k][8], tt, uu, vv);
              any_ok |= ok;
              if (!OCC && ok && tt < bt) {
                bt = tt;
                bi = k * 32 + lane;
                lu = uu;
                lv = vv;
              }
            }
            if (OCC) {
              if (__any_sync(FULL, any_ok) && lane == src) tbest = 0.0f;
            } else {
              // two redux: the smallest t (-0 counted as +0, as a float
              // compare does), then its lowest triangle
              const unsigned tkey = ordered_bits(bt + 0.0f);
              const unsigned wkey = __reduce_min_sync(FULL, tkey);
              bi = (int)__reduce_min_sync(
                  FULL, tkey == wkey ? (unsigned)bi : (unsigned)G);
              bt = __shfl_sync(FULL, bt, bi & 31);
              const float wu = __shfl_sync(FULL, lu, bi & 31);
              const float wv = __shfl_sync(FULL, lv, bi & 31);
              if (lane == src && bt < rtb) {  // strictly closer than before
                tbest = bt;
                slot = slot0 + bi;
                bu = wu;
                bv = wv;
              }
            }
          }
        }
      }

      // the early-exit bound for the next step, and this step's stats
      bound = cta_step<OCC>(valid ? tbest : 0.0f, valid && (tbest > 0.0f),
                            wor, wpc, xch[w & 1], ncl, npairs);
      ++w;
    }
  }

  const bool improved = OCC ? (tbest <= 0.0f) : (tbest < tcur);
  __stcs(out_tuv + ray * 3 + 0, tbest);
  __stcs(out_tuv + ray * 3 + 1, bu);
  __stcs(out_tuv + ray * 3 + 2, bv);
  __stcs(out_slot + ray, improved ? (OCC ? 1 : slot) : -1);
  if (tid == 0) {
    out_stats[(size_t)chunk * 3 + 0] = w;       // blocks visited
    out_stats[(size_t)chunk * 3 + 1] = ncl;     // clusters tested
    out_stats[(size_t)chunk * 3 + 2] = npairs;  // ray-cluster candidates
    if (totals != nullptr && w > 0) {  // a chunk that did not walk adds 0
      atomicAdd(totals + 0, (unsigned long long)w);
      atomicAdd(totals + 1, (unsigned long long)ncl);
      atomicAdd(totals + 2, (unsigned long long)npairs);
    }
  }
}

template <bool OCC>
int launch(const float* rows, const int* wl, const float* went,
           const int* cnt, const float* blk_tris, const float* blk_boxes,
           float* out_tuv, int* out_slot, int* out_stats, int chunks, int wb,
           void* stream, unsigned long long* totals) {
  if (chunks > 0) {
    stream_kernel<OCC><<<chunks, R, 0, (cudaStream_t)stream>>>(
        rows, wl, went, cnt, blk_tris, blk_boxes, out_tuv, out_slot,
        out_stats, wb, totals);
  }
  return (int)cudaGetLastError();
}

template <bool OCC>
int resources(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, stream_kernel<OCC>);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], stream_kernel<OCC>, R, 0);
  out[1] = attr.numRegs;
  out[2] = (int)attr.sharedSizeBytes;
  return (int)err;
}

}  // namespace

extern "C" {

int stream_closest(const float* rows, const int* wl, const float* went,
                   const int* cnt, const float* blk_tris,
                   const float* blk_boxes, float* out_tuv, int* out_slot,
                   int* out_stats, int chunks, int wb, void* stream,
                   unsigned long long* totals) {
  return launch<false>(rows, wl, went, cnt, blk_tris, blk_boxes, out_tuv,
                       out_slot, out_stats, chunks, wb, stream, totals);
}

int stream_any(const float* rows, const int* wl, const float* went,
               const int* cnt, const float* blk_tris, const float* blk_boxes,
               float* out_tuv, int* out_slot, int* out_stats, int chunks,
               int wb, void* stream, unsigned long long* totals) {
  return launch<true>(rows, wl, went, cnt, blk_tris, blk_boxes, out_tuv,
                      out_slot, out_stats, chunks, wb, stream, totals);
}

// out[0..2]: resident CTAs per SM, registers per thread and static shared
// memory per CTA of the closest (occlusion == 0) or any-hit kernel.
int stream_resources(int occlusion, int* out) {
  return occlusion ? resources<true>(out) : resources<false>(out);
}

}  // extern "C"
