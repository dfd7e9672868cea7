// Tile-clustered traversal kernels for Hopper (sm_90a): the exact phase A
// mask and the phase B closest-hit and any-hit sweeps.
//
// Replaces XLA routines of royaltracer_dx_tpu/ops/cluster_traverse.py (the
// JAX package traces them in XLA, not Pallas):
//   cluster_mask     <- _tile_cluster_mask (:109-151)
//   cluster_closest  <- closest_hit_clustered (:268-384), its while loops
//                       over _mt_tile (:154-182)
//   cluster_any      <- any_hit_clustered (:387-464)
// and holds bit for bit to the plain PyTorch versions in
// royaltracer_dx_tpu_torch/ops/cluster_traverse.py (_mask_plain,
// _phase_b_plain).
//
// The clusters (build_clusters): C records of G triangles, [C, 9, G]
// floats (v0, e1, e2, component-major), their original ids [C, G] and
// boxes [C, 3] + [C, 3].  Rays are [N_pad, 8] rows (origin, direction,
// t_min, t_max), N_pad a multiple of the tile; a tile is `tile`
// consecutive rays of the batch, the JAX package's tile, because the
// retire rule below makes a tile's answer depend on which rays share it.
//
// cluster_mask: one CTA per tile, one thread per ray.  Every ray
// slab-tests every box (inv = |d| > 1e-12 ? 1/d : 3e38; t0 = (lo - o) *
// inv, the running max / min against t_min / t_max, x then y then z,
// NaN-propagating as jnp.minimum / jnp.maximum are); a warp ORs its
// overlaps with a ballot and takes its least entry with shuffles, and
// after each 32 clusters the CTA's warps are combined through shared
// memory into mask [tiles, C] and entry [tiles, C] (INF where no ray
// overlaps; -0.0 is stored as +0.0).
//
// The wrapper then sorts each tile's row by (entry, cluster id) with a
// stable library sort (the JAX package's lax.sort), giving the worklist wl,
// its entries went and count = the overlapped clusters.
//
// cluster_closest: one CTA per tile, one thread per ray.  Before step k
// the CTA reduces bound = max over its rays of min(best t, t_max), NaN
// propagating, and goes on only while k < count and went[k] < bound
// (:327-334); then it stages cluster wl[k]'s record and ids in shared
// memory and each ray runs Moller-Trumbore against its G triangles in
// lane order (inv_det = |det| > 1e-12 ? 1/det : 0; u, v and t as products
// with inv_det of sums taken left to right).  Within a cluster the first
// minimum lane wins; a later cluster wins only if strictly closer.
// cluster_any: the same staging; a tile stops when its list ends or every
// ray is occluded (__syncthreads_and), with no entry test (:434-435).
//
// Stats builds (STATS, the wrappers' stats=True) write per tile the steps
// it took and the triangle tests its answer needs: a live ray (t_min <
// t_max; a dead, NaN or padding ray cannot hit) tests G triangles a step
// in cluster_closest, and in cluster_any only until its first hit and not
// after it is occluded.  cluster_work bounds the kernels by those tests.
//
// What bounds them on this card.  Phase B is a product: each step is up
// to tile x G triangle tests of 52 FP32 operations against a 4.6 KB
// record (G = 128), so by cluster_work's count it is bound by operations
// (of the live rays' tests alone); the record is read once per tile and step
// through shared memory, every thread reading the same word (a
// broadcast).  Phase A is C slab tests a ray plus a warp reduction per
// cluster.  This is the first, simple design: one ray per thread, one
// barrier-separated step per cluster, no double buffering of the records
// and no packing of live rays (a tile's retired or dead lanes idle while
// the tile walks).  Its times stand in PERF.md.
//
// Numerics: built with -fmad=false and IEEE division and written in the
// JAX operation order, so the plain versions repeat it bit for bit.
// Supported: tile <= 1024 rays (threads are rounded up to whole warps;
// the extra threads are not rays) and G <= 1024 (a 40 KB stage); the
// wrappers raise beyond.

#include <cuda_runtime.h>

namespace {

constexpr float INF = 1e30f;
constexpr float BIG = 3.0e38f;
constexpr float DET_EPS = 1e-12f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;

// NaN-propagating min/max, the semantics of torch.minimum/maximum and of
// XLA's min/max (fminf/fmaxf would drop a NaN operand).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((a > b) ? a : b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : ((a < b) ? a : b);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

__device__ __forceinline__ Ray load_ray(const float* rays, size_t i) {
  const float4* p = reinterpret_cast<const float4*>(rays + i * 8);
  const float4 a = __ldg(p), b = __ldg(p + 1);
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// A thread past the tile's rays: never overlaps, never hits.
__device__ __forceinline__ Ray no_ray() {
  return {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 0.0f, -1.0f};
}

// ------------------------------ phase A ---------------------------------

__device__ __forceinline__ float slab_inv(float d) {
  return (fabsf(d) > 1e-12f) ? 1.0f / d : BIG;
}

__global__ void __launch_bounds__(MAX_THREADS)
mask_kernel(const float* __restrict__ rays, const float* __restrict__ lo,
            const float* __restrict__ hi, unsigned char* __restrict__ mask,
            float* __restrict__ entry, int tile, int c) {
  __shared__ unsigned s_any[32][33];
  __shared__ float s_min[32][33];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const size_t t = blockIdx.x;
  const bool real = tid < tile;
  const Ray r = real ? load_ray(rays, t * tile + tid) : no_ray();
  const float ix = slab_inv(r.dx), iy = slab_inv(r.dy), iz = slab_inv(r.dz);
  for (int c0 = 0; c0 < c; c0 += 32) {
    const int nb = min(32, c - c0);
    for (int j = 0; j < nb; ++j) {
      const float* bl = lo + (size_t)(c0 + j) * 3;
      const float* bh = hi + (size_t)(c0 + j) * 3;
      float tn = r.tmin, tf = r.tmax;
      float t0 = (__ldg(bl + 0) - r.ox) * ix;
      float t1 = (__ldg(bh + 0) - r.ox) * ix;
      tn = max_nan(tn, min_nan(t0, t1));
      tf = min_nan(tf, max_nan(t0, t1));
      t0 = (__ldg(bl + 1) - r.oy) * iy;
      t1 = (__ldg(bh + 1) - r.oy) * iy;
      tn = max_nan(tn, min_nan(t0, t1));
      tf = min_nan(tf, max_nan(t0, t1));
      t0 = (__ldg(bl + 2) - r.oz) * iz;
      t1 = (__ldg(bh + 2) - r.oz) * iz;
      tn = max_nan(tn, min_nan(t0, t1));
      tf = min_nan(tf, max_nan(t0, t1));
      const bool ov = real && (tn <= tf);
      float e = ov ? tn + 0.0f : INF;  // + 0.0 stores -0.0 as +0.0
      const unsigned any = __ballot_sync(FULL, ov);
      for (int s = 16; s > 0; s >>= 1) {
        e = fminf(e, __shfl_xor_sync(FULL, e, s));  // no NaN, no -0.0
      }
      if (lane == 0) {
        s_any[warp][j] = any;
        s_min[warp][j] = e;
      }
    }
    __syncthreads();
    if (tid < nb) {
      unsigned a = 0u;
      float m = INF;
      for (int w = 0; w < nw; ++w) {
        a |= s_any[w][tid];
        m = fminf(m, s_min[w][tid]);
      }
      mask[t * c + c0 + tid] = a ? 1 : 0;
      entry[t * c + c0 + tid] = m;
    }
    __syncthreads();
  }
}

// ------------------------------ phase B ---------------------------------

// The CTA's max_nan of v; every thread gets the same value.  red holds
// one float a warp; the caller's next barrier separates this read from
// the next call's writes.
__device__ __forceinline__ float cta_max_nan(float v, float* red) {
  for (int s = 16; s > 0; s >>= 1) {
    v = max_nan(v, __shfl_xor_sync(FULL, v, s));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = max_nan(m, red[w]);
  return m;
}

// Stage cluster cid's [9, G] record (and, for closest, its ids).
template <bool IDS>
__device__ __forceinline__ void stage(const float* __restrict__ planes,
                                      const int* __restrict__ tri_index,
                                      int cid, int g, float* sp, int* si) {
  const float* src = planes + (size_t)cid * 9 * g;
  for (int i = threadIdx.x; i < 9 * g; i += blockDim.x) sp[i] = __ldg(src + i);
  if (IDS) {
    const int* ids = tri_index + (size_t)cid * g;
    for (int i = threadIdx.x; i < g; i += blockDim.x) si[i] = __ldg(ids + i);
  }
}

// Moller-Trumbore of ray r against staged lane l (_mt_tile's order).
// Returns t (INF on a miss) and u, v.
__device__ __forceinline__ float mt_lane(const Ray& r, const float* sp, int g,
                                         int l, float& u, float& v) {
  const float v0x = sp[l], v0y = sp[g + l], v0z = sp[2 * g + l];
  const float e1x = sp[3 * g + l], e1y = sp[4 * g + l], e1z = sp[5 * g + l];
  const float e2x = sp[6 * g + l], e2y = sp[7 * g + l], e2z = sp[8 * g + l];
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool okd = fabsf(det) > DET_EPS;
  const float inv_det = okd ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  const bool ok = okd && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                  (t > r.tmin) && (t < r.tmax);
  return ok ? t : INF;
}

// The stats build's epilogue: out[2 t] = the tile's steps, out[2 t + 1]
// the sum of its threads' tests.  Every thread of the CTA calls it.
__device__ __forceinline__ void write_stats(long long* out, size_t t, int k,
                                            unsigned tests,
                                            unsigned long long* sum) {
  if (threadIdx.x == 0) *sum = 0ull;
  __syncthreads();
  if (tests) atomicAdd(sum, (unsigned long long)tests);
  __syncthreads();
  if (threadIdx.x == 0) {
    out[2 * t] = k;
    out[2 * t + 1] = (long long)*sum;
  }
}

template <bool STATS>
__global__ void __launch_bounds__(MAX_THREADS)
closest_kernel(const float* __restrict__ rays,
               const float* __restrict__ planes,
               const int* __restrict__ tri_index, const int* __restrict__ wl,
               const float* __restrict__ went, const int* __restrict__ count,
               float* __restrict__ out_tuv, int* __restrict__ out_tri,
               long long* __restrict__ out_stats, int tile, int c, int g) {
  extern __shared__ float smem[];
  float* sp = smem;                                // [9, G]
  int* si = reinterpret_cast<int*>(smem + 9 * g);  // [G]
  __shared__ float red[32];
  const int tid = threadIdx.x;
  const size_t t = blockIdx.x;
  const bool real = tid < tile;
  const size_t ray = t * tile + tid;
  const Ray r = real ? load_ray(rays, ray) : no_ray();
  const bool live = real && (r.tmin < r.tmax);
  const int cnt = count[t];
  float best = INF, bu = 0.0f, bv = 0.0f;
  int btri = 0;
  unsigned tests = 0u;
  int k = 0;
  for (; k < cnt; ++k) {
    // the retire rule: threads past the tile do not raise the bound
    const float bound = cta_max_nan(
        real ? min_nan(best, r.tmax) : __int_as_float(0xff800000u), red);
    if (!(went[t * c + k] < bound)) break;
    stage<true>(planes, tri_index, wl[t * c + k], g, sp, si);
    __syncthreads();
    if (real) {
      float cmin = INF, cu = 0.0f, cv = 0.0f;
      int cidx = 0;
      for (int l = 0; l < g; ++l) {
        float u, v;
        const float tl = mt_lane(r, sp, g, l, u, v);
        if (tl < cmin) {  // the first minimum lane of the cluster
          cmin = tl;
          cidx = l;
          cu = u;
          cv = v;
        }
      }
      if (cmin < best) {  // a later cluster only if strictly closer
        best = cmin;
        btri = si[cidx];
        bu = cu + 0.0f;  // as the JAX masked sums: -0.0 reads as +0.0
        bv = cv + 0.0f;
      }
    }
    if (STATS && live) tests += g;
  }
  if (real) {
    out_tuv[ray * 3 + 0] = best;
    out_tuv[ray * 3 + 1] = bu;
    out_tuv[ray * 3 + 2] = bv;
    out_tri[ray] = btri;
  }
  if (STATS) {
    __shared__ unsigned long long sum;
    write_stats(out_stats, t, k, tests, &sum);
  }
}

template <bool STATS>
__global__ void __launch_bounds__(MAX_THREADS)
any_kernel(const float* __restrict__ rays, const float* __restrict__ planes,
           const int* __restrict__ wl, const int* __restrict__ count,
           int* __restrict__ out_occ, long long* __restrict__ out_stats,
           int tile, int c, int g) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const size_t t = blockIdx.x;
  const bool real = tid < tile;
  const size_t ray = t * tile + tid;
  const Ray r = real ? load_ray(rays, ray) : no_ray();
  const bool live = real && (r.tmin < r.tmax);
  const int cnt = count[t];
  bool occ = !real;  // threads past the tile do not hold it
  unsigned tests = 0u;
  int k = 0;
  for (; k < cnt; ++k) {
    if (__syncthreads_and(occ)) break;
    stage<false>(planes, nullptr, wl[t * c + k], g, smem, nullptr);
    __syncthreads();
    if (!occ) {
      int l = 0;
      for (; l < g; ++l) {
        float u, v;
        if (mt_lane(r, smem, g, l, u, v) < INF) {
          occ = true;
          break;
        }
      }
      if (STATS && live) tests += occ ? l + 1 : g;  // up to the first hit
    }
  }
  if (real) out_occ[ray] = occ ? 1 : 0;
  if (STATS) {
    __shared__ unsigned long long sum;
    write_stats(out_stats, t, k, tests, &sum);
  }
}

int threads_of(int tile) { return (tile + 31) / 32 * 32; }

size_t stage_bytes(bool ids, int g) {
  return (size_t)9 * g * sizeof(float) + (ids ? (size_t)g * sizeof(int) : 0);
}

}  // namespace

extern "C" {

int cluster_mask(const float* rays, const float* aabb_lo,
                 const float* aabb_hi, unsigned char* mask, float* entry,
                 int tiles, int tile, int c, void* stream) {
  if (tiles > 0 && c > 0) {
    mask_kernel<<<tiles, threads_of(tile), 0, (cudaStream_t)stream>>>(
        rays, aabb_lo, aabb_hi, mask, entry, tile, c);
  }
  return (int)cudaGetLastError();
}

// out_stats: null, or [tiles, 2] int64 (steps, tests) from the stats build.
int cluster_closest(const float* rays, const float* planes,
                    const int* tri_index, const int* wl, const float* went,
                    const int* count, float* out_tuv, int* out_tri,
                    long long* out_stats, int tiles, int tile, int c, int g,
                    void* stream) {
  if (tiles > 0) {
    const auto fn = out_stats ? closest_kernel<true> : closest_kernel<false>;
    fn<<<tiles, threads_of(tile), stage_bytes(true, g),
         (cudaStream_t)stream>>>(rays, planes, tri_index, wl, went, count,
                                 out_tuv, out_tri, out_stats, tile, c, g);
  }
  return (int)cudaGetLastError();
}

int cluster_any(const float* rays, const float* planes, const int* wl,
                const int* count, int* out_occ, long long* out_stats,
                int tiles, int tile, int c, int g, void* stream) {
  if (tiles > 0) {
    const auto fn = out_stats ? any_kernel<true> : any_kernel<false>;
    fn<<<tiles, threads_of(tile), stage_bytes(false, g),
         (cudaStream_t)stream>>>(rays, planes, wl, count, out_occ, out_stats,
                                 tile, c, g);
  }
  return (int)cudaGetLastError();
}

// out[0..2]: resident CTAs per SM, registers per thread and shared memory
// per CTA (static + dynamic) of kernel `which` (0 mask, 1 closest, 2 any;
// the builds without stats) at `size` rays a tile and triangles a cluster.
int cluster_resources(int which, int size, int* out) {
  const void* fn = which == 0   ? (const void*)mask_kernel
                   : which == 1 ? (const void*)closest_kernel<false>
                                : (const void*)any_kernel<false>;
  const size_t dyn = which == 0 ? 0 : stage_bytes(which == 1, size);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn,
                                                      threads_of(size), dyn);
  out[1] = attr.numRegs;
  out[2] = (int)(attr.sharedSizeBytes + dyn);
  return (int)err;
}

}  // extern "C"
