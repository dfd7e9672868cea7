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
// cluster_mask, what it computes: per (tile, cluster) whether any of the
// tile's rays overlaps the cluster's box and the least slab entry of those
// that do (inv = |d| > 1e-12 ? 1/d : 3e38; t0 = (lo - o) * inv, the
// running max / min against t_min / t_max, x then y then z, NaN-propagating
// as jnp.minimum / jnp.maximum are; overlap: tn <= tf), into mask [tiles,
// C] and entry [tiles, C] (INF where no ray overlaps; -0.0 is stored as
// +0.0).
//
// cluster_mask, how.  The first design (a CTA a tile, a thread a ray, a
// ballot, a shuffle chain and per 32 boxes two barriers) ran every ray
// through every box, though on the frame's bounce batches 90-98% of them
// are dead, and reduced across the tile for every box.  This one rests on
// four premises of the semantics (tests/test_torch_cluster_mask.py holds
// them on the plain version):
//   (a) a ray with !(t_min <= t_max), NaN included, overlaps no box: tn
//       only rises from t_min, tf only falls from t_max, a NaN propagates.
//       (t_min == t_max can overlap: the test is <=, not phase B's <.)
//   (b) the OR and the least entry do not depend on the rays' order: no
//       entry is NaN and -0.0 is folded, so any grouping gives the tables.
//   (c) a ray with finite origin and direction (live, so its bounds are
//       not NaN) against a finite box gives no NaN slab value (inv is
//       finite and non-zero; an overflowing lo - o is an infinity times
//       it), so fminf / fmaxf (one FMNMX each) give the tables of the
//       NaN-propagating min / max: they differ only in the sign of a zero,
//       which neither tn <= tf nor tn + 0.0 sees.
//   (d) for such a ray and a box with lo <= hi, lo - o <= hi - o and so
//       (lo - o) * inv <= (hi - o) * inv when inv > 0, >= when inv < 0
//       (rounding is monotone): the sign of inv names each axis's entry
//       plane, and min(t0, t1) / max(t0, t1) need no test.
// So:
//   * A persistent grid (every SM's resident CTAs of MASK_THREADS) takes
//     units of tpc consecutive tiles: tpc = MASK_THREADS / C for small C
//     (menger's 38 clusters: 6 tiles), one for C >= MASK_THREADS.  The
//     rows are streamed: each CTA copies its next unit into the other of
//     MASK_STAGES shared buffers with 16-byte cp.async while it compacts
//     and tests the current one (the frame's largest batch is a 597 MB
//     read with ~5% of its rays live).
//   * Dead rays leave first (a).  Each live ray is written back over its
//     row as (origin, t_min), (inv, t_max), inv computed once, and ranked
//     in its tile's bucket (a match and one shared atomic per warp, tile
//     and bucket): the 8 octants of inv's signs for the finite rays (c,
//     d), then the others; then it moves into the tile's list, bucket
//     after bucket (b allows any order).  A tile with no live ray only
//     writes its row of 0 / INF.
//   * The reduction is transposed: a thread owns a (tile, cluster) pair
//     and runs over the tile's list (all of its tile's threads read the
//     same ray: a broadcast).  Per octant it loads the box's near and far
//     planes once and tests with fmaxf / fminf alone, 20 floating-point
//     instructions against 26 with min(t0, t1) and max(t0, t1) (24 in
//     cluster_work's count); the other rays, and every ray when the box is
//     not finite or has lo > hi on an axis, take the exact test.  It keeps
//     the least overlapping entry (NaN while none, which fminf drops) in a
//     register and writes mask[t, c] and entry[t, c] once, coalesced along
//     c.  No ballot, shuffle or barrier per box.  For C > MASK_THREADS a
//     thread takes clusters c, c + MASK_THREADS, ..., MASK_BOXES of them a
//     ray load, and that build is given more registers (MIN_CTAS).
// What bounds it (tools/cluster_study.py on an H100): dense batches are
// issue-bound, 21 instructions a test at MASK_BOXES boxes a ray load and
// 24.5 at one (sponza's primary batch at 1.2x its no-FMA floor; menger's,
// whose tiles of 38 threads straddle warps and whose compaction and
// barriers take a quarter of the time, at 2.5x); sparse ones by the
// stream of rows (the frame's 18.7M-lane batch at 1.3x its bytes bound,
// its staging alone at 1.1x).
//
// The wrapper then sorts each tile's row by (entry, cluster id) with a
// stable library sort (the JAX package's lax.sort), giving the worklist wl,
// its entries went and count = the overlapped clusters, and the tiles
// busiest first (tile_order: a stable sort of count, descending; the JAX
// package's perm = argsort(-count), :306).
//
// Phase B, what a tile computes.  Closest: before step k the tile goes on
// only while k < count and went[k] < bound, bound = max over its rays of
// min(best t, t_max), NaN propagating (:327-334); step k runs
// Moller-Trumbore of every ray against cluster wl[k]'s G triangles
// (inv_det = |det| > 1e-12 ? 1/det : 0; u, v and t as products with
// inv_det of sums taken left to right); within a cluster the first
// minimum lane wins, a later cluster only if strictly closer.  Any hit: a
// tile stops when its list ends or every ray is occluded, with no entry
// test (:434-435).  Stats builds (STATS, the wrappers' stats=True) write
// per tile the steps it took and the triangle tests its answer needs: a
// live ray (t_min < t_max) tests G triangles a step in cluster_closest,
// and in cluster_any only up to its first hit and nothing once occluded.
//
// Phase B, how.  A step is up to tile x G tests of 52 FP32 operations
// against a 4.6 KB record (G = 128): by cluster_work's count it is bound
// by operations, of the live rays' tests alone.  What the first design
// (one thread a ray, a CTA a tile) lost was not the operations: a tile's
// time was its longest walk, each step G tests in series on one thread,
// and on the frame's bounce batches 70-85% of a walking tile's lanes were
// dead and idled (or, in any hit, tested every triangle).  So:
//   * Dead rays leave the work.  A ray with !(t_min < t_max) never hits;
//     its only effect on a closest-hit tile is min(INF, t_max) in the
//     bound, folded at the start into dead_bound (padding rows count with
//     their -1; a NaN retires the tile).  The live rays are compacted into
//     shared memory (ballot + one atomic a warp) and only they are tested;
//     any hit compacts the live rays not yet occluded again each step.
//   * A step is spread over the CTA (PB_THREADS threads): each ray gets a
//     team of q lanes (a power of two up to 32, the largest with
//     rays x q <= PB_THREADS), team lane j tests the slot pairs
//     (2 p, 2 p + 1), p = j (mod q), in increasing order and keeps its
//     first minimum (t, slot), and the team reduces (t, slot)
//     lexicographically with shuffles: the first minimum slot, bit for
//     bit.  Only the winner's u, v are needed: its leader computes them
//     again, by the same arithmetic.  Any hit tests one pair a lane and
//     ballots the team after each, so it stops at the first hit and
//     knows its slot.
//   * The records are double-buffered: step k+1's record (and ids) is
//     copied with cp.async (16 bytes a copy when G % 4 == 0) while step k
//     tests; for closest the copy is speculative (the retire rule may
//     drop it).  A staged record is laid out in groups of 4 slots, each
//     group's 9 components side by side, so a lane loads a pair's
//     triangles with nine 8-byte loads at fixed offsets: the first layout
//     ([9, G], a load and an address a component) spent 22 of a test's
//     102 instructions on them.
//   * The busiest tiles start first: a persistent grid (every SM's
//     resident CTAs) takes positions of the wrapper's tile order from an
//     atomic counter, so the longest walks start at time 0.  Once a CTA
//     meets a tile with count 0 every later position has count 0 too, and
//     it takes them ZERO_CHUNK at a time and only writes their misses.
//   * Steps that need no work are counted, not walked: a closest tile
//     with no live ray takes the first k with !(went[k] < dead_bound)
//     (capped at count) as its steps; an any-hit tile whose live rays are
//     all occluded stops there, or counts up to count if it holds a dead
//     ray (which JAX's tile waits on, never occluded).
//
// What bounds it now is the instruction rate: every SM's schedulers are
// busy with the tests, 84 instructions a test (46 floating-point
// operations without FMA, the IEEE reciprocal and its range check, the
// hit predicates, the loads and the minimum) where cluster_work counts 52
// operations at two a lane and clock (the no-FMA floor counts them at
// one).  On the frame's sparse batches the longest tile, sharing its SM,
// sets the time.  Its times stand in PERF.md.
//
// Numerics: built with -fmad=false and IEEE division and written in the
// JAX operation order, so the plain versions repeat it bit for bit.
// Supported: tile <= 1024 rays and G <= 1024 (phase B: two records of 40
// KB and the compacted rays, up to 132 KB of dynamic shared memory; phase
// A: MASK_STAGES + 1 units of up to 1024 rays, 128 KB); the wrappers raise
// beyond.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr float INF = 1e30f;
constexpr float BIG = 3.0e38f;
constexpr float DET_EPS = 1e-12f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SIZE = 1024;  // the wrappers' MAX_TILE and MAX_GROUP

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------ phase A ---------------------------------

constexpr int MASK_THREADS = 256;  // threads of a phase A CTA
constexpr int MASK_STAGES = 2;     // units of rows staged: in flight + read
constexpr int MASK_BOXES = 4;      // boxes a ray load when C > MASK_THREADS
constexpr int MASK_TPC = 32;       // the most tiles a unit
// resident CTAs the register budget aims at, C <= / > MASK_THREADS: one box
// a ray load (menger) ran 5% faster a frame at 3 (80 registers) than at 2,
// four (sponza) 6% faster at 2 (tools/cluster_study.py --set, on an H100)
constexpr int MASK_MIN_CTAS_SMALL = 3;
constexpr int MASK_MIN_CTAS_LARGE = 2;

// A unit: tpc consecutive tiles a CTA takes at once, w threads a tile
// (one a cluster, or MASK_THREADS taking every w-th cluster).
struct MaskShape {
  int w, tpc, rays;
};

__host__ __device__ __forceinline__ MaskShape mask_shape(int tile, int c) {
  const int w = c < MASK_THREADS ? c : MASK_THREADS;
  int tpc = MASK_THREADS / w;
  tpc = tpc < MAX_SIZE / tile ? tpc : MAX_SIZE / tile;
  tpc = tpc < MASK_TPC ? tpc : MASK_TPC;
  return {w, tpc, tpc * tile};
}

// Dynamic shared memory of a phase A CTA: MASK_STAGES units of rows and
// the unit's compacted live rays, 32 bytes a ray each.
__host__ __device__ __forceinline__ size_t mask_bytes(int tile, int c) {
  return (size_t)(MASK_STAGES + 1) * mask_shape(tile, c).rays * 32;
}

__device__ __forceinline__ float slab_inv(float d) {
  return (fabsf(d) > 1e-12f) ? 1.0f / d : BIG;
}

// Start copying unit u's rows (its tiles; the last unit may hold fewer)
// into dst, 16 bytes a copy; the caller commits the group.
__device__ __forceinline__ void stage_unit(const float* __restrict__ rays,
                                           int u, int tiles, int tile,
                                           const MaskShape& sh, float4* dst) {
  const int t0 = u * sh.tpc;
  const int n = min(sh.tpc, tiles - t0) * tile * 2;
  const float4* src =
      reinterpret_cast<const float4*>(rays) + (size_t)t0 * tile * 2;
  for (int i = threadIdx.x; i < n; i += MASK_THREADS) cp_async16(dst + i, src + i);
}

// Cluster boxes cl + j w (j < NB): the planes a slab test of an octant's
// rays meets first (nx) and last (fx) on each axis; octant 0 gives lo, hi.
template <int NB>
__device__ __forceinline__ void load_planes(const float* __restrict__ lo,
                                            const float* __restrict__ hi,
                                            int cl, int w, int oct,
                                            float (&nx)[NB][3],
                                            float (&fx)[NB][3]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const bool neg = (oct >> a) & 1;
      const size_t k = (size_t)(cl + j * w) * 3 + a;
      nx[j][a] = __ldg((neg ? hi : lo) + k);
      fx[j][a] = __ldg((neg ? lo : hi) + k);
    }
  }
}

// Ray r of a tile's list, (origin, t_min) and (inv, t_max), against NB
// boxes: m[j] keeps the least entry of the overlaps (NaN while none, which
// fminf drops; an overlap's tn is never NaN).  EXACT: nx, fx are lo, hi
// and the NaN-propagating min / max of the plain version order each slab;
// else they are the ray's octant's near and far planes (premise d), which
// fmaxf / fminf fold in (premise c).
template <int NB, bool EXACT>
__device__ __forceinline__ void slab_test(const float4* rl, int r,
                                          const float (&nx)[NB][3],
                                          const float (&fx)[NB][3],
                                          float (&m)[NB]) {
  const float4 p = rl[2 * r], q = rl[2 * r + 1];
  const float o[3] = {p.x, p.y, p.z}, inv[3] = {q.x, q.y, q.z};
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    float tn = p.w, tf = q.w;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float t0 = (nx[j][a] - o[a]) * inv[a];
      const float t1 = (fx[j][a] - o[a]) * inv[a];
      if (EXACT) {
        tn = max_nan(tn, min_nan(t0, t1));
        tf = min_nan(tf, max_nan(t0, t1));
      } else {
        tn = fmaxf(tn, t0);
        tf = fminf(tf, t1);
      }
    }
    if (tn <= tf) m[j] = fminf(m[j], tn);
  }
}

// Clusters cl + j w (j < NB) against a tile's listed rays, whose bucket
// counts are cnt[0..8] (the 8 octants of the finite rays, then the rest);
// writes their flags and entries.  A box that is not finite or has lo > hi
// on an axis takes the exact test for every ray.
template <int NB>
__device__ __forceinline__ void mask_boxes(const float4* rl, const int* cnt,
                                           int live,
                                           const float* __restrict__ lo,
                                           const float* __restrict__ hi,
                                           int cl, int w,
                                           unsigned char* __restrict__ mrow,
                                           float* __restrict__ erow) {
  float nx[NB][3], fx[NB][3], m[NB];
  load_planes<NB>(lo, hi, cl, w, 0, nx, fx);
  bool fast = true;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      fast = fast && isfinite(nx[j][a]) && isfinite(fx[j][a]) &&
             nx[j][a] <= fx[j][a];
    m[j] = __int_as_float(0x7fc00000);
  }
  int r = 0;
  if (fast) {
    for (int oct = 0; oct < 8; ++oct) {
      const int end = r + cnt[oct];
      if (r == end) continue;
      load_planes<NB>(lo, hi, cl, w, oct, nx, fx);
#pragma unroll 2
      for (; r < end; ++r) slab_test<NB, false>(rl, r, nx, fx, m);
    }
    if (r < live) load_planes<NB>(lo, hi, cl, w, 0, nx, fx);
  }
  for (; r < live; ++r) slab_test<NB, true>(rl, r, nx, fx, m);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const bool any = m[j] == m[j];
    mrow[cl + j * w] = any ? 1 : 0;
    erow[cl + j * w] = any ? m[j] + 0.0f : INF;  // + 0.0: -0.0 as +0.0
  }
}

constexpr int MASK_BUCKETS = 9;  // a tile's list: 8 octants, then the rest
// rays a thread compacts, at most
constexpr int MASK_RPT = (MAX_SIZE + MASK_THREADS - 1) / MASK_THREADS;

template <int MIN_CTAS>
__global__ void __launch_bounds__(MASK_THREADS, MIN_CTAS)
mask_kernel(const float* __restrict__ rays, const float* __restrict__ lo,
            const float* __restrict__ hi, unsigned char* __restrict__ mask,
            float* __restrict__ entry, int tiles, int tile, int c) {
  extern __shared__ __align__(16) float smem[];
  // per parity and tile of the unit, the rays of each bucket
  __shared__ int s_cnt[2][MASK_BUCKETS * MASK_TPC];
  const MaskShape sh = mask_shape(tile, c);
  float4* ring = reinterpret_cast<float4*>(smem);  // [STAGES][rays][2]
  float4* list = ring + (size_t)MASK_STAGES * sh.rays * 2;  // [rays][2]
  const int tid = threadIdx.x, lane = tid & 31;
  const int units = (tiles + sh.tpc - 1) / sh.tpc;
  for (int k = 0; k < MASK_STAGES; ++k) {
    const int u = blockIdx.x + k * gridDim.x;
    if (u < units)
      stage_unit(rays, u, tiles, tile, sh, ring + (size_t)k * sh.rays * 2);
    cp_async_commit();
  }
  for (int i = tid; i < 2 * MASK_BUCKETS * MASK_TPC; i += MASK_THREADS)
    (&s_cnt[0][0])[i] = 0;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++it) {
    float4* st = ring + (size_t)(it % MASK_STAGES) * sh.rays * 2;
    int* cnt = s_cnt[it & 1];
    cp_async_wait<MASK_STAGES - 1>();
    // unit u's rows have landed; the last unit's tests are done with the
    // list, and this unit's counts were zeroed
    __syncthreads();
    const int t0 = u * sh.tpc, nt = min(sh.tpc, tiles - t0);
    const int nr = nt * tile;
    // the live rays (premise a): each one's tile bucket and its rank there
    // (premise b: any order); its (origin, t_min), (inv, t_max) go back
    // over its row
    int key[MASK_RPT], rank[MASK_RPT];
#pragma unroll
    for (int j = 0; j < MASK_RPT; ++j) {
      key[j] = -1;
      if (j * MASK_THREADS >= sh.rays) continue;  // uniform
      const int i = j * MASK_THREADS + tid;
      if (i < nr) {
        const float4 a = st[2 * i], b = st[2 * i + 1];
        if (b.z <= b.w) {
          const float4 q = make_float4(slab_inv(a.w), slab_inv(b.x),
                                       slab_inv(b.y), b.w);
          st[2 * i] = make_float4(a.x, a.y, a.z, b.z);
          st[2 * i + 1] = q;
          const bool fin = isfinite(a.x) && isfinite(a.y) &&
                           isfinite(a.z) && isfinite(a.w) &&
                           isfinite(b.x) && isfinite(b.y);
          const int oct = (q.x < 0.0f ? 1 : 0) | (q.y < 0.0f ? 2 : 0) |
                          (q.z < 0.0f ? 4 : 0);
          key[j] = MASK_BUCKETS * (i / tile) + (fin ? oct : 8);
        }
      }
      const unsigned peers = __match_any_sync(FULL, key[j]);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (key[j] >= 0 && lane == leader)
        base = atomicAdd(cnt + key[j], __popc(peers));
      rank[j] = __shfl_sync(FULL, base, leader) +
                __popc(peers & ((1u << lane) - 1u));
    }
    __syncthreads();
    // into the list: per tile, bucket after bucket
#pragma unroll
    for (int j = 0; j < MASK_RPT; ++j) {
      if (key[j] < 0) continue;
      const int i = j * MASK_THREADS + tid;
      const int g = key[j] / MASK_BUCKETS, bk = key[j] - g * MASK_BUCKETS;
      int slot = g * tile + rank[j];
      for (int k = 0; k < bk; ++k) slot += cnt[g * MASK_BUCKETS + k];
      list[2 * slot] = st[2 * i];
      list[2 * slot + 1] = st[2 * i + 1];
    }
    __syncthreads();
    // the stage is read: this CTA's unit MASK_STAGES on goes into it
    const int un = u + MASK_STAGES * gridDim.x;
    if (un < units) stage_unit(rays, un, tiles, tile, sh, st);
    cp_async_commit();
    for (int i = tid; i < MASK_BUCKETS * MASK_TPC; i += MASK_THREADS)
      s_cnt[(it & 1) ^ 1][i] = 0;  // the next unit's (its tests are done)
    const int g = tid / sh.w;
    if (g < nt) {
      const int* ct = cnt + g * MASK_BUCKETS;
      int live = 0;
      for (int k = 0; k < MASK_BUCKETS; ++k) live += ct[k];
      const float4* rl = list + (size_t)g * tile * 2;
      const size_t row = (size_t)(t0 + g) * c;
      int cl = tid - g * sh.w;
      if (live == 0) {
        for (; cl < c; cl += sh.w) {
          mask[row + cl] = 0;
          entry[row + cl] = INF;
        }
      } else {
        for (; cl + (MASK_BOXES - 1) * sh.w < c; cl += MASK_BOXES * sh.w)
          mask_boxes<MASK_BOXES>(rl, ct, live, lo, hi, cl, sh.w, mask + row,
                                 entry + row);
        for (; cl < c; cl += sh.w)
          mask_boxes<1>(rl, ct, live, lo, hi, cl, sh.w, mask + row,
                        entry + row);
      }
    }
  }
  cp_async_wait<0>();
}

// ------------------------------ phase B ---------------------------------

constexpr int PB_THREADS = 256;  // threads of a phase B CTA
constexpr int PB_WARPS = PB_THREADS / 32;
// resident CTAs an SM the register budget aims at: closest at 3 (80
// registers, no spills) ran 5% faster a menger frame than at 4 (64
// registers, spilling), any hit at 4 3% faster than at 3
// (tools/cluster_study.py --set, on an H100)
constexpr int CLOSEST_MIN_CTAS = 3;
constexpr int ANY_MIN_CTAS = 4;
constexpr int ZERO_CHUNK = 8;    // count-0 tiles taken at a time

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000u);
}

__device__ __forceinline__ float warp_max_nan(float v) {
  for (int s = 16; s > 0; s >>= 1) {
    v = max_nan(v, __shfl_xor_sync(FULL, v, s));
  }
  return v;
}

// A slot in a shared list for each lane that keeps: one atomic a warp.
// Every lane of the warp calls it.
__device__ __forceinline__ int warp_append(bool keep, int* counter) {
  const unsigned b = __ballot_sync(FULL, keep);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && b) base = atomicAdd(counter, __popc(b));
  base = __shfl_sync(FULL, base, 0);
  return base + __popc(b & ((1u << lane) - 1u));
}

// The team of lanes a ray gets: the largest power of two up to 32 (and
// not above the G / 2 slot pairs) with n rays x q lanes <= PB_THREADS;
// q = 1 when n exceeds the CTA, and then a lane takes several rays in
// turn.
__device__ __forceinline__ int team_size(int n, int g) {
  int q = 1;
  while (q < 32 && 2 * q <= (g + 1) / 2 && n * 2 * q <= PB_THREADS) q *= 2;
  return q;
}

// A staged record is [G/4][9][4] floats: slots in groups of 4, each
// group's 9 components (v0, e1, e2) of its 4 slots side by side, so that
// one 8-byte load gives a component of a slot pair and the 9 loads of a
// pair sit at fixed offsets; for closest the G ids follow.  Floats of one
// record, a multiple of 4 (16 bytes).
__host__ __device__ __forceinline__ size_t rec_stride(bool ids, int g) {
  return (size_t)(g + 3) / 4 * (ids ? 40 : 36);
}

// Dynamic shared memory of a phase B CTA: two records, then per ray of
// the tile its 8 floats (by live slot, component-major) and the slot's
// ray index, for closest its best t, u, v and id, for any hit two
// lists of live slots still walking.
__host__ __device__ __forceinline__ size_t phase_b_floats(bool closest,
                                                          int tile, int g) {
  return 2 * rec_stride(closest, g) + (size_t)tile * (closest ? 13 : 11);
}

// Start copying cluster cid's [9, G] record (and, for closest, its ids)
// into dst in the grouped layout; the caller commits the group.  vec:
// 16-byte copies (G % 4 == 0 and 16-byte aligned sources).
template <bool IDS>
__device__ __forceinline__ void prefetch(const float* __restrict__ planes,
                                         const int* __restrict__ tri_index,
                                         int cid, int g, float* dst,
                                         bool vec) {
  const float* src = planes + (size_t)cid * 9 * g;
  const int* ids = IDS ? tri_index + (size_t)cid * g : nullptr;
  const int groups = (g + 3) / 4;
  float* di = dst + 36 * groups;
  if (vec) {
    // 16 bytes i: group i / 9, component i % 9
    for (int i = threadIdx.x; i < 9 * groups; i += PB_THREADS)
      cp_async16(dst + 4 * i, src + (i % 9) * g + 4 * (i / 9));
    if (IDS)
      for (int i = threadIdx.x; i < groups; i += PB_THREADS)
        cp_async16(di + 4 * i, ids + 4 * i);
  } else {
    // float i: slot i / 9, component i % 9
    for (int i = threadIdx.x; i < 9 * g; i += PB_THREADS) {
      const int l = i / 9, c = i % 9;
      cp_async4(dst + (l / 4 * 9 + c) * 4 + l % 4, src + c * g + l);
    }
    if (IDS)
      for (int i = threadIdx.x; i < g; i += PB_THREADS)
        cp_async4(di + i, ids + i);
  }
}

// Moller-Trumbore of ray r against one triangle (_mt_tile's order).
// Returns t (INF on a miss) and u, v.
__device__ __forceinline__ float mt(const Ray& r, float v0x, float v0y,
                                    float v0z, float e1x, float e1y,
                                    float e1z, float e2x, float e2y,
                                    float e2z, float& u, float& v) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool okd = fabsf(det) > DET_EPS;
  const float inv_det = okd ? 1.0f / (okd ? det : 1.0f) : 0.0f;  // no branch
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

// Slot l of a staged record (grouped layout).
__device__ __forceinline__ float mt_slot(const Ray& r, const float* sp, int l,
                                         float& u, float& v) {
  const float* p = sp + (l / 4) * 36 + (l & 3);
  return mt(r, p[0], p[4], p[8], p[12], p[16], p[20], p[24], p[28], p[32],
            u, v);
}

// Slots 2 j and 2 j + 1 of a staged record: their t (INF on a miss; the
// slots past the record's G are zeros, a zero determinant: a miss).
__device__ __forceinline__ void mt_pair(const Ray& r, const float* sp, int j,
                                        float& t0, float& t1) {
  const float2* p =
      reinterpret_cast<const float2*>(sp + (j / 2) * 36 + 2 * (j & 1));
  const float2 a = p[0], b = p[2], c = p[4], d = p[6], e = p[8], f = p[10],
               h = p[12], i = p[14], k = p[16];
  float u, v;
  t0 = mt(r, a.x, b.x, c.x, d.x, e.x, f.x, h.x, i.x, k.x, u, v);
  t1 = mt(r, a.y, b.y, c.y, d.y, e.y, f.y, h.y, i.y, k.y, u, v);
}

// Zero the slots of both record buffers past the record's G (a group's
// padding): they then test as misses.  Before the CTA's first barrier.
__device__ __forceinline__ void zero_padding(float* smem, size_t rs, int g) {
  const int pad = (4 - g % 4) % 4;
  for (int i = threadIdx.x; i < 2 * 9 * pad; i += PB_THREADS) {
    const int l = g + i % pad, c = i / pad % 9;
    smem[(i / (9 * pad)) * rs + (l / 4 * 9 + c) * 4 + l % 4] = 0.0f;
  }
}

// The ray in live slot s of the compacted rays ([8, tile] in shared).
__device__ __forceinline__ Ray slot_ray(const float* s_ray, int tile, int s) {
  return {s_ray[s],            s_ray[tile + s],     s_ray[2 * tile + s],
          s_ray[3 * tile + s], s_ray[4 * tile + s], s_ray[5 * tile + s],
          s_ray[6 * tile + s], s_ray[7 * tile + s]};
}

__device__ __forceinline__ void put_ray(float* s_ray, int tile, int s,
                                        const Ray& r) {
  s_ray[s] = r.ox;
  s_ray[tile + s] = r.oy;
  s_ray[2 * tile + s] = r.oz;
  s_ray[3 * tile + s] = r.dx;
  s_ray[4 * tile + s] = r.dy;
  s_ray[5 * tile + s] = r.dz;
  s_ray[6 * tile + s] = r.tmin;
  s_ray[7 * tile + s] = r.tmax;
}

__device__ __forceinline__ void write_miss(float* out_tuv, int* out_tri,
                                           size_t ray) {
  out_tuv[ray * 3 + 0] = INF;
  out_tuv[ray * 3 + 1] = 0.0f;
  out_tuv[ray * 3 + 2] = 0.0f;
  out_tri[ray] = 0;
}

// The next position of the tile order for this CTA: one at a time while
// tiles have work, ZERO_CHUNK at a time once a count-0 tile was met.
// Every thread calls it; the caller's barrier after the tile protects
// s_pos.
__device__ __forceinline__ int take(unsigned long long* counter, int step,
                                    int* s_pos) {
  if (threadIdx.x == 0)
    *s_pos = (int)atomicAdd(counter, (unsigned long long)step);
  __syncthreads();
  return *s_pos;
}

template <bool STATS>
__global__ void __launch_bounds__(PB_THREADS, CLOSEST_MIN_CTAS)
closest_kernel(const float* __restrict__ rays,
               const float* __restrict__ planes,
               const int* __restrict__ tri_index, const int* __restrict__ wl,
               const float* __restrict__ went, const int* __restrict__ count,
               const long long* __restrict__ order,
               unsigned long long* __restrict__ counter,
               float* __restrict__ out_tuv, int* __restrict__ out_tri,
               long long* __restrict__ out_stats, int tiles, int tile, int c,
               int g, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const size_t rs = rec_stride(true, g);
  float* s_ray = smem + 2 * rs;               // [8, tile] by live slot
  float* s_best = s_ray + 8 * tile;           // [tile] best t, u, v, id
  float* s_u = s_best + tile;
  float* s_v = s_u + tile;
  int* s_tri = reinterpret_cast<int*>(s_v + tile);
  int* s_idx = s_tri + tile;                  // [tile] slot -> ray
  __shared__ float s_red[2][PB_WARPS];
  __shared__ int s_pos, s_live, s_steps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  zero_padding(smem, rs, g);
  int step = 1;
  for (;;) {
    const int pos = take(counter, step, &s_pos);
    if (pos >= tiles) break;
    if (step > 1 || count[order[pos]] == 0) {
      // count-0 tiles from here on: only their misses
      step = ZERO_CHUNK;
      const int nb = min(ZERO_CHUNK, tiles - pos);
      for (int e = tid; e < nb * tile; e += PB_THREADS) {
        const size_t t = (size_t)order[pos + e / tile];
        write_miss(out_tuv, out_tri, t * tile + e % tile);
      }
      if (STATS && tid < nb) {
        const size_t t = (size_t)order[pos + tid];
        out_stats[2 * t] = 0;
        out_stats[2 * t + 1] = 0;
      }
      __syncthreads();
      continue;
    }
    const size_t t = (size_t)order[pos];
    const int cnt = count[t];
    const size_t row0 = t * tile;
    if (tid == 0) {
      s_live = 0;
      s_steps = cnt;
    }
    __syncthreads();
    // load the tile's rays: the dead ones answer a miss at once and fold
    // into dead_bound, the live ones are compacted
    float dead = neg_inf(), first = neg_inf();
    for (int i0 = 0; i0 < tile; i0 += PB_THREADS) {
      const int i = i0 + tid;
      const bool real = i < tile;
      const Ray r = real ? load_ray(rays, row0 + i) : no_ray();
      const bool live = real && (r.tmin < r.tmax);
      if (real) {
        const float b = min_nan(INF, r.tmax);  // min(best, t_max), best INF
        first = max_nan(first, b);
        if (!live) {
          dead = max_nan(dead, b);
          write_miss(out_tuv, out_tri, row0 + i);
        }
      }
      const int s = warp_append(live, &s_live);
      if (live) {
        put_ray(s_ray, tile, s, r);
        s_idx[s] = i;
        s_best[s] = INF;
        s_u[s] = 0.0f;
        s_v[s] = 0.0f;
        s_tri[s] = 0;
      }
    }
    dead = warp_max_nan(dead);
    first = warp_max_nan(first);
    if (lane == 0) {
      s_red[0][warp] = dead;
      s_red[1][warp] = first;
    }
    __syncthreads();
    const int live_n = s_live;
    float dead_bound = s_red[0][0], bound = s_red[1][0];
    for (int w = 1; w < PB_WARPS; ++w) {
      dead_bound = max_nan(dead_bound, s_red[0][w]);
      bound = max_nan(bound, s_red[1][w]);
    }
    const float* went_t = went + t * c;
    const int* wl_t = wl + t * c;
    int k = 0;
    if (live_n == 0) {
      // no live ray: the bound stays dead_bound, so the steps are counted
      for (int j = tid; j < cnt; j += PB_THREADS)
        if (!(__ldg(went_t + j) < dead_bound)) atomicMin(&s_steps, j);
      __syncthreads();
      k = s_steps;
    } else {
      const int q = team_size(live_n, g);
      const int nt = PB_THREADS / q, team = tid / q, jj = tid & (q - 1);
      const int groups = (g + 3) / 4, pairs = (g + 1) / 2;
      prefetch<true>(planes, tri_index, __ldg(wl_t), g, smem, vec);
      cp_async_commit();
      int cid_n = cnt > 1 ? __ldg(wl_t + 1) : 0;
      float went_k = __ldg(went_t);
      for (; k < cnt; ++k) {
        if (!(went_k < bound)) break;
        const bool more = k + 1 < cnt;
        // step k+1's record while step k tests (speculative)
        if (more) {
          prefetch<true>(planes, tri_index, cid_n, g,
                         smem + ((k + 1) & 1) * rs, vec);
        }
        cp_async_commit();
        const float went_n = more ? __ldg(went_t + k + 1) : 0.0f;
        cid_n = k + 2 < cnt ? __ldg(wl_t + k + 2) : 0;
        cp_async_wait<1>();
        __syncthreads();
        const float* sp = smem + (k & 1) * rs;
        const int* si = reinterpret_cast<const int*>(sp + 36 * groups);
        float contrib = neg_inf();
        for (int base = 0; base < live_n; base += nt) {
          const int s = base + team;
          const bool have = s < live_n;
          const Ray r = have ? slot_ray(s_ray, tile, s) : no_ray();
          float cmin = INF;
          int cidx = g;
          if (have) {
            for (int j = jj; j < pairs; j += q) {
              float t0, t1;
              mt_pair(r, sp, j, t0, t1);
              if (t0 < cmin) {  // this lane's first minimum
                cmin = t0;
                cidx = 2 * j;
              }
              if (t1 < cmin) {
                cmin = t1;
                cidx = 2 * j + 1;
              }
            }
          }
          // the team's first minimum slot: (t, slot) lexicographically
          for (int o = q >> 1; o > 0; o >>= 1) {
            const float ot = __shfl_xor_sync(FULL, cmin, o);
            const int oi = __shfl_xor_sync(FULL, cidx, o);
            if (ot < cmin || (ot == cmin && oi < cidx)) {
              cmin = ot;
              cidx = oi;
            }
          }
          if (have && jj == 0) {
            float best = s_best[s];
            if (cmin < best) {  // a later cluster only if strictly closer
              float u, v;  // the winner's u, v: the same arithmetic again
              mt_slot(r, sp, cidx, u, v);
              best = cmin;
              s_best[s] = cmin;
              s_tri[s] = si[cidx];
              s_u[s] = u + 0.0f;  // as the JAX masked sums: -0.0 -> +0.0
              s_v[s] = v + 0.0f;
            }
            contrib = max_nan(contrib, min_nan(best, r.tmax));
          }
        }
        contrib = warp_max_nan(contrib);
        if (lane == 0) s_red[0][warp] = contrib;
        __syncthreads();
        bound = dead_bound;
        for (int w = 0; w < PB_WARPS; ++w) bound = max_nan(bound, s_red[0][w]);
        went_k = went_n;
      }
      cp_async_wait<0>();
      for (int s = tid; s < live_n; s += PB_THREADS) {
        const size_t ray = row0 + s_idx[s];
        out_tuv[ray * 3 + 0] = s_best[s];
        out_tuv[ray * 3 + 1] = s_u[s];
        out_tuv[ray * 3 + 2] = s_v[s];
        out_tri[ray] = s_tri[s];
      }
    }
    if (STATS && tid == 0) {
      out_stats[2 * t] = k;
      out_stats[2 * t + 1] = (long long)k * live_n * g;
    }
    __syncthreads();
  }
}

template <bool STATS>
__global__ void __launch_bounds__(PB_THREADS, ANY_MIN_CTAS)
any_kernel(const float* __restrict__ rays, const float* __restrict__ planes,
           const int* __restrict__ wl, const int* __restrict__ count,
           const long long* __restrict__ order,
           unsigned long long* __restrict__ counter, int* __restrict__ out_occ,
           long long* __restrict__ out_stats, int tiles, int tile, int c,
           int g, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const size_t rs = rec_stride(false, g);
  float* s_ray = smem + 2 * rs;                               // [8, tile]
  int* s_idx = reinterpret_cast<int*>(s_ray + 8 * tile);      // [tile]
  int* s_act = s_idx + tile;                                  // [2, tile]
  __shared__ int s_pos, s_live, s_next[2];
  __shared__ unsigned long long s_sum;
  const int tid = threadIdx.x, lane = tid & 31;
  zero_padding(smem, rs, g);
  int step = 1;
  for (;;) {
    const int pos = take(counter, step, &s_pos);
    if (pos >= tiles) break;
    if (step > 1 || count[order[pos]] == 0) {
      step = ZERO_CHUNK;
      const int nb = min(ZERO_CHUNK, tiles - pos);
      for (int e = tid; e < nb * tile; e += PB_THREADS) {
        const size_t t = (size_t)order[pos + e / tile];
        out_occ[t * tile + e % tile] = 0;
      }
      if (STATS && tid < nb) {
        const size_t t = (size_t)order[pos + tid];
        out_stats[2 * t] = 0;
        out_stats[2 * t + 1] = 0;
      }
      __syncthreads();
      continue;
    }
    const size_t t = (size_t)order[pos];
    const int cnt = count[t];
    const size_t row0 = t * tile;
    if (tid == 0) {
      s_live = 0;
      s_next[0] = 0;
      s_sum = 0ull;
    }
    __syncthreads();
    // dead rays (padding included) are never occluded: they answer 0 at
    // once and only keep the tile walking to the end of its list
    bool dead_here = false;
    for (int i0 = 0; i0 < tile; i0 += PB_THREADS) {
      const int i = i0 + tid;
      const bool real = i < tile;
      const Ray r = real ? load_ray(rays, row0 + i) : no_ray();
      const bool live = real && (r.tmin < r.tmax);
      if (real && !live) {
        dead_here = true;
        out_occ[row0 + i] = 0;
      }
      const int s = warp_append(live, &s_live);
      if (live) {
        put_ray(s_ray, tile, s, r);
        s_idx[s] = i;
        s_act[s] = s;
      }
    }
    const bool has_dead = __syncthreads_or(dead_here);
    const int* wl_t = wl + t * c;
    int walking = s_live, cur = 0, k = 0;
    unsigned long long tests = 0ull;
    if (walking > 0) {
      prefetch<false>(planes, nullptr, __ldg(wl_t), g, smem, vec);
      cp_async_commit();
    }
    int cid_n = cnt > 1 ? __ldg(wl_t + 1) : 0;
    for (; k < cnt && walking > 0; ++k) {
      const bool more = k + 1 < cnt;
      if (more) {
        prefetch<false>(planes, nullptr, cid_n, g, smem + ((k + 1) & 1) * rs,
                        vec);
      }
      cp_async_commit();
      cid_n = k + 2 < cnt ? __ldg(wl_t + k + 2) : 0;
      cp_async_wait<1>();
      __syncthreads();
      if (tid == 0) s_next[(k + 1) & 1] = 0;  // read by all before this step
      const float* sp = smem + (k & 1) * rs;
      const int* act = s_act + cur * tile;
      int* nxt = s_act + (cur ^ 1) * tile;
      const int q = team_size(walking, g);
      const int nt = PB_THREADS / q, team = tid / q, jj = tid & (q - 1);
      const int pairs = (g + 1) / 2;
      const unsigned qmask = q == 32 ? FULL : (1u << q) - 1u;
      for (int base = 0; base < walking; base += nt) {
        const int s = base + team;
        const bool have = s < walking;
        const int slot = have ? act[s] : 0;
        const Ray r = have ? slot_ray(s_ray, tile, slot) : no_ray();
        bool found = false;
        int first = g;
        for (int c0 = 0; c0 < pairs; c0 += q) {
          const int j = c0 + jj;
          float t0 = INF, t1 = INF;
          if (have && j < pairs) mt_pair(r, sp, j, t0, t1);
          const int shift = lane & ~(q - 1);
          const unsigned b =
              (__ballot_sync(FULL, t0 < INF || t1 < INF) >> shift) & qmask;
          const unsigned b0 = (__ballot_sync(FULL, t0 < INF) >> shift) & qmask;
          if (b && !found) {  // the team's first hit slot
            const int at = __ffs(b) - 1;
            found = true;
            first = 2 * (c0 + at) + ((b0 >> at) & 1u ? 0 : 1);
          }
          if (__all_sync(FULL, found || !have)) break;
        }
        const bool lead = have && jj == 0;
        if (STATS && lead) tests += found ? first + 1 : g;
        if (lead && found) out_occ[row0 + s_idx[slot]] = 1;
        const int at = warp_append(lead && !found, &s_next[k & 1]);
        if (lead && !found) nxt[at] = slot;
      }
      __syncthreads();
      walking = s_next[k & 1];
      cur ^= 1;
    }
    // every live ray occluded: JAX's tile still walks to the end of its
    // list if it holds a dead ray
    if (walking == 0 && has_dead) k = cnt;
    cp_async_wait<0>();
    const int* act = s_act + cur * tile;
    for (int s = tid; s < walking; s += PB_THREADS)
      out_occ[row0 + s_idx[act[s]]] = 0;
    if (STATS) {
      for (int o = 16; o > 0; o >>= 1)
        tests += __shfl_xor_sync(FULL, tests, o);
      if (lane == 0 && tests) atomicAdd(&s_sum, tests);
      __syncthreads();
      if (tid == 0) {
        out_stats[2 * t] = k;
        out_stats[2 * t + 1] = (long long)s_sum;
      }
    }
    __syncthreads();
  }
}

// The persistent grid: every SM's resident CTAs, no more than the tiles.
// The shared-memory attribute (set to the kernel's largest size), the SM
// count and the occupancy query run once per (device, kernel, shared
// bytes); later launches read the cached CTA count.
struct GridEntry {
  int dev;
  const void* fn;
  size_t smem;
  int ctas;
};
constexpr int GRID_CACHE = 64;
GridEntry g_grids[GRID_CACHE];
int g_n_grids = 0;
std::mutex g_grid_mu;

template <typename K>
int resident_ctas(K kernel, int threads, size_t smem, size_t max_smem,
                  int* ctas_out) {
  int dev = 0, ctas = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const void* fn = (const void*)kernel;
  {
    std::lock_guard<std::mutex> lock(g_grid_mu);
    for (int e = 0; e < g_n_grids && !ctas; ++e)
      if (g_grids[e].dev == dev && g_grids[e].fn == fn &&
          g_grids[e].smem == smem)
        ctas = g_grids[e].ctas;
  }
  if (!ctas) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    ctas = sms * per_sm;
    std::lock_guard<std::mutex> lock(g_grid_mu);
    if (g_n_grids < GRID_CACHE) g_grids[g_n_grids++] = {dev, fn, smem, ctas};
  }
  *ctas_out = ctas;
  return 0;
}

size_t phase_b_bytes(bool closest, int tile, int g) {
  return phase_b_floats(closest, tile, g) * sizeof(float);
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

// The phase A kernel's build for c clusters.
using MaskKernel = void (*)(const float*, const float*, const float*,
                            unsigned char*, float*, int, int, int);
MaskKernel mask_fn(int c) {
  return c > MASK_THREADS ? mask_kernel<MASK_MIN_CTAS_LARGE>
                          : mask_kernel<MASK_MIN_CTAS_SMALL>;
}

int kernel_resources(const void* fn, int threads, size_t dyn, size_t max_dyn,
                     int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_dyn);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, threads,
                                                      dyn);
  out[1] = attr.numRegs;
  out[2] = threads;
  out[3] = (int)(attr.sharedSizeBytes + dyn);
  out[4] = (int)attr.localSizeBytes;
  return (int)err;
}

}  // namespace

extern "C" {

int cluster_mask(const float* rays, const float* aabb_lo,
                 const float* aabb_hi, unsigned char* mask, float* entry,
                 int tiles, int tile, int c, void* stream) {
  if (tiles <= 0 || c <= 0) return 0;
  if (tile < 1 || tile > MAX_SIZE) return (int)cudaErrorInvalidValue;
  const size_t smem = mask_bytes(tile, c);
  const int tpc = mask_shape(tile, c).tpc;
  int ctas = 0;
  const auto fn = mask_fn(c);
  const int err = resident_ctas(fn, MASK_THREADS, smem,
                                mask_bytes(MAX_SIZE, 1), &ctas);
  if (err) return err;
  fn<<<min(ctas, (tiles + tpc - 1) / tpc), MASK_THREADS, smem,
       (cudaStream_t)stream>>>(rays, aabb_lo, aabb_hi, mask, entry, tiles,
                               tile, c);
  return (int)cudaGetLastError();
}

// order: [tiles] int64, the tiles busiest first; counter: one zeroed
// uint64, the next position of order to take.  out_stats: null, or
// [tiles, 2] int64 (steps, tests) from the stats build.
int cluster_closest(const float* rays, const float* planes,
                    const int* tri_index, const int* wl, const float* went,
                    const int* count, const long long* order,
                    unsigned long long* counter, float* out_tuv,
                    int* out_tri, long long* out_stats, int tiles, int tile,
                    int c, int g, void* stream) {
  if (tiles <= 0) return 0;
  if (tile > MAX_SIZE || g > MAX_SIZE) return (int)cudaErrorInvalidValue;
  const bool vec = g % 4 == 0 && aligned16(planes) && aligned16(tri_index);
  const size_t smem = phase_b_bytes(true, tile, g);
  const size_t max_smem = phase_b_bytes(true, MAX_SIZE, MAX_SIZE);
  const auto fn = out_stats ? closest_kernel<true> : closest_kernel<false>;
  int ctas = 0;
  const int err = resident_ctas(fn, PB_THREADS, smem, max_smem, &ctas);
  if (err) return err;
  fn<<<min(ctas, tiles), PB_THREADS, smem, (cudaStream_t)stream>>>(
      rays, planes, tri_index, wl, went, count, order, counter, out_tuv,
      out_tri, out_stats, tiles, tile, c, g, vec);
  return (int)cudaGetLastError();
}

int cluster_any(const float* rays, const float* planes, const int* wl,
                const int* count, const long long* order,
                unsigned long long* counter, int* out_occ,
                long long* out_stats, int tiles, int tile, int c, int g,
                void* stream) {
  if (tiles <= 0) return 0;
  if (tile > MAX_SIZE || g > MAX_SIZE) return (int)cudaErrorInvalidValue;
  const bool vec = g % 4 == 0 && aligned16(planes);
  const size_t smem = phase_b_bytes(false, tile, g);
  const size_t max_smem = phase_b_bytes(false, MAX_SIZE, MAX_SIZE);
  const auto fn = out_stats ? any_kernel<true> : any_kernel<false>;
  int ctas = 0;
  const int err = resident_ctas(fn, PB_THREADS, smem, max_smem, &ctas);
  if (err) return err;
  fn<<<min(ctas, tiles), PB_THREADS, smem, (cudaStream_t)stream>>>(
      rays, planes, wl, count, order, counter, out_occ, out_stats, tiles,
      tile, c, g, vec);
  return (int)cudaGetLastError();
}

// out[0..4]: resident CTAs per SM, registers per thread, threads per CTA,
// shared memory per CTA (static + dynamic) and local (spilled) bytes per
// thread of the phase A kernel at `tile` rays a tile and `c` clusters.
int cluster_mask_resources(int tile, int c, int* out) {
  if (tile < 1 || tile > MAX_SIZE || c < 1) return (int)cudaErrorInvalidValue;
  return kernel_resources((const void*)mask_fn(c), MASK_THREADS,
                          mask_bytes(tile, c), mask_bytes(MAX_SIZE, 1), out);
}

// The same for kernel `which` (0 mask, 1 closest, 2 any; the builds
// without stats) at `size` rays a tile and triangles (mask: clusters) a
// cluster.
int cluster_resources(int which, int size, int* out) {
  if (which == 0) return cluster_mask_resources(size, size, out);
  const void* fn = which == 1 ? (const void*)closest_kernel<false>
                              : (const void*)any_kernel<false>;
  return kernel_resources(fn, PB_THREADS, phase_b_bytes(which == 1, size, size),
                          phase_b_bytes(which == 1, MAX_SIZE, MAX_SIZE), out);
}

}  // extern "C"
