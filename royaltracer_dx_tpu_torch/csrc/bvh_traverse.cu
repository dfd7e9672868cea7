// LBVH traversal kernels for Hopper (sm_90a): closest hit and any hit, one
// ray per thread on persistent warps that pack live lanes.
//
// Replaces the lock-step lax.while_loop walks of the JAX package (they are
// XLA loops, not Pallas kernels):
//   bvh_closest  <- royaltracer_dx_tpu/ops/traverse.py::closest_hit_bvh
//                   (:117-233, while_loop :224)
//   bvh_any      <- royaltracer_dx_tpu/ops/traverse.py::any_hit_bvh
//                   (:236-329, while_loop :328)
// and holds bit for bit to their plain PyTorch versions in
// ops/traverse.py (_closest_plain / _any_plain), which repeat the JAX walk
// with one change of work, not of answers: an empty box (a node over
// padding leaves only, stored as 1e30 | -1e30) is missed, where the JAX
// slab test reads it as an infinite slab and walks every padding subtree.
//
// The tree (ops/bvh.py): heap nodes k in [1, 2P) as 6-float rows (min |
// max), leaves [P, 2P), leaf j holding sorted triangles [j*ls, (j+1)*ls) as
// 9 floats each, perm mapping a sorted slot to its original triangle id.
// Child links are 2k; the skip link strips k's trailing ones and steps to
// the sibling.  The S = min(256, P) subtree roots are heap ids [S, 2S).
//
// What bounds them on this card.  A lane's walk is a chain of dependent
// 24-byte node loads (L2 hits: sponza's 6.3 MB of nodes do not fit an
// SM's L1) and slab tests, divergent across a warp; bvh_work's yardstick
// (24 FP32 operations a slab test, 52 a triangle test, the top-tree tests
// of one root scan a live closest lane, over 67 TFLOP/s) puts it at a
// tenth of a millisecond or more for each sponza batch (PERF.md).  What
// kept the first, per-thread walk far from that: root scans
// that lanes start at different iterations (a warp then runs them one
// after another, 256 slab tests each), too few resident warps to hide the
// load chain, and warps that hold their slot until their slowest lane
// ends while dead lanes idle in them.  The design:
//
//   * Persistent CTAs (SMs x resident CTAs).  A warp takes 32 rays at a
//     time from a global counter (the wrapper's zeroed scratch), answers
//     dead lanes at once and queues the live ones in shared memory; its
//     lanes walk queued rays only.  Once REFILL of its lanes are idle it
//     hands them new rays (dynamic fetch).  bvh_closest refills whole
//     warps (REFILL = 32), so that the 32 lanes' root scans run in lock
//     step; bvh_any, which has no scan, refills at 8 idle lanes.
//   * bvh_closest stages the top tree (heap ids [1, 2S): the S roots and
//     their ancestors, 6 planes of 2S floats) once per CTA in shared
//     memory and scans the roots once per lane, by a left-first DFS of
//     that tree that skips the roots under a missed internal box, into a
//     sorted list of at most ROOT_CAP (entry, root) pairs in shared
//     memory (floats and bytes, strided by the CTA's threads) of the
//     roots entered before the lane's t_max.  Only a lane whose list was
//     cut and is used up scans again, for the next ROOT_CAP after the
//     last one taken and before its best t.  ROOT_CAP = 24 holds the
//     roots nearly every sponza ray enters; chip_smoke.py prints the
//     scan's slab tests a lane (a sponza primary ray: ~75 of the 511).
//   * While-while walks: a step takes the next root (closest) when the
//     lane has no node, descends until a leaf is hit or the walk leaves
//     the subtree, then tests the leaf; lanes test their leaves together
//     and no iteration counter is kept.
//   * 512-thread CTAs: 2 an SM at <= 64 registers for closest (32 warps
//     an SM, no spills), 3 an SM at <= 40 registers for any hit (48
//     warps).  min.NaN / max.NaN give the NaN-propagating minimum and
//     maximum in one instruction.
//   Measured and left out (tools/bvh_study.py on sponza's batches): any
//   hit at 4 CTAs and 32 registers (it spills), staging the tree's top
//   1,023 nodes in shared memory for any hit (it takes L1 from the walk),
//   node rows padded to 32 bytes, closest refills at 16 or 24 idle lanes,
//   ROOT_CAP 16 and 32, a linear scan of the S root boxes, and taking
//   128-512 rays per counter update.
//
// Why the closest answers are unchanged.  The JAX walk takes the subtrees
// in stable (entry, root index) order with missed roots keyed 1e30, takes
// a root only while its entry is below the running best t, walks a
// subtree left-first along the skip links testing each box against the
// running best t, and lets a later leaf win only if strictly closer.  The
// scan visits the roots in index order and inserts an entry behind equal
// ones, so the list is in that order; a root whose entry is not below
// t_max can never be taken (the best t only falls), and a rescan starts
// after the last one taken, so the lane takes exactly the JAX roots.  The
// DFS skips only roots that cannot qualify: a root entered before limit
// within [t_min, t_max] is hit within [t_min, limit], and so is each of
// its ancestors, whose boxes hold it (the monotonicity argument below).  The
// JAX iteration (a transition, at most 4 descend steps, the leaf phase)
// changes nothing while the best t is at most 1e30: every event happens in
// the same order with the same best t.  Above 1e30 (t_max > 1e30 only) the
// leaf phase without a parked leaf sets t = 1e30 and slot 0 (the JAX
// quirk), so such a lane keeps the 4-step window until its best t falls
// to 1e30 or below, and an exhausted transition still ends in that leaf
// phase.  The iteration cap 4P + 4S + 64 never binds: with a non-NaN
// t_max every iteration but the last tests at least one node, a DFS tests
// a node at most once, the subtrees are disjoint, so a lane runs at most
// 2P - S + 1 iterations.  A lane with a NaN t_max never resolves a
// transition and misses after max_iters of them; a lane with t_max <=
// t_min (and t_max <= 1e30) misses after one.  The arithmetic keeps the
// plain version's operation order (-fmad=false, IEEE division).
//
// bvh_any answers a boolean, which does not depend on the order in which
// leaves are visited, so it walks the whole tree from the root in DFS
// order along the same links and stops at the first confirmed hit.  Every
// leaf the JAX walk tests is tested here too: a parent's box holds its
// children's exactly, and the slab test's rounded subtract and multiply are
// monotone, so a box hit implies its ancestors' boxes hit; the empty boxes
// of padding-only subtrees are missed by both walks.  A DFS visits each
// node at most once, so the cap (4P + 4S + 64 > 2P) never binds.  Lanes
// with t_max <= t_min (or a NaN bound) are never occluded.
//
// Stats (the STATS instantiation, [N, 3] int32): node slab tests of the
// walk, triangle tests, root transitions (closest: as the plain version
// counts them, lane for lane; any: its own DFS, third column 0).  With
// stats, counters[1] sums the slab tests of the closest kernel's root
// scans.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CLOSEST_CTAS = 2;     // resident CTAs an SM at <= 64 registers
constexpr int ANY_CTAS = 3;         // at <= 40 registers
// a warp hands rays to its idle lanes once this many of its 32 are idle
constexpr int CLOSEST_REFILL = 32;
constexpr int ANY_REFILL = 8;
constexpr int ROOT_CAP = 24;        // (entry, root) pairs a closest lane keeps
constexpr int QUEUE = 64;           // live lane indices a warp can queue
constexpr int MAX_ROOTS = 256;
constexpr int DESCEND_SUBSTEPS = 4;
constexpr float INF_F = 1e30f;
constexpr float DET_EPS = 1e-12f;
constexpr unsigned FULL = 0xffffffffu;

// NaN-propagating min / max (torch.minimum / torch.maximum semantics)
__device__ __forceinline__ float nmin(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float safe_inv(float d) {
  return fabsf(d) > 1e-20f ? 1.0f / d : (d >= 0.0f ? 1e20f : -1e20f);
}

struct Ray {
  float o[3], d[3], inv[3], tmin, tmax;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        int i) {
  const float4* q = reinterpret_cast<const float4*>(rays + (size_t)i * 8);
  float4 a = __ldg(q), b = __ldg(q + 1);
  Ray r;
  r.o[0] = a.x; r.o[1] = a.y; r.o[2] = a.z;
  r.d[0] = a.w; r.d[1] = b.x; r.d[2] = b.y;
  r.tmin = b.z; r.tmax = b.w;
#pragma unroll
  for (int c = 0; c < 3; ++c) r.inv[c] = safe_inv(r.d[c]);
  return r;
}

// (hit, t_enter) of the slab test of box (min | max) (traverse.py:66-74);
// the caller checks emptiness
__device__ __forceinline__ bool slab_test(const float lo_b[3],
                                          const float hi_b[3], const Ray& r,
                                          float t_lo, float t_hi,
                                          float* t_enter) {
  float lo[3], hi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float t0 = (lo_b[c] - r.o[c]) * r.inv[c];
    float t1 = (hi_b[c] - r.o[c]) * r.inv[c];
    lo[c] = nmin(t0, t1);
    hi[c] = nmax(t0, t1);
  }
  float te = nmax(nmax(nmax(lo[0], lo[1]), lo[2]), t_lo);
  float tx = nmin(nmin(nmin(hi[0], hi[1]), hi[2]), t_hi);
  *t_enter = te;
  return te <= tx;
}

// node k's row as three 8-byte loads; an empty box is missed
__device__ __forceinline__ bool slab_node(const float* __restrict__ nodes,
                                          int k, const Ray& r, float t_lo,
                                          float t_hi) {
  const float2* row = reinterpret_cast<const float2*>(nodes + (size_t)k * 6);
  float2 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
  float lo[3] = {a.x, a.y, b.x}, hi[3] = {b.y, c.x, c.y};
  float te;
  return slab_test(lo, hi, r, t_lo, t_hi, &te) && a.x <= b.y;
}

// skip(k): strip the trailing ones of k, then step to the sibling; 0 past
// the root (traverse.py:52-57)
__device__ __forceinline__ int skip_link(int node) {
  int anc = (int)((uint32_t)node >> (__ffs(node + 1) - 1));
  return anc <= 1 ? 0 : anc + 1;
}

// skip(k) inside the subtree of a root in [S, 2S), 0 once it leaves: the
// ancestor reached is a strict descendant of the root exactly when its id
// is >= 2S (traverse.py:178-179)
__device__ __forceinline__ int skip_in_subtree(int node, int s) {
  int anc = (int)((uint32_t)node >> (__ffs(node + 1) - 1));
  return anc >= 2 * s ? anc + 1 : 0;
}

// Moller-Trumbore against sorted triangle `slot`, in the plain version's
// operation order (traverse.py:183-205)
__device__ __forceinline__ bool mt(const float* __restrict__ tris, int slot,
                                   const Ray& r, float t_hi, float* t_out,
                                   float* u_out, float* v_out) {
  const float* q9 = tris + (size_t)slot * 9;
  float v0x = __ldg(q9 + 0), v0y = __ldg(q9 + 1), v0z = __ldg(q9 + 2);
  float e1x = __ldg(q9 + 3) - v0x, e1y = __ldg(q9 + 4) - v0y;
  float e1z = __ldg(q9 + 5) - v0z;
  float e2x = __ldg(q9 + 6) - v0x, e2y = __ldg(q9 + 7) - v0y;
  float e2z = __ldg(q9 + 8) - v0z;
  float dx = r.d[0], dy = r.d[1], dz = r.d[2];
  float px = dy * e2z - dz * e2y;
  float py = dz * e2x - dx * e2z;
  float pz = dx * e2y - dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  bool okd = fabsf(det) > DET_EPS;
  float inv_det = okd ? 1.0f / det : 0.0f;
  float tx = r.o[0] - v0x, ty = r.o[1] - v0y, tz = r.o[2] - v0z;
  float uu = (tx * px + ty * py + tz * pz) * inv_det;
  float qx = ty * e1z - tz * e1y;
  float qy = tz * e1x - tx * e1z;
  float qz = tx * e1y - ty * e1x;
  float vv = (dx * qx + dy * qy + dz * qz) * inv_det;
  float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  *t_out = t;
  *u_out = uu;
  *v_out = vv;
  return okd && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
         t > r.tmin && t < t_hi;
}

// The persistent warp loop.  Each lane walks one ray at a time with
// walk.start(i), walk.step() (true once the walk has ended) and
// walk.finish(i).  Once at least REFILL of the warp's 32 lanes are idle,
// the warp tops up its queue -- 32 rays at a time from counters[0], each
// dead lane answered at once with dead(i, tmin, tmax), the live ones
// queued -- and hands queued rays to its idle lanes.  REFILL = 32 refills
// whole warps only.
template <int REFILL, typename IsLive, typename Dead, typename Walk>
__device__ __forceinline__ void warp_loop(const float* __restrict__ rays,
                                          int n,
                                          unsigned long long* counters,
                                          int* queue, IsLive is_live,
                                          Dead dead, Walk& walk) {
  const int lane = threadIdx.x & 31;
  int qn = 0, ray = -1;
  bool drained = false;
  for (;;) {
    unsigned idle = __ballot_sync(FULL, ray < 0);
    int n_idle = __popc(idle);
    if (n_idle >= REFILL) {
      while (qn < n_idle && !drained) {
        unsigned long long base = 0;
        if (lane == 0) base = atomicAdd(counters, 32ull);
        base = __shfl_sync(FULL, base, 0);
        if (base >= (unsigned long long)n) {
          drained = true;
          break;
        }
        int i = (int)base + lane;
        bool ok = false;
        if (i < n) {
          float2 tb = __ldg(reinterpret_cast<const float2*>(
              rays + (size_t)i * 8 + 6));
          ok = is_live(tb.x, tb.y);
          if (!ok) dead(i, tb.x, tb.y);
        }
        unsigned m = __ballot_sync(FULL, ok);
        if (ok) queue[qn + __popc(m & ((1u << lane) - 1u))] = i;
        qn += __popc(m);
        __syncwarp();
      }
      if (qn == 0 && n_idle == 32) break;
      int take = min(qn, n_idle);
      int rank = __popc(idle & ((1u << lane) - 1u));
      bool fresh = ray < 0 && rank < take;
      if (fresh) ray = queue[qn - 1 - rank];
      qn -= take;
      __syncwarp();
      if (fresh) walk.start(ray);
    }
    if (ray >= 0 && walk.step()) {
      walk.finish(ray);
      ray = -1;
    }
  }
}

// The capped sorted root list of a lane: ROOT_CAP keys and root indices
// in shared memory, entry e at e * THREADS from the lane's base.
struct RootList {
  float* key;
  unsigned char* idx;
};

// Scan the S roots in index order: a left-first DFS of the staged top
// tree (heap ids [1, 2S), 6 planes of 2S floats), which skips the roots
// under an internal box that the ray misses within [t_min, limit] (their
// boxes lie inside it, so none of them can be entered before limit; a
// limit above 1e30 keys missed roots too, so then nothing is skipped).
// Keep the roots entered before `limit` and after (after_k, after_j) in
// (entry, index) order, the ROOT_CAP smallest of them sorted in the list
// (an entry goes behind equal ones: its index is larger).  Returns how
// many qualified; adds the slab tests made to *tests.
__device__ __forceinline__ int root_scan(const float* __restrict__ top,
                                         int s, const Ray& r, float after_k,
                                         int after_j, float limit,
                                         RootList lst, unsigned* tests) {
  const int n2 = 2 * s;
  const bool prune = limit <= INF_F;
  int count = 0;
  for (int node = 1; node > 0;) {
    float lo[3] = {top[node], top[n2 + node], top[2 * n2 + node]};
    float hi[3] = {top[3 * n2 + node], top[4 * n2 + node],
                   top[5 * n2 + node]};
    float te;
    ++*tests;
    if (node < s) {
      bool hit = !prune || slab_test(lo, hi, r, r.tmin, limit, &te);
      node = hit ? 2 * node : skip_link(node);
      continue;
    }
    int j = node - s;
    node = skip_link(node);
    // an empty box is staged as NaN, which misses
    float key = slab_test(lo, hi, r, r.tmin, r.tmax, &te) ? te : INF_F;
    if (key < limit && (key > after_k || (key == after_k && j > after_j))) {
      int pos = count < ROOT_CAP ? count
                : key < lst.key[(ROOT_CAP - 1) * THREADS] ? ROOT_CAP - 1
                                                          : -1;
      ++count;
      if (pos >= 0) {
        for (; pos > 0 && lst.key[(pos - 1) * THREADS] > key; --pos) {
          lst.key[pos * THREADS] = lst.key[(pos - 1) * THREADS];
          lst.idx[pos * THREADS] = lst.idx[(pos - 1) * THREADS];
        }
        lst.key[pos * THREADS] = key;
        lst.idx[pos * THREADS] = (unsigned char)j;
      }
    }
  }
  return count;
}

// A closest-hit lane's walk: start() scans the roots, each step() takes
// the next root if the lane has no node (or ends the walk), descends to
// the next hit leaf and tests it; finish() writes the answer.
template <bool STATS>
struct ClosestWalk {
  const float* rays;
  const float* nodes;
  const float* tris;
  const int* perm;
  const float* top;
  RootList lst;
  float* out_tuv;
  int* out_tri;
  int* out_stats;
  int p, ls, s;
  unsigned root_tests;
  Ray r;
  float t_best, bu, bv, last_k;
  int tri, n_nodes, n_tris, n_roots, count, len, head, taken, last_j, node;

  __device__ __forceinline__ void start(int i) {
    r = load_ray(rays, i);
    t_best = r.tmax;
    tri = -1;
    bu = bv = 0.0f;
    n_nodes = n_tris = n_roots = 0;
    count = root_scan(top, s, r, -INFINITY, -1, t_best, lst, &root_tests);
    len = min(count, ROOT_CAP);
    head = taken = 0;
    last_k = -INFINITY;
    last_j = -1;
    node = 0;
  }

  // the JAX quirk: the leaf phase without a parked leaf turns a t_best
  // above 1e30 into 1e30 with slot 0's u, v
  __device__ __forceinline__ void quirk() {
    float t, uu, vv;
    mt(tris, 0, r, t_best, &t, &uu, &vv);
    t_best = INF_F;
    tri = 0;
    bu = uu;
    bv = vv;
  }

  __device__ __forceinline__ bool step() {
    if (node == 0) {
      // the next root in (entry, index) order, unless it is not entered
      // before t_best (then none is)
      if (taken == s) return true;
      ++n_roots;
      if (head == len && count > len) {
        count = root_scan(top, s, r, last_k, last_j, t_best, lst,
                          &root_tests);
        len = min(count, ROOT_CAP);
        head = 0;
      }
      float key = head < len ? lst.key[head * THREADS] : INFINITY;
      if (!(key < t_best)) {
        // exhausted; the JAX iteration still ends in its leaf phase
        if (t_best > INF_F) quirk();
        return true;
      }
      last_k = key;
      last_j = lst.idx[head * THREADS];
      ++head;
      ++taken;
      node = s + last_j;
    }
    // descend to the next hit leaf; while t_best is above 1e30 the JAX
    // iteration's window of DESCEND_SUBSTEPS steps decides where the quirk
    // fires
    int budget = t_best > INF_F ? DESCEND_SUBSTEPS : 0x7fffffff;
    int pending = 0;
    for (int k = 0; node > 0 && k < budget; ++k) {
      bool hit = slab_node(nodes, node, r, r.tmin, t_best);
      bool leaf = node >= p;
      int cur = node;
      node = (hit && !leaf) ? 2 * node : skip_in_subtree(node, s);
      ++n_nodes;
      if (leaf && hit) {
        pending = cur;
        break;
      }
    }
    // leaf phase: first minimum lane, a leaf wins only if strictly closer
    if (pending > 0) {
      int base = (pending - p) * ls;
      float tc = INF_F, uc = 0.0f, vc = 0.0f;
      int best_l = 0;
      for (int l = 0; l < ls; ++l) {
        float t, uu, vv;
        bool ok = mt(tris, base + l, r, t_best, &t, &uu, &vv);
        float tt = ok ? t : INF_F;
        if (l == 0 || tt < tc) {
          tc = tt;
          uc = uu;
          vc = vv;
          best_l = l;
        }
      }
      n_tris += ls;
      if (tc < t_best) {
        t_best = tc;
        tri = base + best_l;
        bu = uc;
        bv = vc;
      }
    } else if (t_best > INF_F) {
      quirk();
    }
    return false;
  }

  __device__ __forceinline__ void finish(int i) {
    bool found = tri >= 0;
    out_tuv[(size_t)i * 3 + 0] = found ? t_best : INF_F;
    out_tuv[(size_t)i * 3 + 1] = bu;
    out_tuv[(size_t)i * 3 + 2] = bv;
    out_tri[i] = found ? __ldg(perm + tri) : 0;
    if (STATS) {
      out_stats[(size_t)i * 3 + 0] = n_nodes;
      out_stats[(size_t)i * 3 + 1] = n_tris;
      out_stats[(size_t)i * 3 + 2] = n_roots;
    }
  }
};

__host__ __device__ constexpr size_t closest_smem(int s) {
  return (size_t)12 * s * 4 + (size_t)ROOT_CAP * THREADS * 4 +
         (size_t)WARPS * QUEUE * 4 + (size_t)ROOT_CAP * THREADS;
}

template <bool STATS>
__global__ void __launch_bounds__(THREADS, CLOSEST_CTAS)
bvh_closest_kernel(const float* rays,
                   const float* nodes,
                   const float* tris,
                   const int* perm, float* out_tuv,
                   int* out_tri, int* out_stats,
                   unsigned long long* counters, int n, int p, int ls, int s,
                   int max_iters) {
  extern __shared__ float4 smem4[];
  float* top = reinterpret_cast<float*>(smem4);        // 6 planes of 2s
  float* keys = top + 12 * s;                            // ROOT_CAP x THREADS
  int* queues = reinterpret_cast<int*>(keys + ROOT_CAP * THREADS);
  unsigned char* idx = reinterpret_cast<unsigned char*>(queues + WARPS * QUEUE);
  // stage the top tree's boxes as planes; an empty box (min > max) as NaN
  for (int e = threadIdx.x; e < 12 * s; e += THREADS) {
    int c = e / (2 * s), k = e - c * 2 * s;
    const float* row = nodes + (size_t)k * 6;
    top[e] = __ldg(row) <= __ldg(row + 3) ? __ldg(row + c) : NAN;
  }
  __syncthreads();
  ClosestWalk<STATS> walk;
  walk.rays = rays;
  walk.nodes = nodes;
  walk.tris = tris;
  walk.perm = perm;
  walk.top = top;
  walk.lst = RootList{keys + threadIdx.x, idx + threadIdx.x};
  walk.out_tuv = out_tuv;
  walk.out_tri = out_tri;
  walk.out_stats = out_stats;
  walk.p = p;
  walk.ls = ls;
  walk.s = s;
  walk.root_tests = 0;
  warp_loop<CLOSEST_REFILL>(
      rays, n, counters, queues + (threadIdx.x >> 5) * QUEUE,
      // a NaN t_max never resolves a transition; t_max <= t_min (and <=
      // 1e30) keys every root at or past t_max: both miss at once
      [](float tmin, float tmax) {
        return tmax == tmax && !(tmax <= tmin && tmax <= INF_F);
      },
      [&](int i, float, float tmax) {
        out_tuv[(size_t)i * 3 + 0] = INF_F;
        out_tuv[(size_t)i * 3 + 1] = 0.0f;
        out_tuv[(size_t)i * 3 + 2] = 0.0f;
        out_tri[i] = 0;
        if (STATS) {
          out_stats[(size_t)i * 3 + 0] = 0;
          out_stats[(size_t)i * 3 + 1] = 0;
          out_stats[(size_t)i * 3 + 2] = tmax == tmax ? 1 : max_iters;
        }
      },
      walk);
  if (STATS) {
    unsigned sum = __reduce_add_sync(FULL, walk.root_tests);
    if ((threadIdx.x & 31) == 0 && sum)
      atomicAdd(counters + 1, (unsigned long long)sum);
  }
}

// An any-hit lane's walk: left-first DFS from the root; each step()
// descends to the next hit leaf and tests its triangles up to the first
// confirmed hit.
template <bool STATS>
struct AnyWalk {
  const float* rays;
  const float* nodes;
  const float* tris;
  int* out_occ;
  int* out_stats;
  int p, ls;
  Ray r;
  int node, n_nodes, n_tris;
  bool occ;

  __device__ __forceinline__ void start(int i) {
    r = load_ray(rays, i);
    node = 1;
    n_nodes = n_tris = 0;
    occ = false;
  }

  __device__ __forceinline__ bool step() {
    int leaf = 0;
    while (node > 0) {
      bool hit = slab_node(nodes, node, r, r.tmin, r.tmax);
      bool is_leaf = node >= p;
      int cur = node;
      node = (hit && !is_leaf) ? 2 * node : skip_link(node);
      ++n_nodes;
      if (is_leaf && hit) {
        leaf = cur;
        break;
      }
    }
    if (leaf > 0) {
      int base = (leaf - p) * ls;
      for (int l = 0; l < ls && !occ; ++l) {
        float t, uu, vv;
        occ = mt(tris, base + l, r, r.tmax, &t, &uu, &vv);
        ++n_tris;
      }
    }
    return occ || node == 0;
  }

  __device__ __forceinline__ void finish(int i) {
    out_occ[i] = occ ? 1 : 0;
    if (STATS) {
      out_stats[(size_t)i * 3 + 0] = n_nodes;
      out_stats[(size_t)i * 3 + 1] = n_tris;
      out_stats[(size_t)i * 3 + 2] = 0;
    }
  }
};

__host__ __device__ constexpr size_t any_smem() {
  return (size_t)WARPS * QUEUE * 4;
}

template <bool STATS>
__global__ void __launch_bounds__(THREADS, ANY_CTAS)
bvh_any_kernel(const float* __restrict__ rays,
               const float* __restrict__ nodes,
               const float* __restrict__ tris, int* __restrict__ out_occ,
               int* __restrict__ out_stats, unsigned long long* counters,
               int n, int p, int ls) {
  extern __shared__ int queues[];
  AnyWalk<STATS> walk;
  walk.rays = rays;
  walk.nodes = nodes;
  walk.tris = tris;
  walk.out_occ = out_occ;
  walk.out_stats = out_stats;
  walk.p = p;
  walk.ls = ls;
  warp_loop<ANY_REFILL>(
      rays, n, counters, queues + (threadIdx.x >> 5) * QUEUE,
      [](float tmin, float tmax) { return tmax > tmin; },
      [&](int i, float, float) {
        out_occ[i] = 0;
        if (STATS) {
          out_stats[(size_t)i * 3 + 0] = 0;
          out_stats[(size_t)i * 3 + 1] = 0;
          out_stats[(size_t)i * 3 + 2] = 0;
        }
      },
      walk);
}

// The grid: every SM's resident CTAs, no more CTAs than 512-ray chunks.
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
int grid_of(K kernel, size_t smem, size_t max_smem, int n, int* grid) {
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
                                                          THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    ctas = sms * per_sm;
    std::lock_guard<std::mutex> lock(g_grid_mu);
    if (g_n_grids < GRID_CACHE) g_grids[g_n_grids++] = {dev, fn, smem, ctas};
  }
  *grid = max(1, min(ctas, (n + THREADS - 1) / THREADS));
  return 0;
}

}  // namespace

extern "C" {

// counters: two zeroed uint64 -- the next ray to take, and (with stats)
// the closest kernel's root slab tests
int bvh_closest(const float* rays, const float* nodes, const float* tris,
                const int* perm, float* out_tuv, int* out_tri,
                int* out_stats, unsigned long long* counters, int n, int p,
                int ls, int s, int max_iters, void* stream) {
  if (n <= 0) return 0;
  if (s > MAX_ROOTS) return (int)cudaErrorInvalidValue;
  size_t smem = closest_smem(s), max_smem = closest_smem(MAX_ROOTS);
  cudaStream_t st = (cudaStream_t)stream;
  int grid = 0, err;
  if (out_stats) {
    err = grid_of(bvh_closest_kernel<true>, smem, max_smem, n, &grid);
    if (err) return err;
    bvh_closest_kernel<true><<<grid, THREADS, smem, st>>>(
        rays, nodes, tris, perm, out_tuv, out_tri, out_stats, counters, n, p,
        ls, s, max_iters);
  } else {
    err = grid_of(bvh_closest_kernel<false>, smem, max_smem, n, &grid);
    if (err) return err;
    bvh_closest_kernel<false><<<grid, THREADS, smem, st>>>(
        rays, nodes, tris, perm, out_tuv, out_tri, out_stats, counters, n, p,
        ls, s, max_iters);
  }
  return (int)cudaGetLastError();
}

int bvh_any(const float* rays, const float* nodes, const float* tris,
            int* out_occ, int* out_stats, unsigned long long* counters,
            int n, int p, int ls, void* stream) {
  if (n <= 0) return 0;
  size_t smem = any_smem();
  cudaStream_t st = (cudaStream_t)stream;
  int grid = 0, err;
  if (out_stats) {
    err = grid_of(bvh_any_kernel<true>, smem, smem, n, &grid);
    if (err) return err;
    bvh_any_kernel<true><<<grid, THREADS, smem, st>>>(
        rays, nodes, tris, out_occ, out_stats, counters, n, p, ls);
  } else {
    err = grid_of(bvh_any_kernel<false>, smem, smem, n, &grid);
    if (err) return err;
    bvh_any_kernel<false><<<grid, THREADS, smem, st>>>(
        rays, nodes, tris, out_occ, out_stats, counters, n, p, ls);
  }
  return (int)cudaGetLastError();
}

// out[0..3]: resident CTAs per SM, registers per thread, threads per CTA
// and dynamic shared bytes per CTA of the closest (occlusion == 0) or
// any-hit kernel, without (stats == 0) or with per-lane stats, at the
// largest tree (S = 256 roots).
int bvh_resources(int occlusion, int stats, int* out) {
  const void* fn;
  size_t smem;
  if (occlusion) {
    fn = stats ? (const void*)bvh_any_kernel<true>
               : (const void*)bvh_any_kernel<false>;
    smem = any_smem();
  } else {
    fn = stats ? (const void*)bvh_closest_kernel<true>
               : (const void*)bvh_closest_kernel<false>;
    smem = closest_smem(MAX_ROOTS);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, THREADS,
                                                      smem);
  out[1] = attr.numRegs;
  out[2] = THREADS;
  out[3] = (int)smem;
  return (int)err;
}

}  // extern "C"
