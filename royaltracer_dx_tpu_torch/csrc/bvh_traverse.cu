// LBVH traversal kernels for Hopper (sm_90a): closest hit and any hit, one
// thread per ray, no stack and no shared tables.
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
// slab test reads it as an infinite slab and walks every padding subtree
// first.  On sponza (66,321 real leaves padded to 131,072) the faithful
// walk makes every closest lane test ~129,000 nodes and ~258,000 padding
// triangles: 3.8-8.9 s a 2,073,600-lane batch on the H100.
//
// The tree (ops/bvh.py): heap nodes k in [1, 2P) as 6-float rows (min |
// max), leaves [P, 2P), leaf j holding sorted triangles [j*ls, (j+1)*ls) as
// 9 floats each, perm mapping a sorted slot to its original triangle id.
// Child links are 2k; the skip link strips k's trailing ones and steps to
// the sibling (__ffs for the trailing ones, __clz for bit lengths).
//
// bvh_closest follows the JAX walk exactly, lane by lane.  The JAX walk
// first slab-tests every ray against the S = min(256, P) subtree roots and
// sorts them by entry distance with a stable argsort (ties by root index,
// missed roots keyed 1e30).  Materialising those [N, S] keys would take 19
// GB for an 18.7M-lane batch, so a thread instead scans the S roots for
// the NEXT_ROOTS (8) smallest (entry, index) above the last one taken,
// keeps them sorted in registers, and scans again when it has taken them
// all: the same order.  (A scan at every transition would spend 14 of a
// lane's 15 slab tests in scans: a primary ray of the sponza atrium takes
// ~13 subtrees.)
// Per iteration it takes at most one transition (skipped once the next
// entry reaches the running best t), 4 descend substeps, and one
// Moller-Trumbore test of the parked leaf's ls triangles (first minimum
// lane; a later leaf wins only if strictly closer); the iteration count and
// its cap of 4P + 4S + 64 are JAX's, so an answer cut by the cap would be
// the same answer.  The operation order is the plain version's (no FMA
// contraction: the library is built with -fmad=false), and min/max
// propagate NaN as torch.minimum / jnp.minimum do.
//
// bvh_any answers a boolean, which does not depend on the order in which
// leaves are visited, so it walks the whole tree from the root in DFS order
// along the same links and stops at the first confirmed hit.  Every leaf
// the JAX walk tests is tested here too: a parent's box holds its
// children's exactly, and the slab test's rounded subtract and multiply are
// monotone, so a box hit implies its ancestors' boxes hit; the empty
// boxes of padding-only subtrees are missed by both walks.  A DFS
// iteration visits at least one node, so the cap (4P + 4S + 64 > 2P) never
// binds here.  Lanes with t_max <= t_min (or a NaN bound) are never
// occluded and return at once.
//
// What bounds it on this card: per lane a chain of dependent node loads
// (24 B, through the read-only cache) and slab tests, divergent across a
// warp because each ray walks its own path; the FP32 operations of the
// walk (bvh_work: 24 a slab test, 52 a triangle test) over 67 TFLOP/s, or
// 48 B a closest lane (20 B an any-hit lane) plus the tree over 3.35 TB/s,
// whichever is larger, is the bound chip_smoke.py prints beside the time.
// This first version is the simple per-thread walk; it keeps the walk's
// state in registers and its 256-root scans in the L1.
//
// Optional per-lane stats [N, 3] int32: node slab tests of the walk,
// triangle tests, root transitions (closest) -- the plain version counts
// the first two the same way for closest.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int DESCEND_SUBSTEPS = 4;
constexpr float INF_F = 1e30f;
constexpr float DET_EPS = 1e-12f;
// subtree roots a closest lane keeps in registers between scans of the S
// roots, and the index of an empty entry
constexpr int NEXT_ROOTS = 8;
constexpr int NO_ROOT = 0x7fffffff;

// NaN-propagating min / max (torch.minimum / torch.maximum semantics)
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float safe_inv(float d) {
  return fabsf(d) > 1e-20f ? 1.0f / d : (d >= 0.0f ? 1e20f : -1e20f);
}

struct Ray {
  float o[3], d[3], inv[3], tmin, tmax;
};

// (hit, t_enter) of the slab test against node k (traverse.py:66-74)
__device__ __forceinline__ bool slab(const float* __restrict__ nodes, int k,
                                     const Ray& r, float t_lo, float t_hi,
                                     float* t_enter) {
  const float* b = nodes + (size_t)k * 6;
  float lo[3], hi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float t0 = (__ldg(b + c) - r.o[c]) * r.inv[c];
    float t1 = (__ldg(b + 3 + c) - r.o[c]) * r.inv[c];
    lo[c] = nmin(t0, t1);
    hi[c] = nmax(t0, t1);
  }
  float te = nmax(nmax(nmax(lo[0], lo[1]), lo[2]), t_lo);
  float tx = nmin(nmin(nmin(hi[0], hi[1]), hi[2]), t_hi);
  *t_enter = te;
  return te <= tx && __ldg(b) <= __ldg(b + 3);   // an empty box is missed
}

// (key, index) order of the subtree roots: the stable argsort's
__device__ __forceinline__ bool root_less(float ka, int ia, float kb,
                                          int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

__device__ __forceinline__ int bitlen(uint32_t x) {
  return x ? 32 - __clz(x) : 0;
}

// skip(k): strip the trailing ones of k, then step to the sibling; 0 past
// the root (traverse.py:52-57)
__device__ __forceinline__ int skip_link(int node) {
  uint32_t x = (uint32_t)node + 1u;
  int ctz = __ffs(x) - 1;
  int anc = (int)((uint32_t)node >> ctz);
  return anc <= 1 ? 0 : anc + 1;
}

__device__ __forceinline__ bool in_subtree(int node, int root) {
  int shift = max(bitlen((uint32_t)node) - bitlen((uint32_t)root), 0);
  return node > 0 && (node >> shift) == root;
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

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        int i) {
  const float4* p = reinterpret_cast<const float4*>(rays + (size_t)i * 8);
  float4 a = __ldg(p), b = __ldg(p + 1);
  Ray r;
  r.o[0] = a.x; r.o[1] = a.y; r.o[2] = a.z;
  r.d[0] = a.w; r.d[1] = b.x; r.d[2] = b.y;
  r.tmin = b.z; r.tmax = b.w;
#pragma unroll
  for (int c = 0; c < 3; ++c) r.inv[c] = safe_inv(r.d[c]);
  return r;
}

__global__ void __launch_bounds__(THREADS)
bvh_closest_kernel(const float* __restrict__ rays,
                   const float* __restrict__ nodes,
                   const float* __restrict__ tris,
                   const int* __restrict__ perm, float* __restrict__ out_tuv,
                   int* __restrict__ out_tri, int* __restrict__ out_stats,
                   int n, int p, int ls, int s, int max_iters) {
  int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(rays, i);
  int n_nodes = 0, n_tris = 0, n_roots = 0;
  float t_best = r.tmax;
  int tri = -1;
  float bu = 0.0f, bv = 0.0f;
  // a segment with t_max <= t_min (both finite and below 1e30) misses
  // every root and leaf, and no leaf phase can move its t_best: it is a
  // miss, as the full walk would find
  bool dead = r.tmax <= r.tmin && r.tmax <= INF_F;
  if (!dead) {
    int slot = 0, node = 0, root = 1, pending = 0;
    float last_key = -INFINITY;   // the last root taken, (key, index)
    int last_idx = -1;
    // the next NEXT_ROOTS roots after the last taken, in (key, index)
    // order; an index of NO_ROOT marks an empty entry
    float qk[NEXT_ROOTS];
    int qi[NEXT_ROOTS];
#pragma unroll
    for (int q = 0; q < NEXT_ROOTS; ++q) {
      qk[q] = INFINITY;
      qi[q] = NO_ROOT;
    }
    for (int it = 0; it < max_iters; ++it) {
      if (!(node > 0 || pending > 0 || slot < s)) break;
      // subtree transition: the next root in stable (entry, index) order
      if (node == 0 && pending == 0 && slot < s) {
        if (qi[0] == NO_ROOT) {
          // refill: the NEXT_ROOTS smallest (key, index) after the last
          // taken, by insertion into the sorted registers
          for (int j = 0; j < s; ++j) {
            float te;
            bool h = slab(nodes, s + j, r, r.tmin, r.tmax, &te);
            float key = h ? te : INF_F;
            bool after = key > last_key || (key == last_key && j > last_idx);
            if (after && root_less(key, j, qk[NEXT_ROOTS - 1],
                                   qi[NEXT_ROOTS - 1])) {
              qk[NEXT_ROOTS - 1] = key;
              qi[NEXT_ROOTS - 1] = j;
#pragma unroll
              for (int q = NEXT_ROOTS - 1; q > 0; --q) {
                if (root_less(qk[q], qi[q], qk[q - 1], qi[q - 1])) {
                  float tk = qk[q];
                  qk[q] = qk[q - 1];
                  qk[q - 1] = tk;
                  int ti = qi[q];
                  qi[q] = qi[q - 1];
                  qi[q - 1] = ti;
                }
              }
            }
          }
        }
        float best_key = qk[0];   // INFINITY when no root is left
        ++n_roots;
        if (best_key < t_best) {
          node = s + qi[0];
          root = node;
          ++slot;
          last_key = best_key;
          last_idx = qi[0];
#pragma unroll
          for (int q = 0; q + 1 < NEXT_ROOTS; ++q) {
            qk[q] = qk[q + 1];
            qi[q] = qi[q + 1];
          }
          qk[NEXT_ROOTS - 1] = INFINITY;
          qi[NEXT_ROOTS - 1] = NO_ROOT;
        } else if (best_key >= t_best) {
          slot = s;
        }
      }
      // bounded descend substeps inside the current subtree
      for (int k = 0; k < DESCEND_SUBSTEPS; ++k) {
        if (!(node > 0 && pending == 0)) break;
        float te;
        bool hit = slab(nodes, node, r, r.tmin, t_best, &te);
        bool leaf = node >= p;
        if (leaf && hit) pending = node;
        int nxt = (hit && !leaf) ? 2 * node : skip_link(node);
        node = in_subtree(nxt, root) ? nxt : 0;
        ++n_nodes;
      }
      // leaf phase: first minimum lane, a leaf wins only if strictly
      // closer.  Without a parked leaf every lane misses (t = INF); that
      // can still replace a t_best above 1e30 with leaf 0's first lane,
      // as in the JAX walk
      if (pending > 0) {
        int leaf_idx = pending - p;
        float tc = INF_F, uc = 0.0f, vc = 0.0f;
        int best_l = 0;
        for (int l = 0; l < ls; ++l) {
          float t, uu, vv;
          bool ok = mt(tris, leaf_idx * ls + l, r, t_best, &t, &uu, &vv);
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
          tri = leaf_idx * ls + best_l;
          bu = uc;
          bv = vc;
        }
        pending = 0;
      } else if (INF_F < t_best) {
        float t, uu, vv;
        mt(tris, 0, r, t_best, &t, &uu, &vv);
        t_best = INF_F;
        tri = 0;
        bu = uu;
        bv = vv;
      }
    }
  }
  bool found = tri >= 0;
  out_tuv[(size_t)i * 3 + 0] = found ? t_best : INF_F;
  out_tuv[(size_t)i * 3 + 1] = bu;
  out_tuv[(size_t)i * 3 + 2] = bv;
  out_tri[i] = found ? __ldg(perm + tri) : 0;
  if (out_stats) {
    out_stats[(size_t)i * 3 + 0] = n_nodes;
    out_stats[(size_t)i * 3 + 1] = n_tris;
    out_stats[(size_t)i * 3 + 2] = n_roots;
  }
}

__global__ void __launch_bounds__(THREADS)
bvh_any_kernel(const float* __restrict__ rays,
               const float* __restrict__ nodes,
               const float* __restrict__ tris, int* __restrict__ out_occ,
               int* __restrict__ out_stats, int n, int p, int ls,
               int max_iters) {
  int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(rays, i);
  int n_nodes = 0, n_tris = 0;
  bool occ = false;
  if (r.tmax > r.tmin) {
    int node = 1;
    for (int it = 0; it < max_iters && node > 0 && !occ; ++it) {
      int pending = 0;
      for (int k = 0; k < DESCEND_SUBSTEPS && node > 0 && pending == 0;
           ++k) {
        float te;
        bool hit = slab(nodes, node, r, r.tmin, r.tmax, &te);
        bool leaf = node >= p;
        if (leaf && hit) pending = node;
        node = (hit && !leaf) ? 2 * node : skip_link(node);
        ++n_nodes;
      }
      if (pending > 0) {
        int base = (pending - p) * ls;
        for (int l = 0; l < ls && !occ; ++l) {
          float t, uu, vv;
          occ = mt(tris, base + l, r, r.tmax, &t, &uu, &vv);
          ++n_tris;
        }
      }
    }
  }
  out_occ[i] = occ ? 1 : 0;
  if (out_stats) {
    out_stats[(size_t)i * 3 + 0] = n_nodes;
    out_stats[(size_t)i * 3 + 1] = n_tris;
    out_stats[(size_t)i * 3 + 2] = 0;
  }
}

}  // namespace

extern "C" {

int bvh_closest(const float* rays, const float* nodes, const float* tris,
                const int* perm, float* out_tuv, int* out_tri,
                int* out_stats, int n, int p, int ls, int s, int max_iters,
                void* stream) {
  if (n > 0) {
    bvh_closest_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                         (cudaStream_t)stream>>>(
        rays, nodes, tris, perm, out_tuv, out_tri, out_stats, n, p, ls, s,
        max_iters);
  }
  return (int)cudaGetLastError();
}

int bvh_any(const float* rays, const float* nodes, const float* tris,
            const int* perm, int* out_occ, int* unused, int* out_stats,
            int n, int p, int ls, int s, int max_iters, void* stream) {
  (void)perm;
  (void)unused;
  (void)s;
  if (n > 0) {
    bvh_any_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                     (cudaStream_t)stream>>>(
        rays, nodes, tris, out_occ, out_stats, n, p, ls, max_iters);
  }
  return (int)cudaGetLastError();
}

// out[0..2]: resident blocks per SM, registers per thread and threads per
// block of the closest (occlusion == 0) or any-hit kernel.
int bvh_resources(int occlusion, int* out) {
  cudaFuncAttributes attr;
  const void* fn = occlusion ? (const void*)bvh_any_kernel
                             : (const void*)bvh_closest_kernel;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fn, THREADS,
                                                      0);
  out[1] = attr.numRegs;
  out[2] = THREADS;
  return (int)err;
}

}  // extern "C"
