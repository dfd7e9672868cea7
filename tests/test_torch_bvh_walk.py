"""A scalar model of the bvh_closest kernel's walk (csrc/bvh_traverse.cu),
held lane for lane against the plain version it must equal
(ops/traverse.py::_closest_plain, the JAX lock-step walk in torch ops).

The kernel cannot run here, so this file checks its algorithm: the same
steps in the same order, one lane at a time, in float32 with the
kernel's operation order.

  1. One scan of the S subtree roots, a left-first DFS of the top tree
     that skips the roots under a missed internal box, into a sorted list
     of at most ``cap`` (entry, index) pairs, keeping only roots whose
     entry is below the lane's t_max (missed roots are keyed 1e30); the
     number of qualifying roots is kept, so the lane knows whether the
     list was cut.
  2. When the list is used up and was cut, a rescan for the next ``cap``
     roots after the last one taken, below the current best t.
  3. A while-while walk: take the next root unless its entry is not below
     the best t, then descend along the analytic child and skip links
     until a leaf is hit or the subtree ends, test the leaf, go on.
  4. While the best t is above 1e30 (a lane with t_max > 1e30), the
     JAX walk's iteration window: at most 4 descend steps, then the leaf
     or, without one, the quirk that sets t = 1e30 and slot 0.
  5. Lanes with a NaN t_max never end a transition: a miss after the
     iteration cap; lanes with t_max <= t_min (and t_max <= 1e30) miss
     after one transition.

Every case must give the plain version's t, u, v, triangle id and all
three stats (node tests, triangle tests, root transitions) bit for bit,
with small caps so that the rescan runs.  One tie case also runs through
the JAX walk, which shows the plain version right on exact ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.ops import bvh as jbvh
from royaltracer_dx_tpu.ops import traverse as jtr

from royaltracer_dx_tpu_torch.ops import bvh as tbvh
from royaltracer_dx_tpu_torch.ops import traverse as ttr
from test_torch_cuda import bvh_order_case
from test_torch_restir import one_torch_thread  # noqa: F401 (autouse)

F = np.float32
INF_F = F(1e30)
DESCEND_SUBSTEPS = 4


# ------------------------------- the model ---------------------------------


def _nmin(a, b):
    return a if a != a else (b if b != b else min(a, b))


def _nmax(a, b):
    return a if a != a else (b if b != b else max(a, b))


def _safe_inv(d):
    return F(1.0) / d if abs(d) > F(1e-20) else (F(1e20) if d >= 0 else
                                                  F(-1e20))


class _Lane:
    def __init__(self, ray):
        r = [F(x) for x in ray]
        self.o, self.d = r[0:3], r[3:6]
        self.tmin, self.tmax = r[6], r[7]
        self.inv = [_safe_inv(x) for x in self.d]


def _slab(box, ray, t_lo, t_hi):
    """(hit, t_enter) in the kernel's order; an empty box is missed."""
    lo, hi = [], []
    for c in range(3):
        t0 = (box[c] - ray.o[c]) * ray.inv[c]
        t1 = (box[3 + c] - ray.o[c]) * ray.inv[c]
        lo.append(_nmin(t0, t1))
        hi.append(_nmax(t0, t1))
    te = _nmax(_nmax(_nmax(lo[0], lo[1]), lo[2]), t_lo)
    tx = _nmin(_nmin(_nmin(hi[0], hi[1]), hi[2]), t_hi)
    return bool(te <= tx) and bool(box[0] <= box[3]), te


def _mt(q9, ray, t_hi):
    """Moller-Trumbore of one triangle row in the kernel's order."""
    v0x, v0y, v0z = q9[0], q9[1], q9[2]
    e1x, e1y, e1z = q9[3] - v0x, q9[4] - v0y, q9[5] - v0z
    e2x, e2y, e2z = q9[6] - v0x, q9[7] - v0y, q9[8] - v0z
    dx, dy, dz = ray.d
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    okd = abs(det) > F(1e-12)
    inv_det = F(1.0) / det if okd else F(0.0)
    tx, ty, tz = ray.o[0] - v0x, ray.o[1] - v0y, ray.o[2] - v0z
    uu = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (okd and uu >= 0 and vv >= 0 and uu + vv <= 1 and t > ray.tmin
          and t < t_hi)
    return bool(ok), t, uu, vv


def _skip_in_subtree(node, s):
    """skip(node) inside the subtree of a root at heap level log2(S), 0
    once it leaves: strip the trailing ones; the ancestor reached is a
    strict descendant of the root exactly when its id is >= 2S."""
    x = node + 1
    anc = node >> ((x & -x).bit_length() - 1)
    return anc + 1 if anc >= 2 * s else 0


def _slabs(boxes, ray, t_hi):
    """(hit, t_enter) of ``_slab`` over many boxes at once (elementwise,
    so the same float32 roundings; np.minimum / np.maximum propagate NaN
    as the kernel's min / max)."""
    o = np.asarray(ray.o, F)
    inv = np.asarray(ray.inv, F)
    t0 = (boxes[:, 0:3] - o) * inv
    t1 = (boxes[:, 3:6] - o) * inv
    lo, hi = np.minimum(t0, t1), np.maximum(t0, t1)
    te = np.maximum(np.maximum(np.maximum(lo[:, 0], lo[:, 1]), lo[:, 2]),
                    ray.tmin)
    tx = np.minimum(np.minimum(np.minimum(hi[:, 0], hi[:, 1]), hi[:, 2]),
                    t_hi)
    return (te <= tx) & (boxes[:, 0] <= boxes[:, 3]), te


def _skip_link(node):
    """skip(node): strip the trailing ones, step to the sibling; 0 past
    the root."""
    x = node + 1
    anc = node >> ((x & -x).bit_length() - 1)
    return 0 if anc <= 1 else anc + 1


def _root_scan(top, ray, after, limit, cap):
    """The kernel's scan: a left-first DFS of the top tree (heap ids [1,
    2S), ``top`` its rows) that skips the roots under an internal box the
    ray misses within [t_min, limit] (nothing when limit > 1e30); each
    root reached is keyed by its entry within [t_min, t_max] (1e30 when
    missed) and kept when below ``limit`` and after ``after`` in (key,
    index) order; insertion keeps the cap smallest (a later index goes
    behind an equal key).  Returns (list, qualifying count, slab tests)."""
    s = len(top) // 2
    inner, _ = _slabs(top[1:s], ray, limit)
    hit, te = _slabs(top[s:], ray, ray.tmax)
    keys = np.where(hit, te, INF_F)
    lst, count, tests = [], 0, 0
    node = 1
    while node > 0:
        tests += 1
        if node < s:
            pass_ = inner[node - 1] or not limit <= INF_F
            node = 2 * node if pass_ else _skip_link(node)
            continue
        j = node - s
        node = _skip_link(node)
        key = keys[j]
        if not key < limit:
            continue
        if not (key > after[0] or (key == after[0] and j > after[1])):
            continue
        count += 1
        if len(lst) < cap:
            pos = len(lst)
            lst.append(None)
        elif key < lst[-1][0]:
            pos = cap - 1
        else:
            continue
        while pos > 0 and lst[pos - 1][0] > key:
            lst[pos] = lst[pos - 1]
            pos -= 1
        lst[pos] = (key, j)
    return lst, count, tests


def model_closest(bvh, rays, cap):
    """(tuv [N, 3], tri [N], stats [N, 3], root scans [N], the scans'
    slab tests [N]) of the kernel's walk, one lane at a time."""
    nodes = bvh.nodes.numpy()
    tris = bvh.sorted_tris.numpy().reshape(-1, 9)
    perm = bvh.perm.numpy()
    p, ls = bvh.num_leaves, bvh.leaf_size
    s = min(256, p)
    top = nodes[:2 * s]
    max_iters = ttr.max_iters_of(bvh)
    rows = rays.numpy()
    n = rows.shape[0]
    tuv = np.zeros((n, 3), np.float32)
    tri_out = np.zeros(n, np.int32)
    stats = np.zeros((n, 3), np.int32)
    scans = np.zeros(n, np.int64)
    tests = np.zeros(n, np.int64)
    for i in range(n):
        ray = _Lane(rows[i])
        t_best, tri, bu, bv = ray.tmax, -1, F(0.0), F(0.0)
        n_nodes = n_tris = n_roots = 0
        if ray.tmax != ray.tmax:
            n_roots = max_iters          # no transition ever resolves
        elif ray.tmax <= ray.tmin and ray.tmax <= INF_F:
            n_roots = 1                  # every root keyed at or past t_max
        else:
            lst, count, k = _root_scan(top, ray, (F(-np.inf), -1), t_best,
                                       cap)
            scans[i] += 1
            tests[i] += k
            head = taken = 0
            last = (F(-np.inf), -1)
            node = 0
            while True:
                if node == 0:
                    if taken == s:
                        break
                    n_roots += 1
                    if head == len(lst) and count > len(lst):
                        lst, count, k = _root_scan(top, ray, last, t_best,
                                                   cap)
                        scans[i] += 1
                        tests[i] += k
                        head = 0
                    if head == len(lst) or not lst[head][0] < t_best:
                        # exhausted; the JAX iteration still ends in its
                        # leaf phase, where the quirk may fire
                        if t_best > INF_F:
                            _, _, uu, vv = _mt(tris[0], ray, t_best)
                            t_best, tri, bu, bv = INF_F, 0, uu, vv
                        break
                    last = lst[head]
                    head += 1
                    taken += 1
                    node = s + last[1]
                # descend to the next hit leaf; at most 4 steps while
                # t_best is above 1e30 (the JAX iteration's window)
                budget = DESCEND_SUBSTEPS if t_best > INF_F else 1 << 30
                pending, k = 0, 0
                while node > 0 and k < budget:
                    hit, _ = _slab(nodes[node], ray, ray.tmin, t_best)
                    leaf = node >= p
                    cur = node
                    node = 2 * node if hit and not leaf else \
                        _skip_in_subtree(node, s)
                    n_nodes += 1
                    k += 1
                    if leaf and hit:
                        pending = cur
                        break
                if pending:
                    base = (pending - p) * ls
                    tc, uc, vc, best_l = INF_F, F(0.0), F(0.0), 0
                    for lane in range(ls):
                        ok, t, uu, vv = _mt(tris[base + lane], ray, t_best)
                        tt = t if ok else INF_F
                        if lane == 0 or tt < tc:
                            tc, uc, vc, best_l = tt, uu, vv, lane
                    n_tris += ls
                    if tc < t_best:
                        t_best, tri, bu, bv = tc, base + best_l, uc, vc
                elif t_best > INF_F:
                    _, _, uu, vv = _mt(tris[0], ray, t_best)
                    t_best, tri, bu, bv = INF_F, 0, uu, vv
        found = tri >= 0
        tuv[i] = (t_best if found else INF_F, bu, bv)
        tri_out[i] = perm[tri] if found else 0
        stats[i] = (n_nodes, n_tris, n_roots)
    return tuv, tri_out, stats, scans, tests


# ------------------------------- the tests ---------------------------------


@pytest.mark.parametrize("cap", [2, 24])
@pytest.mark.parametrize("name", ["soup64", "soup1024", "ties", "axis",
                                  "edges"])
def test_model_walk_matches_plain(name, cap):
    """The model's t, u, v, triangle id and stats equal the plain
    version's on every lane; with cap 2 lists overflow and rescan."""
    tris, rays, ls = bvh_order_case(name)
    bvh = tbvh.build_lbvh(torch.as_tensor(tris), leaf_size=ls)
    p_tuv, p_tri, p_st = ttr._closest_plain(rays, bvh)
    m_tuv, m_tri, m_st, scans, tests = model_closest(bvh, rays, cap)
    np.testing.assert_array_equal(m_tri, p_tri.numpy())
    np.testing.assert_array_equal(m_tuv.view(np.int32),
                                  p_tuv.numpy().view(np.int32))
    np.testing.assert_array_equal(m_st, p_st.numpy())
    hit = m_tuv[:, 0] < 1e29
    assert hit.mean() > 0.25
    if cap == 2:
        assert (scans > 1).any()              # the rescan ran
    # the DFS skips missed parts of the top tree: fewer slab tests than
    # the 2S - 1 top nodes a scan could visit
    s = min(256, bvh.num_leaves)
    assert tests[scans > 0].min() < 2 * s - 1
    # the t_max = inf lanes leave the window with t = 1e30 or a hit
    inf_lanes = np.isinf(rays[:, 7].numpy())
    assert inf_lanes.any() and (m_tuv[inf_lanes, 0] <= 1e30).all()


@pytest.mark.parametrize("name", ["soup64", "soup1024", "ties", "axis",
                                  "edges"])
def test_top_scan_tests_count_one_scan(name):
    """``traverse.top_scan_tests``, which the bound counts, is the model's
    first root scan of a live lane (t_max > t_min) capped at S, S above
    t_max 1e30 and 0 on a dead lane: the kernel's scans make at least
    that many slab tests."""
    tris, rays, ls = bvh_order_case(name)
    bvh = tbvh.build_lbvh(torch.as_tensor(tris), leaf_size=ls)
    s = min(256, bvh.num_leaves)
    top = bvh.nodes.numpy()[:2 * s]
    got = ttr.top_scan_tests(rays, bvh).numpy()
    want = np.zeros_like(got)
    for i, row in enumerate(rays.numpy()):
        ray = _Lane(row)
        if not ray.tmax > ray.tmin:
            continue
        want[i] = s if ray.tmax > INF_F else min(
            s, _root_scan(top, ray, (F(-np.inf), -1), ray.tmax, 24)[2])
    np.testing.assert_array_equal(got, want)
    pruned = (want > 0) & (want < s)
    assert pruned.any() and (want == 0).any()


def test_ties_plain_matches_jax():
    """On exact ties (the same triangle in two leaves), the plain version
    picks the JAX walk's triangle: the first leaf in visit order."""
    tris, rays, ls = bvh_order_case("ties")
    live = (rays[:, 7] > rays[:, 6]) & (rays[:, 7] < 1e29)
    rays = rays[live]
    jb = jbvh.build_lbvh(jnp.asarray(tris), leaf_size=ls)
    tb = tbvh.build_lbvh(torch.as_tensor(tris), leaf_size=ls)
    r = rays.numpy()
    hj = jtr.closest_hit_bvh(jnp.asarray(r[:, 0:3]), jnp.asarray(r[:, 3:6]),
                             jb, t_min=jnp.asarray(r[:, 6]),
                             t_max=jnp.asarray(r[:, 7]))
    _, p_tri, _ = ttr._closest_plain(rays, tb)
    hit = np.asarray(hj.t) < 1e29
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(p_tri.numpy(), np.asarray(hj.tri))
    # duplicates: a hit triangle has a copy with the same t elsewhere
    perm = tb.perm.numpy()
    assert len(np.unique(perm[perm >= 0] // 5)) == len(tris) // 5
