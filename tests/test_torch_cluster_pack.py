"""The premises of the phase B cluster kernels' design (csrc/
cluster_traverse.cu: dead rays packed out, a ray's triangles spread over a
team of lanes, the tiles taken busiest first), held on the CPU by the
plain version (ops/cluster_traverse.py::_phase_b_plain, what the kernels
equal bit for bit on the card) and the JAX package.

  (a) a closest-hit tile's answers and steps depend on its dead rays
      (t_min >= t_max) only through the largest min(INF, t_max) among
      them, so the kernel may drop them after folding that one value;
  (b) taking the tiles busiest first and putting them back changes no
      answer and no stat;
  (c) the any-hit step rule: a tile holding a dead ray walks to the end
      of its list with no tests once its live rays are occluded, an
      all-live tile stops there;
  and a model of the team reductions: a team's strided first minima
  reduced on (t, slot), and its per-chunk ballots, give the first
  minimum and the first hit slot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.ops import cluster_traverse as jct
from royaltracer_dx_tpu_torch.ops import cluster_traverse as tct
from royaltracer_dx_tpu_torch.tools import cluster_cases
from test_torch_cluster import _both, _menger
from test_torch_restir import one_torch_thread  # noqa: F401 (autouse)

TILE = 16
INF = float(np.float32(1e30))     # the miss t, as float32 holds it


@pytest.fixture(scope="module")
def sponge():
    """The level-2 menger sponge's 4,800 triangles clustered in groups of
    32 by both packages."""
    return _both(_menger(), 32)


def _corner_rays(n, seed):
    """n rays from a sphere around the sponge, each aimed at one of its
    solid corner cubes: every one hits."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 2.5 + 0.5
    corner = rng.integers(0, 2, (n, 3)) * (16.0 / 18) + 1.0 / 18
    d = (corner + rng.uniform(-0.04, 0.04, (n, 3))).astype(np.float32) - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


def _with_dead(t_max_dead, dir_seed, n=96):
    """n rays: every third one dead (t_min 2e4 above its t_max, so it
    overlaps no box) with the given t_max values and a direction drawn
    from ``dir_seed``; the others aimed at the sponge's solid corners
    (every one hits, so a tile's live bound falls to its farthest hit)."""
    o, d = _corner_rays(n, 3)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, 1e4, np.float32)
    dead = np.arange(n) % 3 == 0
    t_min[dead] = 2e4
    t_max[dead] = t_max_dead
    dd = np.random.default_rng(dir_seed).normal(size=(int(dead.sum()), 3))
    d = d.copy()
    d[dead] = dd / np.linalg.norm(dd, axis=1, keepdims=True)
    return o, d, t_min, t_max


def _closest_plain(tcl, o, d, t_min, t_max):
    rows = tct.prepare_rays(*(torch.as_tensor(a) for a in (o, d, t_min,
                                                           t_max)), TILE)
    wl, went, count = tct.tile_worklists(rows, tcl, TILE)
    return (wl, went, count), tct._phase_b_plain(rows, tcl, wl, went, count,
                                                 TILE, False)


def _dead_values(seed, top):
    """Each tile's dead t_max values: random below ``top``, one of them
    ``top`` (a NaN tile keeps a NaN)."""
    rng = np.random.default_rng(seed)
    n_dead = 32                     # 96 rays, every third dead
    v = rng.uniform(-5.0, 1.0, n_dead).astype(np.float32) * np.abs(top)
    per_tile = TILE // 3 + 1        # dead rays of a 16-ray tile: 5 or 6
    starts = np.searchsorted(np.arange(0, 96, 3), np.arange(0, 96, TILE))
    for s in starts:
        v[s + rng.integers(0, per_tile - 1)] = top
    return v


@pytest.mark.parametrize("top", [0.5, 40.0, float("nan")])
def test_closest_sees_dead_rays_only_through_their_largest_t_max(sponge,
                                                                 top):
    """(a): two batches that differ only in their dead rays (directions
    and t_max values), with the same largest t_max in every tile, give
    the same worklists, answers and stats in the plain version, and the
    same hits in the JAX package; the JAX hits equal the plain ones.
    Raising that largest t_max from 0.5 to 40 (beyond the live rays'
    hits) changes some tile's steps."""
    jcl, tcl = sponge
    first = _with_dead(_dead_values(1, top), dir_seed=1)
    second = _with_dead(_dead_values(2, top), dir_seed=2)
    assert not np.array_equal(first[1], second[1], equal_nan=True)
    (wl1, went1, c1), out1 = _closest_plain(tcl, *first)
    (wl2, went2, c2), out2 = _closest_plain(tcl, *second)
    assert torch.equal(c1, c2)
    for a, b in zip((wl1, went1), (wl2, went2)):
        assert torch.equal(a, b)
    for a, b in zip(out1, out2):
        assert torch.equal(a, b)
    jhits = [jct.closest_hit_clustered(
        jnp.asarray(o), jnp.asarray(d), jcl, t_min=jnp.asarray(tn),
        t_max=jnp.asarray(tx), tile=TILE) for o, d, tn, tx in (first,
                                                               second)]
    for f in ("t", "u", "v", "tri"):
        np.testing.assert_array_equal(np.asarray(getattr(jhits[0], f)),
                                      np.asarray(getattr(jhits[1], f)))
    np.testing.assert_array_equal(np.asarray(jhits[0].tri),
                                  out1[1][:96].numpy())
    np.testing.assert_allclose(np.asarray(jhits[0].t),
                               out1[0][:96, 0].numpy(), rtol=0, atol=1e-5)
    if np.isnan(top):
        assert (out1[2][:, 0] == 0).all()           # every tile retired
        return
    assert int((out1[0][:, 0] < INF).sum()) > 0
    if top == 0.5:
        _, out3 = _closest_plain(tcl, *_with_dead(_dead_values(1, 40.0),
                                                  dir_seed=1))
        assert (out3[2][:, 0] >= out1[2][:, 0]).all()
        assert (out3[2][:, 0] > out1[2][:, 0]).any()


@pytest.mark.parametrize("occlusion", [False, True])
def test_busiest_first_changes_no_answer(sponge, occlusion):
    """(b): the plain phase B on the tiles in ``tile_order`` (busiest
    first), put back in place, equals it in batch order: answers and the
    per-tile stats."""
    _, tcl = sponge
    o, d, t_min, t_max = _with_dead(np.full(32, -1.0, np.float32), 5)
    rows = tct.prepare_rays(*(torch.as_tensor(a) for a in (o, d, t_min,
                                                           t_max)), TILE)
    wl, went, count = tct.tile_worklists(rows, tcl, TILE)
    order = tct.tile_order(count)
    assert not torch.equal(order, torch.arange(count.shape[0]))
    inv = torch.argsort(order)
    prows = rows.reshape(-1, TILE, 8)[order].reshape(-1, 8)
    ref = tct._phase_b_plain(rows, tcl, wl, None if occlusion else went,
                             count, TILE, occlusion)
    got = tct._phase_b_plain(prows, tcl, wl[order],
                             None if occlusion else went[order],
                             count[order], TILE, occlusion)
    *answers, stats = got
    back = [a.reshape(count.shape[0], TILE, *a.shape[1:])[inv].reshape(
        a.shape) for a in answers]
    for a, b in zip(back + [stats[inv]], ref):
        assert torch.equal(a, b)
    assert int(ref[-1][:, 0].sum()) > 0


@pytest.mark.parametrize("n,seed", [(1, 0), (37, 1), (200, 2), (4096, 3)])
def test_tile_order_is_busiest_first(n, seed):
    """``tile_order``: tile indices by count descending, ties in tile
    order, as numpy's stable argsort of -count and the JAX package's
    ``argsort(-count)`` (cluster_traverse.py:306) give them."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, 6, n).astype(np.int32)
    got = tct.tile_order(torch.as_tensor(count))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  np.argsort(-count, kind="stable"))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.argsort(-jnp.asarray(count))))


def test_any_hit_walks_on_for_a_dead_ray(sponge):
    """(c): a tile of rays that all hit stops once every ray is occluded;
    the same tile with one ray made dead walks to the end of its list,
    and its live rays test nothing after they are occluded: its tests are
    a ray-by-ray count up to each ray's first hit.  The occlusion equals
    the JAX package's."""
    jcl, tcl = sponge
    o, d = (np.tile(a, (2, 1)) for a in _corner_rays(TILE, 4))
    t_min = np.full(2 * TILE, 1e-4, np.float32)
    t_max = np.full(2 * TILE, 1e4, np.float32)
    t_max[TILE + 5] = -1.0                     # the second tile's dead ray
    args = [torch.as_tensor(a) for a in (o, d, t_min, t_max)]
    rows = tct.prepare_rays(*args, TILE)
    wl, _, count = tct.tile_worklists(rows, tcl, TILE)
    occ, stats = tct._phase_b_plain(rows, tcl, wl, None, count, TILE, True)
    assert occ[:TILE].all() and int(occ[TILE:].sum()) == TILE - 1
    steps, tests = stats[:, 0], stats[:, 1]
    assert steps[0] < count[0]
    assert steps[1] == count[1] and steps[1] > steps[0]
    o_, d_, tn, tx = tct._rays(rows)
    want = 0
    for r in range(TILE, 2 * TILE):
        for k in range(int(steps[1])):
            if not bool(tn[r] < tx[r]):
                break
            t, _, _ = tct._mt_tile(o_[r][None, None], d_[r][None, None],
                                   tcl.tri_planes[wl[1, k].long()][None],
                                   tn[r][None, None], tx[r][None, None])
            lanes = torch.nonzero(t[0, 0] < INF)[:, 0]
            if lanes.numel():
                want += int(lanes[0]) + 1
                break
            want += tcl.group
    assert int(tests[1]) == want
    jo, jd, jn, jx = (jnp.asarray(a) for a in (o, d, t_min, t_max))
    jocc = jct.any_hit_clustered(jo, jd, jcl, jn, jx, tile=TILE)
    np.testing.assert_array_equal(occ.numpy() > 0, np.asarray(jocc))


def _team_first_min(t, q):
    """The closest kernel's team: lane j keeps the first minimum of slots
    j, j + q, ...; a butterfly over the lanes keeps (t, slot)
    lexicographically."""
    g = t.shape[0]
    lanes = []
    for j in range(q):
        best, at = INF, g
        for slot in range(j, g, q):
            if t[slot] < best:
                best, at = t[slot], slot
        lanes.append((best, at))
    o = q // 2
    while o:
        lanes = [min(lanes[j], lanes[j ^ o]) for j in range(q)]
        o //= 2
    return lanes[0]


def _team_first_hit(hit, q):
    """The any-hit kernel's team: chunk c tests slots c*q .. c*q + q - 1,
    one a lane, and a ballot stops the team at its first hit."""
    g = hit.shape[0]
    for c0 in range(0, g, q):
        bits = [c0 + j < g and bool(hit[c0 + j]) for j in range(q)]
        if any(bits):
            return c0 + bits.index(True)
    return g


@pytest.mark.parametrize("g", [1, 3, 100, 128])
def test_team_reductions_give_the_first_slot(g):
    """The team reductions of the phase B kernels against the plain
    version's rule (the first minimum slot, ``_phase_b_group``; the first
    hit slot of the needed-tests count) for every team size, on slots with
    exact ties and misses."""
    rng = np.random.default_rng(g)
    for trial in range(20):
        t = rng.choice([0.5, 0.25, 0.75, INF], size=g).astype(np.float32)
        if trial % 4 == 0:
            t[:] = INF
        tt = torch.as_tensor(t)
        t_c = torch.amin(tt)
        want = int(torch.amin(torch.where(tt <= t_c, torch.arange(g), g)))
        hit = t < INF
        first_hit = int(np.argmax(hit)) if hit.any() else g
        for q in (1, 2, 4, 8, 16, 32):
            if q > g:
                continue
            best, at = _team_first_min(t, q)
            assert best == float(t_c)
            if best < INF:
                assert at == want, (q, t)
            assert _team_first_hit(hit, q) == first_hit


@pytest.mark.parametrize("tile", [32, 24])
def test_pack_case_tiles_do_what_they_claim(tile):
    """``cluster_cases.pack_case`` (the card tests' and chip_smoke.py's
    adversarial tiles) at a small size: every packing width's live count,
    and in the plain version the tiles without a live ray counting their
    steps without tests (the whole list, or none for a NaN), the all-hit
    tiles stopping before the end of their list in any hit, and exact-t
    ties between the twin triangles (the card holds the kernels to the
    plain version on them)."""
    rows, cl, kinds = cluster_cases.pack_case("cpu", tile, 32, reps=2)
    kinds = np.asarray(kinds)
    live = (rows[:, 6] < rows[:, 7]).reshape(-1, tile).sum(dim=1).numpy()
    widths = [w for k, w in cluster_cases.pack_kinds(tile) for _ in range(2)]
    np.testing.assert_array_equal(live, widths)
    assert set(cluster_cases.pack_widths(tile)) == {0, 1, 31, 32, 33,
                                                    tile - 1, tile} & set(
        range(tile + 1))
    wl, went, count = tct.tile_worklists(rows, cl, tile)
    _, _, cstats = tct._phase_b_plain(rows, cl, wl, went, count, tile,
                                        False)
    _, astats = tct._phase_b_plain(rows, cl, wl, None, count, tile, True)
    over = kinds == "dead_overlap"
    assert (count[over] > 0).all()
    assert torch.equal(cstats[over, 0], count[over].long())
    assert (cstats[over, 1] == 0).all()
    assert (cstats[kinds == "nan_dead", 0] == 0).all()
    hit_all = kinds == "all_hit"
    assert (astats[hit_all, 0] < count[hit_all]).all()
    assert int((cstats[:, 1] > 0).sum()) > 0
