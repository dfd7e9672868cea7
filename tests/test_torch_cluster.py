"""The port's tile-clustered traversal (ops/cluster_traverse.py), its
route through the renderers, and the stream accel's morton and
median_host builds, against the JAX package on the CPU (the ReSTIR
frames are in tests/test_torch_cluster_frames.py).

The builds are integer ordering and min/max of the same float32 inputs,
so clusters and accels must equal the JAX builds bit for bit.  The
queries' plain versions (what the CUDA kernels are held to on the card,
tests/test_torch_cuda.py) are held to the JAX functions on the same rays:
valid masks, triangle ids and occlusion equal, t, u and v within 1e-5 (as
tests/test_stream.py:142; XLA-CPU may contract products into FMAs), and
the phase A mask and entry tables equal.  The frames are held at
tests/test_torch_restir.py's image tolerance (``image_close``: >= 99% of
pixels within 1e-3 relative, channel means within 5e-3).  On the CPU the
kernel wrappers run the plain versions and launch nothing.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.camera import Camera as JCamera
from royaltracer_dx_tpu.config import RenderConfig as JConfig
from royaltracer_dx_tpu.ops import cluster_traverse as jct
from royaltracer_dx_tpu.ops import restir as jrestir
from royaltracer_dx_tpu.ops import stream_trace as jst
from royaltracer_dx_tpu.render.di_oracle import DiOracle as JDiOracle
from royaltracer_dx_tpu.render.renderer import Renderer as JRenderer
from royaltracer_dx_tpu.scene import procedural as jproc

from royaltracer_dx_tpu_torch import cli
from royaltracer_dx_tpu_torch.camera import Camera
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.ops import cluster_traverse as tct
from royaltracer_dx_tpu_torch.ops import intersect as tit
from royaltracer_dx_tpu_torch.ops import restir as trestir
from royaltracer_dx_tpu_torch.ops import stream_trace as tst
from royaltracer_dx_tpu_torch.parallel import shard as tshard
from royaltracer_dx_tpu_torch.render.di_oracle import DiOracle
from royaltracer_dx_tpu_torch.render.renderer import Renderer
from royaltracer_dx_tpu_torch.scene import procedural as tproc
from test_torch_restir import (  # noqa: F401 (one_torch_thread: autouse)
    image_close,
    one_torch_thread,
    with_lut,
)

EYE, CENTER = (0.5, 0.5, 1.72), (0.5, 0.5, 0.0)
TOL = 1e-5
# several clusters and tiles on the 32-triangle Cornell box
SMALL = dict(cluster_group=8, cluster_tile=32)


def _menger(n=None):
    v, idx = jproc.menger_sponge(2)
    tv = np.asarray(v)[np.asarray(idx)].astype(np.float32)
    return tv if n is None else tv[:n]


def _soup(n, seed=7):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n, 1, 3)).astype(np.float32)
    return c + rng.uniform(-0.08, 0.08, (n, 3, 3)).astype(np.float32)


def _rays(n=512, seed=7):
    """Box-crossing rays (tests/test_cluster.py's): origins on a sphere
    around the sponge, aimed inside it."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 2.5 + 0.5
    d = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32) - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


def _both(tv, group):
    return (jct.build_clusters(jnp.asarray(tv), group=group),
            tct.build_clusters(torch.as_tensor(tv), group=group))


def _assert_same_clusters(jcl, tcl):
    for f in ("tri_planes", "tri_index", "aabb_lo", "aabb_hi"):
        a, b = np.asarray(getattr(jcl, f)), getattr(tcl, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.fixture(scope="module")
def sponge():
    """4,001 menger triangles (not a multiple of the groups) clustered in
    groups of 32 by both packages."""
    return _both(_menger(4001), 32)


def _assert_hits(hj, ht):
    valid = np.asarray(hj.t) < 1e30
    np.testing.assert_array_equal(ht.valid.numpy(), valid)
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    for f in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(ht, f).numpy(),
                                   np.asarray(getattr(hj, f)), rtol=0,
                                   atol=TOL, err_msg=f)
    return int(valid.sum())


# ------------------------------- build -----------------------------------


@pytest.mark.parametrize("tris,group", [
    (_menger(4001), 128), (_menger(4001), 32), (_soup(333), 16),
    (_menger(256), 128)], ids=["menger4001-128", "menger4001-32",
                               "soup333-16", "menger256-128"])
def test_build_matches(tris, group):
    jcl, tcl = _both(tris, group)
    _assert_same_clusters(jcl, tcl)
    assert tcl.group == group
    assert tcl.num_clusters == -(-tris.shape[0] // group)


def test_flatten_rebuilds_clusters_under_prev():
    """Scene.flatten(build_clusters=True, cluster_group=32) builds the
    clusters of its world-space triangles, and flatten(prev=) after
    set_transform rebuilds them with the same group (JAX scene.py:
    181-187), each as the JAX build_clusters does on the same triangles
    (the two world bakes may differ by an ulp, so both start from the
    port's); no stream accel is built beside them."""
    rot = np.asarray([[0.8, 0, 0.6, 0.1], [0, 1, 0, 0], [-0.6, 0, 0.8, 0],
                      [0, 0, 0, 1]], np.float32)
    ts = cli.build_scene("menger")[0]
    ta = ts.flatten(ts.build_materials(with_lut=False, device="cpu"),
                    build_clusters=True, cluster_group=32, device="cpu")
    assert ta.stream is None and ta.clusters.group == 32
    _assert_same_clusters(jct.build_clusters(
        jnp.asarray(ta.tri_verts.numpy()), group=32), ta.clusters)
    ts.set_transform(0, rot)
    tb = ts.flatten(ta.materials, prev=ta)
    assert not torch.equal(tb.tri_verts, ta.tri_verts)
    assert tb.clusters.group == 32 and tb.stream is None
    _assert_same_clusters(jct.build_clusters(
        jnp.asarray(tb.tri_verts.numpy()), group=32), tb.clusters)


# ------------------------------- queries ---------------------------------


@pytest.mark.parametrize("tile", [128, 32])
@pytest.mark.parametrize("n", [512, 333])
def test_closest_matches_jax(sponge, n, tile):
    jcl, tcl = sponge
    o, d = _rays()
    o, d = o[:n], d[:n]
    hj = jct.closest_hit_clustered(jnp.asarray(o), jnp.asarray(d), jcl,
                                   tile=tile)
    ht = tct.closest_hit_clustered(torch.as_tensor(o), torch.as_tensor(d),
                                   tcl, tile=tile)
    assert _assert_hits(hj, ht) > n // 2


@pytest.mark.parametrize("tile", [128, 32])
@pytest.mark.parametrize("n", [512, 333])
def test_any_matches_jax(sponge, n, tile):
    jcl, tcl = sponge
    o, d = _rays()
    o, d = o[:n], d[:n]
    t_min = np.full(n, 1e-3, np.float32)
    t_max = np.where(np.arange(n) % 2 == 0, 4.0, 2.2).astype(np.float32)
    oj = jct.any_hit_clustered(jnp.asarray(o), jnp.asarray(d), jcl,
                               jnp.asarray(t_min), jnp.asarray(t_max),
                               tile=tile)
    ot = tct.any_hit_clustered(torch.as_tensor(o), torch.as_tensor(d), tcl,
                               torch.as_tensor(t_min),
                               torch.as_tensor(t_max), tile=tile)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert 0 < int(ot.sum()) < n


@pytest.mark.parametrize("mode", ["exact", "interval"])
def test_mask_tables_match_jax(sponge, mode):
    """Phase A's [tiles, C] mask and entry tables, both modes, on 512
    rays in tiles of 32."""
    jcl, tcl = sponge
    o, d = _rays()
    t_min = np.full(512, 1e-4, np.float32)
    t_max = np.full(512, 1e4, np.float32)
    jfn = (jct._tile_cluster_mask if mode == "exact"
           else jct._tile_cluster_mask_interval)
    jm, je = jfn(jnp.asarray(o), jnp.asarray(d), jcl, jnp.asarray(t_min),
                 jnp.asarray(t_max), 32)
    rows = tct.prepare_rays(torch.as_tensor(o), torch.as_tensor(d), 1e-4,
                            1e4, 32)
    tfn = tct.cluster_mask if mode == "exact" else tct._mask_interval
    tm, te = tfn(rows, tcl, 32)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    exact, _ = tct.cluster_mask(rows, tcl, 32)
    assert 0 < int(exact.sum()) < exact.numel()
    assert bool((tm | ~exact).all())           # a superset of the exact


def test_interval_mode_matches_exact(sponge):
    """The interval mask is a superset, so hits and occlusion equal the
    exact mode's (tests/test_cluster.py:88-107)."""
    _, tcl = sponge
    o, d = (torch.as_tensor(a) for a in _rays())
    he = tct.closest_hit_clustered(o, d, tcl, mask_mode="exact")
    hi = tct.closest_hit_clustered(o, d, tcl, mask_mode="interval")
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(he, f), getattr(hi, f)), f
    oe = tct.any_hit_clustered(o, d, tcl, 1e-3, 4.0, mask_mode="exact")
    oi = tct.any_hit_clustered(o, d, tcl, 1e-3, 4.0, mask_mode="interval")
    assert torch.equal(oe, oi)


def test_t_range_respected(sponge):
    """Rays cut off at half their true hit distance all miss
    (tests/test_cluster.py:110-121)."""
    _, tcl = sponge
    o, d = _rays()
    tris = _menger(4001)
    ref = tit.closest_hit_brute(torch.as_tensor(o), torch.as_tensor(d),
                                torch.as_tensor(tris))
    valid = ref.valid
    assert valid.any()
    t_cut = torch.where(valid, ref.t * 0.5, 1e-3)
    near = tct.closest_hit_clustered(torch.as_tensor(o), torch.as_tensor(d),
                                     tcl, t_min=1e-3, t_max=t_cut)
    assert not bool(near.valid[valid].any())


def test_nan_and_dead_lanes_match_jax(sponge):
    """Lanes with a NaN origin, direction, t_min or t_max, and dead lanes
    (t_max <= t_min): the same answers as the JAX functions, the
    retire rule's NaN included (a NaN t_max retires its tile, so its
    other rays miss there)."""
    jcl, tcl = sponge
    o, d = _rays()
    t_min = np.full(512, 1e-3, np.float32)
    t_max = np.full(512, 4.0, np.float32)
    o[5, 0] = np.nan
    d[40, 1] = np.nan
    t_min[77] = np.nan
    t_max[130] = np.nan            # the tile of lanes 128-159 (tile 32)
    t_max[200:260:3] = 1e-3        # dead
    t_max[300:310] = -1.0          # dead
    args_j = [jnp.asarray(a) for a in (o, d)]
    args_t = [torch.as_tensor(a) for a in (o, d)]
    hj = jct.closest_hit_clustered(*args_j, jcl, t_min=jnp.asarray(t_min),
                                   t_max=jnp.asarray(t_max), tile=32)
    ht = tct.closest_hit_clustered(*args_t, tcl,
                                   t_min=torch.as_tensor(t_min),
                                   t_max=torch.as_tensor(t_max), tile=32)
    _assert_hits(hj, ht)
    assert not ht.valid[128:160].any() and ht.valid[160:192].any()
    assert not ht.valid[300:310].any()
    oj = jct.any_hit_clustered(*args_j, jcl, jnp.asarray(t_min),
                               jnp.asarray(t_max), tile=32)
    ot = tct.any_hit_clustered(*args_t, tcl, torch.as_tensor(t_min),
                               torch.as_tensor(t_max), tile=32)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


def test_kernel_shapes_and_steps(sponge):
    """The wrappers' outputs and the per-tile stats (steps, needed
    tests): closest tests G triangles a live ray a step, any hit no more
    and fewer where a ray stopped at a hit."""
    _, tcl = sponge
    o, d = (torch.as_tensor(a) for a in _rays(333))
    rows = tct.prepare_rays(o, d, 1e-4, 1e4, 32)
    assert rows.shape == (352, 8)
    assert (rows[333:, 7] == -1.0).all() and (rows[333:, 3:6] == 1.0).all()
    wl, went, count = tct.tile_worklists(rows, tcl, 32)
    assert wl.dtype == torch.int32 and count.shape == (11,)
    assert (went[:, 1:] >= went[:, :-1]).all()
    launches = dict(tct.LAUNCHES)
    tuv, tri, cstats = tct.cluster_closest(rows, tcl, wl, went, count, 32)
    occ, astats = tct.cluster_any(rows, tcl, wl, count, 32)
    assert tct.LAUNCHES == launches
    assert tuv.shape == (352, 3) and tri.dtype == torch.int32
    assert occ.dtype == torch.int32
    assert cstats.shape == astats.shape == (11, 2)
    assert cstats.dtype == astats.dtype == torch.int64
    steps, asteps = cstats[:, 0], astats[:, 0]
    assert (steps <= count).all() and (asteps <= count).all()
    assert (steps < count).any()              # some tile retired early
    g = tcl.group
    # all 333 rays are live: closest tests G triangles a live ray a step
    live = torch.full((11,), 32)
    live[-1] = 333 - 320
    assert torch.equal(cstats[:, 1], steps * live * g)
    assert (astats[:, 1] <= asteps * live * g).all()
    assert (astats[:, 1] < asteps * live * g).any()   # stopped at a hit


def test_needed_tests_scalar_model(sponge):
    """The per-tile tests of ``_phase_b_plain`` (what the kernels' stats
    builds are held to on the card) against a ray-by-ray count over the
    steps each tile took: a live ray (t_min < t_max) tests every triangle
    of a step's cluster for closest; for any hit it stops at its first
    hit and tests nothing once occluded.  Dead, NaN and padding rays count
    nothing."""
    _, tcl = sponge
    o, d = (torch.as_tensor(a) for a in _rays(90, seed=3))
    t_max = torch.full((90,), 1e4)
    t_max[::5] = -1.0                         # dead
    t_max[1::9] = 0.6                         # short
    t_min = torch.full((90,), 1e-4)
    t_min[2::11] = float("nan")
    rows = tct.prepare_rays(o, d, t_min, t_max, 16)
    wl, went, count = tct.tile_worklists(rows, tcl, 16)
    g = tcl.group
    o, d, tn, tx = tct._rays(rows)
    for occlusion in (False, True):
        out = tct._phase_b_plain(rows, tcl, wl, None if occlusion else went,
                                 count, 16, occlusion)
        stats = out[-1]
        want = []
        for t in range(rows.shape[0] // 16):
            n = 0
            for r in range(t * 16, (t + 1) * 16):
                if not bool(tn[r] < tx[r]):
                    continue
                for k in range(int(stats[t, 0])):
                    hit, _, _ = tct._mt_tile(
                        o[r][None, None], d[r][None, None],
                        tcl.tri_planes[wl[t, k].long()][None],
                        tn[r][None, None], tx[r][None, None])
                    lanes = torch.nonzero(hit[0, 0] < 1e30)[:, 0]
                    if not occlusion:
                        n += g
                    elif lanes.numel():
                        n += int(lanes[0]) + 1
                        break
                    else:
                        n += g
            want.append(n)
        assert stats[:, 1].tolist() == want, occlusion
        assert sum(want) > 0


def test_kernel_limits_refuse():
    """The CUDA kernels take tiles and groups of 1 to 1024: beyond, a
    ValueError names the limit (no quiet fallback)."""
    for tile, group in ((2048, 128), (0, 128), (128, 1025)):
        with pytest.raises(ValueError, match="1024"):
            tct._check_limits(tile, group)
    tct._check_limits(1024, 1024)


@pytest.mark.parametrize("tile", [128, 96])
def test_trace_pieces_follow_jax_chunks(tile):
    """Above 2^22 rays the JAX package traces 128-aligned chunks
    (``_chunked_rays``, read off here); a tile that divides 128 keeps the
    global tiles there, so the port traces such a batch in one piece; a
    tile that does not would be cut by the chunks, so the port refuses
    the batch (and takes it at 2^22 rays)."""
    n = (1 << 22) + 1000
    pos = np.asarray(jrestir._chunked_rays(
        lambda x: jnp.arange(x.shape[0], dtype=jnp.int32), n,
        (jnp.zeros(n, jnp.float32),), (0.0,)))
    starts = np.flatnonzero(pos == 0)
    assert len(starts) == 2 and (starts % 128 == 0).all()
    assert trestir.cluster_tile_for(1 << 22, tile) == tile
    if tile == 128:
        assert trestir.cluster_tile_for(n, tile) == tile
    else:
        assert (starts % tile != 0).any()     # a chunk cuts a tile
        with pytest.raises(ValueError, match="divides 128"):
            trestir.cluster_tile_for(n, tile)


# ------------------------------- frames ----------------------------------


def test_megakernel_frame_matches_jax():
    """A 32x27 megakernel frame (3 bounces) on the Cornell box with
    traversal="cluster" against the JAX Renderer's."""
    cfg = dict(width=32, height=27, max_bounces=3, traversal="cluster",
               **SMALL)
    jrr = JRenderer(jproc.cornell_box(emission=18.0),
                    JCamera(eye=EYE, center=CENTER), JConfig(**cfg))
    jrr.render()
    jrr.render()
    r = Renderer(tproc.cornell_box(emission=18.0),
                 Camera(eye=EYE, center=CENTER), RenderConfig(**cfg),
                 device="cpu")
    assert r.scene_arrays.clusters is not None
    with_lut(r, np.asarray(jrr.scene_arrays.materials.lut))
    r.render()
    r.render()
    image_close(r.radiance(), np.asarray(jrr.radiance()))
    assert r.metrics["rays_traced"] == jrr.metrics["rays_traced"]


def test_di_oracle_matches_jax_brute():
    """The DiOracle under traversal="cluster" builds its clusters (the
    JAX oracle builds none and fails there) and matches the JAX oracle at
    its brute-force default."""
    jo = JDiOracle(jproc.cornell_box(emission=18.0),
                   JCamera(eye=EYE, center=CENTER),
                   JConfig(width=32, height=27))
    jo.render()
    jo.render()
    o = DiOracle(tproc.cornell_box(emission=18.0),
                 Camera(eye=EYE, center=CENTER),
                 RenderConfig(width=32, height=27, traversal="cluster",
                              **SMALL), device="cpu")
    assert o.scene_arrays.clusters.num_clusters == 4
    mats = dataclasses.replace(o.scene_arrays.materials, lut=torch.as_tensor(
        np.asarray(jo.scene_arrays.materials.lut)))
    o.scene_arrays = dataclasses.replace(o.scene_arrays,
                                         materials=mats).with_tri_table()
    o.render()
    o.render()
    image_close(o.radiance(), np.asarray(jo.radiance()))


def test_sharded_renderer_renders_cluster(tmp_path):
    """``--devices 2 --traversal cluster`` through the CLI: both bands
    flatten with their clusters, and a refit ``--animate`` rebuilds
    them."""
    res = cli.main(["--cpu", "--devices", "2", "--traversal", "cluster",
                    "--scene", "menger", "--animate", "--width", "16",
                    "--height", "16", "--frames", "2", "--out",
                    str(tmp_path / "b.png")])
    r = res["renderer"]
    assert isinstance(r, tshard.ShardedRestirRenderer)
    assert r.scene_arrays.clusters is not None
    assert r.scene_arrays.stream is None and len(res["refit_ms"]) == 2
    img = r.radiance()
    assert r.frame == 2 and np.isfinite(img).all() and img.mean() > 0.0


# ----------------------------- stream builds -----------------------------


@pytest.mark.parametrize("method", ["morton", "median_host"])
def test_flatten_stream_methods_match_jax(method):
    """Scene.flatten(stream_method=) builds the accel of its triangles as
    the JAX build does (perm, boxes and rows exactly; whole blocks, not a
    power of two: menger's 4,802 triangles take 3 blocks), and the stream
    kernels' plain version traces it as brute force does."""
    ts = cli.build_scene("menger")[0]
    sa = ts.flatten(ts.build_materials(with_lut=False, device="cpu"),
                    build_stream=True, stream_method=method, device="cpu")
    ja = jst.build_stream_accel(jnp.asarray(sa.tri_verts.numpy()),
                                method=method)
    for f in ("perm", "blk_tris", "blk_boxes", "top_lo", "top_hi"):
        np.testing.assert_array_equal(getattr(sa.stream, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    assert sa.stream.num_blocks == 3
    o, d = (torch.as_tensor(a) for a in _rays(300, seed=3))
    hs = tst.closest_hit_stream(o, d, sa.stream)
    hb = tit.closest_hit_brute(o, d, sa.tri_verts)
    np.testing.assert_allclose(hs.t.numpy(), hb.t.numpy(), rtol=0, atol=TOL)
    assert hs.valid.sum() > 100
    occ = tst.any_hit_stream(o, d, sa.stream, 1e-3, 2.5)
    ob = tit.any_hit_brute(o, d, sa.tri_verts, 1e-3, 2.5)
    assert torch.equal(occ, ob)


def test_stream_methods_match_jax_on_a_soup():
    """The two builds on a soup of 5,000 triangles (three blocks)."""
    tris = _soup(5000)
    for method in ("morton", "median_host"):
        ja = jst.build_stream_accel(jnp.asarray(tris), method=method)
        ta = tst.build_stream_accel(torch.as_tensor(tris), method=method)
        for f in ("perm", "blk_tris", "blk_boxes", "top_lo", "top_hi"):
            np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                          np.asarray(getattr(ja, f)),
                                          err_msg=f"{method} {f}")
    with pytest.raises(ValueError, match="median_host"):
        tst.build_stream_accel(torch.as_tensor(tris), method="sah")
