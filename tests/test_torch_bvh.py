"""The port's LBVH (ops/bvh.py), its traversal's plain versions
(ops/traverse.py) and an LBVH ReSTIR frame against the JAX package.

The build is integer and ordering work, so nodes, sorted triangles and
perm must equal the JAX package's bit for bit (the stable Morton sort
included).  The walks are held to the JAX walks: triangle ids and
occlusion equal, t within 1e-5, and u and v within 1e-5 plus the float32
rounding of their Moller-Trumbore quotient (``_uv_tol``: on the soup's
5 cm triangles seen from 1.5 m, the numerator cancels and an ulp of
XLA-vs-PyTorch drift in its sum moves u by up to ~1e-4 -- the JAX value
itself is that far from the float64 one).  The frame is held to the JAX renderer at
the tolerances of tests/test_torch_restir.py.  On the CPU the kernel
wrappers run the plain versions and launch nothing.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.camera import Camera as JCamera
from royaltracer_dx_tpu.config import RenderConfig as JConfig
from royaltracer_dx_tpu.ops import bvh as jbvh
from royaltracer_dx_tpu.ops import traverse as jtr
from royaltracer_dx_tpu.render import restir_renderer as jr
from royaltracer_dx_tpu.scene import procedural as jproc

from royaltracer_dx_tpu_torch import cli
from royaltracer_dx_tpu_torch.camera import Camera
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.ops import bvh as tbvh
from royaltracer_dx_tpu_torch.ops import intersect as tit
from royaltracer_dx_tpu_torch.ops import traverse as ttr
from royaltracer_dx_tpu_torch.render.di_oracle import DiOracle
from royaltracer_dx_tpu_torch.render.renderer import Renderer
from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
from royaltracer_dx_tpu_torch.scene import procedural as tproc
from test_torch_restir import (  # noqa: F401 (one_torch_thread: autouse)
    image_close,
    one_torch_thread,
    with_lut,
)

EYE, CENTER = (0.5, 0.5, 1.72), (0.5, 0.5, 0.0)
TOL = 1e-5


def _tris(n, seed=2):
    v, idx = jproc.random_tris(n, seed=seed)
    return np.asarray(v[idx], np.float32)


def _cornell_tris():
    s = jproc.cornell_box()
    return np.array(s.flatten(s.build_materials(with_lut=False)).tri_verts)


def _rays(case, n=1024, seed=3):
    """(triangles, origins, dirs, t_min, t_max): rays aimed at the soup's
    triangles from outside it (most hit), or from inside the Cornell box;
    every eighth lane is dead (t_max < t_min)."""
    rng = np.random.default_rng(seed)
    if case == "soup":
        tris = _tris(1000)
        o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
        aim = tris[rng.integers(0, len(tris), n)].mean(axis=1)
        d = aim + rng.normal(scale=1e-3, size=(n, 3)) - o
    else:
        tris = _cornell_tris()
        o = (rng.uniform(-0.9, 0.9, (n, 3)) * 0.4 + 0.5).astype(np.float32)
        d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.where(np.arange(n) % 8 == 0, -1.0, 1e4).astype(np.float32)
    return tris, o, d, t_min, t_max


def _uv_tol(tris, tri, o, d):
    """Per lane, 1e-5 plus 8 float32 ulps of the u / v quotient's
    condition |o - v0| |d x e2| / |det| (float64, from the hit
    triangle)."""
    v = tris[tri].astype(np.float64)
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    pc = np.cross(d.astype(np.float64), e2)
    det = np.abs(np.sum(e1 * pc, axis=1))
    cond = (np.linalg.norm(o - v[:, 0], axis=1) * np.linalg.norm(pc, axis=1)
            / np.maximum(det, 1e-30))
    return 1e-5 + 8 * 2.0 ** -24 * cond


def _both(tris, leaf_size=4):
    return (jbvh.build_lbvh(jnp.asarray(tris), leaf_size=leaf_size),
            tbvh.build_lbvh(torch.as_tensor(tris), leaf_size=leaf_size))


def _assert_same_bvh(jb, tb):
    for f in ("nodes", "sorted_tris", "perm"):
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


# ------------------------------- build ------------------------------------


def test_morton_codes_match():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 3, (4096, 3)).astype(np.float32)
    pts[:8] = [[-2, -2, -2], [3, 3, 3], [0.5, 0.5, 0.5], [1e30, 0, 0],
               [-2, 3, -2], [3, -2, 3], [0, 0, 0], [2.9999, -1.9999, 0]]
    lo = np.asarray([-2, -2, -2], np.float32)
    hi = np.asarray([3, 3, 3], np.float32)
    a = np.asarray(jbvh.morton_codes(jnp.asarray(pts), jnp.asarray(lo),
                                     jnp.asarray(hi)))
    b = tbvh.morton_codes(torch.as_tensor(pts), torch.as_tensor(lo),
                          torch.as_tensor(hi)).numpy()
    np.testing.assert_array_equal(b, a.astype(np.int64))
    assert b.max() < 2 ** 30


@pytest.mark.parametrize("p", [1, 2, 4, 64, 1024])
def test_dfs_links_match(p):
    for a, b in zip(jbvh.dfs_links(p, p), tbvh.dfs_links(p, p)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("num_tris,leaf_size",
                         [(100, 2), (100, 4), (1000, 2), (1000, 4)])
def test_build_matches(num_tris, leaf_size):
    _assert_same_bvh(*_both(_tris(num_tris), leaf_size))


def test_build_duplicate_centroids_match():
    """Equal Morton codes keep their input order (the stable sort): many
    copies of a few triangles, and triangles sharing a centroid."""
    base = _tris(12, seed=5)
    tris = np.concatenate([base] * 20 + [base[:, ::-1]])
    _assert_same_bvh(*_both(tris, 4))


def test_refit_matches():
    tris = _tris(300, seed=6)
    jb, tb = _both(tris, 4)
    rng = np.random.default_rng(7)
    moved = (tris + np.asarray([0.5, 0.0, -0.2], np.float32)
             + rng.normal(scale=0.05, size=tris.shape).astype(np.float32))
    _assert_same_bvh(jbvh.refit_lbvh(jb, jnp.asarray(moved)),
                     tbvh.refit_lbvh(tb, torch.as_tensor(moved)))


def test_link_helpers_match_tables():
    """The analytic links of the walk against the numpy tables: skip(k)
    for every node, and the subtree test by walking up the heap."""
    p = 64
    _, skip = tbvh.dfs_links(p, p)
    k = torch.arange(1, 2 * p)
    np.testing.assert_array_equal(ttr._skip_link(k).numpy(), skip[1:])
    np.testing.assert_array_equal(
        ttr._bitlen(k).numpy(), [int(x).bit_length() for x in k])
    root = torch.full_like(k, 5)
    want = [x >> max(int(x).bit_length() - 3, 0) == 5 for x in range(1, 2 * p)]
    np.testing.assert_array_equal(ttr._in_subtree(k, root).numpy(), want)


# ------------------------------- walks -------------------------------------


@pytest.mark.parametrize("case", ["soup", "cornell"])
def test_closest_matches_jax(case):
    tris, o, d, t_min, t_max = _rays(case)
    jb, tb = _both(tris, 4)
    hj = jtr.closest_hit_bvh(jnp.asarray(o), jnp.asarray(d), jb,
                             t_min=jnp.asarray(t_min), t_max=jnp.asarray(t_max))
    launches = dict(ttr.LAUNCHES)
    ht = ttr.closest_hit_bvh(torch.as_tensor(o), torch.as_tensor(d), tb,
                             torch.as_tensor(t_min), torch.as_tensor(t_max))
    assert ttr.LAUNCHES == launches            # CPU tensors launch nothing
    hit = np.asarray(hj.t) < 1e29
    assert hit.mean() > 0.5
    np.testing.assert_array_equal(ht.tri.numpy(), np.asarray(hj.tri))
    np.testing.assert_array_equal(ht.t.numpy() < 1e29, hit)
    np.testing.assert_allclose(ht.t.numpy()[hit], np.asarray(hj.t)[hit],
                               rtol=TOL, atol=TOL)
    tol = _uv_tol(tris, np.asarray(hj.tri)[hit], o[hit], d[hit])
    for f in ("u", "v"):
        diff = np.abs(getattr(ht, f).numpy() - np.asarray(getattr(hj, f)))
        assert (diff[hit] <= tol).all(), f
        assert (diff[hit] <= TOL).mean() >= 0.9, f
    assert not hit[t_max < t_min].any()


@pytest.mark.parametrize("case", ["soup", "cornell"])
def test_any_matches_jax(case):
    tris, o, d, t_min, _ = _rays(case, seed=4)
    rng = np.random.default_rng(5)
    t_max = rng.uniform(0.0, 2.0, len(o)).astype(np.float32)
    t_max[::8] = 0.0                           # masked: t_max <= t_min
    jb, tb = _both(tris, 4)
    oj = np.asarray(jtr.any_hit_bvh(jnp.asarray(o), jnp.asarray(d), jb,
                                    jnp.asarray(t_min), jnp.asarray(t_max)))
    ot = ttr.any_hit_bvh(torch.as_tensor(o), torch.as_tensor(d), tb,
                         torch.as_tensor(t_min),
                         torch.as_tensor(t_max)).numpy()
    np.testing.assert_array_equal(ot, oj)
    assert 0.05 < ot.mean() < 0.95
    assert not ot[t_max <= t_min].any()


def test_closest_matches_brute():
    tris, o, d, t_min, t_max = _rays("soup", seed=9)
    _, tb = _both(tris, 2)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    hb = tit.closest_hit_brute(ot, dt, torch.as_tensor(tris),
                               torch.as_tensor(t_min), torch.as_tensor(t_max))
    ht = ttr.closest_hit_bvh(ot, dt, tb, torch.as_tensor(t_min),
                             torch.as_tensor(t_max))
    np.testing.assert_allclose(ht.t.numpy(), hb.t.numpy(), rtol=TOL, atol=TOL)
    hit = hb.valid.numpy()
    np.testing.assert_array_equal(ht.tri.numpy()[hit], hb.tri.numpy()[hit])


def test_walk_skips_padding():
    """100 triangles in leaves of 4 pad 25 real leaves to 32: the walks
    test no padding leaf (an empty box is missed; see ops/traverse.py)
    and answer as the JAX walks do, which walk every padding subtree."""
    tris, o, d, t_min, t_max = _rays("soup", n=256, seed=12)
    tris = tris[:100]
    jb, tb = _both(tris, 4)
    assert tb.num_leaves == 32 and int((tb.perm >= 0).sum()) == 100
    rays = ttr.pack_rays(torch.as_tensor(o), torch.as_tensor(d),
                         torch.as_tensor(t_min), torch.as_tensor(t_max))
    tuv, tri, st = ttr.bvh_closest(rays, tb, stats=True)
    hj = jtr.closest_hit_bvh(jnp.asarray(o), jnp.asarray(d), jb,
                             t_min=jnp.asarray(t_min),
                             t_max=jnp.asarray(t_max))
    np.testing.assert_array_equal(tri.numpy(), np.asarray(hj.tri))
    # at most the 25 real leaves, of which the last holds padding slots
    assert int(st[:, 1].max()) <= 25 * 4
    occ, st_a = ttr.bvh_any(rays, tb, stats=True)
    assert int(st_a[:, 1].max()) <= 25 * 4
    empty = tb.nodes[1:, 0] > tb.nodes[1:, 3]
    assert int(empty.sum()) > 0


def test_bvh_work_counts():
    """The work of a call from its walk counts: bytes are the rays, the
    outputs and the tree; operations one root scan of each live closest
    lane (``top_scan_tests``: at most S a lane), the node slab tests and
    the triangle tests; ``dense_top_fp32_ops`` counts S root tests a
    live closest lane instead."""
    tris, o, d, t_min, t_max = _rays("soup", n=512)
    _, tb = _both(tris, 4)
    rays = ttr.pack_rays(torch.as_tensor(o), torch.as_tensor(d),
                         torch.as_tensor(t_min), torch.as_tensor(t_max))
    _, _, st = ttr.bvh_closest(rays, tb, stats=True)
    w = ttr.bvh_work(rays, tb, st, closest=True)
    p = tb.num_leaves
    tree = 2 * p * 6 * 4 + p * 4 * 9 * 4 + p * 4 * 4
    assert w["bytes"] == 512 * 48 + tree
    live = int((t_max > t_min).sum())
    assert w["live_lanes"] == live == 448
    top = ttr.top_scan_tests(rays, tb)
    assert w["top_tests"] == int(top.sum())
    assert int(top[~torch.as_tensor(t_max > t_min)].abs().sum()) == 0
    assert 0 < w["top_tests"] < live * min(256, p)
    assert w["fp32_ops"] == ((w["top_tests"] + w["node_tests"])
                             * ttr.SLAB_OPS + w["tri_tests"] * ttr.MT_OPS)
    assert w["dense_top_fp32_ops"] == (
        (live * min(256, p) + w["node_tests"]) * ttr.SLAB_OPS
        + w["tri_tests"] * ttr.MT_OPS)
    assert w["tri_tests"] % 4 == 0 and w["node_tests"] >= w["tri_tests"] // 4
    occ, st_a = ttr.bvh_any(rays, tb, stats=True)
    wa = ttr.bvh_work(rays, tb, st_a, closest=False)
    assert wa["bytes"] == 512 * 36 + tree - p * 4 * 4


# ------------------------------ scenes and frames ---------------------------


def test_flatten_builds_and_refits_the_lbvh():
    """Scene.flatten(build_bvh=True) builds the LBVH of its world-space
    triangles, and flatten(prev=) after set_transform refits it, each as
    the JAX package's build_lbvh / refit_lbvh do on the same triangles
    (the two world bakes may differ by an ulp, so both sides start from
    the port's)."""
    rot = np.asarray([[0.8, 0, 0.6, 0.1], [0, 1, 0, 0], [-0.6, 0, 0.8, 0],
                      [0, 0, 0, 1]], np.float32)
    ts = cli.build_scene("menger")[0]
    ta = ts.flatten(ts.build_materials(with_lut=False, device="cpu"),
                    build_bvh=True, device="cpu")
    assert ta.stream is None and ta.bvh.leaf_size == 4
    jb = jbvh.build_lbvh(jnp.asarray(ta.tri_verts.numpy()), leaf_size=4)
    _assert_same_bvh(jb, ta.bvh)
    ts.set_transform(0, rot)
    tb = ts.flatten(ta.materials, prev=ta)
    assert not torch.equal(tb.tri_verts, ta.tri_verts)
    _assert_same_bvh(jbvh.refit_lbvh(jb, jnp.asarray(tb.tri_verts.numpy())),
                     tb.bvh)


def test_cornell_bvh_frames_match_jax():
    """A 32x27 Cornell ReSTIR frame with traversal="bvh" against the JAX
    renderer's, at tests/test_torch_restir.py's image tolerance."""
    cfg = dict(width=32, height=27, traversal="bvh")
    jrr = jr.RestirRenderer(jproc.cornell_box(emission=18.0),
                            JCamera(eye=EYE, center=CENTER), JConfig(**cfg))
    jrr.render()
    jrr.render()
    r = RestirRenderer(tproc.cornell_box(emission=18.0),
                       Camera(eye=EYE, center=CENTER), RenderConfig(**cfg),
                       device="cpu")
    assert r.scene_arrays.bvh is not None
    with_lut(r, np.asarray(jrr.scene_arrays.materials.lut))
    launches = dict(ttr.LAUNCHES)
    r.render()
    r.render()
    assert ttr.LAUNCHES == launches
    image_close(r.radiance(), np.asarray(jrr.radiance()))


@pytest.mark.parametrize("which", ["restir", "megakernel", "di_oracle"])
def test_bvh_frames_equal_brute(which):
    """Both traversals are exact, so on the Cornell box at 32x27 (no pixel
    ray on a shared triangle edge, where the two could pick different
    triangles at an equal t) the bvh frame equals the brute-force frame
    of every renderer."""
    imgs = []
    for trav in ("bvh", "brute"):
        cfg = RenderConfig(width=32, height=27, traversal=trav,
                           max_bounces=3)
        cam = Camera(eye=EYE, center=CENTER)
        scene = tproc.cornell_box(emission=18.0)
        if which == "di_oracle":
            r = DiOracle(scene, cam, cfg, device="cpu")
            assert (r.scene_arrays.bvh is not None) == (trav == "bvh")
        else:
            cls = RestirRenderer if which == "restir" else Renderer
            r = cls(scene, cam, cfg, device="cpu")
            assert (r.scene_arrays.bvh is not None) == (trav == "bvh")
        r.render()
        r.render()
        imgs.append(r.radiance())
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert imgs[0].mean() > 0.0


def test_cli_bvh_renders_and_resumes(tmp_path):
    ck = str(tmp_path / "ck.npz")
    out = str(tmp_path / "c.png")
    argv = ["--cpu", "--bvh", "--scene", "cornell", "--width", "32",
            "--height", "32", "--out", out, "--checkpoint", ck]
    res = cli.main([*argv, "--frames", "2"])
    r = res["renderer"]
    assert r.cfg.accel == "bvh" and r.scene_arrays.bvh is not None
    res = cli.main([*argv, "--frames", "1"])
    r = res["renderer"]
    assert r.frame == 3 and float(r.fb.count.min()) == 3.0
    assert np.isfinite(r.radiance()).all()


def test_scene_arrays_field_matches_jax():
    from royaltracer_dx_tpu.scene.types import SceneArrays as JSA

    from royaltracer_dx_tpu_torch.scene.types import SceneArrays as TSA

    port = [f.name for f in dataclasses.fields(TSA)]
    assert "bvh" in port and "bvh" in JSA.__dataclass_fields__
