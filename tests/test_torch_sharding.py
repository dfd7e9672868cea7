"""Pixel-band sharding (parallel/shard.py) on the CPU: bands on repeated
CPU devices against the port's single-device renderer, the band
arguments of the passes against the JAX passes, and the sharded
checkpoint across the two packages.

The sharded frame must equal the single-device frame on the full image at
``rtol=1e-5, atol=1e-6`` (tests/test_sharding.py:137): with a halo of at
least the spatial radius every tap and reprojection reads the same record
as on one device, and each band's rays trace the same chunks.  It is held
on the Cornell box (brute force) and on the menger scene with
traversal="stream", the regime in which the JAX package's sharded
renderer crashes (ROADMAP C).  Nothing here compiles a JAX ``shard_map``:
the band passes are held against one jitted JAX pass each.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from royaltracer_dx_tpu.camera import Camera as JCamera
from royaltracer_dx_tpu.config import RenderConfig as JConfig
from royaltracer_dx_tpu.io import checkpoint as jck
from royaltracer_dx_tpu.parallel import shard as jshard
from royaltracer_dx_tpu.render import restir_renderer as jr
from royaltracer_dx_tpu.scene import procedural as jproc

from royaltracer_dx_tpu_torch import cli, convert
from royaltracer_dx_tpu_torch.camera import Camera, generate_rays
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.io import checkpoint as tck
from royaltracer_dx_tpu_torch.ops import restir as trestir
from royaltracer_dx_tpu_torch.parallel import shard as tshard
from royaltracer_dx_tpu_torch.render import megakernel as tmk
from royaltracer_dx_tpu_torch.render import restir_renderer as tr
from royaltracer_dx_tpu_torch.scene.procedural import cornell_box
from royaltracer_dx_tpu_torch.utils.rng import pixel_seed
from test_torch_restir import (  # noqa: F401 (one_torch_thread: autouse)
    assert_lanes,
    jax_scene_dict,
    one_torch_thread,
    to_t,
)

EYE, CENTER = (0.5, 0.5, 1.72), (0.5, 0.5, 0.0)
RTOL, ATOL = 1e-5, 1e-6
SMALL = dict(width=16, height=16, gi_bounces=1, nee_samples=2,
             nee_samples_di=2, spatial_radius=4)


def _cam():
    return Camera(eye=EYE, center=CENTER)


def _pair(cfg, devices, frames, scene_fn=None):
    """(single-device renderer, sharded renderer) after ``frames`` frames
    each, on the CPU."""
    scene_fn = scene_fn or (lambda: (cornell_box(emission=18.0), _cam()))
    s, c = scene_fn()
    ref = tr.RestirRenderer(s, c, cfg, device="cpu")
    s, c = scene_fn()
    shr = tshard.ShardedRestirRenderer(s, c, cfg, devices=devices)
    for _ in range(frames):
        ref.render()
        shr.render()
    return ref, shr


# ------------------------------ geometry -----------------------------------


def test_pad_to_devices():
    assert tshard.pad_to_devices(100, 8) == 104
    assert tshard.pad_to_devices(104, 8) == 104
    assert tshard.pad_to_devices(1, 3) == 3


def test_band_geometry_and_its_error():
    cfg = RenderConfig(width=8, height=12, spatial_radius=5)
    assert tshard._band_geometry(2, cfg) == (2, 6, 5)
    assert tshard._band_geometry(4, cfg) == (4, 3, 3)   # halo <= band
    with pytest.raises(ValueError, match="not divisible by 5 devices"):
        tshard._band_geometry(5, cfg)
    with pytest.raises(ValueError, match="not divisible"):
        tshard.ShardedRestirRenderer(cornell_box(), _cam(),
                                     RenderConfig(width=8, height=10),
                                     devices=["cpu"] * 4)


def test_halo_extend_rows():
    """Each band gets the neighbours' adjacent rows, zeros at the image's
    outer edges."""
    rows = [torch.arange(b * 6, (b + 1) * 6, dtype=torch.float32)[:, None]
            .expand(6, 8) for b in range(3)]
    ext = tshard.halo_extend([(r, r + 100, r + 200) for r in rows],
                             [torch.device("cpu")] * 3, 2)
    assert len(ext) == 3 and all(len(e) == 3 for e in ext)
    np.testing.assert_array_equal(ext[0][0][:, 0].numpy(),
                                  [0, 0, 0, 1, 2, 3, 4, 5, 6, 7])
    np.testing.assert_array_equal(ext[1][0][:, 0].numpy(),
                                  [4, 5, 6, 7, 8, 9, 10, 11, 12, 13])
    np.testing.assert_array_equal(ext[2][1][:, 0].numpy(),
                                  [110, 111, 112, 113, 114, 115, 116, 117,
                                   0, 0])


def test_sharded_trace_matches_trace_paths():
    """make_sharded_trace on four CPU bands equals trace_paths on the
    whole batch; the rays traced add up."""
    cfg = RenderConfig(width=64, height=8, max_bounces=2)
    s = cornell_box()
    sa = s.flatten(s.build_materials(device="cpu"), device="cpu")
    cam = Camera(eye=(0.5, 0.6, 2.2), center=(0.5, 0.5, 0.0))
    ca = {k: torch.as_tensor(v) for k, v in cam.matrices(8.0).items()}
    o, d = generate_rays(ca, 64, 8)
    ys, xs = torch.meshgrid(torch.arange(8), torch.arange(64), indexing="ij")
    seeds = pixel_seed(xs.reshape(-1), ys.reshape(-1), 2, 1)
    single, rays = tmk.trace_paths(sa, o, d, seeds, cfg)
    step = tshard.make_sharded_trace(["cpu"] * 4, cfg)
    sharded, rays_s = step(sa, o, d, seeds)
    np.testing.assert_allclose(sharded.numpy(), single.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert np.isclose(float(rays), rays_s)
    with pytest.raises(ValueError, match="bands"):
        step(sa, o[:-1], d[:-1], seeds[:-1])


def test_sharded_frame_runs_and_converges():
    """make_sharded_restir_frame on four CPU bands (tests/test_sharding.py
    :63-105): finite samples, the packed DI confidence m grows over the
    frames (the last tables ping-pong), and the occupancy vector."""
    cfg = RenderConfig(width=16, height=16, gi_bounces=1, nee_samples=2,
                       nee_samples_di=2)
    devs = ["cpu"] * 4
    s = cornell_box(emission=18.0)
    sa = s.flatten(s.build_materials(device="cpu"), device="cpu")
    cam = {k: torch.as_tensor(v) for k, v in _cam().matrices(1.0).items()}
    cam["prev_view"], cam["prev_proj"] = cam["view"], cam["proj"]
    xs = [torch.arange(16).repeat(4) for _ in range(4)]
    ys = [torch.arange(b * 4, b * 4 + 4).repeat_interleave(16)
          for b in range(4)]
    zero = tuple(torch.zeros((64, 8)) for _ in range(3))
    pdi, pgi = [zero] * 4, [zero] * 4
    frame_fn = tshard.make_sharded_restir_frame(devs, cfg)
    m_prev = 0.0
    for f in range(3):
        sample, pdi, pgi, l1, occ = frame_fn([sa] * 4, [cam] * 4, f, xs, ys,
                                             pdi, pgi)
        smp = torch.cat(sample).numpy()
        assert np.isfinite(smp).all()
        m_now = float(torch.cat([p[2][:, 7] for p in pdi]).mean())
        assert m_now >= m_prev
        m_prev = m_now
    assert smp.mean() > 0.0 and m_prev > 1.0
    assert occ.shape == (1 + cfg.gi_bounces,) and 0.0 < occ[0] <= 1.0


# ------------------------- sharded == single device -------------------------


@pytest.mark.parametrize("n_dev,frames", [(2, 3), (4, 2)])
def test_sharded_cornell_equals_single(n_dev, frames):
    """32x64 Cornell (tests/test_sharding.py:122-125), brute force."""
    cfg = RenderConfig(width=32, height=64, spatial_radius=4,
                       spatial_max_tries=4)
    ref, shr = _pair(cfg, ["cpu"] * n_dev, frames)
    b = shr.radiance()
    assert np.isfinite(b).all() and b.mean() > 0.0
    np.testing.assert_allclose(b, ref.radiance(), rtol=RTOL, atol=ATOL)
    assert float(shr.fb.count.min()) == frames
    assert len(shr.bands) == n_dev


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_menger_stream_equals_single(n_dev):
    """The menger scene (4,802 triangles) with traversal="stream": the
    CPU dispatch sends coherent batches through the stream kernels' plain
    version, in 128-ray chunks that each band's 256 or 512 lanes split
    alike."""
    cfg = RenderConfig(width=32, height=32, traversal="stream",
                       spatial_radius=8)
    ref, shr = _pair(cfg, ["cpu"] * n_dev, 2,
                     lambda: cli.build_scene("menger"))
    assert shr.scene_arrays.stream is not None
    np.testing.assert_allclose(shr.radiance(), ref.radiance(), rtol=RTOL,
                               atol=ATOL)


def test_metrics_and_profile_match_single():
    """tests/test_sharding.py:166-208: the same ray metrics, and in
    profile mode per-stage times, the same occupancy and the same image."""
    cfg = RenderConfig(**SMALL)
    ref, shr = _pair(cfg, ["cpu"] * 2, 1)
    for key in ("rays_traced", "ray_lanes", "pass1_sampling", "mrays_per_s",
                "mray_lanes_per_s", "frame_time_s", "fps", "frame"):
        assert key in ref.metrics and key in shr.metrics
    assert np.isclose(ref.metrics["rays_traced"], shr.metrics["rays_traced"],
                      rtol=1e-5)
    assert ref.metrics["ray_lanes"] == shr.metrics["ray_lanes"]
    assert shr.metrics["devices"] == 2
    ref.profile = shr.profile = True
    ref.render()
    shr.render()
    assert set(shr.metrics["occupancy"]) == set(ref.metrics["occupancy"])
    for k, v in ref.metrics["occupancy"].items():
        assert np.isclose(v, shr.metrics["occupancy"][k], atol=1e-6)
    assert {"pass1_di", "pass1_gi", "pass2_temporal",
            "pass3_spatial"} <= set(ref.metrics["pass_times_s"])
    assert {"pass1", "pass2_temporal", "pass3_spatial"} <= set(
        shr.metrics["pass_times_s"])
    np.testing.assert_allclose(shr.radiance(), ref.radiance(), rtol=RTOL,
                               atol=ATOL)


def test_seed_mode_time():
    cfg = RenderConfig(**SMALL, seed_mode="time", temporal_reuse=False)
    r = tshard.ShardedRestirRenderer(cornell_box(emission=18.0), _cam(), cfg,
                                     devices=["cpu"] * 2)
    r.render()
    a = r.fb.accum.numpy().copy()
    r.render()
    b = r.fb.accum.numpy() - a
    assert np.isfinite(b).all()
    assert np.abs(b - a).max() > 0.0


def test_camera_moves_match_single():
    """After a camera move the framebuffer restarts; within the halo the
    reprojections read the same records as on one device."""
    cfg = RenderConfig(width=32, height=32, spatial_radius=8)
    ref, shr = _pair(cfg, ["cpu"] * 2, 2)
    for r in (ref, shr):
        r.update(camera=r.camera.orbited(0.01, 0.0))
        r.render()
    assert float(shr.fb.count.max()) == 1.0
    np.testing.assert_allclose(shr.radiance(), ref.radiance(), rtol=RTOL,
                               atol=ATOL)


# ------------------------------- checkpoint ---------------------------------


def test_checkpoint_round_trip(tmp_path):
    cfg = RenderConfig(**SMALL)
    a = tshard.ShardedRestirRenderer(cornell_box(emission=18.0), _cam(), cfg,
                                     devices=["cpu"] * 2)
    a.render()
    a.render()
    path = str(tmp_path / "shard.npz")
    tck.save_renderer_state(path, a)
    a.render()
    b = tshard.ShardedRestirRenderer(cornell_box(emission=18.0), _cam(), cfg,
                                     devices=["cpu"] * 2)
    tck.load_renderer_state(path, b)
    assert b.frame == 2
    b.render()
    np.testing.assert_array_equal(b.radiance(), a.radiance())
    with pytest.raises(ValueError, match="sharded_restir"):
        tck.load_renderer_state(path, tr.RestirRenderer(
            cornell_box(), _cam(), cfg, device="cpu"))


def test_shards_from_legacy_matches_jax():
    rng = np.random.default_rng(4)
    rows = rng.normal(size=(64, 26)).astype(np.float32)
    rows[:, 12] = rng.integers(0, 5, 64)
    rows[:, 13] = rng.integers(0, 3, 64)
    rows[:8, 9:12] = 0.0
    rows[8:16, 23:26] = -1.0
    for keys_j, keys_t in ((jr._DI_KEYS, tr._DI_KEYS),
                           (jr._GI_KEYS, tr._GI_KEYS)):
        a = jr._shards_from_legacy(jnp.asarray(rows), keys_j)
        b = tr._shards_from_legacy(torch.as_tensor(rows), keys_t)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def test_legacy_checkpoint_loads(tmp_path):
    """A legacy npz with monolithic [N, 26] packed tables loads through
    _shards_from_legacy."""
    cfg = RenderConfig(**SMALL)
    r = tshard.ShardedRestirRenderer(cornell_box(emission=18.0), _cam(), cfg,
                                     devices=["cpu"] * 2)
    r.render()
    st = r.state_dict()
    rng = np.random.default_rng(5)
    legacy = rng.normal(size=(256, 26)).astype(np.float32)
    legacy[:, 12:14] = 1.0
    path = str(tmp_path / "legacy.npz")
    np.savez(path, **{k: v for k, v in st.items()
                      if not k.startswith("packed_")},
             packed_di=legacy, packed_gi=legacy)
    tck.load_renderer_state(path, r)
    want = tr._shards_from_legacy(torch.as_tensor(legacy), tr._DI_KEYS)
    got = r.state_dict()
    for c in range(3):
        np.testing.assert_array_equal(got[f"packed_di.{c}"],
                                      want[c].numpy())
    r.render()
    assert np.isfinite(r.radiance()).all()


def test_checkpoint_crosses_to_jax_and_back(tmp_path):
    """A port sharded npz loads into a freshly constructed JAX
    ShardedRestirRenderer (constructing and loading compile nothing), and
    the npz the JAX renderer then saves loads back into the port; a format
    mismatch raises the JAX package's ValueError."""
    cfg = RenderConfig(**SMALL)
    jcfg = JConfig(**SMALL)
    a = tshard.ShardedRestirRenderer(cornell_box(emission=18.0), _cam(), cfg,
                                     devices=["cpu"] * 2)
    a.render()
    a.render()
    p1 = str(tmp_path / "port.npz")
    tck.save_renderer_state(p1, a)
    j = jshard.ShardedRestirRenderer(jproc.cornell_box(emission=18.0),
                                     JCamera(eye=EYE, center=CENTER), jcfg,
                                     devices=jax.devices()[:2])
    jck.load_renderer_state(p1, j)
    st = a.state_dict()
    assert j.frame == 2
    for c in range(3):
        np.testing.assert_array_equal(np.asarray(j.packed_di[c]),
                                      st[f"packed_di.{c}"])
        np.testing.assert_array_equal(np.asarray(j.packed_gi[c]),
                                      st[f"packed_gi.{c}"])
    np.testing.assert_array_equal(np.asarray(j.fb.accum), st["fb.accum"])
    np.testing.assert_array_equal(np.asarray(j.l1), st["l1"])
    p2 = str(tmp_path / "jax.npz")
    jck.save_renderer_state(p2, j)
    b = tshard.ShardedRestirRenderer(cornell_box(emission=18.0), _cam(), cfg,
                                     devices=["cpu"] * 2)
    tck.load_renderer_state(p2, b)
    for k, v in b.state_dict().items():
        np.testing.assert_array_equal(v, st[k], err_msg=k)
    jsingle = jr.RestirRenderer(jproc.cornell_box(emission=18.0),
                                JCamera(eye=EYE, center=CENTER), jcfg)
    with pytest.raises(ValueError, match="sharded_restir"):
        jck.load_renderer_state(p1, jsingle)


# ---------------------------- the band passes -------------------------------


def _to_j(tree):
    if isinstance(tree, dict):
        return {k: _to_j(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_j(v) for v in tree)
    return jnp.asarray(tree.numpy())


def _ext(table, row0, bh_ext, w):
    """Rows [row0, row0 + bh_ext) of a full-image [H*W, 8] table, zero
    rows outside the image (the halo of an edge band)."""
    h = table.shape[0] // w
    out = torch.zeros((bh_ext * w, table.shape[1]), dtype=table.dtype)
    lo, hi = max(row0, 0), min(row0 + bh_ext, h)
    out[(lo - row0) * w:(hi - row0) * w] = table[lo * w:hi * w]
    return out


def test_band_passes_match_jax():
    """One band of a 2-band 32x32 Cornell frame after a camera move larger
    than the halo: the port's pass2_temporal and pass3_spatial with the
    band's xs / ys, row0 and halo-extended tables against the JAX passes
    on the same inputs (tests/test_torch_restir.py's lane tolerance).
    Some reprojections land inside the image but outside the band's
    window, so the out-of-halo rejection is pinned."""
    w = h = 32
    halo, band_h, band = 4, 16, 1
    row0, bh_ext = band * band_h - halo, band_h + 2 * halo
    jcfg = JConfig(width=w, height=h, spatial_radius=halo, gi_bounces=1)
    cfg = RenderConfig(width=w, height=h, spatial_radius=halo, gi_bounces=1)
    jscene = jproc.cornell_box(emission=18.0).flatten()
    scene = convert.scene_arrays_from_numpy(jax_scene_dict(jscene),
                                            device="cpu")
    cam0 = Camera(eye=EYE, center=CENTER)
    cam1 = cam0.orbited(0.0, 0.2)

    def cam_arrays(cam, prev):
        mats = {k: torch.as_tensor(v) for k, v in cam.matrices(1.0).items()}
        pm = prev.matrices(1.0)
        mats["prev_view"] = torch.as_tensor(pm["view"])
        mats["prev_proj"] = torch.as_tensor(pm["proj"])
        return mats

    def frame(cam, prev, f):
        ca = cam_arrays(cam, prev)
        res_di, sdata, gi_in, seed = tr.pass1_di(scene, ca, f, cfg)
        gst = tr.pass1_gi_init(scene, gi_in, seed, cfg)
        for b in range(cfg.gi_bounces):
            gst = tr.pass1_gi_bounce(scene, cfg, gst, b)
        res_gi, _ = tr.pass1_gi_final(scene, gi_in, gst, cfg)
        return ca, res_di, res_gi, sdata

    _, di0, gi0, sd0 = frame(cam0, cam0, 0)
    ca, di1, gi1, sd1 = frame(cam1, cam0, 1)
    last_di = tr._pack_record(sd0, di0, tr._DI_KEYS)
    last_gi = tr._pack_record(sd0, gi0, tr._GI_KEYS)
    ext_di = tuple(_ext(t, row0, bh_ext, w) for t in last_di)
    ext_gi = tuple(_ext(t, row0, bh_ext, w) for t in last_gi)
    lanes = slice(band * band_h * w, (band + 1) * band_h * w)

    def cut(tree):
        if isinstance(tree, dict):
            return {k: cut(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(cut(v) for v in tree)
        return tree[lanes]

    di, gi, sd = cut(di1), cut(gi1), cut(sd1)
    ys, xs = torch.meshgrid(torch.arange(band * band_h, (band + 1) * band_h),
                            torch.arange(w), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)

    # the move sends some of the band's reprojections outside its window
    px, py = trestir.reproject_to_prev_pixel_p(
        scene, sd["x1"], sd["obj"], ca["prev_view"], ca["prev_proj"], w, h)
    shading = sd["l1"][0] == 0.0
    inside = (px >= 0) & (px < w) & (py >= 0) & (py < h) & shading
    out_of_window = inside & ((py - row0 < 0) | (py - row0 >= bh_ext))
    assert int(out_of_window.sum()) > 0
    assert int((inside & ~out_of_window).sum()) > 0

    jca = _to_j(ca)
    jargs = dict(xs=jnp.asarray(xs.numpy(), jnp.int32),
                 ys=jnp.asarray(ys.numpy(), jnp.int32), row0=row0,
                 band_h=bh_ext)
    targs = dict(xs=xs, ys=ys, row0=row0, band_h=bh_ext)
    j2 = jr.pass2_temporal(jscene, jca, jnp.uint32(1), _to_j(di), _to_j(gi),
                           _to_j(sd), _to_j(ext_di), _to_j(ext_gi), jcfg,
                           **jargs)
    t2 = tr.pass2_temporal(scene, ca, 1, di, gi, sd, ext_di, ext_gi, cfg,
                           **targs)
    assert_lanes(t2, j2)

    cur_di, cur_gi = to_t(j2)
    full_di = dict(di1)
    full_gi = dict(gi1)
    ext_cur_di = tuple(_ext(t, row0, bh_ext, w) for t in
                       tr._pack_record(sd1, full_di, tr._DI_KEYS))
    ext_cur_gi = tuple(_ext(t, row0, bh_ext, w) for t in
                       tr._pack_record(sd1, full_gi, tr._GI_KEYS))
    j3 = jr.pass3_spatial(jscene, jca, jnp.uint32(1), _to_j(cur_di),
                          _to_j(cur_gi), _to_j(sd), jcfg,
                          packed_di_ext=_to_j(ext_cur_di),
                          packed_gi_ext=_to_j(ext_cur_gi), **jargs)
    t3 = tr.pass3_spatial(scene, ca, 1, cur_di, cur_gi, sd, cfg,
                          packed_di_ext=ext_cur_di, packed_gi_ext=ext_cur_gi,
                          **targs)
    assert_lanes(t3, j3)


def test_cli_devices_renders_and_resumes(tmp_path):
    ck = str(tmp_path / "ck.npz")
    argv = ["--cpu", "--devices", "2", "--scene", "cornell", "--width", "32",
            "--height", "32", "--out", str(tmp_path / "c.png"),
            "--checkpoint", ck]
    r = cli.main([*argv, "--frames", "2"])["renderer"]
    assert isinstance(r, tshard.ShardedRestirRenderer)
    assert [d.type for d in r.devices] == ["cpu", "cpu"]
    r = cli.main([*argv, "--frames", "1"])["renderer"]
    assert r.frame == 3 and float(r.fb.count.min()) == 3.0
    # as in the JAX CLI, the megakernel renderer does not shard
    r = cli.main(["--cpu", "--devices", "2", "--renderer", "megakernel",
                  "--width", "16", "--height", "16", "--frames", "1",
                  "--out", str(tmp_path / "m.png")])["renderer"]
    assert not isinstance(r, tshard.ShardedRestirRenderer)
