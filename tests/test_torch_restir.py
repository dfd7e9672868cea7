"""The port's ReSTIR passes and frames against the JAX package.

Every pass of ``royaltracer_dx_tpu_torch.render.restir_renderer`` is fed
the JAX pass's own inputs (a 32x32 Cornell frame after one warm frame, so
pass 2 reuses real history) and its outputs are held against the JAX
outputs.  Tolerance: integer and decision outputs match on >= 99.9% of
lanes and floats within 1e-4 relative on the lanes whose decisions agree,
because an ulp of drift between XLA-CPU and PyTorch arithmetic (cos/sin,
rsqrt, fused vs unfused products) can flip an RIS pick or a spatial tap.
Then whole frames: >= 99% of pixels within 1e-3 and the per-channel
means within 0.5%, for the same reason compounded over two frames.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.camera import Camera as JCamera
from royaltracer_dx_tpu.config import RenderConfig as JConfig
from royaltracer_dx_tpu.render import restir_renderer as jr
from royaltracer_dx_tpu.scene.procedural import cornell_box as j_cornell

from royaltracer_dx_tpu_torch import convert
from royaltracer_dx_tpu_torch.camera import Camera
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.ops import stream_trace as tst
from royaltracer_dx_tpu_torch.render import restir_renderer as tr
from royaltracer_dx_tpu_torch.scene.procedural import cornell_box

W, H = 32, 27
EYE, CENTER = (0.5, 0.5, 1.72), (0.5, 0.5, 0.0)
RTOL, ATOL = 1e-4, 1e-6
MIN_LANES = 0.999


# ------------------------------ helpers ----------------------------------


def to_t(x):
    """JAX pytree (dicts / tuples of arrays) -> the same tree of CPU
    tensors; uint32 seeds become the port's int64 seeds."""
    if isinstance(x, dict):
        return {k: to_t(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(to_t(v) for v in x)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(a)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}."))
        return out
    a = tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return {prefix[:-1]: a}


def assert_lanes(port, ref, skip=(), rtol=RTOL, atol=ATOL):
    """Per lane: every integer/bool leaf equal and every float leaf within
    rtol/atol; at least MIN_LANES of the lanes must agree on all leaves."""
    lp, lr = leaves(port), leaves(ref)
    keys = sorted(k for k in lr if k not in skip)
    assert sorted(k for k in lp if k not in skip) == keys
    n = lr[keys[0]].shape[0]
    agree = np.ones(n, bool)
    for k in keys:
        a, b = lp[k], lr[k]
        assert a.shape == b.shape, k
        if a.dtype.kind == "f":
            ok = np.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True)
        else:
            ok = a == b
        agree &= ok.reshape(n, -1).all(axis=1)
    frac = agree.mean()
    assert frac >= MIN_LANES, f"{frac:.4f} of lanes agree"


def jax_scene_dict(sa) -> dict:
    d = dict(tri_verts=sa.tri_verts, tri_normals=sa.tri_normals,
             tri_material=sa.tri_material, tri_instance=sa.tri_instance,
             object_to_world=sa.object_to_world,
             prev_object_to_world=sa.prev_object_to_world)
    for grp in ("materials", "lights"):
        obj = getattr(sa, grp)
        for f in dataclasses.fields(obj):
            d[f"{grp}.{f.name}"] = getattr(obj, f.name)
    return {k: np.asarray(v) for k, v in d.items()}


def with_lut(r, lut):
    """Feed the JAX E_ss LUT into a port renderer (the port's own LUT
    draws other Monte Carlo samples)."""
    sa = r.scene_arrays
    mats = dataclasses.replace(sa.materials, lut=torch.as_tensor(lut))
    r.scene_arrays = dataclasses.replace(sa, materials=mats).with_tri_table()


def image_close(a, b):
    close = np.abs(a - b) <= 1e-3 * np.maximum(1.0, np.abs(b))
    assert close.all(axis=-1).mean() >= 0.99
    ma, mb = a.reshape(-1, 3).mean(0), b.reshape(-1, 3).mean(0)
    np.testing.assert_allclose(ma, mb, rtol=5e-3)


# ------------------------------ fixtures ---------------------------------


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch intra-op thread for this module's tests: at these tiny
    sizes more threads gain nothing, and under pytest-xdist several
    workers share the host's cores (8 threads each made some tests 10x
    slower).  Restored after the module.  Imported by the other
    tests/test_torch_*.py modules that run frames."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_frames():
    """JAX Cornell renderer after one frame, plus the inputs and outputs
    of every pass of its second frame."""
    r = jr.RestirRenderer(j_cornell(emission=18.0), JCamera(eye=EYE,
                          center=CENTER), JConfig(width=W, height=H))
    r.render()
    scene, cfg = r.scene_arrays, r.cfg
    cam = r._camera_arrays()
    frame = jnp.uint32(r.frame)
    io = dict(scene=scene, cfg=cfg, cam=cam, frame=int(r.frame))
    io["p1"] = jr.pass1_di(scene, cam, frame, cfg)
    res_di, sdata, gi_in, seed = io["p1"]
    gst = [jr.pass1_gi_init(scene, gi_in, seed, cfg)]
    for b in range(cfg.gi_bounces):
        gst.append(jr.pass1_gi_bounce(scene, cfg, gst[-1], jnp.uint32(b)))
    io["gst"] = gst
    io["gi_final"] = jr.pass1_gi_final(scene, gi_in, gst[-1], cfg)
    res_gi = io["gi_final"][0]
    io["packed"] = jr._pack_last(r.last_di, r.last_gi, r.last_sdata)
    io["p2"] = jr.pass2_temporal(scene, cam, frame, res_di, res_gi, sdata,
                                 *io["packed"], cfg)
    io["p3"] = jr.pass3_spatial(scene, cam, frame, *io["p2"], sdata, cfg)
    io["state"] = dict(
        {f"{grp}.{f}": np.asarray(getattr(getattr(r, grp), f))
         for grp in ("last_di", "last_gi", "last_sdata")
         for f in getattr(r, grp).__dataclass_fields__},
        frame=np.asarray(r.frame), prev_view=np.asarray(r._prev_view),
        prev_proj=np.asarray(r._prev_proj), l1=np.asarray(r.l1))
    io["state"]["fb.accum"] = np.asarray(r.fb.accum)
    io["state"]["fb.count"] = np.asarray(r.fb.count)
    r.render()
    io["image"] = np.asarray(r.radiance())
    return io


@pytest.fixture(scope="module")
def port_io(jax_frames):
    scene = convert.scene_arrays_from_numpy(
        jax_scene_dict(jax_frames["scene"]), device="cpu")
    cfg = RenderConfig(width=W, height=H)
    return scene, cfg, to_t(jax_frames["cam"])


# ------------------------------- passes ----------------------------------


def test_pass1_di_matches(jax_frames, port_io):
    scene, cfg, cam = port_io
    out = tr.pass1_di(scene, cam, jax_frames["frame"], cfg)
    assert_lanes(out, jax_frames["p1"])


def test_gi_passes_match(jax_frames, port_io):
    scene, cfg, _ = port_io
    _, _, gi_in, seed = to_t(jax_frames["p1"])
    gst = jax_frames["gst"]
    assert_lanes(tr.pass1_gi_init(scene, gi_in, seed, cfg), gst[0])
    for b in range(cfg.gi_bounces):
        out = tr.pass1_gi_bounce(scene, cfg, to_t(gst[b]), b)
        assert_lanes(out, gst[b + 1])
    out = tr.pass1_gi_final(scene, gi_in, to_t(gst[-1]), cfg)
    assert_lanes(out, jax_frames["gi_final"])


def test_pack_last_matches(jax_frames, port_io):
    scene, cfg, _ = port_io
    r = tr.RestirRenderer(cornell_box(emission=18.0),
                          Camera(eye=EYE, center=CENTER), cfg, device="cpu")
    r.load_state(jax_frames["state"])
    out = tr._pack_last(r.last_di, r.last_gi, r.last_sdata)
    for a, b in zip(leaves(out).values(), leaves(jax_frames["packed"]).values()):
        np.testing.assert_array_equal(a, b)


def test_pass2_temporal_matches(jax_frames, port_io):
    scene, cfg, cam = port_io
    res_di, sdata, _, _ = to_t(jax_frames["p1"])
    res_gi = to_t(jax_frames["gi_final"][0])
    out = tr.pass2_temporal(scene, cam, jax_frames["frame"], res_di, res_gi,
                            sdata, *to_t(jax_frames["packed"]), cfg)
    assert_lanes(out, jax_frames["p2"])


def test_pass3_spatial_matches(jax_frames, port_io):
    scene, cfg, cam = port_io
    _, sdata, _, _ = to_t(jax_frames["p1"])
    cur_di, cur_gi = to_t(jax_frames["p2"])
    out = tr.pass3_spatial(scene, cam, jax_frames["frame"], cur_di, cur_gi,
                           sdata, cfg)
    assert_lanes(out, jax_frames["p3"])


# ------------------------------- frames ----------------------------------


def _port_frames(traversal, lut, frames=2):
    r = tr.RestirRenderer(cornell_box(emission=18.0),
                          Camera(eye=EYE, center=CENTER),
                          RenderConfig(width=W, height=H, traversal=traversal),
                          device="cpu")
    with_lut(r, lut)
    for _ in range(frames):
        r.render()
    return r


def test_cornell_frames_match_brute(jax_frames):
    lut = np.asarray(jax_frames["scene"].materials.lut)
    r = _port_frames("auto", lut)
    assert r.scene_arrays.stream is None       # 36 tris: brute on the CPU
    image_close(r.radiance(), jax_frames["image"])
    assert (r.fb.count == 2).all()


def test_stream_path_frames_match():
    """traversal="stream": the port's CPU dispatch sends coherent closest
    batches and every occlusion batch through the stream kernels' plain
    version, the JAX package through its XLA stream path."""
    jrr = jr.RestirRenderer(j_cornell(emission=18.0),
                            JCamera(eye=EYE, center=CENTER),
                            JConfig(width=W, height=H, traversal="stream"))
    jrr.render()
    jrr.render()
    launches = dict(tst.LAUNCHES)
    r = _port_frames("stream", np.asarray(jrr.scene_arrays.materials.lut))
    assert r.scene_arrays.stream is not None
    assert tst.LAUNCHES == launches            # CPU tensors launch nothing
    image_close(r.radiance(), np.asarray(jrr.radiance()))


def test_state_dict_round_trip(jax_frames):
    r = tr.RestirRenderer(cornell_box(emission=18.0),
                          Camera(eye=EYE, center=CENTER),
                          RenderConfig(width=W, height=H), device="cpu")
    r.load_state(jax_frames["state"])
    back = r.state_dict()
    for k, v in jax_frames["state"].items():
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(ValueError):
        r.load_state(dict(jax_frames["state"], format=np.asarray("megakernel")))


# --------------------------- entry points --------------------------------


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    scene = cornell_box()
    with pytest.raises(RuntimeError, match="GPU"):
        tr.RestirRenderer(scene, Camera(eye=EYE, center=CENTER),
                          RenderConfig(width=8, height=8))
    with pytest.raises(RuntimeError, match="GPU"):
        scene.flatten()


@pytest.mark.parametrize("kw", [dict(traversal="cluster")])
def test_unported_options_raise(kw):
    """traversal="cluster" refused until it was ported; now a ReSTIR
    frame renders through it."""
    r = tr.RestirRenderer(cornell_box(emission=18.0),
                          Camera(eye=EYE, center=CENTER),
                          RenderConfig(width=8, height=8, **kw), device="cpu")
    assert r.scene_arrays.clusters is not None
    r.render()
    img = r.radiance()
    assert np.isfinite(img).all() and img.mean() > 0.0


@pytest.mark.parametrize("kw", [dict(gi_compaction="on"),
                                dict(record_dtype="f16"),
                                dict(traversal="bvh")])
def test_ported_options_render(kw):
    """Options that raised before their slice was ported now render: a
    finite, lit frame whose state matches the default options' shapes."""
    r = tr.RestirRenderer(cornell_box(emission=18.0),
                          Camera(eye=EYE, center=CENTER),
                          RenderConfig(width=16, height=16, **kw),
                          device="cpu")
    r.render()
    img = r.radiance()
    assert np.isfinite(img).all() and img.mean() > 0.05
    assert r.frame == 1 and float(r.fb.count.max()) == 1.0


def test_port_imports_no_jax():
    code = (
        "import sys, royaltracer_dx_tpu_torch\n"
        "import royaltracer_dx_tpu_torch.render.restir_renderer\n"
        "import royaltracer_dx_tpu_torch.convert\n"
        "import royaltracer_dx_tpu_torch.cli\n"
        "import royaltracer_dx_tpu_torch.io.checkpoint\n"
        "import royaltracer_dx_tpu_torch.scene.assets\n"
        "import royaltracer_dx_tpu_torch.scene.obj_loader\n"
        "import royaltracer_dx_tpu_torch.render.aov\n"
        "import royaltracer_dx_tpu_torch.native\n"
        "import royaltracer_dx_tpu_torch.utils.image\n"
        "import royaltracer_dx_tpu_torch.utils.metrics\n"
        "import royaltracer_dx_tpu_torch.render.megakernel\n"
        "import royaltracer_dx_tpu_torch.render.renderer\n"
        "import royaltracer_dx_tpu_torch.render.di_oracle\n"
        "import royaltracer_dx_tpu_torch.parallel.shard\n"
        "import royaltracer_dx_tpu_torch.ops.bvh\n"
        "import royaltracer_dx_tpu_torch.ops.traverse\n"
        "import royaltracer_dx_tpu_torch.ops.cluster_traverse\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'royaltracer_dx_tpu'"
        " or m.startswith('royaltracer_dx_tpu.')]\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)
