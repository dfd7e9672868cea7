"""The port's I/O and CLI against the JAX package: half-precision payload
tables, checkpoint formats (restir and megakernel, crossing between the
packages), AOVs, PNG and metrics, and
``python -m royaltracer_dx_tpu_torch.cli`` (both renderers).  (A JAX checkpoint resumed
by the port is in tests/test_torch_dynamic.py, beside the JAX frames it
reuses.)

Tolerances: packed f16/bf16 tables, PNG bytes and metrics are exact;
AOVs use ``assert_lanes`` of tests/test_torch_restir.py (>= 99.9% of
lanes equal in ids, floats within 1e-4 relative), because an ulp of
XLA-vs-PyTorch drift can move a hit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from royaltracer_dx_tpu.camera import Camera as JCamera
from royaltracer_dx_tpu.config import RenderConfig as JConfig
from royaltracer_dx_tpu.ops.reservoir import ReservoirDI, ReservoirGI, SampleData
from royaltracer_dx_tpu.io import checkpoint as jck
from royaltracer_dx_tpu.render import renderer as jmk_renderer
from royaltracer_dx_tpu.render import restir_renderer as jr
from royaltracer_dx_tpu.render.aov import render_aovs as j_aovs
from royaltracer_dx_tpu.scene import procedural as jproc
from royaltracer_dx_tpu.utils import image as jimage
from royaltracer_dx_tpu.utils import metrics as jmetrics

from royaltracer_dx_tpu_torch import cli, convert
from royaltracer_dx_tpu_torch.camera import Camera
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.io import checkpoint as tck
from royaltracer_dx_tpu_torch.render import renderer as tr_mk
from royaltracer_dx_tpu_torch.render import restir_renderer as tr
from royaltracer_dx_tpu_torch.render.aov import CHANNELS, render_aovs
from royaltracer_dx_tpu_torch.scene import procedural as tproc
from royaltracer_dx_tpu_torch.utils import image as timage
from royaltracer_dx_tpu_torch.utils import metrics as tmetrics
from test_torch_restir import (  # noqa: F401 (one_torch_thread: autouse)
    assert_lanes,
    jax_scene_dict,
    one_torch_thread,
    to_t,
)

W, H = 32, 27
EYE, CENTER = (0.5, 0.5, 1.72), (0.5, 0.5, 0.0)


# -------------------------- half-precision records -----------------------


def _edge_state(n=4096, seed=3):
    """Renderer state with the values where half precision bites: f16
    underflow and overflow, exact round-to-nearest-even ties, -0.0, and
    zero l1 / n2 / l2 rows (the flags)."""
    rng = np.random.default_rng(seed)

    def v3():
        mag = 10.0 ** rng.uniform(-9, 6, (n, 1))
        a = (rng.normal(size=(n, 3)) * mag).astype(np.float32)
        a[::7] = 0.0
        a[1::11] = -0.0
        a[2::13] = np.float32(1.0 + 2.0 ** -11)     # f16 tie -> 1.0
        a[3::13] = np.float32(1.0 + 3 * 2.0 ** -11)  # f16 tie -> up
        a[4::13] = np.float32(1.0 + 2.0 ** -8)      # bf16 tie -> 1.0
        a[5::13] = np.float32(70000.0)              # f16 overflow
        return a

    def s():
        a = np.abs(rng.normal(size=n) * 10.0 ** rng.uniform(-9, 6, n))
        a[::5] = 0.0
        a[1::9] = 1e-8                              # f16 underflow
        return a.astype(np.float32)

    di = dict(x2=v3(), n2=v3(), l2=v3(), w_sum=s(), w=s(), m=s())
    gi = dict(xn=v3(), nn=v3(), e3=v3(), w_sum=s(), w=s(), m=s())
    sd = dict(x1=v3(), n1=v3(), o=v3(), l1=v3(),
              mid=rng.integers(-2, 200, n).astype(np.int32),
              obj=rng.integers(0, 40, n).astype(np.int32))
    return di, gi, sd


def _bits(x):
    if torch.is_tensor(x):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("dtype", ["f16", "bf16"])
def test_packed_half_tables_bit_equal(dtype):
    di, gi, sd = _edge_state()
    jd = {"f16": jnp.float16, "bf16": jnp.bfloat16}[dtype]
    jp = jr._pack_last(ReservoirDI(**{k: jnp.asarray(v) for k, v in di.items()}),
                       ReservoirGI(**{k: jnp.asarray(v) for k, v in gi.items()}),
                       SampleData(**{k: jnp.asarray(v) for k, v in sd.items()}),
                       jd)
    tp = tr._pack_last({k: torch.as_tensor(v) for k, v in di.items()},
                       {k: torch.as_tensor(v) for k, v in gi.items()},
                       {k: torch.as_tensor(v) for k, v in sd.items()},
                       tr._REC_DTYPES[dtype])
    for rec_t, rec_j in zip(tp, jp):
        for a, b in zip(rec_t, rec_j):
            assert a.dtype == tr._REC_DTYPES[dtype]
            np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype,count", [("bf16", 256), ("f16", 2048)])
def test_half_record_id_guard(dtype, count):
    """Half-precision ids are exact below 2^(mantissa + 1): bf16 rejects
    256 materials, f16 (and every dtype's f16 accept tables) 2048."""
    scene = tproc.cornell_box()
    while len(scene._materials) < count:
        scene.add_material(kd=(0.5, 0.5, 0.5, 1.0))
    with pytest.raises(ValueError, match="< "):
        tr.RestirRenderer(scene, Camera(eye=EYE, center=CENTER),
                          RenderConfig(width=8, height=8,
                                       record_dtype=dtype), device="cpu")


# ------------------------------ checkpoint -------------------------------


def test_checkpoint_resolution_mismatch_raises(tmp_path):
    path = str(tmp_path / "x.npz")
    cam = Camera(eye=EYE, center=CENTER)
    tck.save_renderer_state(path, tr.RestirRenderer(
        tproc.cornell_box(), cam, RenderConfig(width=8, height=6),
        device="cpu"))
    r = tr.RestirRenderer(tproc.cornell_box(), cam,
                          RenderConfig(width=8, height=8), device="cpu")
    with pytest.raises(ValueError, match="resolution"):
        tck.load_renderer_state(path, r)


def _mk(w=8, h=6, **kw):
    return tr_mk.Renderer(tproc.cornell_box(), Camera(eye=EYE, center=CENTER),
                          RenderConfig(width=w, height=h, max_bounces=2,
                                       **kw), device="cpu")


def _jax_mk(w=8, h=6):
    return jmk_renderer.Renderer(jproc.cornell_box(),
                                 JCamera(eye=EYE, center=CENTER),
                                 JConfig(width=w, height=h, max_bounces=2))


def test_megakernel_checkpoint_round_trip(tmp_path):
    """A port megakernel state saved and restored by the port, then read
    by the JAX package's load_renderer_state into its Renderer."""
    path = str(tmp_path / "mk.npz")
    a = _mk()
    a.render()
    a.render()
    tck.save_renderer_state(path, a)
    with np.load(path) as data:
        saved = {k: data[k] for k in data.files}
    assert str(saved["format"]) == "megakernel"
    assert sorted(saved) == ["fb.accum", "fb.count", "format", "frame",
                             "prev_view"]
    b = _mk()
    tck.load_renderer_state(path, b)
    for k, v in a.state_dict().items():
        np.testing.assert_array_equal(b.state_dict()[k], v)
    a.render()
    b.render()                      # resumed: the same third frame
    np.testing.assert_array_equal(a.radiance(), b.radiance())
    assert b.frame == 3 and float(b.fb.count.max()) == 3.0
    j = _jax_mk()
    jck.load_renderer_state(path, j)
    assert j.frame == 2
    for key, got in (("fb.accum", j.fb.accum), ("fb.count", j.fb.count),
                     ("prev_view", j._prev_view)):
        np.testing.assert_array_equal(np.asarray(got), saved[key])


def test_jax_megakernel_checkpoint_resumes_in_port(tmp_path):
    """A megakernel npz written by the JAX package's save_renderer_state
    resumes in the port: every array restored, and the next frame keeps
    accumulating (the camera did not move)."""
    import jax.numpy as jnp
    from royaltracer_dx_tpu.render.framebuffer import Framebuffer as JFb

    rng = np.random.default_rng(4)
    j = _jax_mk()
    j.fb = JFb(accum=jnp.asarray(rng.uniform(0, 3, (48, 3)), jnp.float32),
               count=jnp.full((48,), 5.0, jnp.float32))
    j.frame = 5
    j._prev_view = jnp.asarray(j._camera_arrays()["view"])
    path = str(tmp_path / "jmk.npz")
    jck.save_renderer_state(path, j)
    r = _mk()
    tck.load_renderer_state(path, r)
    assert r.frame == 5
    np.testing.assert_array_equal(r.fb.accum.numpy(), np.asarray(j.fb.accum))
    np.testing.assert_array_equal(r._prev_view.numpy(),
                                  np.asarray(j._prev_view))
    r.render()
    assert r.frame == 6 and float(r.fb.count.min()) == 6.0


@pytest.mark.parametrize("saved", ["megakernel", "restir"])
def test_checkpoint_format_mismatch_raises(tmp_path, saved):
    """A megakernel state fed to a RestirRenderer, and the reverse, raise
    naming the formats; so does a resolution mismatch."""
    path = str(tmp_path / "x.npz")
    cam = Camera(eye=EYE, center=CENTER)
    rest = tr.RestirRenderer(tproc.cornell_box(), cam,
                             RenderConfig(width=8, height=6), device="cpu")
    mk = _mk()
    src, dst = (mk, rest) if saved == "megakernel" else (rest, mk)
    tck.save_renderer_state(path, src)
    want = "restir" if saved == "megakernel" else "megakernel"
    with pytest.raises(ValueError, match=f"'{saved}'.*'{want}'"):
        tck.load_renderer_state(path, dst)
    with pytest.raises(ValueError, match="resolution"):
        tck.load_renderer_state(path, src.__class__(
            tproc.cornell_box(), cam, RenderConfig(width=8, height=8),
            device="cpu"))


# --------------------------------- AOVs ----------------------------------


def test_aovs_match_jax():
    jscene = jproc.cornell_box(emission=18.0)
    jsa = jscene.flatten(jscene.build_materials(with_lut=False))
    cam = JCamera(eye=EYE, center=CENTER)
    jcam = {k: jnp.asarray(v) for k, v in cam.matrices(W / H).items()}
    cfg = JConfig(width=W, height=H)
    ref = j_aovs(jsa, jcam, cfg)
    scene = convert.scene_arrays_from_numpy(jax_scene_dict(jsa), device="cpu")
    out = render_aovs(scene, to_t(jcam), RenderConfig(width=W, height=H))
    assert set(out) == set(CHANNELS) == set(ref)
    assert_lanes(out, {k: np.asarray(v) for k, v in ref.items()})
    mid = out["material_id"]
    assert int(mid.max()) >= 1 and int((mid == -1).sum()) == int(
        (np.asarray(ref["material_id"]) == -1).sum())


# ---------------------------- PNG and metrics ----------------------------


def _read_png(path):
    """Decode an 8-bit RGB PNG of unfiltered rows, as write_png writes."""
    import struct
    import zlib

    with open(path, "rb") as fh:
        data = fh.read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_write_png_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for img in (rng.uniform(-0.2, 1.2, (9, 7, 3)).astype(np.float32),
                rng.integers(0, 256, (5, 6, 3)).astype(np.uint8),
                rng.uniform(0, 1, (4, 3)).astype(np.float32)):
        a, b = str(tmp_path / "t.png"), str(tmp_path / "j.png")
        timage.write_png(a, img)
        jimage.write_png(b, img)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        back = _read_png(a)
        want = img if img.dtype == np.uint8 else (
            np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
        if want.ndim == 2:
            want = np.repeat(want[:, :, None], 3, axis=2)
        np.testing.assert_array_equal(back, want)


def test_metrics_match_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 2, (12, 10, 3))
    b = a + rng.normal(0, 0.05, a.shape)
    assert tmetrics.rmse_report(a, b) == jmetrics.rmse_report(a, b)
    assert timage.rmse(a, b) == jimage.rmse(a, b) == tmetrics.rmse(a, b)
    assert tmetrics.rel_mean(a, b) == jmetrics.rel_mean(a, b)


# ---------------------------------- CLI ----------------------------------


def test_cli_smoke_and_resume(tmp_path, capsys):
    """tests/test_io_cli.py:84 for the port: cornell at 16x16 on the CPU
    with a checkpoint, snapshots and every AOV, then a resumed run whose
    frame counter continues."""
    out = str(tmp_path / "o.png")
    ck = str(tmp_path / "ck.npz")
    argv = ["--cpu", "--scene", "cornell", "--width", "16", "--height",
            "16", "--out", out, "--checkpoint", ck]
    res = cli.main(argv + ["--frames", "2", "--snapshot-every", "1",
                           "--aov", "all"])
    assert res["renderer"].frame == 2 and len(res["frame_ms"]) == 2
    for name in ["o.png", "ck.npz", "o_00001.png", "o_00002.png"] + [
            f"o.{c}.png" for c in CHANNELS]:
        assert os.path.exists(tmp_path / name), name
    res = cli.main(argv + ["--frames", "1"])
    assert "resumed from" in capsys.readouterr().out
    assert res["renderer"].frame == 3
    assert float(res["renderer"].fb.count.max()) == 3.0


def test_cli_megakernel_renders_and_resumes(tmp_path, capsys):
    """``--renderer megakernel`` on the CPU writes an image and a
    megakernel checkpoint, and a second run resumes from it."""
    out = str(tmp_path / "m.png")
    ck = str(tmp_path / "mk.npz")
    argv = ["--cpu", "--renderer", "megakernel", "--scene", "cornell",
            "--width", "16", "--height", "12", "--bounces", "3", "--out",
            out, "--checkpoint", ck]
    res = cli.main(argv + ["--frames", "2"])
    r = res["renderer"]
    assert type(r).__name__ == "Renderer" and r.frame == 2
    assert os.path.exists(out) and os.path.exists(ck)
    assert _read_png(out).shape == (12, 16, 3)
    assert r.metrics["mrays_per_s"] > 0 and r.cfg.max_bounces == 3
    with np.load(ck) as data:
        assert str(data["format"]) == "megakernel"
    res = cli.main(argv + ["--frames", "1"])
    assert "resumed from" in capsys.readouterr().out
    assert res["renderer"].frame == 3
    assert float(res["renderer"].fb.count.min()) == 3.0


def test_cli_animate_and_profile(tmp_path):
    res = cli.main(["--cpu", "--scene", "menger", "--width", "16",
                    "--height", "8", "--frames", "1", "--animate",
                    "--out", str(tmp_path / "m.png"),
                    "--profile", str(tmp_path / "prof")])
    assert len(res["refit_ms"]) == 1
    r = res["renderer"]
    assert np.asarray(r.scene.transforms[1])[0, 2] != 0.0   # rotated
    assert os.path.exists(tmp_path / "prof" / "trace.json")


@pytest.mark.parametrize("renderer", ["restir", "megakernel"],
                         ids=["argv0-A'11", "argv1-A'11"])
def test_cli_unported_options_raise(renderer, tmp_path):
    """``--traversal cluster`` refused until the cluster traversal was
    ported; now both renderers render through it."""
    res = cli.main(["--cpu", "--frames", "1", "--traversal", "cluster",
                    "--renderer", renderer, "--width", "16", "--height",
                    "12", "--out", str(tmp_path / "c.png")])
    r = res["renderer"]
    assert r.cfg.accel == "cluster" and r.scene_arrays.clusters is not None
    img = r.radiance()
    assert r.frame == 1 and np.isfinite(img).all() and img.mean() > 0.0


def test_cli_reference_scene_needs_its_files(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "REFERENCE_INCLUDE", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        cli.build_scene("reference")
