"""The port's OBJ/MTL loader, native parser, generated assets and
procedural scenes against the JAX package (host numpy on both sides).

Tolerance: exact.  Loaded arrays and material tables are equal, the
generated OBJ/MTL files are byte for byte the JAX generators' files, and
the procedural meshes are equal vertex for vertex.
"""

import os

import numpy as np
import pytest

from royaltracer_dx_tpu.scene import assets as jassets
from royaltracer_dx_tpu.scene import obj_loader as jobj
from royaltracer_dx_tpu.scene import procedural as jproc
from royaltracer_dx_tpu.scene.scene import Scene as JScene

from royaltracer_dx_tpu_torch import native
from royaltracer_dx_tpu_torch.scene import assets as tassets
from royaltracer_dx_tpu_torch.scene import obj_loader as tobj
from royaltracer_dx_tpu_torch.scene import procedural as tproc
from royaltracer_dx_tpu_torch.scene.scene import Scene as TScene

EDGE_CASES = "\n".join([            # tests/test_native_obj.py:37-49
    "mtllib edge.mtl",
    "v 0 0 0", "v 1 0 0", "v 1 1 0", "v 0 1 0", "v 0.5 0.5 1",
    "vn 0 0 1", "vn 1 0 0",
    "f 1//1 2//1 3//1 4//1",         # quad, v//vn
    "usemtl nope",                    # unknown material -> default
    "f -5 -4 -1",                     # negative indices, no normals
    "usemtl shiny",
    "f 1/9/2 2/9/2 5/9/2",            # v/vt/vn (vt ignored)
    "# comment", "",
    "f 2 3 4 5 1",                    # pentagon fan
])
EDGE_MTL = "\n".join([
    "newmtl shiny", "Kd 0.5 0.25 0.125", "Ks 0.9 0.8 0.7", "Ke 1 2 3",
    "Ni 1.45", "d 0.5", "Pr 0.3", "Pm 1", "Ps 0.2", "Pc 0.1",
    "newmtl plain", "Kd 0.1 0.2 0.3",
])


def _same_mesh(a: dict, b: dict):
    for k in ("vertices", "normals", "indices", "tri_material"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k
    assert a["materials"] == b["materials"]


@pytest.fixture
def edge_obj(tmp_path):
    (tmp_path / "edge.mtl").write_text(EDGE_MTL)
    p = tmp_path / "edge.obj"
    p.write_text(EDGE_CASES)
    return str(p)


def test_native_and_python_parsers_agree(edge_obj):
    if native.build() is None:
        pytest.skip("no C compiler: only the Python parser runs")
    a = tobj.load_obj(edge_obj, use_native=False)
    b = tobj.load_obj(edge_obj, use_native=True)
    assert (a["parser"], b["parser"]) == ("python", "native")
    _same_mesh(a, b)
    assert a["indices"].shape[0] == 7          # 2 + 1 + 1 + 3 (fan)


@pytest.mark.parametrize("use_native", [True, False])
def test_loader_matches_jax_on_edge_cases(edge_obj, use_native):
    _same_mesh(tobj.load_obj(edge_obj, use_native=use_native),
               jobj.load_obj(edge_obj, use_native=False))


def test_mtl_pbr_extensions(edge_obj):
    path = os.path.join(os.path.dirname(edge_obj), "edge.mtl")
    names, mats = tobj.parse_mtl(path)
    assert (names, mats) == jobj.parse_mtl(path)
    assert mats[0]["pr_pm_ps_pc"] == [0.3, 1.0, 0.2, 0.1]
    assert mats[0]["kd"] == [0.5, 0.25, 0.125, 0.5]


@pytest.mark.parametrize("name,kw", [
    ("bunny", dict(subdiv=2)),
    ("dragon", dict(nu=40, nv=12)),
    ("atrium", dict(detail=0.05)),
])
def test_assets_byte_identical(tmp_path, name, kw):
    gen = {"bunny": "generate_bunny", "dragon": "generate_dragon",
           "atrium": "generate_atrium"}[name]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    pj = str(tmp_path / "j" / f"{name}.obj")
    pt = str(tmp_path / "t" / f"{name}.obj")
    getattr(jassets, gen)(pj, **kw)
    getattr(tassets, gen)(pt, **kw)
    for ext in (".obj", ".mtl"):
        with open(pj[:-4] + ext, "rb") as a, open(pt[:-4] + ext, "rb") as b:
            assert a.read() == b.read(), ext


def test_generated_obj_loads_like_jax(tmp_path):
    path = str(tmp_path / "atrium.obj")
    tassets.generate_atrium(path, detail=0.05)
    j = jobj.load_obj(path, use_native=False)
    for use_native in (True, False):
        _same_mesh(tobj.load_obj(path, use_native=use_native), j)
    ke = np.array([m["ke"] for m in j["materials"]])
    assert (ke.sum(1) > 0).sum() == 1             # the lamp material


def test_ensure_asset_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("ROYALTRACER_ASSET_DIR", str(tmp_path))
    p1 = tassets.ensure_asset("bunny", subdiv=1)
    t1 = os.path.getmtime(p1)
    assert os.path.dirname(p1) == str(tmp_path)
    p2 = tassets.ensure_asset("bunny")
    assert p1 == p2 and os.path.getmtime(p2) == t1
    with pytest.raises(KeyError):
        tassets.ensure_asset("teapot")


def test_add_obj_matches_jax(tmp_path):
    """Scene.add_obj offsets local material ids into the global table
    (scene.py:60-75); the flattened soup matches the JAX package's."""
    path = str(tmp_path / "bunny.obj")
    tassets.generate_bunny(path, subdiv=1)
    out = []
    for cls, kw in ((JScene, {}), (TScene, dict(device="cpu"))):
        s = cls()
        s.add_material(kd=(0.2, 0.3, 0.4, 1.0))
        s.add_instance(s.add_obj(path))
        s.add_instance(s.add_obj(path), np.diag([2.0, 1.0, 1.0, 1.0]))
        out.append((s.material_table(),
                    s.flatten(s.build_materials(with_lut=False, **kw), **kw)))
    (jt, ja), (tt, ta) = out
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    np.testing.assert_array_equal(ta.tri_material.numpy(),
                                  np.asarray(ja.tri_material))
    np.testing.assert_array_equal(ta.tri_instance.numpy(),
                                  np.asarray(ja.tri_instance))
    np.testing.assert_allclose(ta.tri_verts.numpy(), np.asarray(ja.tri_verts),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ta.tri_normals.numpy(),
                               np.asarray(ja.tri_normals), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("fn,kw", [
    ("heightfield", dict(res=66)),
    ("displaced_sphere", dict(subdiv=24)),
])
def test_procedural_meshes_match_jax(fn, kw):
    tv, ti = getattr(tproc, fn)(**kw)
    jv, ji = getattr(jproc, fn)(**kw)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    assert tv.dtype == jv.dtype and ti.dtype == ji.dtype


def test_heightfield_windowed_scale():
    """heightfield(66) is the tests' windowed-scale scene: 8,450
    triangles, 8 blocks = 256 clusters, past the 128-cluster flat path."""
    from royaltracer_dx_tpu_torch.ops import stream_trace as tst
    import torch

    v, idx = tproc.heightfield(66)
    acc = tst.build_stream_accel(torch.as_tensor(v[idx]))
    assert idx.shape[0] == 8450 and acc.num_blocks == 8


def test_many_lights_matches_jax():
    t, j = tproc.many_lights(), jproc.many_lights()
    tt, jt = t.material_table(), j.material_table()
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k], err_msg=k)
    for a, b in zip(t.meshes, j.meshes):
        for f in ("vertices", "indices", "normals", "tri_material"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    lt = t.build_lights(device="cpu")
    lj = j.build_lights()
    np.testing.assert_allclose(lt.cdf.numpy(), np.asarray(lj.cdf),
                               rtol=1e-6)
    assert lt.count == lj.count == 64 * 2
