"""The port's ReSTIR frames under traversal="cluster" against the JAX
package on the CPU: one device's frame against the JAX renderer's, and a
2-band frame against the JAX passes run band by band (the rest of the
cluster traversal's tests are in tests/test_torch_cluster.py).  Held at
tests/test_torch_restir.py's image tolerance (``image_close``: >= 99% of
pixels within 1e-3 relative, channel means within 5e-3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from royaltracer_dx_tpu.camera import Camera as JCamera
from royaltracer_dx_tpu.config import RenderConfig as JConfig
from royaltracer_dx_tpu.ops import cluster_traverse as jct
from royaltracer_dx_tpu.render import restir_renderer as jr
from royaltracer_dx_tpu.scene import procedural as jproc

from royaltracer_dx_tpu_torch import convert
from royaltracer_dx_tpu_torch.camera import Camera
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.ops import cluster_traverse as tct
from royaltracer_dx_tpu_torch.ops import restir as trestir
from royaltracer_dx_tpu_torch.parallel import shard as tshard
from royaltracer_dx_tpu_torch.render import restir_renderer as tr
from royaltracer_dx_tpu_torch.scene import procedural as tproc
from test_torch_restir import (  # noqa: F401 (one_torch_thread: autouse)
    image_close,
    jax_scene_dict,
    one_torch_thread,
    with_lut,
)
from test_torch_sharding import _ext, _to_j

EYE, CENTER = (0.5, 0.5, 1.72), (0.5, 0.5, 0.0)
# several clusters and tiles on the 32-triangle Cornell box
SMALL = dict(cluster_group=8, cluster_tile=32)


def test_restir_frame_matches_jax():
    """A 32x27 Cornell ReSTIR frame with traversal="cluster" (4 clusters
    of 8 triangles, tiles of 32 rays) against the JAX renderer's."""
    cfg = dict(width=32, height=27, traversal="cluster", **SMALL)
    jrr = jr.RestirRenderer(jproc.cornell_box(emission=18.0),
                            JCamera(eye=EYE, center=CENTER), JConfig(**cfg))
    jrr.render()
    jrr.render()
    r = tr.RestirRenderer(tproc.cornell_box(emission=18.0),
                          Camera(eye=EYE, center=CENTER), RenderConfig(**cfg),
                          device="cpu")
    assert r.scene_arrays.clusters.num_clusters == 4
    assert r.scene_arrays.stream is None
    with_lut(r, np.asarray(jrr.scene_arrays.materials.lut))
    launches = dict(tct.LAUNCHES)
    r.render()
    r.render()
    assert tct.LAUNCHES == launches           # CPU tensors launch nothing
    image_close(r.radiance(), np.asarray(jrr.radiance()))


def test_two_band_frame_matches_jax_bands():
    """A 2-band 33x28 Cornell frame under traversal="cluster": the port's
    sharded frame function against the JAX passes run band by band with
    each band's pixel coordinates, row window and halo-extended tables
    (how the JAX package's sharded frame forms a band, parallel/shard.py:
    104-168; its shard_map cannot trace the cluster while loops).  Each
    band traces its own batches, so its tiles are its own: the reference
    is the 2-band frame, not one device's.  33 pixels wide: at 32 the
    camera's pixel corners fall on triangle edges, where an ulp of
    XLA-vs-PyTorch drift picks the other triangle (brute force too)."""
    img, jimg = _two_band_images("cluster", 33, 28)
    assert np.isfinite(img).all() and img.mean() > 0.0
    image_close(img, jimg)


def _two_band_images(traversal, w, h, halo=4):
    """(the port's 2-band frame, the JAX bands' frame) as [h, w, 3]."""
    kw = dict(width=w, height=h, spatial_radius=halo, gi_bounces=1,
              traversal=traversal, **SMALL)
    jcfg, cfg = JConfig(**kw), RenderConfig(**kw)
    jscene = jproc.cornell_box(emission=18.0).flatten()
    scene = convert.scene_arrays_from_numpy(jax_scene_dict(jscene),
                                            device="cpu")
    group = SMALL["cluster_group"]
    jcl = jct.build_clusters(jscene.tri_verts, group=group)
    tcl = tct.build_clusters(scene.tri_verts, group=group)
    jscene = jscene.replace(clusters=jcl)
    scene = dataclasses.replace(scene, clusters=tcl)
    cam = Camera(eye=EYE, center=CENTER)
    ca = {k: torch.as_tensor(v) for k, v in cam.matrices(w / h).items()}
    ca["prev_view"] = torch.zeros((4, 4))
    ca["prev_proj"] = torch.zeros((4, 4))
    jca = _to_j(ca)
    band_h = h // 2
    bh_ext = band_h + 2 * halo
    n = band_h * w
    fresh = torch.zeros((h * w, 8))
    fresh[:, 6] = float(trestir.MISS_ID_I32)
    fresh[:, 7] = 1.0
    last = (fresh, torch.zeros((h * w, 8)), torch.zeros((h * w, 8)))
    xs, ys = [], []
    for b in range(2):
        yy, xx = torch.meshgrid(torch.arange(b * band_h, (b + 1) * band_h),
                                torch.arange(w), indexing="ij")
        xs.append(xx.reshape(-1))
        ys.append(yy.reshape(-1))

    # the JAX bands: pass 1 and the GI paths, temporal reuse, then
    # spatial reuse over both bands' current records
    cur, res = [], []
    for b in range(2):
        row0 = b * band_h - halo
        jargs = dict(xs=jnp.asarray(xs[b].numpy(), jnp.int32),
                     ys=jnp.asarray(ys[b].numpy(), jnp.int32))
        rdi, sd, gi_in, seed = jr.pass1_di(jscene, jca, jnp.uint32(0), jcfg,
                                           **jargs)
        st = jr.pass1_gi_init(jscene, gi_in, seed, jcfg)
        st = jr.pass1_gi_bounce(jscene, jcfg, st, jnp.uint32(0))
        rgi, _ = jr.pass1_gi_final(jscene, gi_in, st, jcfg)
        ext = [_to_j(tuple(_ext(t, row0, bh_ext, w) for t in last))] * 2
        rdi, rgi = jr.pass2_temporal(jscene, jca, jnp.uint32(0), rdi, rgi,
                                     sd, *ext, jcfg, row0=row0,
                                     band_h=bh_ext, **jargs)
        res.append((rdi, rgi, sd, jargs, row0))
        cur.append((jr._pack_record(sd, rdi, jr._DI_KEYS),
                    jr._pack_record(sd, rgi, jr._GI_KEYS)))
    full = [tuple(torch.cat([torch.as_tensor(np.asarray(c[k][s]))
                             for c in cur]) for s in range(3))
            for k in range(2)]
    samples = []
    for rdi, rgi, sd, jargs, row0 in res:
        ext = [_to_j(tuple(_ext(t, row0, bh_ext, w) for t in f))
               for f in full]
        sample, _, _, _ = jr.pass3_spatial(
            jscene, jca, jnp.uint32(0), rdi, rgi, sd, jcfg, row0=row0,
            band_h=bh_ext, packed_di_ext=ext[0], packed_gi_ext=ext[1],
            **jargs)
        samples.append(np.asarray(sample))
    jimg = np.concatenate(samples).reshape(h, w, 3)

    fn = tshard.make_sharded_restir_frame(["cpu", "cpu"], cfg)
    packed = [tuple(t[b * n:(b + 1) * n] for t in last) for b in range(2)]
    sample, _, _, _, _ = fn([scene] * 2, [ca] * 2, 0, xs, ys, packed,
                            packed)
    return torch.cat(sample).reshape(h, w, 3).numpy(), jimg
