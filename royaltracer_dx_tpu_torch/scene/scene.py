"""Scene: meshes, materials, instances (port of
royaltracer_dx_tpu/scene/scene.py:30-261).

On the card ``flatten`` builds the stream accel unless it builds the LBVH
(``build_bvh``) or the clusters (``build_clusters``): every trace there
runs the stream kernels, or under traversal "bvh" / "cluster" the LBVH /
cluster kernels (ops/restir.py).  With ``prev`` (the previous frame's
arrays) ``flatten`` is the per-frame refit: the object-space arrays stay
cached on the device, ``_world_bake`` re-bakes world space there, the LBVH
and the stream accel refit with the build's order and the clusters are
rebuilt, as in the JAX package.  The light table is rebuilt on the host
from every mesh's triangles (scene/lights.py), the one part of a refit
whose host work grows with the triangle count.  A refit is spanned
(utils/telemetry.py) as ``update.bake``, ``update.refit``,
``update.lights`` and ``update.table``, its host copies and reads as
``sync.transforms``, ``sync.lights`` and ``sync.world_bounds``, and counts
the triangles re-baked and the stream slots re-laid.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from royaltracer_dx_tpu_torch.device import resolve_device
from royaltracer_dx_tpu_torch.scene import obj_loader
from royaltracer_dx_tpu_torch.scene.lights import collect_emissive_triangles
from royaltracer_dx_tpu_torch.scene.lut import compute_ess_lut
from royaltracer_dx_tpu_torch.scene.types import (
    LightTriangles,
    Materials,
    MeshData,
    SceneArrays,
    world_bounds,
)
from royaltracer_dx_tpu_torch.utils import telemetry

DEFAULT_MATERIAL = obj_loader.DEFAULT_MATERIAL


class Scene:
    def __init__(self):
        self.meshes: list[MeshData] = []
        self._materials: list[dict] = []
        self.instance_mesh: list[int] = []
        self.transforms: list[np.ndarray] = []
        self.prev_transforms: list[np.ndarray] = []
        self._static: dict = {}

    def add_material(self, **mat) -> int:
        """Add a material dict; returns its global id (scene.py:40-46)."""
        full = dict(DEFAULT_MATERIAL)
        full.update(mat)
        self._materials.append(full)
        return len(self._materials) - 1

    def add_mesh(self, vertices, indices, normals=None,
                 tri_material=None) -> int:
        """Add a mesh whose tri_material holds GLOBAL material ids."""
        self.meshes.append(MeshData(vertices, indices, normals, tri_material))
        self._static = {}
        return len(self.meshes) - 1

    def add_obj(self, path: str) -> int:
        """Load an OBJ model; its local material ids are offset into the
        global table (scene.py:60-75, ObjLoader.h:455-460)."""
        data = obj_loader.load_obj(path)
        offset = len(self._materials)
        self._materials.extend(data["materials"])
        self.meshes.append(MeshData(data["vertices"], data["indices"],
                                    data["normals"],
                                    data["tri_material"] + offset))
        self._static = {}
        return len(self.meshes) - 1

    def add_instance(self, mesh_id: int, transform=None) -> int:
        if transform is None:
            transform = np.eye(4, dtype=np.float32)
        self.instance_mesh.append(mesh_id)
        self.transforms.append(np.asarray(transform, np.float32))
        self.prev_transforms.append(np.asarray(transform, np.float32))
        self._static = {}
        return len(self.instance_mesh) - 1

    def set_transform(self, instance_id: int, transform):
        """Rolls current -> prev (scene.py:85-89)."""
        self.prev_transforms[instance_id] = self.transforms[instance_id]
        self.transforms[instance_id] = np.asarray(transform, np.float32)

    @property
    def num_triangles(self) -> int:
        return sum(self.meshes[m].num_triangles for m in self.instance_mesh)

    def material_table(self) -> dict[str, np.ndarray]:
        mats = self._materials or [dict(DEFAULT_MATERIAL)]
        return dict(
            kd=np.asarray([m["kd"] for m in mats], np.float32),
            ks=np.asarray([m["ks"] for m in mats], np.float32),
            ke=np.asarray([m["ke"] for m in mats], np.float32),
            ni=np.asarray([m["ni"] for m in mats], np.float32),
            pr_pm_ps_pc=np.asarray([m["pr_pm_ps_pc"] for m in mats],
                                   np.float32),
        )

    def build_materials(self, with_lut: bool = True,
                        device=None) -> Materials:
        dev = resolve_device(device)
        t = self.material_table()
        lut = None
        if with_lut:
            lut = compute_ess_lut(t["pr_pm_ps_pc"][:, 0]).numpy()
        return Materials.from_numpy(t["kd"], t["ks"], t["ni"], t["ke"],
                                    t["pr_pm_ps_pc"], lut, device=dev)

    def build_lights(self, device=None) -> LightTriangles:
        t = self.material_table()
        return collect_emissive_triangles(
            self.meshes, self.instance_mesh, t["ke"], self.transforms,
            device=resolve_device(device))

    def _object_static(self, dev: torch.device):
        """Concatenated OBJECT-space triangle arrays + material and
        instance maps on ``dev`` (scene.py:121-140), built once per device
        and cached until a mesh or an instance is added."""
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev in self._static:
            return self._static[dev]
        tv, tn, tm, ti = [], [], [], []
        for inst, mesh_id in enumerate(self.instance_mesh):
            mesh = self.meshes[mesh_id]
            tv.append(mesh.vertices[mesh.indices])
            tn.append(mesh.normals[mesh.indices])
            tm.append(mesh.tri_material)
            ti.append(np.full(mesh.num_triangles, inst, np.int32))
        self._static[dev] = tuple(
            torch.as_tensor(np.concatenate(a).astype(dt), device=dev)
            for a, dt in ((tv, np.float32), (tn, np.float32),
                          (tm, np.int32), (ti, np.int32)))
        return self._static[dev]

    def flatten(self, materials: Materials | None = None,
                build_stream: bool = False, stream_method: str = "median",
                device=None, prev: SceneArrays | None = None,
                build_bvh: bool = False,
                bvh_leaf_size: int = 4, build_clusters: bool = False,
                cluster_group: int = 128) -> SceneArrays:
        """Bake instances into a world-space triangle soup on ``device``
        (scene.py:142-209).  ``build_bvh`` builds the LBVH,
        ``build_clusters`` the clusters of ``cluster_group`` triangles; on
        CUDA the stream accel is built unless one of them is.  With
        ``prev`` its LBVH and stream accel are refitted and its clusters
        rebuilt with their group (scene.py:181-187), on ``prev``'s
        device."""
        from royaltracer_dx_tpu_torch.ops import cluster_traverse
        from royaltracer_dx_tpu_torch.ops.bvh import build_lbvh, refit_lbvh
        from royaltracer_dx_tpu_torch.ops.stream_trace import (
            build_stream_accel,
            refit_stream_accel,
        )

        if not self.instance_mesh:
            raise ValueError("scene has no instances")
        dev = prev.device if prev is not None else resolve_device(device)
        if materials is None:
            materials = self.build_materials(device=dev)
        obj_tv, obj_tn, tm, ti = self._object_static(dev)
        with _part(prev, "bake"):
            xf = telemetry.to_device("transforms", np.stack(self.transforms),
                                     dev)
            prev_xf = telemetry.to_device(
                "transforms", np.stack(self.prev_transforms), dev)
            tri_verts, tri_normals = _world_bake(obj_tv, obj_tn, ti, xf)
        with _part(prev, "refit"):
            bvh = None
            if prev is not None and prev.bvh is not None:
                bvh = refit_lbvh(prev.bvh, tri_verts)
            elif build_bvh:
                bvh = build_lbvh(tri_verts, leaf_size=bvh_leaf_size)
            clusters = None
            if prev is not None and prev.clusters is not None:
                cluster_group = prev.clusters.group
                build_clusters = True
            if build_clusters:
                clusters = cluster_traverse.build_clusters(
                    tri_verts, group=cluster_group)
            stream = None
            if prev is not None and prev.stream is not None:
                stream = refit_stream_accel(prev.stream, tri_verts)
            elif build_stream or (dev.type == "cuda" and bvh is None
                                  and clusters is None):
                stream = build_stream_accel(tri_verts, method=stream_method)
        with _part(prev, "lights"):
            lights = self.build_lights(device=dev)
        with _part(prev, "table"):
            arrays = SceneArrays(
                tri_verts=tri_verts,
                tri_normals=tri_normals,
                tri_material=tm,
                tri_instance=ti,
                materials=materials,
                lights=lights,
                object_to_world=xf,
                prev_object_to_world=prev_xf,
                bounds=world_bounds(tri_verts),
                bvh=bvh,
                clusters=clusters,
                stream=stream,
            ).with_tri_table()
        if prev is not None:
            telemetry.count("triangles", tri_verts.shape[0])
            telemetry.count("stream_slots", 0 if stream is None
                            else stream.perm.shape[0])
        return arrays


def _part(prev, name: str):
    """The ``update.<name>`` span of a refit (``prev`` given); none for a
    first build."""
    if prev is None:
        return contextlib.nullcontext()
    return telemetry.span("update." + name)


def _world_bake(obj_tv, obj_tn, tri_instance, transforms):
    """Object -> world triangle bake (scene.py:212-261): explicit planar
    fp32 math and an adjugate inverse-transpose for the normals."""
    a = transforms[:, :3, :3]
    trn = transforms[:, :3, 3]
    c00 = a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1]
    c01 = a[:, 1, 2] * a[:, 2, 0] - a[:, 1, 0] * a[:, 2, 2]
    c02 = a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0]
    c10 = a[:, 0, 2] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 2]
    c11 = a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0]
    c12 = a[:, 0, 1] * a[:, 2, 0] - a[:, 0, 0] * a[:, 2, 1]
    c20 = a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1]
    c21 = a[:, 0, 2] * a[:, 1, 0] - a[:, 0, 0] * a[:, 1, 2]
    c22 = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    det = a[:, 0, 0] * c00 + a[:, 0, 1] * c01 + a[:, 0, 2] * c02
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det,
                                torch.ones_like(det))
    nrm = torch.stack(
        [torch.stack([c00, c01, c02], dim=-1),
         torch.stack([c10, c11, c12], dim=-1),
         torch.stack([c20, c21, c22], dim=-1)], dim=1) * inv_det[:, None, None]

    ti = tri_instance.long()
    rot_t, trn_t, nrm_t = a[ti], trn[ti], nrm[ti]

    def xform(pts, m, add=None):
        out = []
        for c in range(3):
            acc = (pts[:, :, 0] * m[:, None, c, 0]
                   + pts[:, :, 1] * m[:, None, c, 1]
                   + pts[:, :, 2] * m[:, None, c, 2])
            if add is not None:
                acc = acc + add[:, None, c]
            out.append(acc)
        return torch.stack(out, dim=-1)

    world_v = xform(obj_tv, rot_t, trn_t)
    n = xform(obj_tn, nrm_t)
    ln = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    world_n = torch.where(ln > 1e-12, n / torch.clamp_min(ln, 1e-12),
                          torch.zeros_like(n))
    return world_v, world_n
