"""The reference's own scene: the raw inputs (an OBJ + MTL file, or a
procedural mesh) parsed or generated here, and baked into the world-space
arrays that the reference passes read.  Frozen copies of the port's
arithmetic: ``scene/types.py`` (the table layouts), ``scene/scene.py``
``_world_bake``, ``scene/lights.py`` and ``scene/lut.py`` (the LUT),
``scene/procedural.py`` ``menger_sponge`` / ``menger_scene`` and the OBJ
reader's semantics (one default material first, MTL materials after it,
fan triangulation, absent normals as zeros).  Nothing here reads what the
program built.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from reference.lut import compute_ess_lut

# obj_loader.py: the default material of every model
DEFAULT_MATERIAL = dict(
    kd=(1.0, 1.0, 1.0, 1.0),
    ks=(1.0, 1.0, 1.0),
    ke=(0.0, 0.0, 0.0),
    ni=1.0,
    pr_pm_ps_pc=(1.0, 0.0, 0.0, 0.0),
)


# ------------------------------- types -----------------------------------


@dataclasses.dataclass
class Materials:
    kd: torch.Tensor
    ks: torch.Tensor
    ni: torch.Tensor
    ke: torch.Tensor
    pr_pm_ps_pc: torch.Tensor
    lut: torch.Tensor

    @property
    def count(self) -> int:
        return self.kd.shape[0]


@dataclasses.dataclass
class LightTriangles:
    verts: torch.Tensor         # [L, 3, 3] object space
    instance: torch.Tensor      # [L] int32
    weight: torch.Tensor        # [L]
    cdf: torch.Tensor           # [L]
    emission: torch.Tensor      # [L, 3]
    total_weight: torch.Tensor  # []

    @property
    def count(self) -> int:
        return self.verts.shape[0]


@dataclasses.dataclass
class SceneArrays:
    """What the reference passes read of a scene (the port's SceneArrays
    without any acceleration structure)."""

    tri_verts: torch.Tensor      # [T, 3, 3] world space
    tri_normals: torch.Tensor    # [T, 3, 3] world space (0 = flat)
    tri_material: torch.Tensor   # [T] int32
    tri_instance: torch.Tensor   # [T] int32
    materials: Materials
    lights: LightTriangles
    object_to_world: torch.Tensor
    prev_object_to_world: torch.Tensor
    bounds: tuple
    tri_table: torch.Tensor      # [T, 20]: verts(9) normals(9) mid obj
    # the precision of every trace (bfloat16: the comparisons' control)
    trace_dtype: torch.dtype = torch.float32

    @property
    def num_triangles(self) -> int:
        return self.tri_verts.shape[0]

    @property
    def world_abs_max(self) -> float:
        return max(max(abs(v) for v in b) for b in self.bounds)

    @property
    def device(self) -> torch.device:
        return self.tri_verts.device


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray      # [V, 3] float32
    indices: np.ndarray       # [T, 3] int32
    normals: np.ndarray       # [V, 3] float32 (zeros where absent)
    tri_material: np.ndarray  # [T] int32, global material ids

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]


@dataclasses.dataclass
class SceneInput:
    """Host-side scene as the inputs give it: meshes, materials (dicts with
    the keys of DEFAULT_MATERIAL), instances as (mesh, 4x4 transform)."""

    meshes: list
    materials: list
    instances: list

    def add_material(self, **mat) -> int:
        full = dict(DEFAULT_MATERIAL)
        full.update(mat)
        self.materials.append(full)
        return len(self.materials) - 1

    def add_mesh(self, vertices, indices, tri_material,
                 normals=None) -> int:
        v = np.asarray(vertices, np.float32)
        self.meshes.append(Mesh(
            v, np.asarray(indices, np.int32).reshape(-1, 3),
            np.zeros_like(v) if normals is None
            else np.asarray(normals, np.float32),
            np.asarray(tri_material, np.int32)))
        return len(self.meshes) - 1

    def add_instance(self, mesh: int, transform=None) -> None:
        self.instances.append(
            (mesh, np.eye(4, dtype=np.float32) if transform is None
             else np.asarray(transform, np.float32)))

    @property
    def num_triangles(self) -> int:
        return sum(self.meshes[m].num_triangles for m, _ in self.instances)


def empty_scene() -> SceneInput:
    return SceneInput(meshes=[], materials=[], instances=[])


# ------------------------------ inputs -----------------------------------


def _parse_mtl(path: str) -> tuple[list, list]:
    names, mats = [], []
    cur = None
    pbr = {"Pr": 0, "Pm": 1, "Ps": 2, "Pc": 3}
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "newmtl":
                cur = dict(kd=[1.0, 1.0, 1.0, 1.0], ks=[0.0, 0.0, 0.0],
                           ke=[0.0, 0.0, 0.0], ni=1.0,
                           pr_pm_ps_pc=[0.0, 0.0, 0.0, 0.0])
                names.append(tok[1] if len(tok) > 1 else f"mat{len(mats)}")
                mats.append(cur)
            elif cur is None:
                continue
            elif key == "Kd":
                cur["kd"][:3] = [float(x) for x in tok[1:4]]
            elif key in ("Ks", "Ke"):
                cur[key.lower()] = [float(x) for x in tok[1:4]]
            elif key == "Ni":
                cur["ni"] = float(tok[1])
            elif key == "d":
                cur["kd"][3] = float(tok[1])
            elif key in pbr:
                cur["pr_pm_ps_pc"][pbr[key]] = float(tok[1])
    return names, mats


def load_obj(scene: SceneInput, path: str) -> int:
    """Add an OBJ model as one mesh (its materials after the scene's
    current ones, the model's default material first); returns the mesh
    id.  Triangle corners carry their own position and normal, so the
    vertex sharing of the program's loader does not matter here."""
    base = os.path.dirname(os.path.abspath(path))
    offset = len(scene.materials)
    names: list = []
    materials = [dict(DEFAULT_MATERIAL)]
    pos_txt, nrm_txt, faces = [], [], []
    cur = 0
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            c = line[:2]
            if c == "v ":
                pos_txt.append(line[2:])
            elif c == "vn":
                nrm_txt.append(line[3:])
            elif c == "f ":
                faces.append((cur, line[2:].split()))
            else:
                tok = line.split()
                if not tok:
                    continue
                if tok[0] == "mtllib" and len(tok) > 1:
                    mtl = os.path.join(base, tok[1])
                    if os.path.exists(mtl):
                        n, m = _parse_mtl(mtl)
                        names.extend(n)
                        materials.extend(m)
                elif tok[0] == "usemtl":
                    name = tok[1] if len(tok) > 1 else ""
                    cur = names.index(name) + 1 if name in names else 0
    pos = np.asarray(" ".join(pos_txt).split(), np.float32).reshape(-1, 3)
    nrm = np.asarray(" ".join(nrm_txt).split(), np.float32).reshape(-1, 3)
    corner_v, corner_n, tri_mat = [], [], []
    for mat, verts in faces:
        vi, ni = [], []
        for v in verts:
            parts = v.split("/")
            a = int(parts[0])
            vi.append(a - 1 if a > 0 else len(pos) + a)
            n = -1
            if len(parts) >= 3 and parts[2]:
                n = int(parts[2])
                n = n - 1 if n > 0 else len(nrm) + n
            ni.append(n)
        for k in range(1, len(vi) - 1):
            corner_v.extend((vi[0], vi[k], vi[k + 1]))
            corner_n.extend((ni[0], ni[k], ni[k + 1]))
            tri_mat.append(mat)
    cv = np.asarray(corner_v, np.int64)
    cn = np.asarray(corner_n, np.int64)
    nrm_pad = np.concatenate([nrm, np.zeros((1, 3), np.float32)])
    vertices = pos[cv]
    normals = nrm_pad[np.where(cn < 0, len(nrm), cn)]
    scene.materials.extend(materials)
    return scene.add_mesh(vertices, np.arange(len(cv)).reshape(-1, 3),
                          np.asarray(tri_mat, np.int32) + offset, normals)


def menger_sponge(levels: int = 2):
    """Menger-sponge cube faces (procedural.py ``menger_sponge``)."""
    cubes = [(np.zeros(3), 1.0)]
    for _ in range(levels):
        nxt = []
        for origin, size in cubes:
            step = size / 3.0
            for i in range(3):
                for j in range(3):
                    for k in range(3):
                        if (i == 1) + (j == 1) + (k == 1) >= 2:
                            continue
                        nxt.append((origin + np.array([i, j, k]) * step, step))
        cubes = nxt
    verts, tris = [], []
    corners = np.array(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
         [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32)
    faces = [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
             (2, 3, 7, 6), (0, 4, 7, 3), (1, 2, 6, 5)]
    for origin, size in cubes:
        base = len(verts)
        verts.extend(origin + corners * size)
        for a, b, c, d in faces:
            tris.append([base + a, base + b, base + c])
            tris.append([base + a, base + c, base + d])
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32)


def menger(levels: int = 2) -> SceneInput:
    """The menger scene (procedural.py ``menger_scene``): a white sponge
    under a 2-triangle ceiling light."""
    s = empty_scene()
    v, idx = menger_sponge(levels)
    white = s.add_material(kd=(0.7, 0.7, 0.7, 1.0), ks=(0, 0, 0))
    light = s.add_material(ke=(20.0, 20.0, 20.0))
    s.add_instance(s.add_mesh(v, idx, np.full(len(idx), white, np.int32)))
    lv = np.array([[0.2, 1.4, 0.2], [0.8, 1.4, 0.2], [0.8, 1.4, 0.8],
                   [0.2, 1.4, 0.8]], np.float32)
    s.add_instance(s.add_mesh(lv, [[0, 1, 2], [0, 2, 3]], [light, light]))
    return s


# ------------------------------- bake ------------------------------------


def _world_bake(obj_tv, obj_tn, tri_instance, transforms):
    """Object -> world bake (scene.py ``_world_bake``)."""
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


def _materials(scene: SceneInput, device) -> Materials:
    mats = scene.materials or [dict(DEFAULT_MATERIAL)]

    def col(key):
        return np.asarray([m[key] for m in mats], np.float32)

    pr = col("pr_pm_ps_pc")
    lut = compute_ess_lut(pr[:, 0]).numpy()

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Materials(kd=t(col("kd")), ks=t(col("ks")), ni=t(col("ni")),
                     ke=t(col("ke")), pr_pm_ps_pc=t(pr), lut=t(lut))


def _lights(scene: SceneInput, device) -> LightTriangles:
    """Emissive-triangle table and CDF (lights.py)."""
    ke_table = np.asarray([m["ke"] for m in scene.materials], np.float32)
    verts, inst, weight, emission = [], [], [], []
    for instance_index, (mesh_index, xf) in enumerate(scene.instances):
        mesh = scene.meshes[mesh_index]
        tri = mesh.vertices[mesh.indices]
        ke = ke_table[mesh.tri_material]
        lit = ke.sum(axis=-1) > 0.0
        if not lit.any():
            continue
        tv = tri[lit]
        m = np.asarray(xf, np.float32)
        tw = tv @ m[:3, :3].T + m[:3, 3]
        e1 = tw[:, 1] - tw[:, 0]
        e2 = tw[:, 2] - tw[:, 0]
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        avg_ke = ke[lit].mean(axis=-1)
        verts.append(tv)
        inst.append(np.full(len(tv), instance_index, np.int32))
        weight.append(area * avg_ke)
        emission.append(ke[lit])

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    if not verts:
        return LightTriangles(
            verts=t(np.zeros((1, 3, 3))), instance=t([0], torch.int32),
            weight=t([0.0]), cdf=t([1.0]), emission=t(np.zeros((1, 3))),
            total_weight=t(0.0))
    verts = np.concatenate(verts)
    inst = np.concatenate(inst)
    weight = np.concatenate(weight).astype(np.float32)
    emission = np.concatenate(emission).astype(np.float32)
    order = np.argsort(-weight, kind="stable")
    verts, inst, weight, emission = (verts[order], inst[order],
                                     weight[order], emission[order])
    total = float(weight.sum())
    prob = weight / total
    cdf = np.cumsum(prob).astype(np.float32)
    cdf[-1] = 1.0
    return LightTriangles(
        verts=t(verts), instance=t(inst, torch.int32),
        weight=t(prob.astype(np.float32)), cdf=t(cdf),
        emission=t(emission), total_weight=t(np.float32(total)))


def bake(scene: SceneInput, device) -> SceneArrays:
    """World-space arrays of ``scene`` on ``device`` (scene.py
    ``flatten`` without an acceleration structure)."""
    if not scene.instances:
        raise ValueError("scene has no instances")
    tv, tn, tm, ti = [], [], [], []
    for inst, (mesh_id, _) in enumerate(scene.instances):
        mesh = scene.meshes[mesh_id]
        tv.append(mesh.vertices[mesh.indices])
        tn.append(mesh.normals[mesh.indices])
        tm.append(mesh.tri_material)
        ti.append(np.full(mesh.num_triangles, inst, np.int32))
    obj_tv, obj_tn, tri_mat, tri_inst = (
        torch.as_tensor(np.concatenate(a).astype(dt), device=device)
        for a, dt in ((tv, np.float32), (tn, np.float32), (tm, np.int32),
                      (ti, np.int32)))
    xf = torch.as_tensor(np.stack([x for _, x in scene.instances]),
                         device=device)
    tri_verts, tri_normals = _world_bake(obj_tv, obj_tn, tri_inst, xf)
    lo_hi = torch.stack([tri_verts.amin(dim=(0, 1)),
                         tri_verts.amax(dim=(0, 1))]).cpu().tolist()
    t = tri_verts.shape[0]
    ids = torch.stack([tri_mat.to(torch.float32),
                       tri_inst.to(torch.float32)], dim=1)
    table = torch.cat([tri_verts.reshape(t, 9), tri_normals.reshape(t, 9),
                       ids], dim=1)
    return SceneArrays(
        tri_verts=tri_verts, tri_normals=tri_normals, tri_material=tri_mat,
        tri_instance=tri_inst, materials=_materials(scene, device),
        lights=_lights(scene, device), object_to_world=xf,
        prev_object_to_world=xf.clone(),
        bounds=(tuple(lo_hi[0]), tuple(lo_hi[1])), tri_table=table)
