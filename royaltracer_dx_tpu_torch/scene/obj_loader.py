"""Wavefront OBJ/MTL loader -> numpy mesh + materials (port of
royaltracer_dx_tpu/scene/obj_loader.py, host numpy).

As in the JAX package: one default material is prepended per model and
faces without a known material map to it; the MTL PBR extensions Pr/Pm/
Ps/Pc become roughness/metallic/sheen/clearcoat, Kd + d become kd.xyzw;
vertices dedup on the resolved (position, normal) values; polygons are
fan-triangulated.  Geometry parses in the native C parser (native/) when
it builds, else in the pure-Python parser, which is the specification;
``load_obj`` reports which one ran under the key ``parser``.
"""

from __future__ import annotations

import os

import numpy as np

# Default material per model (obj_loader.py:25-31, ObjLoader.h:415).
DEFAULT_MATERIAL = dict(
    kd=(1.0, 1.0, 1.0, 1.0),
    ks=(1.0, 1.0, 1.0),
    ke=(0.0, 0.0, 0.0),
    ni=1.0,
    pr_pm_ps_pc=(1.0, 0.0, 0.0, 0.0),
)


def parse_mtl(path: str) -> tuple[list[str], list[dict]]:
    """Parse a .mtl file -> (names, material dicts) (obj_loader.py:34)."""
    names: list[str] = []
    mats: list[dict] = []
    cur: dict | None = None

    def f3(tok):
        return (float(tok[0]), float(tok[1]), float(tok[2]))

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
                cur["kd"][:3] = f3(tok[1:4])
            elif key in ("Ks", "Ke"):
                cur[key.lower()] = list(f3(tok[1:4]))
            elif key == "Ni":
                cur["ni"] = float(tok[1])
            elif key == "d":
                cur["kd"][3] = float(tok[1])
            elif key in pbr:
                cur["pr_pm_ps_pc"][pbr[key]] = float(tok[1])
    return names, mats


def _read_mtllib(base: str, name: str, mtl_names: list, materials: list):
    mtl_path = os.path.join(base, name)
    if os.path.exists(mtl_path):
        names, mats = parse_mtl(mtl_path)
        mtl_names.extend(names)
        materials.extend(mats)


def _load_obj_native(path: str):
    """Native-parser path (obj_loader.py:82-119): geometry parses in C;
    the mtllib/usemtl statements replay here so material ids are the same
    as the Python path's.  Returns the load_obj dict, or None when the
    parser is unavailable."""
    from royaltracer_dx_tpu_torch import native

    parsed = native.parse_obj_geometry(path)
    if parsed is None:
        return None
    verts6, indices, tri_slot, stmt_lines = parsed
    base = os.path.dirname(os.path.abspath(path))
    mtl_names: list[str] = []
    materials: list[dict] = [dict(DEFAULT_MATERIAL)]
    slot_to_mat = [0]           # slot 0 = before any usemtl
    for line in stmt_lines:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "mtllib" and len(tok) > 1:
            _read_mtllib(base, tok[1], mtl_names, materials)
        elif tok[0] == "usemtl":
            name = tok[1] if len(tok) > 1 else ""
            slot_to_mat.append(
                (mtl_names.index(name) + 1) if name in mtl_names else 0)
    return dict(
        vertices=np.ascontiguousarray(verts6[:, :3]),
        normals=np.ascontiguousarray(verts6[:, 3:]),
        indices=indices,
        tri_material=np.asarray(slot_to_mat, np.int32)[tri_slot],
        materials=materials,
        parser="native",
    )


def load_obj(path: str, use_native: bool = True) -> dict:
    """Load an OBJ file (obj_loader.py:122-204).

    Returns dict with vertices [V, 3], normals [V, 3] (zeros where
    absent), indices [T, 3], tri_material [T] (LOCAL ids: 0 = default
    material, 1..K = mtl order), materials (K + 1 dicts, default first)
    and parser ("native" or "python")."""
    if use_native:
        out = _load_obj_native(path)
        if out is not None:
            return out
    positions: list[tuple] = []
    obj_normals: list[tuple] = []
    mtl_names: list[str] = []
    materials: list[dict] = [dict(DEFAULT_MATERIAL)]
    unique: dict[tuple, int] = {}
    out_verts: list[tuple] = []
    out_norms: list[tuple] = []
    indices: list[int] = []
    tri_material: list[int] = []
    cur_mat = 0
    base = os.path.dirname(os.path.abspath(path))

    def vertex_id(vi: int, ni: int) -> int:
        key = (positions[vi], obj_normals[ni] if ni >= 0 else (0.0, 0.0, 0.0))
        idx = unique.get(key)
        if idx is None:
            idx = len(out_verts)
            unique[key] = idx
            out_verts.append(key[0])
            out_norms.append(key[1])
        return idx

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            key = tok[0]
            if key == "v":
                positions.append((float(tok[1]), float(tok[2]),
                                  float(tok[3])))
            elif key == "vn":
                obj_normals.append((float(tok[1]), float(tok[2]),
                                    float(tok[3])))
            elif key == "mtllib":
                _read_mtllib(base, tok[1], mtl_names, materials)
            elif key == "usemtl":
                name = tok[1] if len(tok) > 1 else ""
                cur_mat = ((mtl_names.index(name) + 1) if name in mtl_names
                           else 0)
            elif key == "f":
                face = []
                for v in tok[1:]:
                    parts = v.split("/")
                    vi = int(parts[0])
                    vi = vi - 1 if vi > 0 else len(positions) + vi
                    ni = -1
                    if len(parts) >= 3 and parts[2]:
                        ni = int(parts[2])
                        ni = ni - 1 if ni > 0 else len(obj_normals) + ni
                    face.append(vertex_id(vi, ni))
                for k in range(1, len(face) - 1):
                    indices.extend((face[0], face[k], face[k + 1]))
                    tri_material.append(cur_mat)
    return dict(
        vertices=np.asarray(out_verts, np.float32).reshape(-1, 3),
        normals=np.asarray(out_norms, np.float32).reshape(-1, 3),
        indices=np.asarray(indices, np.int32).reshape(-1, 3),
        tri_material=np.asarray(tri_material, np.int32),
        materials=materials,
        parser="python",
    )
