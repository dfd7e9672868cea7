"""Scene data as structure-of-arrays tensors (port of
royaltracer_dx_tpu/scene/types.py:19-148).

Plain dataclasses of tensors instead of flax pytrees; field names match
the JAX package so the converters (convert.py) and tests map one to one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Materials:
    """Material table (types.py:19-54): kd [M, 4], ks [M, 3], ni [M],
    ke [M, 3], pr_pm_ps_pc [M, 4], lut [M, 16]."""

    kd: torch.Tensor
    ks: torch.Tensor
    ni: torch.Tensor
    ke: torch.Tensor
    pr_pm_ps_pc: torch.Tensor
    lut: torch.Tensor

    @property
    def count(self) -> int:
        return self.kd.shape[0]

    @staticmethod
    def from_numpy(kd, ks, ni, ke, pr_pm_ps_pc, lut=None,
                   device="cpu") -> "Materials":
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        kd = t(kd)
        if lut is None:
            lut = np.ones((kd.shape[0], 16), np.float32)
        return Materials(kd=kd, ks=t(ks), ni=t(ni), ke=t(ke),
                         pr_pm_ps_pc=t(pr_pm_ps_pc), lut=t(lut))


class MeshData:
    """Host-side indexed mesh (types.py:57-83)."""

    def __init__(self, vertices, indices, normals=None, tri_material=None):
        self.vertices = np.asarray(vertices, np.float32)
        self.indices = np.asarray(indices, np.int32).reshape(-1, 3)
        if normals is None:
            normals = np.zeros_like(self.vertices)
        self.normals = np.asarray(normals, np.float32)
        if tri_material is None:
            tri_material = np.zeros(len(self.indices), np.int32)
        self.tri_material = np.asarray(tri_material, np.int32)

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]


@dataclasses.dataclass
class LightTriangles:
    """Emissive-triangle table with its sampling CDF (types.py:86-105)."""

    verts: torch.Tensor         # [L, 3, 3] object space
    instance: torch.Tensor      # [L] int32
    weight: torch.Tensor        # [L] normalized selection probability
    cdf: torch.Tensor           # [L]
    emission: torch.Tensor      # [L, 3]
    total_weight: torch.Tensor  # [] float32

    @property
    def count(self) -> int:
        return self.verts.shape[0]


@dataclasses.dataclass
class SceneArrays:
    """Device-side flattened scene (types.py:108-148).  ``bvh`` holds the
    LBVH (traversal "bvh"), ``stream`` the StreamAccel; the cluster
    structure of the JAX package is not ported yet."""

    tri_verts: torch.Tensor      # [T, 3, 3] world space
    tri_normals: torch.Tensor    # [T, 3, 3] world space (0 = flat)
    tri_material: torch.Tensor   # [T] int32
    tri_instance: torch.Tensor   # [T] int32
    materials: Materials
    lights: LightTriangles
    object_to_world: torch.Tensor       # [I, 4, 4]
    prev_object_to_world: torch.Tensor  # [I, 4, 4]
    # (min xyz, max xyz) of tri_verts as host floats (world_bounds), read
    # once where the world is baked: pass 3 picks its accept tables' dtype
    # from it without a device sync in the frame
    bounds: tuple
    bvh: object = None
    stream: object = None
    # verts(9) normals(9) mid obj as ONE [T, 20] row, ids as float VALUES
    # (types.py:127-145)
    tri_table: torch.Tensor | None = None

    def with_tri_table(self) -> "SceneArrays":
        t = self.num_triangles
        v9 = self.tri_verts.reshape(t, 9)
        n9 = self.tri_normals.reshape(t, 9)
        ids = torch.stack([self.tri_material.to(torch.float32),
                           self.tri_instance.to(torch.float32)], dim=1)
        return dataclasses.replace(
            self, tri_table=torch.cat([v9, n9, ids], dim=1))

    @property
    def num_triangles(self) -> int:
        return self.tri_verts.shape[0]

    @property
    def world_abs_max(self) -> float:
        """The largest |coordinate| of the world triangles."""
        return max(max(abs(v) for v in b) for b in self.bounds)

    @property
    def device(self) -> torch.device:
        return self.tri_verts.device


def world_bounds(tri_verts: torch.Tensor) -> tuple:
    """(min xyz, max xyz) of [T, 3, 3] triangles as host floats: one
    device read."""
    if tri_verts.shape[0] == 0:
        return ((0.0,) * 3, (0.0,) * 3)
    lo_hi = torch.stack([tri_verts.amin(dim=(0, 1)),
                         tri_verts.amax(dim=(0, 1))]).cpu().tolist()
    return tuple(lo_hi[0]), tuple(lo_hi[1])
