"""Emissive-triangle collection and CDF (port of
royaltracer_dx_tpu/scene/lights.py:19-95).  Host numpy, identical
arithmetic; the table lands on ``device`` (each copy to a card spanned as
``sync.lights``)."""

from __future__ import annotations

import numpy as np
import torch

from royaltracer_dx_tpu_torch.scene.types import LightTriangles
from royaltracer_dx_tpu_torch.utils import telemetry


def collect_emissive_triangles(meshes, instance_mesh, ke_table,
                               transforms=None,
                               device="cpu") -> LightTriangles:
    """Light table with weight = world-space area * avg(Ke), sorted by
    descending weight, cdf[-1] forced to 1 (lights.py:19-95)."""
    verts, inst, weight, emission = [], [], [], []
    for instance_index, mesh_index in enumerate(instance_mesh):
        mesh = meshes[mesh_index]
        tri = mesh.vertices[mesh.indices]
        ke = ke_table[mesh.tri_material]
        lit = ke.sum(axis=-1) > 0.0
        if not lit.any():
            continue
        tv = tri[lit]
        tw = tv
        if transforms is not None:
            m = np.asarray(transforms[instance_index], np.float32)
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
        return telemetry.to_device("lights", np.asarray(a), device, dtype)

    if not verts:
        # no lights: one degenerate entry keeps every shape static
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
