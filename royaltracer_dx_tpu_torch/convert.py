"""Numpy-only converters from the JAX package's arrays to the port's.

Scene data crosses as dicts of numpy arrays, taken from the JAX objects
with ``np.asarray`` (or read from an npz), under dotted keys named after
the JAX dataclass fields:

  tri_verts, tri_normals, tri_material, tri_instance,
  materials.{kd, ks, ni, ke, pr_pm_ps_pc, lut},
  lights.{verts, instance, weight, cdf, emission, total_weight},
  object_to_world, prev_object_to_world,
  stream.{blk_tris, blk_boxes, top_lo, top_hi, perm}   (optional)

and the matmul tracer's coefficients as {coeff, center, num_tris}
(``mxu_tris_from_numpy``).

Renderer state crosses through ``RestirRenderer.state_dict`` /
``load_state``, which use the npz key names of the JAX package's
io/checkpoint.py:36-57.  Nothing here imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from royaltracer_dx_tpu_torch.device import resolve_device
from royaltracer_dx_tpu_torch.ops.mxu_trace import MxuTris
from royaltracer_dx_tpu_torch.ops.stream_trace import StreamAccel
from royaltracer_dx_tpu_torch.scene.types import (
    LightTriangles,
    Materials,
    SceneArrays,
    world_bounds,
)

_INT_FIELDS = ("tri_material", "tri_instance", "instance", "perm")


def _tensor(d: dict, key: str, device) -> torch.Tensor:
    int_field = key.rsplit(".", 1)[-1] in _INT_FIELDS
    dtype = torch.int32 if int_field else torch.float32
    return torch.as_tensor(np.array(d[key]), dtype=dtype, device=device)


def _fields(cls, d: dict, prefix: str, device) -> dict:
    return {f.name: _tensor(d, f"{prefix}{f.name}", device)
            for f in dataclasses.fields(cls)}


def stream_accel_from_numpy(d: dict, device=None,
                            prefix: str = "") -> StreamAccel:
    """StreamAccel from blk_tris / blk_boxes / top_lo / top_hi / perm
    (the fields the kernels read; the JAX accel's bf16 rows and plane
    slabs are not used by the port)."""
    dev = resolve_device(device)
    acc = StreamAccel(**_fields(StreamAccel, d, prefix, dev))
    acc.blk_tris = acc.blk_tris.contiguous()
    acc.blk_boxes = acc.blk_boxes.contiguous()
    return acc


def mxu_tris_from_numpy(d: dict, device=None) -> MxuTris:
    """MxuTris from {"coeff", "center", "num_tris"} (the JAX MxuTris's
    fields: coeff [10, 4Tp], center [3], the triangle count)."""
    dev = resolve_device(device)
    return MxuTris(coeff=_tensor(d, "coeff", dev).contiguous(),
                   center=_tensor(d, "center", dev).contiguous(),
                   num_tris=int(d["num_tris"]))


def scene_arrays_from_numpy(d: dict, device=None) -> SceneArrays:
    """SceneArrays (with its [T, 20] triangle table) from a dict of numpy
    arrays under the keys listed in the module docstring."""
    dev = resolve_device(device)
    stream = None
    if "stream.blk_tris" in d:
        stream = stream_accel_from_numpy(d, dev, prefix="stream.")
    tri_verts = _tensor(d, "tri_verts", dev)
    return SceneArrays(
        tri_verts=tri_verts,
        tri_normals=_tensor(d, "tri_normals", dev),
        tri_material=_tensor(d, "tri_material", dev),
        tri_instance=_tensor(d, "tri_instance", dev),
        materials=Materials(**_fields(Materials, d, "materials.", dev)),
        lights=LightTriangles(**_fields(LightTriangles, d, "lights.", dev)),
        object_to_world=_tensor(d, "object_to_world", dev),
        prev_object_to_world=_tensor(d, "prev_object_to_world", dev),
        bounds=world_bounds(tri_verts),
        stream=stream,
    ).with_tri_table()
