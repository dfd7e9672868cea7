"""AOV / debug channels from the primary hit (port of
royaltracer_dx_tpu/render/aov.py): each channel is a flat row-major [N]
or [N, C] tensor.  The primary trace goes through ops/restir.py, which on
the card launches the stream kernel."""

from __future__ import annotations

import torch

from royaltracer_dx_tpu_torch.camera import generate_rays
from royaltracer_dx_tpu_torch.config import RenderConfig
from royaltracer_dx_tpu_torch.ops import restir
from royaltracer_dx_tpu_torch.utils import math3d as m3

CHANNELS = (
    "albedo", "normal", "depth", "position", "material_id", "instance_id",
    "emission", "roughness", "metallic",
)


def render_aovs(scene, cam: dict, cfg: RenderConfig) -> dict:
    """Primary-hit AOV dict (aov.py:27-46)."""
    origins, dirs = generate_rays(cam, cfg.width, cfg.height)
    dirs = m3.normalize(dirs)
    hit = restir.trace_closest(scene, origins, dirs, cfg)
    mat = restir.fetch_material(scene, hit["mid"])
    v = hit["valid"]
    v3 = v[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    none = torch.full_like(hit["mid"], -1)
    return dict(
        albedo=torch.where(v3, mat["kd"][:, :3], zero),
        normal=torch.where(v3, hit["normal"] * 0.5 + 0.5, zero),
        depth=torch.where(v, m3.length(hit["pos"] - origins), zero),
        position=torch.where(v3, hit["pos"], zero),
        material_id=torch.where(v, hit["mid"], none),
        instance_id=torch.where(v, hit["obj"], none),
        emission=torch.where(v3, mat["ke"], zero),
        roughness=torch.where(v, mat["rough"], zero),
        metallic=torch.where(v, mat["metal"], zero),
    )
