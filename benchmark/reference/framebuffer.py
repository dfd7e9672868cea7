"""Frozen copy for the benchmark's plain reference: Progressive accumulation framebuffer (port of
royaltracer_dx_tpu/render/framebuffer.py:19-69, RayGen_v6_pass3.hlsl:384-432).
"""

from __future__ import annotations

import dataclasses

import torch

from reference import math3d as m3


@dataclasses.dataclass
class Framebuffer:
    accum: torch.Tensor   # [N, 3] radiance sum
    count: torch.Tensor   # [N] frames accumulated

    @staticmethod
    def create(num_pixels: int, device) -> "Framebuffer":
        return Framebuffer(
            accum=torch.zeros((num_pixels, 3), dtype=torch.float32,
                              device=device),
            count=torch.zeros((num_pixels,), dtype=torch.float32,
                              device=device))


def accumulate(fb: Framebuffer, sample, camera_changed,
               max_frames: int = 2_000_000) -> Framebuffer:
    """One accumulation step: non-finite samples are skipped, the count
    caps at max_frames, a camera change restarts from this frame
    (framebuffer.py:32-57).  camera_changed: a bool or a 0-d bool tensor
    (kept on the device, so the step needs no host round trip)."""
    changed = torch.as_tensor(camera_changed, device=sample.device)
    finite = torch.all(torch.isfinite(sample), dim=-1)
    fresh = fb.count <= 0.0
    ok_init = fresh & finite
    ok_cont = (~fresh) & (fb.count < max_frames) & finite
    accum = torch.where(ok_init[:, None], sample,
                        torch.where(ok_cont[:, None], fb.accum + sample,
                                    fb.accum))
    count = torch.where(ok_init, 1.0,
                        torch.where(ok_cont, fb.count + 1.0, fb.count))
    # camera motion restarts from this frame's sample; a non-finite
    # sample restarts from the next valid one
    reset_ok = changed & finite
    accum = torch.where(reset_ok[:, None], sample,
                        torch.where(changed, 0.0, accum))
    count = torch.where(reset_ok, 1.0, torch.where(changed, 0.0, count))
    return Framebuffer(accum=accum, count=count)


def resolve(fb: Framebuffer, srgb: bool = True):
    """Averaged color with NaN = magenta / Inf = cyan sentinels
    (framebuffer.py:60-69)."""
    color = fb.accum / torch.clamp_min(fb.count, 1.0)[:, None]
    nan = torch.any(torch.isnan(color), dim=-1, keepdim=True)
    inf = torch.any(torch.isinf(color), dim=-1, keepdim=True)
    magenta = torch.tensor([1.0, 0.0, 1.0], device=color.device)
    cyan = torch.tensor([0.0, 1.0, 1.0], device=color.device)
    color = torch.where(nan, magenta, color)
    color = torch.where(inf & ~nan, cyan, color)
    if srgb:
        color = m3.srgb_gamma(torch.clamp_min(color, 0.0))
    return torch.clamp(color, 0.0, 1.0)
