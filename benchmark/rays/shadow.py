"""Ray kind ``shadow``: ``per_point`` segments from each point of the
batch ``of`` to area-weighted points on the emissive triangles (NEE's
candidates), as any-hit queries bounded short of the lamp."""

import torch

from harness import traffic


def make(spec: dict, ctx: dict) -> dict:
    p, n = ctx["points"][spec["of"]]
    k = int(spec["per_point"])
    p = p.repeat_interleave(k, dim=0)
    n = n.repeat_interleave(k, dim=0)
    to = traffic.light_points(ctx["sa"], p.shape[0], ctx["g"]) - p
    dist = torch.linalg.norm(to, dim=-1)
    bias = traffic.S_BIAS
    return dict(o=(p + n * bias).contiguous(),
                d=(to / torch.clamp_min(dist, 1e-20)[:, None]).contiguous(),
                t_max=torch.clamp_min(dist - 10.0 * bias, 2.0 * bias))
