"""ReSTIR reservoirs (port of royaltracer_dx_tpu/ops/reservoir.py).

Reservoirs live as dicts: planar (vectors as 3-tuples of [N] planes)
inside the passes, AoS ([N, 3] tensors) between frames — the persistent
state, keyed like the JAX dataclass fields (x2/n2/l2/w_sum/w/m,
xn/nn/e3/..., x1/n1/o/l1/mid/obj) so checkpoints map one to one.
"""

from __future__ import annotations

import torch

from royaltracer_dx_tpu_torch.utils import pvec as pv
from royaltracer_dx_tpu_torch.utils.rng import tea_random

DI_VEC = ("x2", "n2", "l2")
GI_VEC = ("xn", "nn", "e3")
SD_VEC = ("x1", "n1", "o", "l1")


def zeros_reservoir(n: int, keys: tuple, device) -> dict:
    """Fresh AoS reservoir (ReservoirDI/GI.zeros_like_lanes)."""
    out = {k: torch.zeros((n, 3), dtype=torch.float32, device=device)
           for k in keys}
    for k in ("w_sum", "w", "m"):
        out[k] = torch.zeros((n,), dtype=torch.float32, device=device)
    return out


def get_w(w_sum, p_hat, eps: float = 1e-6):
    """W = w_sum / p_hat, 0 when p_hat ~ 0 (reservoir.py:138-140)."""
    return torch.where(p_hat > eps, w_sum / torch.clamp_min(p_hat, eps),
                       torch.zeros_like(w_sum))


def to_planes(r: dict) -> dict:
    """AoS record -> planar (di_to_planes / gi_to_planes /
    sdata_to_planes, reservoir.py:150-181)."""
    return {k: (pv.from_aos(v, 1) if torch.is_tensor(v) and v.dim() == 2
                else v) for k, v in r.items()}


def from_planes(d: dict) -> dict:
    """Planar record -> AoS (planes_to_di / planes_to_gi /
    planes_to_sdata)."""
    return {k: (pv.to_aos(v, 1) if isinstance(v, tuple) else v)
            for k, v in d.items()}


def update_reservoir_p(r: dict, keys: tuple, accept_mask, wi, m_add,
                       sample: tuple, seed):
    """Planar UpdateReservoir (reservoir.py:184-198, Reservoir_v6.hlsl:30-80).
    Returns (reservoir dict, took, seed); the RNG advances on every lane."""
    u, seed = tea_random(seed)
    w_sum = torch.where(accept_mask, r["w_sum"] + wi, r["w_sum"])
    m = torch.where(accept_mask, r["m"] + m_add, r["m"])
    one = torch.ones((), dtype=w_sum.dtype, device=w_sum.device)
    take = accept_mask & (u < wi / torch.where(w_sum == 0.0, one, w_sum))
    out = dict(r, w_sum=w_sum, m=m)
    for key, vec in zip(keys, sample):
        out[key] = pv.where(take, vec, r[key])
    return out, take, seed


def is_valid_di_p(r: dict):
    return ((pv.length(r["n2"]) > 0.0) & (pv.length(r["l2"]) > 0.0)
            & (r["w_sum"] > 0.0) & (r["m"] > 0.0))


def is_valid_gi_p(r: dict):
    return (r["w_sum"] > 0.0) & (r["m"] > 0.0)
