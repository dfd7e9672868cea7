"""Frozen copy for the benchmark's plain reference: ReSTIR reservoirs (port of royaltracer_dx_tpu/ops/reservoir.py).

The renderer's reservoirs live as dicts: planar (vectors as 3-tuples of
[N] planes) inside the passes, AoS ([N, 3] tensors) between frames — the
persistent state, keyed like the JAX dataclass fields (x2/n2/l2/w_sum/w/m,
xn/nn/e3/..., x1/n1/o/l1/mid/obj) so checkpoints map one to one.  The JAX
package's AoS types ``ReservoirDI`` / ``ReservoirGI`` / ``SampleData``,
their streaming updates, validity tests and planar converters
(reservoir.py:21-178) are here too, for the AoS API.
"""

from __future__ import annotations

import dataclasses

import torch

from reference import math3d as m3
from reference import pvec as pv
from reference.rng import tea_random


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


# ------------------------------ AoS types --------------------------------


def _zero_lanes(ref):
    """([N, 3], [N]) zeros shaped from ``ref`` [N, ...] as
    zeros_like_lanes does (ref * 0.0, so a non-finite ref gives NaN)."""
    z3 = ref[..., :1] * 0.0 + torch.zeros(3, dtype=ref.dtype,
                                          device=ref.device)
    return z3, ref[..., 0] * 0.0


@dataclasses.dataclass
class ReservoirDI:
    """Direct-illumination reservoir (reservoir.py:21-38): reconnection
    point x2 / n2, its radiance l2 [N, 3]; w_sum, W, confidence m [N]."""

    x2: torch.Tensor
    n2: torch.Tensor
    l2: torch.Tensor
    w_sum: torch.Tensor
    w: torch.Tensor
    m: torch.Tensor

    @staticmethod
    def zeros_like_lanes(ref) -> "ReservoirDI":
        z3, z = _zero_lanes(ref)
        return ReservoirDI(x2=z3, n2=z3, l2=z3, w_sum=z, w=z, m=z)


@dataclasses.dataclass
class ReservoirGI:
    """Global-illumination reservoir (reservoir.py:41-56): reconnection
    vertex xn / nn and the radiance e3 arriving there [N, 3]; w_sum, W, m
    [N]."""

    xn: torch.Tensor
    nn: torch.Tensor
    e3: torch.Tensor
    w_sum: torch.Tensor
    w: torch.Tensor
    m: torch.Tensor

    @staticmethod
    def zeros_like_lanes(ref) -> "ReservoirGI":
        z3, z = _zero_lanes(ref)
        return ReservoirGI(xn=z3, nn=z3, e3=z3, w_sum=z, w=z, m=z)


@dataclasses.dataclass
class SampleData:
    """Per-pixel primary-hit record (reservoir.py:59-68): x1, n1, o
    (toward the camera), l1 [N, 3]; mid, obj [N] int32."""

    x1: torch.Tensor
    n1: torch.Tensor
    o: torch.Tensor
    l1: torch.Tensor
    mid: torch.Tensor
    obj: torch.Tensor


def is_valid_di(r: ReservoirDI):
    """IsValidReservoir (reservoir.py:126-133, Sampler_v6.hlsl:7-14)."""
    return ((m3.length(r.n2) > 0.0) & (m3.length(r.l2) > 0.0)
            & (r.w_sum > 0.0) & (r.m > 0.0))


def is_valid_gi(r: ReservoirGI):
    """IsValidReservoir_GI (reservoir.py:136-138, Sampler_v6.hlsl:17-22)."""
    return (r.w_sum > 0.0) & (r.m > 0.0)


def _to_planes(rec) -> dict:
    return to_planes({f.name: getattr(rec, f.name)
                      for f in dataclasses.fields(rec)})


def di_to_planes(r: ReservoirDI) -> dict:
    """AoS ReservoirDI -> planar dict (reservoir.py:150-152)."""
    return _to_planes(r)


def planes_to_di(d: dict) -> ReservoirDI:
    return ReservoirDI(**from_planes(d))


def gi_to_planes(r: ReservoirGI) -> dict:
    """AoS ReservoirGI -> planar dict (reservoir.py:161-163)."""
    return _to_planes(r)


def planes_to_gi(d: dict) -> ReservoirGI:
    return ReservoirGI(**from_planes(d))


def sdata_to_planes(s: SampleData) -> dict:
    """AoS SampleData -> planar dict (reservoir.py:172-175)."""
    return _to_planes(s)


def planes_to_sdata(d: dict) -> SampleData:
    return SampleData(**from_planes(d))
