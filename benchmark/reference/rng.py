"""Frozen copy for the benchmark's plain reference: Counter-based TEA random numbers (port of royaltracer_dx_tpu/utils/rng.py).

Bit-exact with the JAX package's ``tea_random`` / ``tea_batch`` /
``tea_batch_major`` / ``tea_batch_at`` / ``pixel_seed`` (rng.py:42-163).
PyTorch has no uint32 shifts on the CPU (``lshift_cpu`` is not implemented
for UInt32), so a seed here is an int64 tensor [..., 2] holding uint32
values, and every step of the hash is masked with ``& 0xFFFFFFFF`` — the
same arithmetic on both devices.
"""

from __future__ import annotations

import torch

_M = 0xFFFFFFFF
_DELTA = 0x9E3779B9
_K0 = 0xA341316C
_K1 = 0xC8013EA4
_K2 = 0xAD90777D
_K3 = 0x7E95761E

_PRIME1_X = 73856093
_PRIME2_X = 19349663
_PRIME3_X = 83492791
_PRIME1_Y = 37623481
_PRIME2_Y = 51964263
_PRIME3_Y = 68250729
_PRIME_TIME_X = 293803
_PRIME_TIME_Y = 423977

_CTR_X = 0x9E3779B9
_CTR_Y = 0x85EBCA6B


def _rounds(v0: torch.Tensor, v1: torch.Tensor):
    """The 4 TEA rounds (Common_v6.hlsl:119-138) on masked int64 values."""
    s = 0
    for _ in range(4):
        s = (s + _DELTA) & _M
        v0 = (v0 + ((((v1 << 4) & _M) + _K0) ^ ((v1 + s) & _M)
                    ^ ((v1 >> 5) + _K1))) & _M
        v1 = (v1 + ((((v0 << 4) & _M) + _K2) ^ ((v0 + s) & _M)
                    ^ ((v0 >> 5) + _K3))) & _M
    return v0, v1


def _to_unit(v0: torch.Tensor) -> torch.Tensor:
    # float(v0) / 2^32, rounded to nearest like the uint32 -> f32 convert;
    # can round to exactly 1.0 (rng.py:50-51)
    return v0.to(torch.float32) / 4294967296.0


def tea_random(seed: torch.Tensor):
    """One draw (rng.py:42-62).  seed: int64 [..., 2]; returns (u, seed)."""
    v0, v1 = _rounds(seed[..., 0], seed[..., 1])
    return _to_unit(v0), torch.stack([v0, v1], dim=-1)


def tea_batch(seed: torch.Tensor, n: int):
    """``n`` counter-mode draws, draw index minor: (u [..., n], seed)
    (rng.py:79-100)."""
    i = torch.arange(n, dtype=torch.int64, device=seed.device)
    v0 = (seed[..., 0:1] + i * _CTR_X) & _M
    v1 = seed[..., 1:2] ^ ((i * _CTR_Y) & _M)
    v0, _ = _rounds(v0, v1)
    _, new_seed = tea_random(seed)
    return _to_unit(v0), new_seed


def tea_batch_major(seed: torch.Tensor, n: int):
    """``tea_batch`` with the draw index MAJOR: (u [n, ...], seed)
    (rng.py:103-122)."""
    shape = (n,) + (1,) * seed[..., 0].dim()
    i = torch.arange(n, dtype=torch.int64, device=seed.device).reshape(shape)
    v0 = (seed[..., 0][None] + i * _CTR_X) & _M
    v1 = seed[..., 1][None] ^ ((i * _CTR_Y) & _M)
    v0, _ = _rounds(v0, v1)
    _, new_seed = tea_random(seed)
    return _to_unit(v0), new_seed


def tea_batch_at(seed: torch.Tensor, i: int) -> torch.Tensor:
    """Draw #``i`` of ``tea_batch(seed, n)`` as one plane; does not advance
    the seed (rng.py:125-143)."""
    v0 = (seed[..., 0] + (i * _CTR_X & _M)) & _M
    v1 = seed[..., 1] ^ ((i * _CTR_Y) & _M)
    v0, _ = _rounds(v0, v1)
    return _to_unit(v0)


def pixel_seed(x: torch.Tensor, y: torch.Tensor, stream: int,
               time: int) -> torch.Tensor:
    """Per-pixel seed (rng.py:146-163, RayGen_v6_pass1.hlsl:76-77).
    Returns int64 [..., 2] holding uint32 values."""
    x = x.to(torch.int64) & _M
    y = y.to(torch.int64) & _M
    st = int(stream) & _M
    tm = int(time) & _M
    sx = ((y * _PRIME1_X) & _M) ^ ((x * _PRIME2_X) & _M) \
        ^ ((st * _PRIME3_X) & _M) ^ ((tm * _PRIME_TIME_X) & _M)
    sy = ((x * _PRIME1_Y) & _M) ^ ((y * _PRIME2_Y) & _M) \
        ^ ((st * _PRIME3_Y) & _M) ^ ((tm * _PRIME_TIME_Y) & _M)
    sx, sy = torch.broadcast_tensors(sx, sy)
    return torch.stack([sx, sy], dim=-1)


