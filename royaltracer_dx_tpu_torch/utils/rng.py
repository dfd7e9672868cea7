"""Counter-based TEA random numbers (port of royaltracer_dx_tpu/utils/rng.py).

Bit-exact with the JAX package's ``tea_random`` / ``tea_batch`` /
``tea_batch_major`` / ``tea_batch_at`` / ``pixel_seed`` (rng.py:42-163).
PyTorch has no uint32 shifts on the CPU (``lshift_cpu`` is not implemented
for UInt32), so a seed here is an int64 tensor [..., 2] holding uint32
values, and every step of the hash is masked with ``& 0xFFFFFFFF`` — the
same arithmetic on both devices.

For CUDA tensors the four ``_rounds``-based entry points launch one
hand-written kernel a call (``csrc/tea_rng.cu`` ``tea_draws``, built at
first use by ``utils.cuda_build.build_library``): it reads the low 32 bits
of each seed word, runs the same rounds in uint32 and writes the draws
and, for ``tea_random`` and the batches, the advanced seed in the same
launch, bit for bit with the plain form.  CPU tensors take the plain form
below, which the kernel is held against; a CUDA tensor never does
(``_draws`` launches or raises).  ``pixel_seed`` stays tensor code on
every device.
"""

from __future__ import annotations

import ctypes
import os

import torch

from royaltracer_dx_tpu_torch.utils.cuda_build import build_library

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

# one launch count, bumped only where the kernel is launched
LAUNCHES = {"tea": 0}
_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "tea_rng.cu")
_LIB = None
BUILD_INFO: dict = {}
# the C interface of csrc/tea_rng.cu: seed, lanes, n, base, lane stride,
# draw stride, out, new seed (or null), stream
_SIGNATURES = {"tea_draws": [ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                             ctypes.c_uint, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_void_p]}


def build_kernels():
    """Build csrc/tea_rng.cu (nvcc for sm_90a, the package's flags) and
    load it.  Called at the first launch; idempotent."""
    global _LIB
    if _LIB is None:
        lib, info = build_library(_SRC, signatures=_SIGNATURES)
        BUILD_INFO.update(info)
        _LIB = lib
    return _LIB


def _takes_kernel(seed: torch.Tensor) -> bool:
    """Whether ``seed``'s draws launch the kernel: CUDA tensors do, CPU
    tensors run the plain form."""
    return seed.is_cuda


def _draws(seed: torch.Tensor, n: int, base: int, shape, major=False,
           advance=False):
    """One ``tea_draws`` launch on PyTorch's current stream: draws at
    counters ``base`` .. ``base + n - 1`` (mod 2^32) of every lane of
    ``seed`` (int64 [..., 2]) into a float32 tensor of ``shape``, draw
    index minor ([..., n]) or ``major`` ([n, ...]), and with ``advance``
    (``base`` 0) the advanced seed, the counter-0 draw's words.  Returns
    (u, new seed or None)."""
    if seed.dtype != torch.int64 or seed.shape[-1:] != (2,):
        raise ValueError(f"TEA seed {seed.dtype} {tuple(seed.shape)}: "
                         "expected int64 [..., 2]")
    if not seed.is_contiguous() or seed.data_ptr() % 16:
        seed = seed.clone(memory_format=torch.contiguous_format)
    lanes = seed.numel() // 2
    if lanes * n >= 2**31:
        raise ValueError(f"TEA draws: {lanes} lanes x {n} draws exceed the "
                         "int32 count of the kernel")
    dev = seed.device
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if advance and n == 0:          # no draws, but the seed still advances
        return out, tea_random(seed)[1]
    new = torch.empty_like(seed) if advance else None
    if lanes == 0:
        return out, new
    lib = _LIB or build_kernels()
    with torch.cuda.device(dev):
        err = lib.tea_draws(seed.data_ptr(), lanes, n, base & _M,
                            *((1, lanes) if major else (n, 1)),
                            out.data_ptr(),
                            None if new is None else new.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tea_draws: CUDA error {err} at launch")
    LAUNCHES["tea"] += 1
    return out, new


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
    if _takes_kernel(seed):
        return _draws(seed, 1, 0, seed.shape[:-1], advance=True)
    v0, v1 = _rounds(seed[..., 0], seed[..., 1])
    return _to_unit(v0), torch.stack([v0, v1], dim=-1)


def tea_batch(seed: torch.Tensor, n: int):
    """``n`` counter-mode draws, draw index minor: (u [..., n], seed)
    (rng.py:79-100)."""
    if _takes_kernel(seed):
        return _draws(seed, n, 0, (*seed.shape[:-1], n), advance=True)
    i = torch.arange(n, dtype=torch.int64, device=seed.device)
    v0 = (seed[..., 0:1] + i * _CTR_X) & _M
    v1 = seed[..., 1:2] ^ ((i * _CTR_Y) & _M)
    v0, _ = _rounds(v0, v1)
    _, new_seed = tea_random(seed)
    return _to_unit(v0), new_seed


def tea_batch_major(seed: torch.Tensor, n: int):
    """``tea_batch`` with the draw index MAJOR: (u [n, ...], seed)
    (rng.py:103-122)."""
    if _takes_kernel(seed):
        return _draws(seed, n, 0, (n, *seed.shape[:-1]), major=True,
                      advance=True)
    shape = (n,) + (1,) * seed[..., 0].dim()
    i = torch.arange(n, dtype=torch.int64, device=seed.device).reshape(shape)
    v0 = (seed[..., 0][None] + i * _CTR_X) & _M
    v1 = seed[..., 1][None] ^ ((i * _CTR_Y) & _M)
    v0, _ = _rounds(v0, v1)
    _, new_seed = tea_random(seed)
    return _to_unit(v0), new_seed


def tea_batch_at(seed: torch.Tensor, i: int) -> torch.Tensor:
    """Draw #``i`` of ``tea_batch(seed, n)`` as one plane; does not advance
    the seed (rng.py:125-143).  The kernel takes ``i`` mod 2^32 and
    forms the counter words from it, as the plain form's masks do."""
    if _takes_kernel(seed):
        return _draws(seed, 1, i, seed.shape[:-1])[0]
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


def tea_randoms(seed: torch.Tensor, n: int):
    """``n`` sequential draws, the reference's order: (u [..., n], seed)
    (rng.py:65-71)."""
    us = []
    for _ in range(n):
        u, seed = tea_random(seed)
        us.append(u)
    return torch.stack(us, dim=-1), seed
