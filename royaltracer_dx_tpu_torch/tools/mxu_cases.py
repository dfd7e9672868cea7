"""Adversarial inputs for the matmul-form kernels (ops/mxu_trace.py), made
from a seed with numpy: the card tests and ``chip_smoke.py`` hold
``mxu_closest`` / ``mxu_any`` against their plain versions on each, bit
for bit.

    zero_area    5 zero-area triangles: nothing hits
    duplicates   a soup whose triangles all stand twice, once reversed:
                 exact-t ties go to the lower index
    all_miss     rays that leave the soup: tri 0 and triangle 0's u, v
    non_finite   NaN, +-inf and huge origins and directions, zero
                 directions
    one_tri      T = 1
    t200         T = 200, not a multiple of the 128-column padding
    bounds       masked (t_max < t_min), equal, NaN and infinite bounds
    edges        a fan of triangles that share edges, beside a soup; rays
                 aimed exactly at vertices and edge midpoints, where u, v
                 or u + v - 1 is zero or within rounding of it
    tiny         triangles about 1e-20 across (their normals and the
                 products of det underflow into subnormals) beside a
                 soup, rays aimed at both
    far          a soup at an offset of 1e6 (re-centred by the build), and
                 rays that start within 1e-2 of a triangle, where t -> 0
                 and o.n - v0.n cancels

Every case has N = 1,001 rays (not a multiple of the kernels' 128-ray
CTA); a third of the rays of the first soups aim at a triangle's
centroid.
"""

from __future__ import annotations

import numpy as np
import torch

MXU_CASES = ("zero_area", "duplicates", "all_miss", "non_finite", "one_tri",
             "t200", "bounds", "edges", "tiny", "far")
N_RAYS = 1001


def _soup(rng, n):
    base = rng.uniform(-1, 1, (n, 1, 3))
    return (base + rng.uniform(-0.15, 0.15, (n, 3, 3))).astype(np.float32)


def _rays(rng, tris, n):
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    aim = rng.random(n) < 1 / 3
    pick = rng.integers(0, len(tris), n)
    d = np.where(aim[:, None], tris[pick].mean(axis=1) - o, d)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    return o, d.astype(np.float32)


def mxu_case(name: str, device, seed: int = 13):
    """(tri_verts [T, 3, 3], origins [N, 3], dirs [N, 3], t_min [N],
    t_max [N]) of case ``name`` as float32 tensors on ``device``."""
    rng = np.random.default_rng(seed)
    n = N_RAYS
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, 1e4, np.float32)
    if name == "zero_area":
        tris = np.zeros((5, 3, 3), np.float32)
        tris[1:] = rng.uniform(-1, 1, (4, 1, 3))      # points, not triangles
        o, d = _rays(rng, _soup(rng, 4), n)
    elif name == "duplicates":
        soup = _soup(rng, 150)
        tris = np.concatenate([soup, soup[:, ::-1], soup])
        o, d = _rays(rng, soup, n)
    elif name == "all_miss":
        tris = _soup(rng, 300)
        o, d = _rays(rng, tris, n)
        o = o / np.linalg.norm(o, axis=1, keepdims=True) * 5.0
        d = o / np.linalg.norm(o, axis=1, keepdims=True)
    elif name == "non_finite":
        tris = _soup(rng, 300)
        o, d = _rays(rng, tris, n)
        bad = np.array([np.nan, np.inf, -np.inf, 3e38, -3e38, 0.0],
                       np.float32)
        k = np.arange(n)
        o[k % 4 == 1, k[k % 4 == 1] % 3] = bad[k[k % 4 == 1] % 6]
        d[k % 4 == 2] = bad[k[k % 4 == 2] % 6][:, None]
        d[k % 4 == 3, k[k % 4 == 3] % 3] = bad[k[k % 4 == 3] % 6]
    elif name == "one_tri":
        tris = _soup(rng, 1)
        o, d = _rays(rng, tris, n)
    elif name == "t200":
        tris = _soup(rng, 200)
        o, d = _rays(rng, tris, n)
    elif name == "bounds":
        tris = _soup(rng, 300)
        o, d = _rays(rng, tris, n)
        k = np.arange(n) % 6
        t_max = np.choose(k, [t_max, np.full(n, -1.0), t_min,
                              np.full(n, np.nan), np.full(n, np.inf),
                              np.full(n, 1.5)]).astype(np.float32)
        t_min = np.where(k == 5, np.float32(np.nan), t_min)
    elif name == "edges":
        m = 24
        ang = np.linspace(0.0, 2.0 * np.pi, m, endpoint=False)
        ring = np.stack([np.cos(ang), np.sin(ang),
                         0.1 * rng.normal(size=m)], axis=1) * 0.8
        fan = np.stack([np.broadcast_to([0.0, 0.0, 0.05], (m, 3)), ring,
                        np.roll(ring, -1, axis=0)], axis=1)
        tris = np.concatenate([fan, _soup(rng, 200)]).astype(np.float32)
        mids = 0.5 * (tris + np.roll(tris, -1, axis=1))
        points = np.concatenate([tris.reshape(-1, 3),
                                 mids.reshape(-1, 3)]).astype(np.float32)
        o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        d = points[rng.integers(0, len(points), n)] - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    elif name == "tiny":
        small = (rng.uniform(-1, 1, (200, 1, 3)) * 1e-14
                 + rng.uniform(-1, 1, (200, 3, 3)) * 1e-20)
        big = _soup(rng, 100)
        tris = np.concatenate([small, big]).astype(np.float32)
        o, d = _rays(rng, big, n)
        aim = rng.random(n) < 0.5
        d = np.where(aim[:, None], -o, d)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    elif name == "far":
        tris = (_soup(rng, 300).astype(np.float64) * 100.0
                + 1e6).astype(np.float32)
        o, d = _rays(rng, tris, n)
        o = (o.astype(np.float64) * 100.0 + 1e6).astype(np.float32)
        # a third start 1e-5 to 1e-2 before a point inside a triangle
        near = np.arange(n) % 3 == 0
        pick = rng.integers(0, len(tris), n)
        w = rng.dirichlet(np.ones(3), n)
        p = np.einsum("nk,nkc->nc", w, tris[pick].astype(np.float64))
        dn = rng.normal(size=(n, 3))
        dn /= np.linalg.norm(dn, axis=1, keepdims=True)
        t0 = 10.0 ** rng.uniform(-5, -2, n)
        o = np.where(near[:, None], (p - t0[:, None] * dn), o)
        d = np.where(near[:, None], dn, d).astype(np.float32)
        o = o.astype(np.float32)
    else:
        raise ValueError(f"unknown mxu case {name!r}")

    def tensor(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=device)

    return tuple(tensor(x) for x in (tris, o, d, t_min, t_max))
