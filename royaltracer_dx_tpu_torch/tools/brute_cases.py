"""Adversarial inputs for the brute-force kernels (ops/brute_trace.py),
made from a seed with numpy: the card tests and ``chip_smoke.py`` hold
``brute_closest`` / ``brute_any`` against their plain versions on each,
bit for bit.

    odd_count      1,100 triangles (not a multiple of the kernels' 512-
                   triangle tile or of the plain version's chunk)
    one_tri        T = 1
    no_tris        T = 0: every ray misses
    bounds         NaN t_min lanes (a missed megakernel lane's shadow
                   ray), masked (t_max < t_min), equal, infinite bounds
    twins          a soup whose triangles stand three times, once
                   reversed: exact-t ties go to the lowest index
    grid_vertices  the 70 x 70 grid (9,800 triangles), rays aimed at its
                   vertices and edge midpoints, where u, v or u + v - 1 is
                   zero or within rounding of it and neighbours tie
    non_finite     NaN, +-inf and huge origins and directions
    beyond_inf     triangles 1.1e30 along x hit by axis rays with t_max =
                   inf at t > INF = 1e30 (closest: a miss; any hit: not
                   occluded, as the plain version's t < INF test says)
    signed_zero    triangles in the plane z = 0, then each again reversed;
                   t_min = -2.  Half of the rays start on the plane inside
                   a triangle, so the twins give t = +0.0 and -0.0 (equal:
                   the lower index wins, with its own zero); the other
                   half start 0.5 off the plane and head away from it, so
                   their hits have negative t (the most negative wins)
    huge_det       directions of length 1e38 and 3e38 (t_min = -1), so
                   that |det| is at or beyond 2^126 on pairs that hit (1 /
                   det rounds into the subnormals) or det overflows to inf
                   (1 / det = 0: the plain version hits at t = 0)

By default every case has N = 10,001 rays (not a multiple of the 256-ray
CTA).
"""

from __future__ import annotations

import numpy as np
import torch

BRUTE_CASES = ("odd_count", "one_tri", "no_tris", "bounds", "twins",
               "grid_vertices", "non_finite", "beyond_inf", "signed_zero",
               "huge_det")
N_RAYS = 10001


def grid_tris(m: int, seed: int = 0) -> np.ndarray:
    """An m x m grid over [-1, 1]^2 with seeded heights (2 m^2 triangles,
    [T, 3, 3] float32): neighbouring triangles share edges and vertices."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-1, 1, m + 1, dtype=np.float32)
    x, y = np.meshgrid(xs, xs, indexing="ij")
    z = (0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    p = np.stack([x, y, z], -1)
    a, b, c, d = p[:-1, :-1], p[1:, :-1], p[1:, 1:], p[:-1, 1:]
    tris = np.concatenate([np.stack([a, b, c], -2).reshape(-1, 3, 3),
                           np.stack([a, c, d], -2).reshape(-1, 3, 3)])
    return tris.astype(np.float32)


def _soup(rng, n):
    base = rng.uniform(-1, 1, (n, 1, 3))
    return (base + rng.uniform(-0.15, 0.15, (n, 3, 3))).astype(np.float32)


def _rays(rng, tris, n):
    """Random rays, a third of them aimed at a triangle's centroid."""
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if len(tris):
        aim = rng.random(n) < 1 / 3
        pick = rng.integers(0, len(tris), n)
        d = np.where(aim[:, None], tris[pick].mean(axis=1) - o, d)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-30)
    return o, d.astype(np.float32)


def brute_case(name: str, device, seed: int = 29, n: int = N_RAYS):
    """(tri_verts [T, 3, 3], origins [N, 3], dirs [N, 3], t_min [N],
    t_max [N]) of case ``name`` with ``n`` rays as float32 tensors on
    ``device``."""
    rng = np.random.default_rng(seed)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, 1e4, np.float32)
    if name == "odd_count":
        tris = _soup(rng, 1100)
        o, d = _rays(rng, tris, n)
        t_max[::3] = -1.0
    elif name == "one_tri":
        tris = _soup(rng, 1)
        o, d = _rays(rng, tris, n)
    elif name == "no_tris":
        tris = np.zeros((0, 3, 3), np.float32)
        o, d = _rays(rng, _soup(rng, 10), n)
    elif name == "bounds":
        tris = _soup(rng, 400)
        o, d = _rays(rng, tris, n)
        k = np.arange(n) % 6
        t_min = np.where(k == 0, np.nan, t_min).astype(np.float32)
        t_max = np.where(k == 1, -1.0, t_max).astype(np.float32)
        t_max = np.where(k == 2, np.inf, t_max).astype(np.float32)
        t_max = np.where(k == 3, t_min, t_max).astype(np.float32)
        t_min = np.where(k == 4, -np.inf, t_min).astype(np.float32)
        t_max = np.where(k == 5, np.nan, t_max).astype(np.float32)
    elif name == "twins":
        soup = _soup(rng, 300)
        tris = np.concatenate([soup, soup[:, ::-1], soup])
        o, d = _rays(rng, soup, n)
    elif name == "grid_vertices":
        m = 70
        tris = grid_tris(m)
        k = rng.integers(0, len(tris), n)
        a = rng.integers(0, 3, n)
        b = (a + 1 + rng.integers(0, 2, n)) % 3
        mid = rng.random(n) < 0.5                   # edge midpoints
        target = np.where(mid[:, None], 0.5 * (tris[k, a] + tris[k, b]),
                          tris[k, a])
        o = np.concatenate([rng.uniform(-1.2, 1.2, (n, 2)),
                            rng.uniform(0.5, 2.0, (n, 1))], 1)
        d = target - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = o.astype(np.float32), d.astype(np.float32)
    elif name == "non_finite":
        tris = _soup(rng, 300)
        o, d = _rays(rng, tris, n)
        bad = np.array([np.nan, np.inf, -np.inf, 3e38, -3e38, 0.0],
                       np.float32)
        k = np.arange(n)
        o[k % 7 == 0, k[k % 7 == 0] % 3] = bad[k[k % 7 == 0] % 6]
        d[k % 5 == 0, k[k % 5 == 0] % 3] = bad[k[k % 5 == 0] % 6]
    elif name == "beyond_inf":
        def at(x):
            return [[x, -5e3, -5e3], [x, 5e3, -5e3], [x, 0.0, 5e3]]

        near = [[0.5, -0.2, -0.2], [0.5, 0.2, -0.2], [0.5, 0.0, 0.3]]
        tris = np.array([at(1.1e30), near, at(-1.1e30)], np.float32)
        o = np.zeros((n, 3), np.float32)
        o[:, 1:] = rng.uniform(-0.4, 0.4, (n, 2))
        d = np.zeros((n, 3), np.float32)
        d[:, 0] = np.where(np.arange(n) % 5 == 0, -1.0, 1.0)
        t_max = np.where(np.arange(n) % 2 == 0, np.inf, 1e4).astype(
            np.float32)
    elif name == "signed_zero":
        flat = _soup(rng, 200)
        flat[:, :, 2] = 0.0
        tris = np.concatenate([flat, flat[:, ::-1]])
        w = rng.dirichlet((1.0, 1.0, 1.0), n).astype(np.float32)
        o = np.einsum("nk,nkc->nc", w, flat[rng.integers(0, len(flat), n)])
        off = np.arange(n) % 2 == 1
        o[:, 2] = np.where(off, 0.5, 0.0)
        d = rng.normal(size=(n, 3))
        d[:, 2] = np.abs(d[:, 2]) + 0.2
        d[off, :2] *= 0.2
        d[~off, 2] *= np.where(rng.random(n) < 0.5, -1.0, 1.0)[~off]
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        o = o.astype(np.float32)
        t_min = np.full(n, -2.0, np.float32)
    elif name == "huge_det":
        tris = _soup(rng, 300) * np.float32(4.0)
        o, d = _rays(rng, tris, n)
        length = np.where(np.arange(n) % 4 == 0, 3e38, 1e38)
        d = (d * length[:, None]).astype(np.float32)
        t_min = np.full(n, -1.0, np.float32)
    else:
        raise ValueError(f"unknown brute case {name!r}")

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    return t(tris), t(o), t(d), t(t_min), t(t_max)
