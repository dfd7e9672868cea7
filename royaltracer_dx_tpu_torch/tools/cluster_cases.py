"""Adversarial inputs for the cluster kernels (ops/cluster_traverse.py),
made from a seed with numpy: the card tests and ``chip_smoke.py`` hold
``cluster_mask`` (phase A, ``mask_case``) and ``cluster_closest`` /
``cluster_any`` (phase B, ``pack_case``) against their plain versions on
each, bit for bit, and the CPU tests hold the plain versions' premises
on them.
"""

from __future__ import annotations

import numpy as np
import torch

from royaltracer_dx_tpu_torch.ops import cluster_traverse as ct
from royaltracer_dx_tpu_torch.ops.traverse import pack_rays
from royaltracer_dx_tpu_torch.scene.procedural import menger_sponge


def pack_widths(tile: int) -> list[int]:
    """Live rays a tile in ``pack_case``: 0, 1, a warp and one either side
    of it, and all but one and all of the tile."""
    return sorted({min(w, tile) for w in (0, 1, 31, 32, 33, tile - 1,
                                          tile)})


def pack_kinds(tile: int) -> list[tuple[str, int]]:
    """``pack_case``'s tile kinds in order: (kind, live rays)."""
    return ([("live", w) for w in pack_widths(tile)]
            + [("all_hit", tile), ("far_dead", min(33, tile)),
               ("nan_dead", min(64, tile - 1)), ("dead_overlap", 0),
               ("dead_touch", 0)])


def pack_case(device, tile: int = 128, group: int = 128, level: int = 2,
              reps: int = 8, seed: int = 11):
    """Adversarial phase B tiles on a menger sponge whose triangles all
    stand twice (exact-t ties within and across clusters).  ``reps``
    tiles of each of ``pack_kinds(tile)``, in turn:

      live w        w live rays at random places of the tile, the rest dead
                    (t_max -1); a third of the live rays end at t = 1.5
      all_hit       every ray live and aimed at one of the sponge's solid
                    corner cubes: every ray is occluded, so any hit stops
                    before the list ends
      far_dead      33 live rays ending at t = 3, the rest dead with
                    t_min 2e4 > t_max 1e4: their t_max decides the bound
      nan_dead      64 live rays, one dead ray with a NaN t_max (the tile
                    retires at once), the rest dead
      dead_overlap  no live ray: half with t_min = t_max = 2.5 (they
                    overlap boxes, so the tile has clusters), half with
                    t_min 2e4 > t_max 1e4 (the tile walks its whole list)
      dead_touch    no live ray, all t_min = t_max = 2.5 (no step)

    A quarter of the rays run along an axis (ties on coplanar faces and
    shared edges), the rest from a sphere around the sponge into it.
    Returns (rows [tiles * tile, 8], clusters, kinds [tiles])."""
    rng = np.random.default_rng(seed)
    v, idx = menger_sponge(level)
    tris = v[idx].astype(np.float32)
    cl = ct.build_clusters(torch.as_tensor(np.concatenate([tris, tris]),
                                           device=device), group)
    kinds = [k for k in pack_kinds(tile) for _ in range(reps)]
    n = len(kinds) * tile
    o = rng.normal(size=(n, 3)).astype(np.float32)
    o_sphere = o = o / np.linalg.norm(o, axis=1, keepdims=True) * 2.5 + 0.5
    d = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32) - o
    axis = rng.integers(0, 3, n)
    along = rng.random(n) < 0.25
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)
    ao = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    ao[np.arange(n), axis] = 0.5 - 2.0 * sign
    ad = np.zeros((n, 3), np.float32)
    ad[np.arange(n), axis] = sign
    o = np.where(along[:, None], ao, o)
    d = np.where(along[:, None], ad, d)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, -1.0, np.float32)
    for j, (kind, w) in enumerate(kinds):
        lo = j * tile
        live = lo + rng.permutation(tile)[:w]
        t_max[live] = np.where(np.arange(w) % 3 == 2, 1.5, 1e4)
        if kind == "all_hit":
            corner = rng.integers(0, 2, (tile, 3)) * (16.0 / 18) + 1.0 / 18
            aim = corner + rng.uniform(-0.04, 0.04, (tile, 3))
            o[lo:lo + tile] = o_sphere[lo:lo + tile]
            d[lo:lo + tile] = aim - o_sphere[lo:lo + tile]
            d[lo:lo + tile] /= np.linalg.norm(d[lo:lo + tile], axis=1,
                                              keepdims=True)
            t_max[lo:lo + tile] = 1e4
        elif kind == "far_dead":
            t_max[live] = 3.0
            dead = np.setdiff1d(np.arange(lo, lo + tile), live)
            t_min[dead], t_max[dead] = 2e4, 1e4
        elif kind == "nan_dead":
            dead = np.setdiff1d(np.arange(lo, lo + tile), live)
            t_max[dead[0]] = np.nan
        elif kind == "dead_overlap":
            t_min[lo:lo + tile:2] = t_max[lo:lo + tile:2] = 2.5
            t_min[lo + 1:lo + tile:2], t_max[lo + 1:lo + tile:2] = 2e4, 1e4
        elif kind == "dead_touch":
            t_min[lo:lo + tile] = t_max[lo:lo + tile] = 2.5
    rows = ct.prepare_rays(*(torch.as_tensor(a, device=device)
                             for a in (o, d, t_min, t_max)), tile)
    return rows, cl, [k for k, _ in kinds]


def mask_boxes(c: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """``c`` boxes in [-1.1, 2.1]^3; from the second on (c > 8) seven odd
    ones: a NaN corner, an infinite side, all space, an inverted axis, a
    point, a box reaching +-3e38 and a flat one."""
    ctr = rng.uniform(-0.5, 1.5, (c, 3))
    half = rng.uniform(0.02, 0.6, (c, 3))
    lo, hi = (ctr - half).astype(np.float32), (ctr + half).astype(np.float32)
    if c > 8:
        lo[1, 0] = np.nan
        hi[2, 1] = np.inf
        lo[3], hi[3] = -np.inf, np.inf
        lo[4, 2], hi[4, 2] = hi[4, 2], lo[4, 2]
        hi[5] = lo[5]
        lo[6], hi[6] = -3e38, 3e38
        hi[7, 0] = lo[7, 0]
    return lo, hi


# live ray kinds of mask_case (drawn with these weights) and dead ones
_LIVE_KINDS = ("plain", "plain", "plain", "equal_bounds", "inside_neg0",
               "inside_pos0", "zero_dir", "on_face", "overflow", "nonfinite",
               "inf_bounds")
_DEAD_KINDS = ("t_max_neg", "nan_t_min", "nan_t_max", "inf_t_min",
               "neg_inf_t_max", "reversed", "padding", "nonfinite")


def mask_case(device, tile: int = 128, c: int = 38, reps: int = 1,
              seed: int = 13):
    """Adversarial phase A tiles against ``c`` boxes of ``mask_boxes`` (the
    clusters hold one zero triangle each: only their boxes matter).  Tile
    k of the first tile + 1 holds k live rays (t_min <= t_max) at random
    places, then ceil(18 / tile) tiles of live rays with a non-finite
    origin or direction component (every one of NaN, +inf and -inf in
    every component) and one of rays with t_min == t_max inside a box.  The live
    rays are of the kinds ``_LIVE_KINDS``: plain rays; equal bounds whose
    point lies in a box; origins in a box with t_min -0.0 (entries -0.0)
    or +0.0; direction components +-0.0 and 1e-13 (inv 3e38); origins on
    a box face, running along it; origins at +-3e38 (lo - o overflows);
    a NaN or +-inf origin or direction component; t_min -inf, t_max +inf
    or both bounds +inf.  The dead ones (``_DEAD_KINDS``): t_max -1, a NaN
    bound, t_min +inf, t_max -inf, t_min > t_max, padding rows, and dead
    rays with a non-finite component.  All of it ``reps`` times over (a
    batch beyond one wave of CTAs).  Returns (rows [tiles * tile, 8],
    clusters, live [tiles] the live rays of each tile)."""
    rng = np.random.default_rng(seed)
    lo, hi = mask_boxes(c, rng)
    with np.errstate(over="ignore", invalid="ignore"):
        ok = np.flatnonzero((hi - lo > 0.01).all(1) & (hi - lo < 2.0).all(1))
    n_nonfinite = -(-18 // tile)
    counts = list(range(tile + 1)) + [tile] * (n_nonfinite + 1)
    n = len(counts) * tile
    o = rng.uniform(-1.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, 1e4, np.float32)
    kind = np.empty(n, object)
    want = np.zeros(n, bool)
    for j, k in enumerate(counts):
        at = j * tile + rng.permutation(tile)
        want[at[:k]] = True
        kind[at[:k]] = rng.choice(_LIVE_KINDS, k)
        kind[at[k:]] = rng.choice(_DEAD_KINDS, tile - k)
    kind[(tile + 1) * tile:(tile + 1 + n_nonfinite) * tile] = "nonfinite"
    kind[(tile + 1 + n_nonfinite) * tile:] = "equal_bounds"
    want[(tile + 1) * tile:] = True
    axis = rng.integers(0, 3, n)
    box = ok[rng.integers(0, len(ok), n)]
    inside = (lo[box] + (hi[box] - lo[box])
              * rng.uniform(0.05, 0.95, (n, 3))).astype(np.float32)
    sign0 = np.where(rng.random(n) < 0.5, 0.0, -0.0).astype(np.float32)
    rows_n = np.arange(n)

    def pick(k):
        return kind == k

    i = pick("equal_bounds")
    t = rng.uniform(0.0, 2.0, n).astype(np.float32)
    o[i] = inside[i] - d[i] * t[i, None]
    t_min[i] = t_max[i] = t[i]
    for k, t0 in (("inside_neg0", -0.0), ("inside_pos0", 0.0)):
        i = pick(k)
        o[i] = inside[i]
        t_min[i] = t0
    i = pick("zero_dir")
    d[rows_n[i], axis[i]] = sign0[i]
    d[rows_n[i], (axis[i] + 1) % 3] = rng.choice(
        np.array([1e-13, -1e-13, -0.0], np.float32), int(i.sum()))
    i = pick("on_face")
    o[i] = inside[i]
    face = np.where(rng.random(n) < 0.5, lo[box, axis], hi[box, axis])
    o[rows_n[i], axis[i]] = face[i]
    d[rows_n[i], axis[i]] = sign0[i]
    i = pick("overflow")
    o[rows_n[i], axis[i]] = np.where(rng.random(int(i.sum())) < 0.5, 3e38,
                                     -3e38)
    i = pick("nonfinite")
    comp, special = np.zeros(n, np.int64), np.zeros(n, np.float32)
    at = np.arange(int(i.sum()))
    comp[i] = at % 6
    special[i] = np.array([np.nan, np.inf, -np.inf], np.float32)[at // 6 % 3]
    for c3, arr in ((0, o), (3, d)):
        j = i & (comp >= c3) & (comp < c3 + 3)
        arr[rows_n[j], comp[j] - c3] = special[j]
    j = i & ~want
    t_min[j] = np.where(rows_n[j] % 2 == 1, np.nan, 2.0)
    t_max[j] = 1.0
    i = pick("inf_bounds")
    bounds = np.array([(-np.inf, 1e4), (1e-4, np.inf), (-np.inf, np.inf),
                       (np.inf, np.inf)], np.float32)[rng.integers(0, 4, n)]
    t_min[i], t_max[i] = bounds[i, 0], bounds[i, 1]
    t_max[pick("t_max_neg")] = -1.0
    t_min[pick("nan_t_min")] = np.nan
    t_max[pick("nan_t_max")] = np.nan
    t_min[pick("inf_t_min")] = np.inf
    t_max[pick("neg_inf_t_max")] = -np.inf
    i = pick("reversed")
    t_min[i], t_max[i] = 2.0, 1.0
    i = pick("padding")
    o[i], d[i], t_min[i], t_max[i] = 0.0, 1.0, 0.0, -1.0
    live = np.tile((t_min <= t_max).reshape(-1, tile).sum(1), reps)
    dev = torch.device(device)
    cl = ct.Clusters(
        tri_planes=torch.zeros((c, 9, 1), dtype=torch.float32, device=dev),
        tri_index=torch.zeros((c, 1), dtype=torch.int32, device=dev),
        aabb_lo=torch.as_tensor(lo, device=dev),
        aabb_hi=torch.as_tensor(hi, device=dev))
    rows = pack_rays(*(torch.as_tensor(x, device=dev)
                       for x in (o, d, t_min, t_max)))
    return rows.repeat(reps, 1), cl, live
