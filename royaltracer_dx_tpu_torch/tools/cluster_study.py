"""Study of the cluster traversal's kernels on rendered frames' own
batches, on one NVIDIA GPU.

    python -m royaltracer_dx_tpu_torch.tools.cluster_study \\
        [--baseline OLD.cu] [--set "MASK_STAGES=3"]... [--clock] \\
        [--phase ab] [--cut notest]... [--sass FILE] [--reps 3] \\
        [--out FILE.json]

It renders the menger scene at 1920x1080 under ``traversal="cluster"``:
one ReSTIR frame to warm up, then one more whose cluster_mask (11
batches, phase A) and cluster_closest / cluster_any launches (6 + 5,
phase B) are kept, and adds sponza's 2,073,600 primary rays (2,073
clusters of 128).  Per batch it prints the lanes, the share of live lanes
(phase A: t_min <= t_max; phase B: t_min < t_max), the bound and the
no-FMA floor (``cluster_traverse.cluster_work`` and
``stream_trace.bound_ms``); for phase B also the tiles that walk and the
steps of the longest tile, for phase A the time of the ``prepare_rays``
and ``worklists`` calls around the kernel.  It then times every build on
every batch, all in this one process and in the order baseline, package,
package, baseline:

  package   csrc/cluster_traverse.cu as the package builds it
  --set     a copy with named ``constexpr int`` constants given other
            values (MASK_STAGES, PB_THREADS, ZERO_CHUNK, ...)
  --clock   a copy with SM clock reads patched into phase B: its stats
            build writes thread 0's clocks per tile (waiting for a step's
            record and the barrier, testing, the bound's reduction, and
            the whole tile), printed per step of the walking tiles
  baseline  an earlier cluster_traverse.cu, written out with ``git show
            <commit>:royaltracer_dx_tpu_torch/csrc/cluster_traverse.cu >
            old.cu``: commit ddf14c4 (the first design of the mask beside
            this phase B; the same C interface) or cf38724 (the first
            design of all three, whose phase B interface has no tile
            order)

Every build's outputs are held bit for bit against the plain versions
(``_mask_plain``; ``_phase_b_plain`` with the per-tile stats, steps and
needed tests) on every batch; a difference ends the run with a non-zero
code.  ``--phase a`` or ``b`` keeps one phase's kernels; ``--sass`` writes
the package's phase A kernel as ``cuobjdump -sass`` prints it; ``--cut``
adds phase A builds with a part taken out, timed and not checked (their
tables are wrong): ``notest`` lists the live rays but tests none,
``nolist`` only stages the rows and writes the tables.

``pack_case`` makes the adversarial phase B tiles that the card tests
and ``chip_smoke.py`` hold the kernels to: every packing width of live
rays, dead rays whose t_max decides the bound, a NaN t_max, tiles
without a live ray that still overlap boxes, and exact-t ties within and
across clusters (every triangle twice).  ``mask_case`` makes their phase
A tiles: every live count, dead rays of every kind, rays with equal
bounds, on box faces, with zero, tiny, huge and non-finite components,
-0.0 entries, and non-finite boxes.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess

import numpy as np
import torch

from royaltracer_dx_tpu_torch.ops import cluster_traverse as ct
from royaltracer_dx_tpu_torch.ops import stream_trace as st
from royaltracer_dx_tpu_torch.utils.cuda_build import build_library, nvcc
from royaltracer_dx_tpu_torch.ops.traverse import pack_rays
from royaltracer_dx_tpu_torch.scene.procedural import menger_sponge
from royaltracer_dx_tpu_torch.tools.stream_study import cut_source, timed

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C interface of the first phase B design (a --baseline of commit
# cf38724): no order or counter
_OLD_SIGNATURES = {
    "cluster_mask": [_P] * 5 + [_I] * 3 + [_P],
    "cluster_closest": [_P] * 9 + [_I] * 4 + [_P],
    "cluster_any": [_P] * 6 + [_I] * 4 + [_P],
    "cluster_resources": [_I, _I, ctypes.POINTER(_I)],
}

# --cut: copies of the phase A kernel with a part taken out, timed only
# (their tables are wrong): "notest" lists the live rays and writes every
# tile's row as if none overlapped; "nolist" also lists none (the rows are
# staged and read, the rows written)
_MASK_CUTS = {
    "notest": [("      if (live == 0) {\n", "      if (true) {\n")],
    "nolist": [("      if (live == 0) {\n", "      if (true) {\n"),
               ("        if (b.z <= b.w) {\n          const float4 q",
                "        if (false) {\n          const float4 q")],
}

# --clock: thread 0's SM clocks per tile, packed two to an int64 stat
# (wait | bound, test | tile)
_CLOCK_START = ("long long c_tot = -clock64(), c_wait = 0, c_test = 0, "
                "c_bar = 0;\n")
_CLOCK = [
    ("""    const size_t row0 = t * tile;
    if (tid == 0) {
      s_live = 0;
      s_steps = cnt;
""", "    " + _CLOCK_START + """    const size_t row0 = t * tile;
    if (tid == 0) {
      s_live = 0;
      s_steps = cnt;
"""),
    ("        cp_async_wait<1>();\n        __syncthreads();\n",
     "        c_wait -= clock64();\n        cp_async_wait<1>();\n"
     "        __syncthreads();\n        c_wait += clock64();\n"),
    ("        float contrib = neg_inf();\n",
     "        c_test -= clock64();\n        float contrib = neg_inf();\n"),
    ("        contrib = warp_max_nan(contrib);\n",
     "        c_test += clock64();\n        c_bar -= clock64();\n"
     "        contrib = warp_max_nan(contrib);\n"),
    ("        went_k = went_n;\n",
     "        c_bar += clock64();\n        went_k = went_n;\n"),
    ("""      out_stats[2 * t] = k;
      out_stats[2 * t + 1] = (long long)k * live_n * g;
""", """      c_tot += clock64();
      out_stats[2 * t] = (c_wait << 32) | (c_bar & 0xffffffffLL);
      out_stats[2 * t + 1] = (c_test << 32) | (c_tot & 0xffffffffLL);
"""),
    ("""    if (tid == 0) {
      s_live = 0;
      s_next[0] = 0;
""", "    " + _CLOCK_START + """    if (tid == 0) {
      s_live = 0;
      s_next[0] = 0;
"""),
    ("      cp_async_wait<1>();\n      __syncthreads();\n",
     "      c_wait -= clock64();\n      cp_async_wait<1>();\n"
     "      __syncthreads();\n      c_wait += clock64();\n"),
    ("      for (int base = 0; base < walking; base += nt) {\n",
     "      c_test -= clock64();\n"
     "      for (int base = 0; base < walking; base += nt) {\n"),
    ("      __syncthreads();\n      walking = s_next[k & 1];\n",
     "      c_test += clock64();\n      c_bar -= clock64();\n"
     "      __syncthreads();\n      walking = s_next[k & 1];\n"
     "      c_bar += clock64();\n"),
    ("""        out_stats[2 * t] = k;
        out_stats[2 * t + 1] = (long long)s_sum;
""", """        c_tot += clock64();
        out_stats[2 * t] = (c_wait << 32) | (c_bar & 0xffffffffLL);
        out_stats[2 * t + 1] = (c_test << 32) | (c_tot & 0xffffffffLL);
"""),
]


def clock_line(stats, steps, mhz):
    """Thread 0's clocks of a --clock build per step of the walking tiles
    (waiting for the record, testing, the bound's reduction) and the rest
    per walking tile; the longest tile's whole time in us."""
    walk = steps > 0
    if not walk.any():
        return "clocks: no tile walks"
    s0, s1 = stats[walk, 0], stats[walk, 1]
    wait, bound = s0 >> 32, s0 & 0xffffffff
    test, tile = s1 >> 32, s1 & 0xffffffff
    n = int(steps[walk].sum())
    rest = (tile - wait - bound - test).float().mean()
    return (f"clocks a step: wait {int(wait.sum()) / n:.0f}, test "
            f"{int(test.sum()) / n:.0f}, bound {int(bound.sum()) / n:.0f}; "
            f"rest a tile {float(rest):.0f}; longest tile "
            f"{int(tile.max()) / mhz:.1f} us")


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


# ------------------------------ the study --------------------------------


def run(lib, old, name, rows, cl, wl, went, count, tile, stats):
    """One launch of ``name`` through ``lib`` (``old``: the first phase B
    design's C interface); returns its outputs and, with ``stats``, its
    [tiles, 2] stats."""
    dev = rows.device
    n_pad = rows.shape[0]
    tiles, c = n_pad // tile, cl.num_clusters
    if name == "cluster_mask":
        outs = (torch.empty((tiles, c), dtype=torch.bool, device=dev),
                torch.empty((tiles, c), dtype=torch.float32, device=dev))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.cluster_mask(rows.data_ptr(), cl.aabb_lo.data_ptr(),
                                   cl.aabb_hi.data_ptr(), outs[0].data_ptr(),
                                   outs[1].data_ptr(), tiles, tile, c, stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")
        return outs
    out_stats = (torch.empty((tiles, 2), dtype=torch.int64, device=dev)
                 if stats else None)
    sp = out_stats.data_ptr() if stats else None
    if name == "cluster_closest":
        outs = (torch.empty((n_pad, 3), dtype=torch.float32, device=dev),
                torch.empty((n_pad,), dtype=torch.int32, device=dev))
        head = [rows.data_ptr(), cl.tri_planes.data_ptr(),
                cl.tri_index.data_ptr(), wl.data_ptr(), went.data_ptr(),
                count.data_ptr()]
        tail = [outs[0].data_ptr(), outs[1].data_ptr(), sp]
    else:
        outs = (torch.empty((n_pad,), dtype=torch.int32, device=dev),)
        head = [rows.data_ptr(), cl.tri_planes.data_ptr(), wl.data_ptr(),
                count.data_ptr()]
        tail = [outs[0].data_ptr(), sp]
    sched = () if old else ct._schedule(count)  # alive until the launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(*head, *(p.data_ptr() for p in sched),
                                 *tail, tiles, tile, c, cl.group, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return outs + ((out_stats,) if stats else ())


def bits(x):
    """float32 as int32, so that -0.0 and NaN payloads count."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def frame_batches():
    """The cluster kernels' launches of one menger cluster ReSTIR frame
    (after a warm-up frame) and of sponza's primary batch: [dict(frame,
    name, rows, cl, wl, went, count, tile, prep)], ``prep`` the arguments
    of the ``prepare_rays`` call that made a mask batch's rows."""
    from royaltracer_dx_tpu_torch import cli
    from royaltracer_dx_tpu_torch.camera import generate_rays
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    scene, camera = menger_scene()
    r = RestirRenderer(scene, camera, RenderConfig(traversal="cluster"))
    r.render()
    batches = []
    names = ("prepare_rays", "cluster_mask", "cluster_closest", "cluster_any")
    real = {n: getattr(ct, n) for n in names}
    prep = []

    def keep(name):
        def call(*args, **kw):
            if name == "prepare_rays":
                prep.append(args)
                return real[name](*args, **kw)
            rows, cl, *rest = args
            b = dict(frame="menger", name=name, rows=rows, cl=cl,
                     tile=rest[-1], wl=None, went=None, count=None)
            if name == "cluster_mask":
                b["prep"] = prep[-1]
            elif name == "cluster_closest":
                b["wl"], b["went"], b["count"] = rest[:3]
            else:
                b["wl"], b["count"] = rest[:2]
            batches.append(b)
            return real[name](*args, **kw)
        return call

    for n in names:
        setattr(ct, n, keep(n))
    try:
        r.render()
    finally:
        for n, fn in real.items():
            setattr(ct, n, fn)
    torch.cuda.synchronize()
    del r
    dev = torch.device("cuda")
    scene, camera = cli.build_scene("sponza")
    sa = scene.flatten(scene.build_materials(device=dev),
                       build_clusters=True, device=dev)
    ca = {k: torch.as_tensor(x, device=dev)
          for k, x in camera.matrices(1920 / 1080).items()}
    o, d = generate_rays(ca, 1920, 1080)
    args = (o, d, 1e-4, 1e4, 128)
    rows = ct.prepare_rays(*args)
    wl, went, count = ct.tile_worklists(rows, sa.clusters, 128)
    for name in names[1:]:
        batches.append(dict(frame="sponza", name=name, rows=rows,
                            cl=sa.clusters, tile=128, prep=args, wl=wl,
                            went=went, count=count))
    return batches


def sass_of(path: str, fn: str) -> str:
    """``cuobjdump -sass`` of the kernels of a built library whose name
    holds ``fn``."""
    tool = os.path.join(os.path.dirname(nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    return "".join("Function : " + part for part in
                   out.split("Function : ")[1:] if fn in part.split("\n")[0])


def phase_a_row(b, order, reps):
    """A mask batch: its work, the times of prepare_rays and worklists,
    and every build's time, each build held bit for bit to the plain
    version."""
    r, cl, tile = b["rows"], b["cl"], b["tile"]
    ref = ct._mask_plain(r, cl, tile)
    work = ct.cluster_work(r, cl, tile)
    row = dict(frame=b["frame"], name=b["name"], lanes=work["lanes"],
               live_share=work["live_lanes"] / max(work["lanes"], 1),
               clusters=cl.num_clusters, work=work, ms={},
               prepare_ms=timed(lambda: ct.prepare_rays(*b["prep"]),
                                reps)[0],
               worklists_ms=timed(lambda: ct.worklists(*ref), reps)[0],
               resources=ct.mask_resources(tile, cl.num_clusters))
    for label, lib, _ in order:
        ms, out = timed(lambda: run(lib, False, "cluster_mask", r, cl, None,
                                    None, None, tile, False), reps)
        row["ms"].setdefault(label, []).append(ms)
        if label in _MASK_CUTS:
            continue
        if not all(torch.equal(bits(x), bits(y)) for x, y in zip(out, ref)):
            raise SystemExit(f"{label}: cluster_mask differs from the plain "
                             f"version on a {b['frame']} batch")
    return row


def phase_b_row(b, order, reps, clock, mhz):
    """A phase B batch: its work and every build's time, each build's
    outputs and stats held bit for bit to the plain version."""
    name, r, cl, tile = b["name"], b["rows"], b["cl"], b["tile"]
    wl, went, count = b["wl"], b["went"], b["count"]
    closest = name == "cluster_closest"
    ref = ct._phase_b_plain(r, cl, wl, went if closest else None, count,
                            tile, not closest)
    work = ct.cluster_work(r, cl, tile, ref[-1], closest)
    live = r[:, 6] < r[:, 7]
    row = dict(frame=b["frame"], name=name, lanes=work["lanes"],
               live_share=float(live.float().mean()),
               live_tiles=work["live_tiles"], tiles=work["tiles"],
               max_steps=work["max_steps"],
               steps_per_tile=work["steps_per_tile"], work=work, ms={})
    for label, lib, old in order:
        ms, _ = timed(lambda: run(lib, old, name, r, cl, wl, went, count,
                                  tile, False), reps)
        row["ms"].setdefault(label, []).append(ms)
        for stats in (False, True):
            out = run(lib, old, name, r, cl, wl, went, count, tile, stats)
            want = ref if stats else ref[:-1]
            if not all(torch.equal(bits(x), bits(y))
                       for x, y in zip(out, want)):
                raise SystemExit(f"{label}: {name} differs from the plain "
                                 f"version on a {b['frame']} batch (stats "
                                 f"{stats})")
    if clock is not None:
        out = run(clock, False, name, r, cl, wl, went, count, tile, True)
        if not all(torch.equal(x, y) for x, y in zip(out[:-1], ref[:-1])):
            raise SystemExit(f"clock: {name} differs from the plain version "
                             f"on a {b['frame']} batch")
        row["clock"] = clock_line(out[-1].cpu(), ref[-1][:, 0].cpu(), mhz)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", default="",
                    help="an earlier cluster_traverse.cu (commit ddf14c4 or "
                    "cf38724) to time beside this one")
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    help='constants of one more build, e.g. "MASK_STAGES=3"')
    ap.add_argument("--clock", action="store_true",
                    help="one more build with clock reads in phase B (timed "
                    "apart)")
    ap.add_argument("--cut", action="append", default=[],
                    choices=sorted(_MASK_CUTS),
                    help="one more phase A build with a part taken out "
                    "(timed, not checked)")
    ap.add_argument("--phase", default="ab", choices=("a", "b", "ab"),
                    help="the kernels to study: a (cluster_mask), b "
                    "(cluster_closest, cluster_any) or both")
    ap.add_argument("--sass", default="",
                    help="write the package's phase A kernel's SASS here")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="", help="write the numbers as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cluster_study needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    props = torch.cuda.get_device_properties(0)
    mhz = float(card.split(",")[2].split()[0])
    rates = st.card_rates(props.name, props.multi_processor_count, mhz)

    builds = [("package", ct.build_kernels(), False)]
    print(f"package: {ct.BUILD_INFO['resources']}", flush=True)
    for ln in ct.BUILD_INFO["log"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print(f"  ptxas: {ln.strip()}", flush=True)
    if args.sass:
        with open(args.sass, "w") as f:
            f.write(sass_of(ct.BUILD_INFO["path"], "mask_kernel"))
    for v in args.sets:
        cuts = [(re.compile(rf"(constexpr int {k} = )\d+;"), rf"\g<1>{val};")
                for k, val in (kv.split("=") for kv in v.split())]
        lib, info = build_library(
            cut_source(ct._SRC, "cluster_set_" + re.sub(r"\W", "_", v),
                       cuts), signatures=ct._SIGNATURES)
        print(f"set {v}: " + "; ".join(
            ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln), flush=True)
        builds.append((v, lib, False))
    clock = (build_library(cut_source(ct._SRC, "cluster_clock", _CLOCK),
                           signatures=ct._SIGNATURES)[0]
             if args.clock and "b" in args.phase else None)
    base = []
    if args.baseline:
        with open(args.baseline) as f:
            old = "const long long* order" not in f.read()
        sigs = {k: v for k, v in (_OLD_SIGNATURES if old
                                  else ct._SIGNATURES).items()
                if k != "cluster_mask_resources"}
        lib, _ = build_library(cut_source(args.baseline,
                                          "cluster_baseline", []),
                               signatures=sigs)
        base = [("baseline", lib, old)]
    for cut in args.cut:
        builds.append((cut, build_library(
            cut_source(ct._SRC, "cluster_cut_" + cut, _MASK_CUTS[cut]),
            signatures=ct._SIGNATURES)[0], False))
    order = base + builds + builds[::-1] + base
    labels = [b[0] for b in base + builds]

    rows_a, rows_b = [], []
    for b in frame_batches():
        if b["name"] == "cluster_mask":
            if "a" in args.phase:
                rows_a.append(phase_a_row(b, order, args.reps))
        elif "b" in args.phase:
            rows_b.append(phase_b_row(b, [o for o in order
                                          if o[0] not in _MASK_CUTS],
                                      args.reps, clock, mhz))
    for row in rows_a + rows_b:
        row.update(st.bound_ms(row.pop("work"), *rates))

    if rows_a:
        print("frame   clusters     lanes   live  bound ms  no-FMA ms  "
              "prepare ms  worklists ms  " + "  ".join(
                  f"{b:>12}" for b in labels), flush=True)
    for row in rows_a:
        best = {b: min(row["ms"][b]) for b in labels}
        print(f"{row['frame']:<7} {row['clusters']:>8} {row['lanes']:>9} "
              f"{row['live_share']:6.3f} {row['bound_ms']:9.3f} "
              f"{row['nofma_floor_ms']:10.3f} {row['prepare_ms']:11.3f} "
              f"{row['worklists_ms']:13.3f}  "
              + "  ".join(f"{best[b]:12.3f}" for b in labels), flush=True)
    for frame in ("menger", "sponza"):
        sel = [r for r in rows_a if r["frame"] == frame]
        if sel:
            print(f"{frame} cluster_mask: {len(sel)} launches, bound "
                  f"{sum(r['bound_ms'] for r in sel):.3f} ms, no-FMA floor "
                  f"{sum(r['nofma_floor_ms'] for r in sel):.3f} ms, "
                  f"prepare_rays {sum(r['prepare_ms'] for r in sel):.3f} ms, "
                  f"worklists {sum(r['worklists_ms'] for r in sel):.3f} ms; "
                  + "; ".join(f"{b} {sum(min(r['ms'][b]) for r in sel):.3f}"
                              " ms" for b in labels)
                  + f"; resources {sel[0]['resources']}", flush=True)
    if rows_b:
        print("frame   kernel            lanes   live  walking/tiles  max "
              "steps  bound ms  no-FMA ms  " + "  ".join(
                  f"{b:>12}" for b in labels) + "  ms/step", flush=True)
    for row in rows_b:
        best = {b: min(row["ms"][b]) for b in labels}
        print(f"{row['frame']:<7} {row['name']:<15} {row['lanes']:>9} "
              f"{row['live_share']:6.3f} {row['live_tiles']:>6}/"
              f"{row['tiles']:<6} {row['max_steps']:>9} "
              f"{row['bound_ms']:9.3f} {row['nofma_floor_ms']:10.3f}  "
              + "  ".join(f"{best[b]:12.3f}" for b in labels)
              + "  " + " ".join(
                  f"{best[b] * 1e3 / max(row['max_steps'], 1):.1f}"
                  for b in labels) + " us", flush=True)
        if "clock" in row:
            print(f"        {row['clock']}", flush=True)
    for name in ("cluster_closest", "cluster_any"):
        sel = [r for r in rows_b if r["frame"] == "menger"
               and r["name"] == name]
        if sel:
            print(f"menger frame {name}: {len(sel)} launches, bound "
                  f"{sum(r['bound_ms'] for r in sel):.3f} ms, no-FMA floor "
                  f"{sum(r['nofma_floor_ms'] for r in sel):.3f} ms; "
                  + "; ".join(f"{b} {sum(min(r['ms'][b]) for r in sel):.3f}"
                              " ms" for b in labels), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, rows=rows_a + rows_b), f, indent=1)


if __name__ == "__main__":
    main()
