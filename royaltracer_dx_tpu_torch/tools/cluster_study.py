"""Study of the cluster traversal's phase B kernels on rendered frames' own
batches, on one NVIDIA GPU.

    python -m royaltracer_dx_tpu_torch.tools.cluster_study \\
        [--baseline OLD.cu] [--set "PB_THREADS=512"]... [--clock] \\
        [--reps 3] [--out FILE.json]

It renders the menger scene at 1920x1080 under ``traversal="cluster"``:
one ReSTIR frame to warm up, then one more whose cluster_closest /
cluster_any launches are kept (6 + 5 batches), and sponza's 2,073,600
primary rays (2,073 clusters of 128) through phase A.  Per batch it
prints the lanes, the share of live lanes (t_min < t_max), the tiles
that walk, the steps of the longest tile, the bound and the no-FMA floor
(``cluster_traverse.cluster_work`` and ``stream_trace.bound_ms``), then
times every build on every batch, all in this one process and in the
order baseline, package, package, baseline:

  package   csrc/cluster_traverse.cu as the package builds it
  --set     a copy with named ``constexpr int`` constants given other
            values (PB_THREADS, ZERO_CHUNK, ...)
  --clock   a copy with SM clock reads patched in: its stats build
            writes thread 0's clocks per tile (waiting for a step's
            record and the barrier, testing, the bound's reduction, and
            the whole tile), printed per step of the walking tiles
  baseline  the first design of the kernels (a CTA a tile, a thread a
            ray, one record staged a step), whose C interface has no tile
            order: the file of commit cf38724, written out with
            ``git show cf38724:royaltracer_dx_tpu_torch/csrc/\\
            cluster_traverse.cu > old.cu``

Every build's outputs and per-tile stats (steps, needed tests) are held
bit for bit against the plain version (``_phase_b_plain``) on every
batch; a difference ends the run with a non-zero code.

``pack_case`` makes the adversarial tiles that the card tests and
``chip_smoke.py`` hold the kernels to: every packing width of live rays,
dead rays whose t_max decides the bound, a NaN t_max, tiles without a
live ray that still overlap boxes, and exact-t ties within and across
clusters (every triangle twice).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import numpy as np
import torch

from royaltracer_dx_tpu_torch.ops import cluster_traverse as ct
from royaltracer_dx_tpu_torch.ops import stream_trace as st
from royaltracer_dx_tpu_torch.scene.procedural import menger_sponge
from royaltracer_dx_tpu_torch.tools.stream_study import cut_source, timed

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C interface of the first design (--baseline): no order or counter
_OLD_SIGNATURES = {
    "cluster_mask": [_P] * 5 + [_I] * 3 + [_P],
    "cluster_closest": [_P] * 9 + [_I] * 4 + [_P],
    "cluster_any": [_P] * 6 + [_I] * 4 + [_P],
    "cluster_resources": [_I, _I, ctypes.POINTER(_I)],
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


# ------------------------------ the study --------------------------------


def run(lib, old, name, rows, cl, wl, went, count, tile, stats):
    """One launch of ``name`` through ``lib`` (``old``: the first design's
    C interface); returns its outputs and, with ``stats``, its [tiles, 2]
    stats."""
    dev = rows.device
    n_pad = rows.shape[0]
    tiles, c = n_pad // tile, cl.num_clusters
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


def frame_batches():
    """The phase B launches of one menger cluster ReSTIR frame (after a
    warm-up frame) and sponza's primary batch: [(label, name, (rows, cl,
    wl, went, count, tile))]."""
    from royaltracer_dx_tpu_torch import cli
    from royaltracer_dx_tpu_torch.camera import generate_rays
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    scene, camera = menger_scene()
    r = RestirRenderer(scene, camera, RenderConfig(traversal="cluster"))
    r.render()
    batches = []
    real = {n: getattr(ct, n) for n in ("cluster_closest", "cluster_any")}

    def keep(name):
        def call(rows, cl, wl, *rest, **kw):
            if name == "cluster_closest":
                went, count, tile = rest
            else:
                went, (count, tile) = None, rest
            batches.append(("menger", name, (rows, cl, wl, went, count,
                                             tile)))
            return real[name](rows, cl, wl, *rest, **kw)
        return call

    for n in real:
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
    rows = ct.prepare_rays(o, d, 1e-4, 1e4, 128)
    wl, went, count = ct.tile_worklists(rows, sa.clusters, 128)
    for name in real:
        batches.append(("sponza", name, (rows, sa.clusters, wl, went, count,
                                         128)))
    return batches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", default="",
                    help="the first design's cluster_traverse.cu (commit "
                    "cf38724) to time beside this one")
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    help='constants of one more build, e.g. "PB_THREADS=512"')
    ap.add_argument("--clock", action="store_true",
                    help="one more build with clock reads (timed apart)")
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
    for v in args.sets:
        cuts = [(re.compile(rf"(constexpr int {k} = )\d+;"), rf"\g<1>{val};")
                for k, val in (kv.split("=") for kv in v.split())]
        lib, info = st.build_library(
            cut_source(ct._SRC, "cluster_set_" + re.sub(r"\W", "_", v),
                       cuts), signatures=ct._SIGNATURES)
        print(f"set {v}: " + "; ".join(
            ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln), flush=True)
        builds.append((v, lib, False))
    clock = (st.build_library(cut_source(ct._SRC, "cluster_clock", _CLOCK),
                              signatures=ct._SIGNATURES)[0]
             if args.clock else None)
    base = []
    if args.baseline:
        lib, _ = st.build_library(cut_source(args.baseline,
                                             "cluster_baseline", []),
                                  signatures=_OLD_SIGNATURES)
        base = [("baseline", lib, True)]
    order = base + builds + builds[::-1] + base
    labels = [b[0] for b in base + builds]

    batches = frame_batches()
    rows = []
    for frame, name, (r, cl, wl, went, count, tile) in batches:
        closest = name == "cluster_closest"
        ref = ct._phase_b_plain(r, cl, wl, went if closest else None, count,
                                tile, not closest)
        work = ct.cluster_work(r, cl, tile, ref[-1], closest)
        live = r[:, 6] < r[:, 7]
        row = dict(frame=frame, name=name, lanes=work["lanes"],
                   live_share=float(live.float().mean()),
                   live_tiles=work["live_tiles"], tiles=work["tiles"],
                   max_steps=work["max_steps"],
                   steps_per_tile=work["steps_per_tile"],
                   **st.bound_ms(work, *rates), ms={})
        for label, lib, old in order:
            ms, _ = timed(lambda: run(lib, old, name, r, cl, wl, went, count,
                                      tile, False), args.reps)
            row["ms"].setdefault(label, []).append(ms)
            for stats in (False, True):
                out = run(lib, old, name, r, cl, wl, went, count, tile,
                          stats)
                want = ref if stats else ref[:-1]
                if not all(torch.equal(a.view(torch.int32) if a.dtype ==
                                       torch.float32 else a,
                                       b.view(torch.int32) if b.dtype ==
                                       torch.float32 else b)
                           for a, b in zip(out, want)):
                    raise SystemExit(f"{label}: {name} differs from the "
                                     f"plain version on a {frame} batch "
                                     f"(stats {stats})")
        if clock is not None:
            out = run(clock, False, name, r, cl, wl, went, count, tile, True)
            if not all(torch.equal(a, b) for a, b in zip(out[:-1],
                                                         ref[:-1])):
                raise SystemExit(f"clock: {name} differs from the plain "
                                 f"version on a {frame} batch")
            row["clock"] = clock_line(out[-1].cpu(), ref[-1][:, 0].cpu(),
                                      mhz)
        rows.append(row)
        del ref

    print("frame   kernel            lanes   live  walking/tiles  max "
          "steps  bound ms  no-FMA ms  " + "  ".join(
              f"{b:>12}" for b in labels) + "  ms/step", flush=True)
    for row in rows:
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
        sel = [r for r in rows if r["frame"] == "menger"
               and r["name"] == name]
        print(f"menger frame {name}: {len(sel)} launches, bound "
              f"{sum(r['bound_ms'] for r in sel):.3f} ms, no-FMA floor "
              f"{sum(r['nofma_floor_ms'] for r in sel):.3f} ms; " + "; ".join(
                  f"{b} {sum(min(r['ms'][b]) for r in sel):.3f} ms"
                  for b in labels), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, rows=rows), f, indent=1)


if __name__ == "__main__":
    main()
