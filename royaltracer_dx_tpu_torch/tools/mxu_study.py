"""Where the matmul form overtakes the walks, on one NVIDIA GPU.

    python -m royaltracer_dx_tpu_torch.tools.mxu_study \\
        [--tris 32 64 ... 2048] [--scenes cornell menger] [--rays 262144] \\
        [--baseline OLD.cu] [--set "STEP=32"]... [--reps 5] [--out FILE.json]

The points are ``scene/procedural.py``'s ``random_tris(n)`` soups (n
triangles about 0.02 across in [-1, 1]^3), then the ``--scenes``:
``cornell``, the CLI's Cornell box (32 triangles) through its own camera
at 512x512 (262,144 rays, ``chip_smoke.py`` phase 8b's camera batch),
and ``menger``, its 4,802 triangles.  The soups and menger take
``--rays`` camera rays from a sphere of radius 3 toward a random
triangle's centroid (half of them) or a random point of the box.  A
point's shadow batch starts at its camera rays' hits (3 units along a
miss) toward a point light (Cornell: its lights' centroid, as phase 8b's;
else ``LIGHT``), every third lane masked.  On the same rays, each after
two warm calls, it times:

  mxu       mxu_closest / mxu_any (ops/mxu_trace.py) as the package builds
            them
  baseline  an earlier mxu_trace.cu with the same C interface, written out
            with ``git show 4f3f827:royaltracer_dx_tpu_torch/csrc/
            mxu_trace.cu > old.cu`` (the first design: a thread a ray)
  --set     a copy of csrc/mxu_trace.cu with named ``constexpr int``
            constants given other values (sizes: STEP, MIN_CTAS, ...)
  stream    stream_closest / stream_any on the stream accel
            (prepare_stream's worklists made beforehand)
  bvh       bvh_closest / bvh_any on the LBVH (rays packed beforehand)

each by CUDA events over ``--reps`` back-to-back calls and by
torch.profiler's device time of the kernels alone (no host launch gaps).
The package and the baseline run in the order baseline, package,
package, baseline, and the better of each pair is printed.  It prints,
per point and kind, the times, the ratios and the share of pairs the
filter kept (the counted build).  Each point's package answers are held
against the plain versions on a 16,384-lane sample, and every other mxu
build's against the package's bit for bit; a difference ends the run
with a non-zero code.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess

import numpy as np
import torch

from royaltracer_dx_tpu_torch.ops import mxu_trace as mx
from royaltracer_dx_tpu_torch.ops import stream_trace as st
from royaltracer_dx_tpu_torch.ops import traverse as tv
from royaltracer_dx_tpu_torch.ops.bvh import build_lbvh

DEFAULT_TRIS = (32, 64, 128, 256, 512, 1024, 2048)
LIGHT = (0.0, 3.0, 0.0)
SAMPLE = 16384
CORNELL_SIZE = 512
# the C functions an earlier mxu_trace.cu (--baseline) must have
_BASE_SIGNATURES = {k: mx._SIGNATURES[k] for k in ("mxu_closest", "mxu_any")}


def cuda_ms(fn, reps):
    """Mean ms of ``reps`` calls after two warm ones, by CUDA events."""
    fn()
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps, key=""):
    """Mean device ms a call of ``fn`` spends in kernels whose name holds
    ``key``, from torch.profiler over ``reps`` calls after a warm one;
    None where the profiler records no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA and key in e.name]
    return sum(us) / 1e3 / reps if us else None


def point_scene(n, dev):
    """([T, 3, 3] float32 triangles, light position or None) of a point:
    random_tris(n), or a scene of the CLI (Cornell's light: its lights'
    centroid)."""
    if isinstance(n, int):
        from royaltracer_dx_tpu_torch.scene.procedural import random_tris

        v, idx = random_tris(n)
        return torch.as_tensor(v[idx], device=dev), None
    from royaltracer_dx_tpu_torch import cli
    from royaltracer_dx_tpu_torch.ops import light_sampling as ls

    scene, _ = cli.build_scene(n)
    sa = scene.flatten(scene.build_materials(device=dev), device=dev)
    if n != "cornell":
        return sa.tri_verts, None
    wv = ls.light_world_verts(sa.lights, sa.object_to_world, torch.arange(
        sa.lights.count, device=dev))
    return sa.tri_verts, wv.reshape(-1, 3).mean(dim=0)


def cornell_rays(dev):
    """The CLI's Cornell camera at CORNELL_SIZE^2, t in [1e-4, 1e4]."""
    from royaltracer_dx_tpu_torch import cli
    from royaltracer_dx_tpu_torch.camera import generate_rays

    _, camera = cli.build_scene("cornell")
    ca = {k: torch.as_tensor(x, device=dev)
          for k, x in camera.matrices(1.0).items()}
    o, d = generate_rays(ca, CORNELL_SIZE, CORNELL_SIZE)
    return mx.prepare_rays(o.contiguous(), d.contiguous(), 1e-4, 1e4)


def point_rays(tris, n_rays, dev, seed=7):
    """Camera rays from a sphere of radius 3 about the triangles' box
    centre (t in [1e-4, 1e4]): half toward a random triangle's centroid,
    half toward random points of the box."""
    rng = np.random.default_rng(seed)
    tv_ = tris.cpu().numpy().astype(np.float64)
    flat = tv_.reshape(-1, 3)
    lo, hi = flat.min(axis=0), flat.max(axis=0)
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    s = rng.normal(size=(n_rays, 3))
    o = mid + 3.0 * max(float(half.max()), 1.0) * s / np.linalg.norm(
        s, axis=1, keepdims=True)
    target = np.where(
        (np.arange(n_rays) % 2 == 0)[:, None],
        tv_[rng.integers(0, len(tv_), n_rays)].mean(axis=1),
        mid + half * rng.uniform(-1, 1, (n_rays, 3)))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    def t_(x):
        return torch.as_tensor(x.astype(np.float32), device=dev).contiguous()

    return (t_(o), t_(d), torch.full((n_rays,), 1e-4, device=dev),
            torch.full((n_rays,), 1e4, device=dev))


def shadow_rays(cam, t, light):
    """From each camera ray's hit (3 units along a miss) toward ``light``,
    t_max short of it; every third lane masked."""
    o, d = cam[:2]
    x = o + torch.where(t < 1e29, t * (1.0 - 1e-4), 3.0)[:, None] * d
    to = light - x
    dist = torch.linalg.vector_norm(to, dim=1)
    lane = torch.arange(o.shape[0], device=o.device)
    return (x.contiguous(), (to / dist[:, None]).contiguous(),
            torch.full_like(dist, 1e-4),
            torch.where(lane % 3 == 0, -1.0, dist * (1.0 - 1e-3)).contiguous())


def mxu_call(kind, args, mt, lib=None):
    """A launch of mxu_closest / mxu_any through ``lib`` (the package's
    build if None) into fresh outputs: (call, outputs)."""
    n, dev = args[0].shape[0], args[0].device
    head = [args[1].data_ptr(), args[2].data_ptr(), args[3].data_ptr(),
            mt.coeff.data_ptr(), mt.center.data_ptr()]
    if kind == "closest":
        outs = (torch.empty(n, device=dev),
                torch.empty(n, dtype=torch.int64, device=dev),
                torch.empty(n, device=dev), torch.empty(n, device=dev))
        ptrs = [outs[0].data_ptr(), outs[2].data_ptr(), outs[3].data_ptr(),
                outs[1].data_ptr()]
    else:
        outs = (torch.empty(n, dtype=torch.bool, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev))
        ptrs = [o.data_ptr() for o in outs]

    def call():
        mx._launch(f"mxu_{kind}", args[0], *head, *ptrs, n, mt.num_tris,
                   mt.padded, lib=lib)

    return call, outs


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def registers(info):
    """The registers per thread of each kernel in a build's ptxas log."""
    return re.findall(r"Used (\d+) registers", info["log"])


def set_build(v):
    """A copy of csrc/mxu_trace.cu with ``v``'s constants, built."""
    with open(mx._SRC) as f:
        src = f.read()
    for k, val in (kv.split("=") for kv in v.split()):
        src, hits = re.subn(rf"(constexpr int {k} = )-?\d+;",
                            rf"\g<1>{val};", src)
        if hits != 1:
            raise SystemExit(f"--set {v}: no constexpr int {k}")
    os.makedirs(st._BUILD_DIR, exist_ok=True)
    path = os.path.join(st._BUILD_DIR,
                        "study_mxu_" + re.sub(r"\W", "_", v) + ".cu")
    with open(path, "w") as f:
        f.write(src)
    lib, info = st.build_library(path, signatures=mx._SIGNATURES)
    print(f"set {v}: registers {registers(info)}", flush=True)
    return lib


def baseline_build(path):
    """An earlier mxu_trace.cu, copied into the build directory, built."""
    with open(path) as f:
        src = f.read()
    os.makedirs(st._BUILD_DIR, exist_ok=True)
    copy = os.path.join(st._BUILD_DIR, "mxu_baseline.cu")
    with open(copy, "w") as f:
        f.write(src)
    lib, info = st.build_library(copy, signatures=_BASE_SIGNATURES)
    print(f"baseline {path}: registers {registers(info)}", flush=True)
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tris", type=int, nargs="*", default=DEFAULT_TRIS)
    ap.add_argument("--scenes", nargs="*", default=("cornell", "menger"),
                    choices=("cornell", "menger"))
    ap.add_argument("--rays", type=int, default=262144)
    ap.add_argument("--baseline", default="",
                    help="an earlier mxu_trace.cu (commit 4f3f827's) to "
                    "time beside this one")
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    help='constants of one more build, e.g. "STEP=32"')
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="", help="write the numbers as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mxu_study needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    mx.build_kernels()
    st.build_kernels()
    tv.build_kernels()
    print(f"package: {mx.BUILD_INFO['filter']}, "
          f"{mx.BUILD_INFO['resources']}", flush=True)
    base = [("baseline", baseline_build(args.baseline))] if args.baseline \
        else []
    variants = [(v, set_build(v)) for v in args.sets]

    report = dict(card=card, rays=args.rays, points=[])
    print("point     kind     mxu ms (device)    stream ms (device)  bvh ms "
          "(device)   mxu/stream  mxu/bvh  kept  [other builds: ms "
          "(device)]", flush=True)
    for n in (*args.tris, *args.scenes):
        tris, light = point_scene(n, dev)
        mt = mx.build_mxu_tris(tris)
        acc = st.build_stream_accel(tris)
        bvh = build_lbvh(tris)
        cam = (cornell_rays(dev) if n == "cornell"
               else point_rays(tris, args.rays, dev))
        hit_t = mx.mxu_closest(*cam, mt)[0]
        light = torch.tensor(LIGHT, device=dev) if light is None else light
        batches = {"closest": cam, "any": shadow_rays(cam, hit_t, light)}
        for kind, rays in batches.items():
            call, outs = mxu_call(kind, rays, mt)
            call()   # the answers the other builds are held against
            timed = {}   # build -> [(events ms, device ms)]
            builds = [*base, ("mxu", None), ("mxu", None), *base[::-1]]
            for label, lib in builds:
                b_call, b_outs = (call, outs) if lib is None else mxu_call(
                    kind, rays, mt, lib)
                timed.setdefault(label, []).append(
                    (cuda_ms(b_call, args.reps),
                     device_ms(b_call, args.reps)))
                torch.cuda.synchronize()
                if lib is not None and not all(
                        torch.equal(bits(a), bits(b))
                        for a, b in zip(b_outs, outs)):
                    raise SystemExit(f"{label}: answers differ on {n} {kind}")
            idx = torch.arange(0, rays[0].shape[0],
                               max(1, rays[0].shape[0] // SAMPLE), device=dev)
            sample = tuple(x[idx] for x in rays)
            plain = (mx._closest_plain(*sample, mt.coeff, mt.center)
                     if kind == "closest" else
                     mx._any_plain(*sample, mt.coeff, mt.center,
                                   mt.num_tris))
            for k, p in zip(outs, plain):
                if not torch.equal(bits(k[idx]), bits(p)):
                    raise SystemExit(f"{n} {kind}: mxu differs from plain")
            for v, lib in variants:
                v_call, v_outs = mxu_call(kind, rays, mt, lib)
                timed[v] = [(cuda_ms(v_call, args.reps),
                             device_ms(v_call, args.reps))]
                if not all(torch.equal(bits(a), bits(b))
                           for a, b in zip(v_outs, outs)):
                    raise SystemExit(f"{v}: answers differ on {n} {kind}")
            counts = mx.filter_counts(*rays, mt, closest=kind == "closest")
            call_s = st.prepare_stream(rays[0], rays[1], acc, rays[2],
                                       rays[3], 16)
            s_kern = st.stream_closest if kind == "closest" else st.stream_any
            packed = tv.pack_rays(*rays)
            b_kern = tv.bvh_closest if kind == "closest" else tv.bvh_any

            def s_fn():
                s_kern(*call_s, acc.blk_tris, acc.blk_boxes)

            def b_fn():
                b_kern(packed, bvh)

            best = {k: (min(x[0] for x in v),
                        min((x[1] for x in v if x[1] is not None),
                            default=None)) for k, v in timed.items()}
            best["stream"] = (cuda_ms(s_fn, args.reps),
                              device_ms(s_fn, args.reps, "stream_kernel"))
            best["bvh"] = (cuda_ms(b_fn, args.reps),
                           device_ms(b_fn, args.reps, f"bvh_{kind}_kernel"))
            ms, s_ms, b_ms = (best[k][0] for k in ("mxu", "stream", "bvh"))
            row = dict(point=n, triangles=mt.num_tris, lanes=rays[0].shape[0],
                       kind=kind, mxu_ms=ms, stream_ms=s_ms, bvh_ms=b_ms,
                       device_ms={k: v[1] for k, v in best.items()},
                       events_ms={k: v[0] for k, v in best.items()},
                       counts=counts,
                       kept=counts["candidates"] / max(counts["pairs"], 1))
            report["points"].append(row)

            def fmt(k):
                e, d = best[k]
                return f"{e:8.4f} ({d:.4f})" if d is not None else \
                    f"{e:8.4f} (not measured)"

            extra = "".join(f"  [{k}: {fmt(k)}]" for k in best
                            if k not in ("mxu", "stream", "bvh"))
            print(f"{str(n):9s} {kind:8s} {fmt('mxu')} {fmt('stream')} "
                  f"{fmt('bvh')} {ms / s_ms:10.2f} {ms / b_ms:8.2f}  "
                  f"{row['kept']:.4%}{extra}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
