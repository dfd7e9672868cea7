"""The brute-force kernels against an earlier design, on one NVIDIA GPU.

    python -m royaltracer_dx_tpu_torch.tools.brute_study \\
        [--baseline OLD.cu] [--set "RAYS=2 TILE=64"]... [--reps 5] \\
        [--no-batches] [--no-sweep] [--out FILE.json]

The batches are ``chip_smoke.py`` phase 9's, captured from the renderers
as the dispatch hands them over: the Cornell box's 512x512 camera batch
and a shadow batch from its hits (every third lane masked), the busiest
scattered closest-hit batch of a 512x512 menger ReSTIR frame and a shadow
batch from it, the busiest any-hit batch of the CLI's default Cornell run
(pass 3's fused visibility batch) and the busiest scattered batch of a
1920x1080 menger frame on 2 bands (1,036,800 lanes).  The sweep crosses
the share of live rays (1, 10, 50, 100% of 262,144 lanes) with the
triangle count (``random_tris`` soups of 32, 256 and 1,024 triangles, 0.1
across; the menger sponge's 4,800).  On each, for closest and any hit:

  package   brute_closest / brute_any as the package builds them
  baseline  an earlier brute_trace.cu with PR 12's C interface ([N, 3]
            rows, [N] bounds), written out with ``git show fe0f5f4:
            royaltracer_dx_tpu_torch/csrc/brute_trace.cu > old.cu``
  --set     a copy of csrc/brute_trace.cu with named ``constexpr int``
            constants given other values (RAYS, TILE, MIN_SLICE,
            ITEMS_PER_CTA, MIN_CTAS)

each by CUDA events over ``--reps`` back-to-back calls and by
torch.profiler's device time of the whole call (memset, list and main
kernel; the baseline's one kernel), beside ``brute_work``'s bound and
no-FMA floor.  The package and the baseline run in the order baseline,
package, package, baseline, and the better of each pair is printed.
Every other build's answers (t, u, v, triangle ids; occlusion and the
counted build's tests) are held against the package's bit for bit, and
the package's against the plain versions on a 16,384-lane sample; a
difference ends the run with a non-zero code.  The plan (slices) each
build's device chose is printed beside its time.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import tempfile

import numpy as np
import torch

from royaltracer_dx_tpu_torch.ops import brute_trace as bt
from royaltracer_dx_tpu_torch.ops import intersect as it
from royaltracer_dx_tpu_torch.ops import stream_trace as st
from royaltracer_dx_tpu_torch.utils.cuda_build import BUILD_DIR, build_library
from royaltracer_dx_tpu_torch.ops.mxu_trace import prepare_rays

SWEEP_TRIS = (32, 256, 1024, "menger")
SWEEP_LIVE = (0.01, 0.1, 0.5, 1.0)
SWEEP_RAYS = 262144
SAMPLE = 16384
_P, _I = bt._P, bt._I
# PR 12's C interface: rows, bounds, planes, outputs, n, tris, stream
_BASE_SIGNATURES = {
    "brute_closest": [_P] * 9 + [_I, _I, _P],
    "brute_any": [_P] * 6 + [_I, _I, _P],
    "brute_any_counted": [_P] * 7 + [_I, _I, _P],
}


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


def device_ms(fn, reps, parts=None):
    """Mean device ms of a call of ``fn`` (every device operation), from
    torch.profiler over ``reps`` calls after a warm one; None where the
    profiler records no device event.  ``parts``, a dict, gets the mean
    ms of each kind of operation: the list kernel, the main kernel, the
    rest (the scratch's memset)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    us = [e.time_range.end - e.time_range.start for e in events]
    if parts is not None:
        for e, t in zip(events, us):
            kind = next((k for k in ("list", "closest", "any")
                         if f"brute_{k}" in e.name), "other")
            parts[kind] = parts.get(kind, 0.0) + t / 1e3 / reps
    return sum(us) / 1e3 / reps if us else None


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def registers(info):
    """The registers per thread of each kernel in a build's ptxas log."""
    return re.findall(r"Used (\d+) registers", info["log"])


def _copy_build(src, name, signatures):
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, name)
    with open(path, "w") as f:
        f.write(src)
    lib, info = build_library(path, signatures=signatures)
    return lib, info


def set_build(v):
    """A copy of csrc/brute_trace.cu with ``v``'s constants, built."""
    with open(bt._SRC) as f:
        src = f.read()
    for k, val in (kv.split("=") for kv in v.split()):
        src, hits = re.subn(rf"(constexpr int {k} = )-?\d+;",
                            rf"\g<1>{val};", src)
        if hits != 1:
            raise SystemExit(f"--set {v}: no constexpr int {k}")
    lib, info = _copy_build(src, "study_brute_" + re.sub(r"\W", "_", v)
                            + ".cu", bt._SIGNATURES)
    print(f"set {v}: registers {registers(info)}, "
          f"{bt.kernel_resources(lib)}", flush=True)
    return lib


def baseline_build(path):
    """An earlier brute_trace.cu (PR 12's C interface), built."""
    with open(path) as f:
        src = f.read()
    lib, info = _copy_build(src, "brute_baseline.cu", _BASE_SIGNATURES)
    print(f"baseline {path}: registers {registers(info)}", flush=True)
    return lib


def package_call(kind, rays, lib=None):
    """A call of the package's wrapper (``lib``: a --set build of the same
    source): (call, outputs)."""
    o, d, lo, hi, tris = rays
    args = bt._check(o, d, lo, hi, tris)
    n, dev = o.shape[0], o.device
    outs = {}

    def call():
        if kind == "closest":
            outs["v"] = bt._closest_into(args, n, dev, tris, lib)[0]
        else:
            outs["v"] = bt._any_into(args, n, dev, tris, True, lib)[0]

    return call, outs


def baseline_call(kind, rays, lib):
    """A launch of PR 12's kernels on [N, 3] rows: (call, outputs)."""
    o, d, lo, hi, tris = rays
    n, dev = o.shape[0], o.device
    planes = bt.planes_of(tris)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = [o.data_ptr(), d.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            planes.data_ptr()]
    if kind == "closest":
        t, u, v = (torch.empty(n, device=dev) for _ in range(3))
        tri = torch.empty(n, dtype=torch.int64, device=dev)
        ptrs, outs = [t, u, v, tri], {"v": (t, tri, u, v)}
        name = "brute_closest"
    else:
        occ = torch.empty(n, dtype=torch.bool, device=dev)
        tests = torch.empty(n, dtype=torch.int32, device=dev)
        ptrs, outs = [occ, tests], {"v": (occ, tests)}
        name = "brute_any_counted"

    def call():
        err = getattr(lib, name)(*head, *(x.data_ptr() for x in ptrs), n,
                                 tris.shape[0], stream)
        if err:
            raise SystemExit(f"baseline {name}: CUDA error {err}")

    return call, outs


class Capture:
    """Keeps the inputs (as rows) of each brute wrapper's call with the
    most live rays while a path runs."""

    def __enter__(self):
        self.largest, self.real = {}, {}
        for name in ("brute_closest", "brute_any"):
            self.real[name] = getattr(bt, name)

            def call(*args, _name=name, **kw):
                rows = (*prepare_rays(*args[:4]), args[4])
                live = int((rows[2] < rows[3]).sum())
                if live > self.largest.get(_name, (0,))[0]:
                    self.largest[_name] = (live, rows)
                return self.real[_name](*args, **kw)

            setattr(bt, name, call)
        return self

    def __exit__(self, *exc):
        for name, fn in self.real.items():
            setattr(bt, name, fn)


def light_of(sa):
    """The centroid of a scene's lights (chip_smoke.py's shadow target)."""
    from royaltracer_dx_tpu_torch.ops import light_sampling as ls

    wv = ls.light_world_verts(sa.lights, sa.object_to_world, torch.arange(
        sa.lights.count, device=sa.tri_verts.device))
    return wv.reshape(-1, 3).mean(dim=0)


def shadow_rays(rays, t, light):
    """From each ray's hit (3 units along a miss) toward ``light``, t_max
    short of it; every third lane masked (chip_smoke.py's
    shadow_batch)."""
    o, d = rays[:2]
    x = o + torch.where(t < 1e29, t * (1.0 - 1e-4), 3.0)[:, None] * d
    to = light - x
    dist = torch.linalg.vector_norm(to, dim=1)
    lane = torch.arange(o.shape[0], device=o.device)
    return (x.contiguous(), (to / dist[:, None]).contiguous(),
            torch.full_like(dist, 1e-4),
            torch.where(lane % 3 == 0, -1.0, dist * (1.0 - 1e-3)).contiguous(),
            rays[4])


def phase9_batches(dev):
    """chip_smoke.py phase 9's batches and the 2-band 1080p one."""
    from royaltracer_dx_tpu_torch import cli
    from royaltracer_dx_tpu_torch.camera import generate_rays
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.parallel.shard import ShardedRestirRenderer
    from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    scene, camera = cli.build_scene("cornell")
    sa = scene.flatten(scene.build_materials(device=dev), device=dev)
    ca = {k: torch.as_tensor(x, device=dev)
          for k, x in camera.matrices(1.0).items()}
    o, d = generate_rays(ca, 512, 512)
    cam = (*prepare_rays(o, d, 1e-4, 1e4), sa.tri_verts)
    out = {("cornell camera", "closest"): cam,
           ("cornell shadow", "any"): shadow_rays(
               cam, bt.brute_closest(*cam)[0], light_of(sa))}
    with tempfile.TemporaryDirectory() as tmp, Capture() as cli_calls:
        cli.main(["--scene", "cornell", "--frames", "1", "--out",
                  os.path.join(tmp, "c.png")])
    out[("cornell cli pass 3", "any")] = cli_calls.largest["brute_any"][1]
    m_scene, m_camera = menger_scene()
    r = RestirRenderer(m_scene, m_camera, RenderConfig(width=512,
                                                       height=512))
    with Capture() as m_calls:
        r.render()
    scatter = m_calls.largest["brute_closest"][1]
    out[("menger-512 scattered", "closest")] = scatter
    out[("menger shadow", "any")] = shadow_rays(
        scatter, bt.brute_closest(*scatter)[0], light_of(r.scene_arrays))
    del r
    b = ShardedRestirRenderer(*menger_scene(), RenderConfig(),
                              devices=[dev] * 2)
    with Capture() as b_calls:
        b.render()
    out[("1080p band scattered", "closest")] = \
        b_calls.largest["brute_closest"][1]
    del b
    torch.cuda.empty_cache()
    return out


def sweep_batches(dev):
    """Live share x triangle count, 262,144 lanes from a sphere about the
    triangles toward their box (half toward a triangle's centroid)."""
    from royaltracer_dx_tpu_torch.scene.procedural import (
        menger_sponge,
        random_tris,
    )

    out = {}
    for count in SWEEP_TRIS:
        if count == "menger":
            v, idx = menger_sponge(2)
        else:
            v, idx = random_tris(count, size=0.1)
        tv = v[idx].astype(np.float32)
        rng = np.random.default_rng(7)
        flat = tv.reshape(-1, 3).astype(np.float64)
        lo_, hi_ = flat.min(0), flat.max(0)
        mid, half = 0.5 * (lo_ + hi_), 0.5 * (hi_ - lo_)
        s = rng.normal(size=(SWEEP_RAYS, 3))
        o = mid + 3.0 * max(half.max(), 1.0) * s / np.linalg.norm(
            s, axis=1, keepdims=True)
        target = np.where((np.arange(SWEEP_RAYS) % 2 == 0)[:, None],
                          tv[rng.integers(0, len(tv), SWEEP_RAYS)].mean(1),
                          mid + half * rng.uniform(-1, 1, (SWEEP_RAYS, 3)))
        d = target - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        order = rng.permutation(SWEEP_RAYS)
        for share in SWEEP_LIVE:
            hi = np.where(order < share * SWEEP_RAYS, 1e4, -1.0)

            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                       device=dev)

            rays = (t(o), t(d), t(np.full(SWEEP_RAYS, 1e-4)), t(hi), t(tv))
            for kind in ("closest", "any"):
                out[(f"{count} tris, {share:.0%} live", kind)] = rays
    return out


def plain_sample(kind, rays, idx):
    o, d, lo, hi, tris = (x[idx] if x is not rays[4] else x for x in rays)
    if kind == "closest":
        h = it.closest_hit_brute(o, d, tris, lo, hi)
        return h.t, h.tri, h.u, h.v
    return (it.any_hit_brute(o, d, tris, lo, hi),
            bt.first_hit_tests(o, d, lo, hi, tris))


def study(label, kind, rays, base, variants, reps, rates):
    call, outs = package_call(kind, rays)
    call()
    torch.cuda.synchronize()
    ref = outs["v"]
    n = rays[0].shape[0]
    idx = torch.arange(0, n, max(1, n // SAMPLE), device=rays[0].device)
    for k, p in zip(ref, plain_sample(kind, rays, idx)):
        if not torch.equal(bits(k[idx]), bits(p)):
            raise SystemExit(f"{label} {kind}: the package differs from the "
                             "plain version")
    timed = {}
    parts = {}
    device_ms(call, reps, parts)
    builds = [*base, ("package", None), ("package", None), *base[::-1]]
    for name, lib in builds:
        b_call, b_outs = ((call, outs) if lib is None
                          else baseline_call(kind, rays, lib))
        timed.setdefault(name, []).append((cuda_ms(b_call, reps),
                                           device_ms(b_call, reps)))
        torch.cuda.synchronize()
        if not all(torch.equal(bits(a), bits(b))
                   for a, b in zip(b_outs["v"], ref)):
            raise SystemExit(f"{name}: answers differ on {label} {kind}")
    plans = {"package": bt.launch_plan(
        "closest" if kind == "closest" else "any_counted", *rays)}
    for v, lib in variants:
        v_call, v_outs = package_call(kind, rays, lib)
        timed[v] = [(cuda_ms(v_call, reps), device_ms(v_call, reps))]
        torch.cuda.synchronize()
        if not all(torch.equal(bits(a), bits(b))
                   for a, b in zip(v_outs["v"], ref)):
            raise SystemExit(f"{v}: answers differ on {label} {kind}")
        plans[v] = bt.launch_plan(
            "closest" if kind == "closest" else "any_counted", *rays,
            lib=lib)
    o, d, lo, hi, tris = rays
    live = int((lo < hi).sum())
    hits = ""
    if kind == "any":
        # where the live rays' first hits fall, by round, and the rays
        # each round listed
        tests, occ = ref[1].long(), ref[0]
        rounds = plans["package"]["rounds"]
        where = [int(((tests[occ] > r["tri_lo"])
                      & (tests[occ] <= r["tri_hi"])).sum()) for r in rounds]
        hits = (f"  needed tests {int(tests.sum())}, occluded "
                f"{int(occ.sum())} of {live}; rounds "
                + ", ".join(f"[{r['tri_lo']}, {r['tri_hi']}): {r['live']} "
                            f"rays x {r['slices']} slices, {w} first hits"
                            for r, w in zip(rounds, where)))
    stages = bt.mt_stages(o, d, lo, hi, tris,
                          None if kind == "closest" else ref[1])
    work = bt.brute_work(stages, tris.shape[0], n, kind == "closest", live)
    bound = st.bound_ms(work, *rates)
    best = {k: (min(x[0] for x in v),
                min((x[1] for x in v if x[1] is not None), default=None))
            for k, v in timed.items()}

    def fmt(k):
        e, dv = best[k]
        return (f"{e:8.4f} ({dv:.4f})" if dv is not None
                else f"{e:8.4f} (not measured)")

    ratio = (f"{best['package'][1] / best['baseline'][1]:6.3f}"
             if base and best["baseline"][1] and best["package"][1]
             else "     -")
    extra = "".join(f"  [{k}: {fmt(k)}, {plans[k]['slices']} slices]"
                    for k in best if k not in ("package", "baseline"))
    print(f"{label:34s} {kind:7s} {n:8d} {live:8d} {tris.shape[0]:5d} "
          f"{plans['package']['slices']:4d}  {fmt('package')}  "
          + (f"{fmt('baseline')}  " if base else "")
          + f"{ratio}  {bound['bound_ms']:.4f} {bound['nofma_floor_ms']:.4f}"
          + "  {" + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
          + "}" + extra + hits, flush=True)
    return dict(label=label, kind=kind, lanes=n, live=live,
                triangles=tris.shape[0], plans=plans,
                events_ms={k: v[0] for k, v in best.items()},
                device_ms={k: v[1] for k, v in best.items()},
                device_parts_ms=parts,
                bound_ms=bound["bound_ms"],
                nofma_floor_ms=bound["nofma_floor_ms"], work=work)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", default="",
                    help="an earlier brute_trace.cu (commit fe0f5f4's) to "
                    "time beside this one")
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    help='constants of one more build, e.g. "RAYS=2"')
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-batches", action="store_true",
                    help="skip phase 9's batches")
    ap.add_argument("--no-sweep", action="store_true",
                    help="skip the live share x triangle count sweep")
    ap.add_argument("--out", default="", help="write the numbers as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("brute_study needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    print(card, flush=True)
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(dev)
    rates = st.card_rates(torch.cuda.get_device_name(0),
                          props.multi_processor_count, clock)
    bt.build_kernels()
    print(f"package: registers {registers(bt.BUILD_INFO)}, "
          f"{bt.BUILD_INFO['resources']}", flush=True)
    base = ([("baseline", baseline_build(args.baseline))] if args.baseline
            else [])
    variants = [(v, set_build(v)) for v in args.sets]
    batches = {}
    if not args.no_batches:
        batches.update(phase9_batches(dev))
    if not args.no_sweep:
        batches.update(sweep_batches(dev))
    report = dict(card=card, rows=[])
    print(f"{'batch':34s} {'kind':7s} {'lanes':>8s} {'live':>8s} "
          f"{'tris':>5s} {'S':>4s}  package ms (device)  "
          + ("baseline ms (device)  new/old  " if base else "")
          + "bound floor  [other builds]", flush=True)
    for (label, kind), rays in batches.items():
        report["rows"].append(study(label, kind, rays, base, variants,
                                    args.reps, rates))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
