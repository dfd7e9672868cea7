"""Study of the LBVH kernels on rendered frames' own batches, on one
NVIDIA GPU.

    python -m royaltracer_dx_tpu_torch.tools.bvh_study \\
        [--baseline OLD.cu] [--set "ROOT_CAP=16"]... [--scan-only] \\
        [--reps 3] [--out FILE.json]

It renders sponza (the generated 265k-triangle atrium) at 1920x1080 with
the LBVH (``--bvh``): one ReSTIR frame to warm up, then one more whose
bvh_closest / bvh_any launches are kept (6 + 5 batches), and one
megakernel frame (5 bounces) whose launches are kept as well, and a
copy of each kernel's largest batch with every lane dead (t_max below
t_min: what taking rays and answering dead lanes costs).  Per batch
it prints the lanes, the share of live lanes (t_max > t_min), the walk
(node and triangle tests a lane, and for closest the slab tests of the
root scans a live lane) and the bound (``traverse.bvh_work`` and
``stream_trace.bound_ms``),
then times every build on every batch, all in this one process and in
the order baseline, package, variants, package, baseline:

  package   csrc/bvh_traverse.cu as the package builds it
  --set     a copy with named ``constexpr int`` constants given other
            values (ROOT_CAP, CLOSEST_CTAS, ANY_CTAS, ANY_REFILL, ...)
  --scan-only  a copy of the closest kernel that ends each lane after its
            root scan: the time of taking rays and scanning roots (its
            answers differ, so it is timed only, and only on closest)
  baseline  the first design of the kernels, whose C interface has no
            counters argument: the file of commit abf0fff, written out
            with ``git show abf0fff:royaltracer_dx_tpu_torch/csrc/\
            bvh_traverse.cu > old.cu``

Every build's outputs are held against the package's on every batch (t,
u, v and triangle ids bit-equal, occlusion equal); a difference ends the
run with a non-zero code.  The source has no ``-D`` switches; a variant is
a patched copy.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import tempfile

import torch

from royaltracer_dx_tpu_torch.ops import stream_trace as st
from royaltracer_dx_tpu_torch.ops import traverse as tv
from royaltracer_dx_tpu_torch.tools.stream_study import cut_source, timed

# --scan-only: a closest lane ends after its root scan
_STEP = "  __device__ __forceinline__ bool step() {\n"
_SCAN_ONLY = [(_STEP + "    if (node == 0) {",
               _STEP + "    if (true) return true;\n    if (node == 0) {")]

# the C interface of the first design (--baseline): no counters argument
_OLD_SIGNATURES = {
    "bvh_closest": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    "bvh_any": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
}


def run(lib, old, name, rays, bvh):
    """One launch of ``name`` through ``lib`` (``old``: the first design's
    C interface); returns its outputs."""
    n = rays.shape[0]
    p, ls = bvh.num_leaves, bvh.leaf_size
    s = min(256, p)
    dev = rays.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if name == "bvh_closest":
        outs = (torch.empty((n, 3), dtype=torch.float32, device=dev),
                torch.empty((n,), dtype=torch.int32, device=dev))
    else:
        outs = (torch.empty((n,), dtype=torch.int32, device=dev),)
    tree = [rays.data_ptr(), bvh.nodes.data_ptr(), bvh.sorted_tris.data_ptr()]
    counters = torch.zeros(2, dtype=torch.int64, device=dev)
    if old:
        err = getattr(lib, name)(
            *tree, bvh.perm.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr() if len(outs) > 1 else None, None, n, p, ls,
            s, tv.max_iters_of(bvh), stream)
    elif name == "bvh_closest":
        err = lib.bvh_closest(*tree, bvh.perm.data_ptr(), outs[0].data_ptr(),
                              outs[1].data_ptr(), None, counters.data_ptr(),
                              n, p, ls, s, tv.max_iters_of(bvh), stream)
    else:
        err = lib.bvh_any(*tree, outs[0].data_ptr(), None,
                          counters.data_ptr(), n, p, ls, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    return outs


def frame_batches(out_dir):
    """The LBVH launches of one sponza --bvh ReSTIR frame (after a warm-up
    frame) and of one megakernel frame: [(label, name, rays, bvh)]."""
    from royaltracer_dx_tpu_torch import cli

    size = ["--scene", "sponza", "--bvh", "--width", "1920", "--height",
            "1080", "--out", os.path.join(out_dir, "s.png")]
    batches = []
    real = tv._launch

    def keep(name, rays, bvh, outs, stats):
        batches.append((label, name, rays, bvh))
        return real(name, rays, bvh, outs, stats)

    for label, extra in (("restir", ["--frames", "1"]),
                         ("megakernel", ["--frames", "1", "--renderer",
                                         "megakernel"])):
        r = cli.main(size + extra)["renderer"]
        tv._launch = keep
        try:
            r.render()
        finally:
            tv._launch = real
        torch.cuda.synchronize()
        del r
    return batches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", default="",
                    help="the first design's bvh_traverse.cu (commit "
                    "abf0fff) to time beside this one")
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    help='constants of one more build, e.g. "ROOT_CAP=16"')
    ap.add_argument("--scan-only", action="store_true",
                    help="one more closest build that only scans roots")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="", help="write the numbers as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bvh_study needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    props = torch.cuda.get_device_properties(0)
    rates = st.card_rates(props.name, props.multi_processor_count,
                          float(card.split(",")[2].split()[0]))

    # ---- builds: (label, library, old interface); timed-only builds are
    # listed apart
    builds = [("package", tv.build_kernels(), False)]
    timed_only = []
    print(f"package: {tv.BUILD_INFO['resources']}", flush=True)
    for v in args.sets:
        cuts = [(re.compile(rf"(constexpr int {k} = )\d+;"), rf"\g<1>{val};")
                for k, val in (kv.split("=") for kv in v.split())]
        lib, info = st.build_library(
            cut_source(tv._SRC, "bvh_set_" + re.sub(r"\W", "_", v), cuts),
            signatures=tv._SIGNATURES)
        print(f"set {v}: " + "; ".join(
            ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln), flush=True)
        builds.append((v, lib, False))
    if args.scan_only:
        lib, _ = st.build_library(
            cut_source(tv._SRC, "bvh_scan_only", _SCAN_ONLY),
            signatures=tv._SIGNATURES)
        timed_only.append(("scan-only", lib, False))
    base = []
    if args.baseline:
        lib, _ = st.build_library(cut_source(args.baseline, "bvh_baseline",
                                             []), signatures=_OLD_SIGNATURES)
        base = [("baseline", lib, True)]
    order = base + builds + timed_only + builds[:1] + base
    labels = [b[0] for b in base + builds + timed_only]

    with tempfile.TemporaryDirectory() as tmp:
        batches = frame_batches(tmp)
    for name in ("bvh_closest", "bvh_any"):
        _, _, rays, bvh = max((b for b in batches if b[1] == name),
                              key=lambda b: b[2].shape[0])
        dead = rays.clone()
        dead[:, 7] = dead[:, 6] - 1.0
        batches.append(("dead", name, dead, bvh))

    # ---- what each batch needs
    rows = []
    for label, name, rays, bvh in batches:
        closest = name == "bvh_closest"
        outs = ((torch.empty((rays.shape[0], 3), device=rays.device),
                 torch.empty((rays.shape[0],), dtype=torch.int32,
                             device=rays.device)) if closest else
                (torch.empty((rays.shape[0],), dtype=torch.int32,
                             device=rays.device),))
        stats = torch.empty((rays.shape[0], 3), dtype=torch.int32,
                            device=rays.device)
        counters = tv._launch(name, rays, bvh, outs, stats)
        work = tv.bvh_work(rays, bvh, stats, closest)
        row = dict(frame=label, name=name, lanes=work["lanes"],
                   live_share=work["live_lanes"] / max(work["lanes"], 1),
                   nodes_per_lane=work["nodes_per_lane"],
                   tris_per_lane=work["tris_per_lane"],
                   root_tests_per_live_lane=(
                       int(counters[1]) / max(work["live_lanes"], 1)
                       if closest else 0.0),
                   **st.bound_ms(work, *rates), ms={})
        rows.append(row)

    # ---- times, and every build against the package
    for label, lib, old in order:
        for (frame, name, rays, bvh), row in zip(batches, rows):
            if label == "scan-only" and name != "bvh_closest":
                continue
            ms, out = timed(lambda: run(lib, old, name, rays, bvh),
                            args.reps)
            row["ms"].setdefault(label, []).append(ms)
            if (label, lib, old) in timed_only:
                continue
            ref = run(builds[0][1], False, name, rays, bvh)
            for a, b in zip(out, ref):
                if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                    raise SystemExit(f"{label}: {name} differs from the "
                                     f"package on a {frame} batch")

    print("frame       kernel       lanes     live  nodes   tris  roots  "
          "bound ms  " + "  ".join(f"{b:>12}" for b in labels), flush=True)
    for row in rows:
        times = "  ".join(f"{min(row['ms'][b]):12.3f}" if b in row["ms"]
                          else f"{'-':>12}" for b in labels)
        print(f"{row['frame']:<11} {row['name']:<11} {row['lanes']:>9} "
              f"{row['live_share']:6.3f} {row['nodes_per_lane']:6.1f} "
              f"{row['tris_per_lane']:6.1f} "
              f"{row['root_tests_per_live_lane']:6.1f} "
              f"{row['bound_ms']:9.3f}  {times}", flush=True)
    for frame in ("restir", "megakernel"):
        for name in ("bvh_closest", "bvh_any"):
            sel = [r for r in rows if r["frame"] == frame
                   and r["name"] == name]
            print(f"{frame} {name}: {len(sel)} launches, bound "
                  f"{sum(r['bound_ms'] for r in sel):.3f} ms; " + "; ".join(
                      f"{b} {sum(min(r['ms'][b]) for r in sel):.3f} ms"
                      for b in labels if b in sel[0]["ms"]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, rows=rows), f, indent=1)


if __name__ == "__main__":
    main()
