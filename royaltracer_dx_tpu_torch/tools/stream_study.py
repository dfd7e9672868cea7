"""Study of the stream kernels on a rendered frame's own batches, on one
NVIDIA GPU.

    python -m royaltracer_dx_tpu_torch.tools.stream_study \\
        [--baseline OLD.cu] [--set "COOP_MAX=0"]... [--clock N]... \\
        [--soup BLOCKS]... [--reps 5] [--out FILE.json]

It renders two 1920x1080 menger frames with the default RenderConfig,
keeps the inputs of every stream-kernel launch of the second frame (6
closest and 5 any-hit batches), adds for every --soup four batches on a
random triangle soup of that many blocks, and then

  1. prints, per batch, what the walk needs: the share of chunks with an
     empty worklist, the blocks visited, hot clusters and ray-cluster
     candidate pairs per live chunk, the share of valid and of live
     lanes, and the batch's bound (``stream_work`` and ``bound_ms`` of
     the package);
  2. times every build on every batch, all within this one process and
     in the order baseline, package, variants, package, baseline:
       package   csrc/stream_trace.cu as the package builds it
       --set     a copy of that source with named ``constexpr int``
                 constants given other values (COOP_MAX, MIN_CTAS)
       --clock   a copy with SM clock reads patched in: the third stat
                 then carries thread 0's clocks per chunk -- N = 1 the
                 whole chunk, 2 the slab tests, 3 the hit tests, 4 the
                 block steps' exchange and barrier -- and their
                 distribution is printed per batch
       baseline  an earlier source with the same C interface and
                 two-column stats (for example the file of an earlier
                 commit, written out with ``git show``; one whose
                 interface ends at the stream ignores the counter pointer
                 passed after it), and two cut-down
                 builds of it that split its time: ``baseline-nomt`` with
                 the Moller-Trumbore loop compiled out (staging, slab
                 tests and barriers remain; without hits no chunk exits
                 early, so its blocks visited are printed) and
                 ``baseline-nostage`` with the shared-memory staging
                 compiled out (boxes and triangles are read from device
                 memory in place; same answers);
     and prints, per build, every soup batch's time and, per kernel, the
     time of the frame's largest batch and the sum over the frame's
     batches, beside the bound.

Every full build's outputs are held against the package's on every batch
(t/u/v and slots bit-equal, the first two stats columns equal); a
difference ends the run with a non-zero code.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

import torch

from royaltracer_dx_tpu_torch.ops import stream_trace as st
from royaltracer_dx_tpu_torch.utils.cuda_build import BUILD_DIR, build_library

# textual cuts applied to the baseline source: (old, new) pairs
_NOMT = [("for (int g = 0; g < G; ++g) {", "for (int g = 0; g < 0; ++g) {")]
_NOSTAGE = [
    ("for (int i = tid; i < ROWF / 4; i += R) cp_async16(dst + i, src + i);",
     "(void)dst; (void)src;"),
    ("if (tid < BOXF / 4) {", "if (false) {"),
    ("const float* bt = buf_t + st * ROWF;",
     "const float* bt = blk_tris + (size_t)wl_c[w] * ROWF;"),
    ("const float* bb = buf_b + st * BOXF;",
     "const float* bb = blk_boxes + (size_t)wl_c[w] * 6 * 128;"),
    ("bb[c * S + s] * inv[c]", "bb[c * 128 + s] * inv[c]"),
    ("bb[(3 + c) * S + s] * inv[c]", "bb[(3 + c) * 128 + s] * inv[c]"),
]

# clock reads patched into the package's source: thread 0's SM clocks,
# summed over the region's passes, replace the third stat
_T0, _T1 = "clk_acc -= clock64();\n", "clk_acc += clock64();\n"
_CLOCK_ALWAYS = [
    ("  const int tid = threadIdx.x;\n",
     "  const int tid = threadIdx.x;\n  long long clk_acc = 0;\n"),
    ("= npairs;", "= (int)clk_acc;"),
]
_CLOCK = {
    1: [("  long long clk_acc = 0;\n", "  long long clk_acc = -clock64();\n"),
        ("  if (tid == 0) {\n    out_stats",
         "  if (tid == 0) {\n    " + _T1 + "    out_stats")],
    2: [("      unsigned cand = 0u;\n", _T0 + "      unsigned cand = 0u;\n"),
        ("      // the clusters some ray of this warp wants",
         _T1 + "      // the clusters some ray of this warp wants")],
    3: [("      unsigned m = wor;\n", _T0 + "      unsigned m = wor;\n"),
        ("      // the early-exit bound for the next step",
         _T1 + "      // the early-exit bound for the next step")],
    4: [("      bound = cta_step<OCC>(", _T0 + "      bound = cta_step<OCC>("),
        ("      ++w;\n", _T1 + "      ++w;\n")],
}


def cut_source(src_path: str, tag: str, cuts) -> str:
    """Write a copy of ``src_path`` with each (old, new) applied to the one
    place ``old`` stands (or, for a compiled pattern, matches)."""
    with open(src_path) as f:
        src = f.read()
    for old, new in cuts:
        is_re = isinstance(old, re.Pattern)
        if (len(old.findall(src)) if is_re else src.count(old)) != 1:
            raise SystemExit(f"{src_path}: expected one {old!r}")
        src = old.sub(new, src) if is_re else src.replace(old, new)
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"study_{tag}.cu")
    with open(out, "w") as f:
        f.write(src)
    return out


def launch(lib, name, args, stats_cols):
    """The package's launch through another library; an earlier build
    writes ``stats_cols`` columns into the front of the stats buffer."""
    tuv, slot, stats = st._launch(name, *args, lib=lib)
    chunks = stats.shape[0]
    return tuv, slot, stats.reshape(-1)[:chunks * stats_cols].reshape(
        chunks, stats_cols)


def timed(fn, reps):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def frame_batches():
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    scene, camera = menger_scene()
    renderer = RestirRenderer(scene, camera, RenderConfig())
    renderer.render()
    real = st._launch
    batches = []

    def keep(name, *args):
        out = real(name, *args)
        batches.append((name, "frame", args, out))
        return out

    st._launch = keep
    try:
        renderer.render()
    finally:
        st._launch = real
    torch.cuda.synchronize()
    return batches


def soup_batches(blocks: int, dev):
    """Closest and any-hit batches on a random triangle soup of ``blocks``
    blocks (2,048 triangles each): 65,536 random rays, whose chunks walk
    long worklists through tiles no other chunk shares, and 262,144
    camera rays in 16 x 8 tiles (coherent chunks, early exits)."""
    from royaltracer_dx_tpu_torch.scene.procedural import random_tris

    v, idx = random_tris(blocks * st.S * st.G, seed=2)
    accel = st.build_stream_accel(torch.as_tensor(v[idx], device=dev))
    gen = torch.Generator(device=dev).manual_seed(3)
    o = torch.rand((65536, 3), generator=gen, device=dev) * 2.4 - 1.2
    d = torch.nn.functional.normalize(
        torch.randn((65536, 3), generator=gen, device=dev), dim=1)
    side = 512
    ty, tx, iy, ix = torch.meshgrid(
        torch.arange(side // 8, device=dev),
        torch.arange(side // 16, device=dev), torch.arange(8, device=dev),
        torch.arange(16, device=dev), indexing="ij")
    px = ((tx * 16 + ix + 0.5) / side * 2.0 - 1.0).reshape(-1) * 0.9
    py = ((ty * 8 + iy + 0.5) / side * 2.0 - 1.0).reshape(-1) * 0.9
    cd = torch.nn.functional.normalize(
        torch.stack([px, py, torch.full_like(px, 2.0)], dim=1), dim=1)
    co = torch.zeros_like(cd)
    co[:, 2] = -3.0
    out = []
    for tag, oo, dd, t_any in (("random", o, d, 0.5), ("camera", co, cd, 3.0)):
        for name, t_far in (("stream_closest", 1e4), ("stream_any", t_any)):
            a = (*st.prepare_stream(oo, dd, accel, 1e-4, t_far, 16),
                 accel.blk_tris, accel.blk_boxes)
            out.append((name, f"soup{blocks}-{tag}", a, st._launch(name, *a)))
    torch.cuda.synchronize()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", default="",
                    help="an earlier stream_trace.cu to time beside this one")
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    help='constants of one more build, e.g. "COOP_MAX=0"')
    ap.add_argument("--clock", action="append", type=int, default=[],
                    choices=sorted(_CLOCK), help="one more build that reads "
                    "the SM clock around region N")
    ap.add_argument("--soup", action="append", type=int, default=[],
                    help="also time a random soup of this many blocks")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default="", help="write the numbers as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stream_study needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    props = torch.cuda.get_device_properties(0)
    peak, hbm = st.card_rates(props.name, props.multi_processor_count,
                              float(card.split(",")[2].split()[0]))

    # ---- builds: (label, library, stats columns, compared with package)
    pkg = st.build_kernels()
    builds = [("package", pkg, 3, False)]
    print(f"package: {st.BUILD_INFO['resources']}", flush=True)
    for v in args.sets:
        cuts = [(re.compile(rf"(constexpr int {k} = )\d+;"), rf"\g<1>{val};")
                for k, val in (kv.split("=") for kv in v.split())]
        lib, _ = build_library(cut_source(
            st._SRC, "set_" + re.sub(r"\W", "_", v), cuts),
            signatures=st.STREAM_SIGNATURES)
        print(f"set {v}: {st.kernel_resources(lib)}", flush=True)
        builds.append((v, lib, 3, True))
    for n in args.clock:
        lib, _ = build_library(cut_source(
            st._SRC, f"clock{n}", _CLOCK_ALWAYS + _CLOCK[n]),
            signatures=st.STREAM_SIGNATURES)
        builds.append((f"clock {n}", lib, 3, True))
    base = []
    if args.baseline:
        for tag, cuts, full in (("baseline", [], True),
                                ("baseline-nomt", _NOMT, False),
                                ("baseline-nostage", _NOSTAGE, True)):
            lib, info = build_library(cut_source(args.baseline, tag, cuts),
                                      signatures=st.STREAM_SIGNATURES)
            for line in info["log"].splitlines():
                if "registers" in line:
                    print(f"{tag}: ptxas: {line.strip()}", flush=True)
            base.append((tag, lib, 2, full))
    order = base + builds + builds[:1] + base[:1]

    # ---- the batches and what they need
    batches = frame_batches()
    for blocks in args.soup:
        batches += soup_batches(blocks, torch.device("cuda"))
    report = dict(card=card, batches=[], builds={})
    for i, (name, tag, a, out) in enumerate(batches):
        rows, wl, went, cnt = a[:4]
        work = st.stream_work(*a, out[2])
        chunks = cnt.shape[0]
        live = max(int((cnt > 0).sum()), 1)
        work.update(
            st.bound_ms(work, peak, hbm), name=name, tag=tag,
            lanes=rows.shape[0], chunks=chunks, live_chunks=live,
            live_lanes=int(((rows[:, 8] > 0.5)
                            & (rows[:, 7] > rows[:, 6])).sum()))
        report["batches"].append(work)
        print(f"batch {i} {tag} {name} {rows.shape[0]} lanes, wb "
              f"{wl.shape[1]}, triangle rows {a[4].numel() * 4 / 1e6:.1f} MB"
              f": empty-worklist chunks {1.0 - live / chunks:.4f}; per live "
              f"chunk: blocks {work['blocks_visited'] / live:.3f}, hot "
              f"clusters {work['clusters_tested'] / live:.3f}, pairs "
              f"{work['pairs'] / live:.2f}; valid lanes "
              f"{work['valid_lanes'] / rows.shape[0]:.4f}, live lanes "
              f"{work['live_lanes'] / rows.shape[0]:.4f}; bound "
              f"{work['bound_ms']:.4f} ms (bytes {work['bytes_ms']:.4f}, "
              f"operations {work['ops_ms']:.4f})", flush=True)

    # ---- timings
    bad = 0
    for turn, (label, lib, cols, compare) in enumerate(order):
        per = {k: dict(frame_ms=0.0, largest_ms=0.0, largest_lanes=0,
                       blocks_visited=0, batch_ms=[]) for k in st.LAUNCHES}
        for (name, tag, a, ref), work in zip(batches, report["batches"]):
            ms, out = timed(lambda: launch(lib, name, a, cols), args.reps)
            p = per[name]
            p["batch_ms"].append(ms)
            if tag == "frame":
                p["frame_ms"] += ms
                p["blocks_visited"] += int(out[2][:, 0].sum())
                if a[0].shape[0] > p["largest_lanes"]:
                    p["largest_lanes"], p["largest_ms"] = a[0].shape[0], ms
            else:
                print(f"turn {turn} {label:>18} {name:>14} {tag}: {ms:.3f} "
                      f"ms (bound {work['bound_ms']:.3f} ms)", flush=True)
            if label.startswith("clock"):
                clk = out[2][:, 2].double()
                live = a[3] > 0
                q = torch.quantile(clk[live], torch.tensor(
                    [0.5, 0.9, 0.99, 1.0], dtype=torch.float64,
                    device=clk.device)).tolist()
                print(f"  {label} {tag} {name} {a[0].shape[0]} lanes: SM "
                      f"clocks per chunk: empty worklist mean "
                      f"{float(clk[~live].mean()):.0f}; live mean "
                      f"{float(clk[live].mean()):.0f}, median, p90, p99, max "
                      f"{[round(x) for x in q]}; sum over chunks "
                      f"{float(clk.sum()):.4g} (kernel {ms:.3f} ms)",
                      flush=True)
            if compare:
                same = (torch.equal(out[0], ref[0])
                        and torch.equal(out[1], ref[1])
                        and torch.equal(out[2][:, :2], ref[2][:, :2]))
                if not same:
                    bad += 1
                    print(f"{label}: {name} on {tag} {a[0].shape[0]} lanes "
                          "differs from the package's kernel", flush=True)
        report["builds"].setdefault(label, []).append(per)
        for name, p in per.items():
            bound = sum(b["bound_ms"] for b in report["batches"]
                        if b["name"] == name and b["tag"] == "frame")
            print(f"turn {turn} {label:>18} {name:>14}: largest batch "
                  f"{p['largest_lanes']} lanes {p['largest_ms']:.3f} ms; "
                  f"frame {p['frame_ms']:.3f} ms (bound {bound:.3f} ms); "
                  f"blocks visited {p['blocks_visited']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f)
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
