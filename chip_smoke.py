"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--profile]

Phases (any failure exits non-zero and prints no result line):

  1. device   name and power limit from nvidia-smi; build the kernels of
              royaltracer_dx_tpu_torch/csrc/ (stream_trace.cu,
              bvh_traverse.cu, cluster_traverse.cu, mxu_trace.cu: one nvcc
              a source, started together) and print their resources
  2. kernels  each CUDA kernel against its plain PyTorch version on the
              same inputs on the card -- (a) the menger accel with 1M
              random rays, closest, and any-hit with half the lanes
              masked; (b) a 262,144-triangle soup (128 blocks) with 64k
              random rays (long worklists) and 64k coherent camera rays
              (early exits) -- and against brute force on 64k rays; (c)
              sparse and ragged batches on the menger accel: 1 valid
              lane in 16, one valid lane per chunk, chunks with an empty
              worklist between live ones, 16,201 chunks, a single chunk,
              and a worklist wider than the accel has blocks.
              Slots and occlusion must be equal (exact-t ties are
              counted), t/u/v and the three per-chunk stats bit-equal.
  3. frames   RestirRenderer on the menger scene at 1920x1080 with the
              default RenderConfig: one warm-up frame and 4 timed frames,
              with the launch counters set to 0 just before and read just
              after; then one more frame whose kernel launches are timed
              with CUDA events, with each batch's work (visited blocks,
              hot clusters, candidate pairs, valid lanes) and bound
              printed.  Each kernel's output on the largest batch
              that frame gave it is held against its plain version on the
              same inputs, and both are timed there.  Last, two 96x54
              menger frames on the card against the same frames on the
              CPU (the plain versions, which the CPU tests hold against
              the JAX package).
  4. scenes   the CLI's large scenes at 1920x1080, each path with the
              launch counters set to 0 just before it and read just
              after: (a) sponza (the generated 265k-triangle atrium, 256
              blocks) through cli.main for 3 frames with
              --snapshot-every, --checkpoint and --aov all, then a second
              cli.main call that resumes from the checkpoint for 1 frame
              (the frame counter must continue); one more frame with
              timed launches and timed prepare_stream calls, and each
              kernel against its plain version on that frame's largest
              batch; (b) dragon (871,200 triangles, 512 blocks) through
              cli.main --animate for 3 frames, each with a refit update()
              on the card, then stream_closest against brute force on
              65,536 of a frame's rays and both kernels against their
              plain versions on the refitted accel; (c) terrain: the
              heightfield(708) accel (999,698 triangles) built on the
              card, closest-hit and any-hit rates on 512x512 swizzled
              camera rays and on the shadow batch of bench.py:491-511;
              (d) render_many(3) against 3 render() calls on a 256x256
              menger frame, bit for bit.
  5. oracles  the megakernel Renderer and the DiOracle, each path with
              the launch counters set to 0 just before it and read just
              after: (a) sponza at 1920x1080 through cli.main
              --renderer megakernel (5 bounces) for 3 frames with
              --checkpoint, then 1 resumed frame; one more frame with
              timed launches, one line per batch (the walk per live
              chunk, lanes whose shadow t_min is NaN), each kernel
              against its plain version on that frame's largest batch,
              and the any-hit walk beside phase 4's ReSTIR sponza frame;
              (b) bench.py's cornell_megakernel row (512x512, 5
              bounces): frame ms and Mrays/s; (c) Renderer.render_many(3)
              against 3 render() calls on a 256x256 menger frame, bit for
              bit, and DiOracle.render_many against render() calls; (d)
              the accuracy rows of bench.py:400-440, time-capped above
              the CPU harness's frame counts: the DiOracle against DI-only
              ReSTIR at 64x64 (bars 0.97 < rel_mean < 1.03, rmse < 0.05)
              and the quirk-free 5-bounce megakernel against ReSTIR at
              96x96 (0.94 < rel_mean < 1.04, rmse < 0.08), printed beside
              BENCH_r05.json's rows for the JAX package; (e) two 96x54
              megakernel menger frames on the card against the CPU.
  6. sharding and LBVH: (a) the 1920x1080 menger frame (phase 3's main
              path) on 1, 2 and 4 bands of one card -- RestirRenderer and
              ShardedRestirRenderer(devices=[cuda:0] * n) -- 3 frames
              with a static camera, then a frame after a camera move
              within the 20-row halo and one after a move beyond it; each
              image against one device's (rtol=1e-5, atol=1e-6 for the
              static and the within-halo frames), frame times, stream
              launches per frame and peak memory, and a checkpoint save
              and load of the 2-band renderer; (b) sponza through cli.main
              --bvh (2 ReSTIR frames) and --bvh --renderer megakernel (1
              frame), with the LBVH launch counters set to 0 just before
              each and read just after; every bvh_closest / bvh_any
              launch held against its plain version on a fixed sample of
              65,536 of its lanes (t, u, v, triangle ids and occlusion
              bit-equal; for closest also the node, triangle and
              root-transition stats of one more launch with stats on that
              sample); then one more frame of each with every batch's
              ms, bound, live share and walk (node and triangle tests a
              lane, root-scan slab tests a live closest lane beside the
              ones a scan needs, which the bound counts: the kernel's must
              be at least as many), the stream
              kernels timed on the megakernel's batches beside them, and
              each kernel alone, its bound and its plain version on the
              ReSTIR frame's largest batch, held against the plain
              version on two differently strided samples; (c) the
              terrain's LBVH (999,698 triangles): build time, closest and
              any-hit Mrays/s beside phase 4's stream kernels; (d) dragon
              through cli.main --bvh --animate: one refit update() and
              one frame, its launches checked as in (b).
  7. cluster traversal: (a) cluster_mask, cluster_closest and
              cluster_any against their plain versions on 512 whole tiles
              of each batch (a lane sample would break the tiles): menger
              1920x1080 camera rays and 2^20 random rays at the default
              128 rays a tile and 128 triangles a cluster, 100,003 random
              rays (the last tiles, padding included) and tiles of 96,
              cluster_study.pack_case's adversarial tiles (every packing
              width of live rays from 0 to the tile, dead rays whose
              t_max decides the bound, a NaN t_max, tiles without a live
              ray that overlap boxes, exact-t ties between twin
              triangles) at tiles and clusters of 128 / 128, 96 / 100,
              128 / 1 and 1024 / 1024, cluster_mask alone on
              cluster_study.mask_case's phase A tiles (every live count,
              dead rays of every kind, equal bounds, -0.0 entries, zero,
              tiny, huge and non-finite components, non-finite boxes) at
              tiles of 128, 96 and 1024 against 38, 2,073, 1 and 38
              boxes, and sponza's 2,073,600-lane primary batch (each
              kernel timed on the whole batch beside its bound); mask,
              entry, t/u/v, triangle ids, occlusion, steps and tests
              bit-equal, and the card's cluster build equal to the CPU's;
              cluster_mask's resources at sponza's and menger's shapes;
              (b) the main path
              of this slice: the 1920x1080 menger ReSTIR frame with
              traversal="cluster", one warm-up and 3 timed frames with
              every count set to 0 just before and read just after (each
              cluster kernel launched, no stream or LBVH kernel, no plain
              version), then one frame with every launch timed beside its
              bound, its no-FMA floor and the ms a step of the batch's
              longest tile, and each kernel on its largest batch timed
              and held against the plain version on 512 tiles; (c)
              bench.py's
              cornell_megakernel row (512x512) through cli.main
              --renderer megakernel --traversal cluster, and a 1920x1080
              menger DiOracle frame under it; (d) the stream kernels on a
              morton and a median_host accel of sponza (130 blocks, not a
              power of two) against their plain versions.  No sponza
              ReSTIR frame under "cluster": its 18.7M-segment pass-3
              batch would take minutes.
  8. mxu      the matmul form of Moller-Trumbore (ops/mxu_trace.py) on
              (a) the menger scene's 4,802 triangles with its 1920x1080
              camera rays and a shadow batch from their hits toward the
              light (every third lane masked), and (b) the 32-triangle
              Cornell box at 512x512, each path with every count set to
              0 just before and read just after and the plain versions
              refused (both kernels launched, nothing else); on the
              whole of each batch the kernels' t, u, v, triangle ids,
              occlusion and tests bit-equal to the plain versions, and on
              a 65,536-lane sample held to tests/test_mxu_trace.py's bars
              against brute force; the share of pairs the kernels'
              tensor-core filter kept (their counted builds), its
              margin, and the kernels' resources; each kernel, the
              stream and LBVH kernels on the same rays and torch.matmul
              of the [4096, 10] @ [10, 4Tp] product alone (TF32 off)
              timed on the whole batches beside the tensor-core and the
              FP32-only bound (mxu_work), the three kernels' device time
              alone also from torch.profiler; (c) tools/mxu_cases.py's
              adversarial inputs, kernel against plain bit for bit; the
              TF32 HMMA instructions in the library's SASS; one
              function of each AoS family (math3d, rng, bsdf, reservoir,
              light_sampling, restir) and coherence_order on the card.
  9. the {"kernels": [...]} line (nine kernels), then
 10. the {"ok": true, ...} line.

--out DIR writes the rendered images there as PNGs (else the scenes
phase writes its CLI outputs into a temporary directory).  --profile runs
one more menger frame under torch.profiler and prints the device's busy
time and its time by kernel name (with --out, also the gzipped Chrome
trace), and one more sponza and dragon frame each in phase 4 and one
more megakernel sponza frame in phase 5.  The
script imports nothing of JAX: it runs the port alone.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "royaltracer_dx_tpu_torch/csrc/stream_trace.cu"
REPLACES = "royaltracer_dx_tpu/ops/stream_trace.py:514"
KERNELS = {
    "stream_closest": "_make_kernel(occlusion=False) via closest_hit_stream",
    "stream_any": "_make_kernel(occlusion=True) via any_hit_stream",
}
# --profile: device time grouped by kernel-name substrings, first match
PROFILE_KINDS = [
    ("stream kernels", ("stream_kernel",)),
    ("gathers and indexing", ("gather", "index", "Index")),
    ("integer elementwise (TEA RNG, ids)", ("<long", "<int", "Bitwise",
                                            "shift")),
    ("copies, cat, fills", ("Copy", "copy", "Memcpy", "Memset", "fill")),
    ("reductions", ("reduce",)),
    ("sorts", ("sort", "Sort", "radix")),
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 1) -> tuple[float, object]:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


# ------------------------------ phase 2 ----------------------------------


def mismatch(name, k_out, p_out, lanes):
    """Kernel outputs vs plain-version outputs on the same input: slots
    (occlusion) equal except exact-t ties, t/u/v and stats bit-equal.
    Fails on any difference; returns the counts."""
    k_tuv, k_slot, k_stats = k_out
    p_tuv, p_slot, p_stats = p_out
    occ = name == "stream_any"
    slot_diff = k_slot != p_slot
    tie = torch.zeros_like(slot_diff)
    if not occ:
        tie = slot_diff & (k_tuv[:, 0] == p_tuv[:, 0])
    bad_slot = int((slot_diff & ~tie).sum())
    neq = (k_tuv != p_tuv)[~tie]
    diff = (k_tuv - p_tuv).abs()[~tie][neq]
    max_err = float(diff.max()) if diff.numel() else 0.0
    bad_tuv = int(neq.any(dim=1).sum())
    bad_stats = int((k_stats != p_stats).any(dim=1).sum())
    if bad_slot or bad_tuv or bad_stats:
        fail(f"{name}: {bad_slot} slot, {bad_tuv} t/u/v (largest difference "
             f"{max_err!r}), {bad_stats} stats lanes differ from the plain "
             "version")
    return dict(slot=bad_slot, tuv=bad_tuv, ties=int(tie.sum()),
                max_abs_err=max_err, lanes=lanes, stats=bad_stats)


def compare_kernel(name, args):
    """Launch the kernel and run its plain version on the same inputs
    (rows, wl, went, cnt, blk_tris, blk_boxes).  Returns (mismatch counts,
    kernel outputs)."""
    from royaltracer_dx_tpu_torch.ops import stream_trace as st

    occ = name == "stream_any"
    k_out = (st.stream_any if occ else st.stream_closest)(*args)
    torch.cuda.synchronize()
    p_out = st._stream_plain(*args, occ)
    return mismatch(name, k_out, p_out, int(args[0].shape[0])), k_out


def random_rays(n, lo, hi, seed, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.as_tensor(o, device=device), torch.as_tensor(d, device=device)


def camera_rays(side, dist, device):
    """Pinhole rays from (0, 0, -dist) through a side x side grid that
    spans [-0.9, 0.9]^2 at z = -1, ordered in 16 x 8 tiles so that each
    128-ray chunk is a coherent bundle (as the renderer's rays are)."""
    ty, tx, iy, ix = np.meshgrid(np.arange(side // 8), np.arange(side // 16),
                                 np.arange(8), np.arange(16), indexing="ij")
    px = ((tx * 16 + ix + 0.5) / side * 2.0 - 1.0) * 0.9
    py = ((ty * 8 + iy + 0.5) / side * 2.0 - 1.0) * 0.9
    d = np.stack([px.ravel(), py.ravel(),
                  np.full(px.size, dist - 1.0)], 1).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.zeros_like(d)
    o[:, 2] = -dist
    return torch.as_tensor(o, device=device), torch.as_tensor(d, device=device)


def kernel_case(label, accel, tri_verts, o, d, t_max_any, mismatches,
                early_exit=False):
    """Closest and masked any-hit through both kernels vs their plain
    versions, and vs brute force on the first 64k rays.  ``early_exit``:
    the rays are coherent bundles, and some chunk must stop before the
    end of its worklist in each mode."""
    from royaltracer_dx_tpu_torch.ops import intersect as it
    from royaltracer_dx_tpu_torch.ops import stream_trace as st

    n = o.shape[0]
    rows, wl, went, cnt = st.prepare_stream(o, d, accel, 1e-4, 1e4, 16)
    mm, (tuv, slot, stats) = compare_kernel(
        "stream_closest", (rows, wl, went, cnt, accel.blk_tris,
                           accel.blk_boxes))
    mismatches.setdefault("stream_closest", []).append(dict(mm, case=label))
    exits = int((stats[:, 0] < cnt).sum())
    print(f"  {label} closest: {n} rays, {mm['ties']} exact-t ties, blocks "
          f"visited mean {float(stats[:, 0].float().mean()):.2f} of worklist "
          f"mean {float(cnt.float().mean()):.2f}, clusters tested "
          f"{int(stats[:, 1].sum())}, early exits {exits} of "
          f"{cnt.shape[0]} chunks", flush=True)
    half = torch.arange(n, device=o.device) % 2 == 0
    t_max = torch.where(half, t_max_any, -1.0)
    rows_a, wl_a, went_a, cnt_a = st.prepare_stream(o, d, accel, 1e-4, t_max,
                                                    16)
    mm_a, (_, slot_a, stats_a) = compare_kernel(
        "stream_any", (rows_a, wl_a, went_a, cnt_a, accel.blk_tris,
                       accel.blk_boxes))
    mismatches.setdefault("stream_any", []).append(dict(mm_a, case=label))
    exits_a = int((stats_a[:, 0] < cnt_a).sum())
    if early_exit and not (exits and exits_a):
        fail(f"{label}: coherent rays took no early exit (closest {exits}, "
             f"any-hit {exits_a} chunks)")
    occ = (slot_a[:n] >= 0) & (rows_a[:n, 7] > rows_a[:n, 6])
    if occ[~half].any():
        fail(f"{label}: a masked any-hit lane reads occluded")
    # brute force on the first 64k rays: the same t and triangles (off
    # exact-t ties) and the same occlusion; a hit within an ulp of a
    # cluster box's face may fall to the slab test's rounding, so a few
    # lanes in 10^4 may differ and are printed
    m = min(n, 65536)
    bh = it.closest_hit_brute(o[:m], d[:m], tri_verts, 1e-4, 1e4)
    found = slot[:m] >= 0
    k_t = torch.where(found, tuv[:m, 0], it.INF)
    k_tri = torch.where(found, accel.perm[slot[:m].clamp_min(0).long()].long(),
                        0)
    t_diff = int((k_t != bh.t).sum())
    tri_ties = int(((k_tri != bh.tri) & found & (k_t == bh.t)).sum())
    bo = it.any_hit_brute(o[:m], d[:m], tri_verts, 1e-4, t_max[:m])
    occ_diff = int((occ[:m] != bo).sum())
    print(f"  {label} any-hit: {int(occ.sum())} of {n} occluded, early exits "
          f"{exits_a} of {cnt_a.shape[0]} chunks; vs brute on {m} rays: "
          f"{t_diff} t and {occ_diff} occlusion lanes differ, {tri_ties} "
          "triangle ties", flush=True)
    if t_diff + occ_diff > m // 10000:
        fail(f"{label}: the kernels differ from brute force on "
             f"{t_diff + occ_diff} of {m} lanes")


def masked_case(label, accel, tri_verts, o, d, keep, mismatches, wb=16,
                empty_chunks=None):
    """Both kernels vs their plain versions on a batch where only the
    lanes of ``keep`` are valid (the others carry valid 0 and t_max -1)
    and the chunks of ``empty_chunks`` have an empty worklist; the kept
    lanes of live chunks are also held against brute force (first 64k)."""
    from royaltracer_dx_tpu_torch.ops import intersect as it
    from royaltracer_dx_tpu_torch.ops import stream_trace as st

    n = o.shape[0]
    live = keep.clone()
    outs = {}
    for name, t_far in (("stream_closest", 1e4), ("stream_any", 1.0)):
        t_max = torch.where(keep, t_far, -1.0)
        rows, wl, went, cnt = st.prepare_stream(o, d, accel, 1e-4, t_max, wb)
        rows[:n, 8] = keep.float()
        if empty_chunks is not None:
            cnt[empty_chunks] = 0
            live = keep & ~empty_chunks.repeat_interleave(
                st.RAYS_PER_CHUNK)[:n]
        mm, out = compare_kernel(name, (rows, wl, went, cnt, accel.blk_tris,
                                        accel.blk_boxes))
        mismatches[name].append(dict(mm, case=label))
        # a dead lane (t_max < t_min) carries the any-hit t=0 encoding;
        # liveness masks it, as any_hit_stream does
        found = (out[1] >= 0) & (rows[:, 7] > rows[:, 6])
        outs[name] = (out[0], found, out[2])
        if bool(found[:n][~live].any()):
            fail(f"{label}: {name} reports a hit on a masked lane")
    m = min(n, 65536)
    tuv, slot, stats = outs["stream_closest"]     # slot: lanes with a hit
    lv = live[:m]
    bh = it.closest_hit_brute(o[:m], d[:m], tri_verts, 1e-4, 1e4)
    k_t = torch.where(slot[:m], tuv[:m, 0], it.INF)
    t_diff = int((k_t != bh.t)[lv].sum())
    bo = it.any_hit_brute(o[:m], d[:m], tri_verts, 1e-4,
                          torch.full((m,), 1.0, device=o.device))
    occ_diff = int((outs["stream_any"][1][:m] != bo)[lv].sum())
    print(f"  {label}: {n} lanes, {int(live.sum())} live, {cnt.shape[0]} "
          f"chunks ({int((cnt == 0).sum())} with an empty worklist), wb "
          f"{wl.shape[1]}; closest: {int(slot.sum())} hits, "
          f"{int(stats[:, 2].sum())} candidate pairs; vs brute on "
          f"{int(lv.sum())} live lanes: {t_diff} t and {occ_diff} occlusion "
          "lanes differ", flush=True)
    if t_diff + occ_diff > int(lv.sum()) // 10000:
        fail(f"{label}: the kernels differ from brute force")


def phase_kernels(dev, menger_arrays):
    from royaltracer_dx_tpu_torch.ops import stream_trace as st
    from royaltracer_dx_tpu_torch.scene.procedural import random_tris

    mismatches: dict = {}
    acc = menger_arrays.stream
    o, d = random_rays(1 << 20, -0.5, 1.5, 1, dev)
    kernel_case("menger", acc, menger_arrays.tri_verts, o, d, 1.0, mismatches)
    v, idx = random_tris(262144, seed=2)
    tris = torch.as_tensor(v[idx], device=dev)
    soup = st.build_stream_accel(tris)
    if soup.num_blocks != 128:
        fail(f"soup accel has {soup.num_blocks} blocks, expected 128")
    o, d = random_rays(65536, -1.2, 1.2, 3, dev)
    kernel_case("soup262k", soup, tris, o, d, 0.5, mismatches)
    o, d = camera_rays(256, 3.0, dev)
    kernel_case("soup262k-camera", soup, tris, o, d, 3.0, mismatches,
                early_exit=True)
    # sparse and ragged batches on the menger accel
    mt = menger_arrays.tri_verts
    n = 1 << 18
    o, d = random_rays(n, -0.5, 1.5, 5, dev)
    lane = torch.arange(n, device=dev)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    masked_case("menger-1-in-16", acc, mt, o, d, lane % 16 == 0, mismatches)
    masked_case("menger-1-per-chunk", acc, mt, o, d,
                lane % st.RAYS_PER_CHUNK == 77, mismatches)
    masked_case("menger-empty-worklists", acc, mt, o, d, every, mismatches,
                empty_chunks=torch.arange(n // st.RAYS_PER_CHUNK,
                                          device=dev) % 2 == 1)
    masked_case("menger-wb64", acc, mt, o, d, every, mismatches, wb=64)
    o, d = random_rays(16201 * st.RAYS_PER_CHUNK, -0.5, 1.5, 6, dev)
    masked_case("menger-16201-chunks", acc, mt, o, d,
                torch.ones(o.shape[0], dtype=torch.bool, device=dev),
                mismatches)
    masked_case("menger-1-chunk", acc, mt, o[:100], d[:100], every[:100],
                mismatches)
    return mismatches


# ------------------------------ phase 3 ----------------------------------


def on_card(r) -> list:
    """Names of renderer state tensors (a RestirRenderer's or a megakernel
    Renderer's) that do not live on the card."""
    items = {"fb.accum": r.fb.accum, "fb.count": r.fb.count,
             "prev_view": r._prev_view,
             "tri_verts": r.scene_arrays.tri_verts,
             "blk_tris": r.scene_arrays.stream.blk_tris}
    for name in ("last_di", "last_gi", "last_sdata"):
        items.update({f"{name}.{k}": v
                      for k, v in getattr(r, name, {}).items()})
    if hasattr(r, "l1"):
        items.update(l1=r.l1, prev_proj=r._prev_proj)
    return [k for k, v in items.items()
            if not (torch.is_tensor(v) and v.is_cuda)]


def phase_frames(renderer):
    from royaltracer_dx_tpu_torch.ops import stream_trace as st

    frame_ms = []
    reset_launches()
    prev = dict(st.LAUNCHES)
    for i in range(5):
        ms, _ = cuda_ms(renderer.render)
        frame_ms.append(ms)
        now = dict(st.LAUNCHES)
        grew = {k: now[k] - prev[k] for k in now}
        if not all(v > 0 for v in grew.values()):
            fail(f"frame {i}: a stream kernel was not launched ({grew})")
        prev = now
        print(f"  frame {i}{' (warm-up)' if i == 0 else ''}: {ms:.3f} ms, "
              f"launches {grew}", flush=True)
    return frame_ms, dict(st.LAUNCHES)


def profile_frame(renderer):
    """One more frame with every kernel launch timed by CUDA events; keeps
    each kernel's largest batch for the timing of kernel and plain."""
    from royaltracer_dx_tpu_torch.ops import stream_trace as st

    real_launch = st._launch
    real_prepare = st.prepare_stream
    events: list = []
    largest: dict = {}
    prepares: list = []

    def timed_prepare(origins, dirs, accel, t_min, t_max, wb):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_prepare(origins, dirs, accel, t_min, t_max, wb)
        end.record()
        end.synchronize()
        prepares.append(dict(lanes=int(out[0].shape[0]),
                             ms=start.elapsed_time(end),
                             peak_gib=(torch.cuda.max_memory_allocated()
                                       - base) / 2**30))
        return out

    def timed_launch(name, rows, wl, went, cnt, blk_tris, blk_boxes):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_launch(name, rows, wl, went, cnt, blk_tris, blk_boxes)
        end.record()
        work = st.stream_work(rows, wl, went, cnt, blk_tris, blk_boxes,
                              out[2])
        live = cnt > 0
        work.update(
            chunks=int(cnt.shape[0]), live_chunks=int(live.sum()),
            live_lanes=int(((rows[:, 8] > 0.5)
                            & (rows[:, 7] > rows[:, 6])).sum()),
            nan_tmin_lanes=int(torch.isnan(rows[:, 6]).sum()))
        events.append((name, rows.shape[0], start, end, work))
        if rows.shape[0] > largest.get(name, (0,))[0]:
            largest[name] = (rows.shape[0], (rows, wl, went, cnt, blk_tris,
                                             blk_boxes), out)
        return out

    st._launch = timed_launch
    st.prepare_stream = timed_prepare
    try:
        ms, _ = cuda_ms(renderer.render)
    finally:
        st._launch = real_launch
        st.prepare_stream = real_prepare
    per_kernel = {k: dict(frame_ms=0.0, frame_launches=0, batches=[])
                  for k in KERNELS}
    for name, lanes, start, end, work in events:
        pk = per_kernel[name]
        pk["frame_ms"] += start.elapsed_time(end)
        pk["frame_launches"] += 1
        pk["batches"].append(dict(work, lanes=lanes,
                                  ms=start.elapsed_time(end)))
    per_kernel["prepare_stream"] = prepares
    return ms, per_kernel, largest


def print_batches(batches, rates) -> float:
    """One line per launch of a frame: time, bound and the walk per live
    chunk.  Returns the frame's summed bound."""
    from royaltracer_dx_tpu_torch.ops import stream_trace as st

    frame_bound = 0.0
    for b in batches:
        b.update(st.bound_ms(b, *rates))
        frame_bound += b["bound_ms"]
        live = max(b["live_chunks"], 1)
        print(f"    batch {b['lanes']} lanes: {b['ms']:.3f} ms, bound "
              f"{b['bound_ms']:.3f} ms ({b['bound_by']}); chunks with an "
              f"empty worklist {1.0 - b['live_chunks'] / b['chunks']:.4f}"
              f"; per live chunk: blocks visited "
              f"{b['blocks_visited'] / live:.3f}, hot clusters "
              f"{b['clusters_tested'] / live:.3f}, candidate pairs "
              f"{b['pairs'] / live:.2f}; valid lanes "
              f"{b['valid_lanes'] / b['lanes']:.4f}, live lanes "
              f"{b['live_lanes'] / b['lanes']:.4f}, NaN t_min lanes "
              f"{b['nan_tmin_lanes']}", flush=True)
    return frame_bound


def small_frames_agree(devices=("cuda", "cpu"), size=(96, 54), frames=2,
                       megakernel=False):
    """The same small menger frames on the card and on the CPU, where
    every kernel wrapper runs its plain version and the passes are held
    against the JAX package by tests/test_torch_*.py.  Tolerance, as in
    those tests: >= 99% of pixels within 1e-3 and per-channel means within
    0.5%, because an ulp of difference in cos/sin/sqrt between the two
    devices can flip an RIS pick.  ``megakernel``: the megakernel Renderer
    (5 bounces) instead of the RestirRenderer.  Returns (pixel share, mean
    deviation)."""
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.render.renderer import Renderer
    from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    cls = Renderer if megakernel else RestirRenderer
    imgs = []
    for dev in devices:
        scene, camera = menger_scene()
        r = cls(scene, camera, RenderConfig(width=size[0], height=size[1],
                                            max_bounces=5), device=dev)
        for _ in range(frames):
            r.render()
        imgs.append(r.radiance())
    if not all(np.isfinite(x).all() and x.mean() > 0.0 for x in imgs):
        fail("small frames: non-finite or black radiance")
    a, b = imgs
    share = float((np.abs(a - b) <= 1e-3 * np.maximum(1.0, np.abs(b)))
                  .all(axis=-1).mean())
    ma, mb = a.reshape(-1, 3).mean(0), b.reshape(-1, 3).mean(0)
    dev_mean = float((np.abs(ma - mb) / np.abs(mb)).max())
    print(f"  {size[0]}x{size[1]} menger {cls.__name__}, {frames} frames, "
          f"{devices[0]} vs "
          f"{devices[1]}: {share:.4f} of pixels within 1e-3, channel means "
          f"within {dev_mean:.2e}", flush=True)
    if share < 0.99 or dev_mean > 5e-3:
        fail("small frames on the card disagree with the CPU path")
    return share, dev_mean


def device_profile(renderer, out_dir, tag="frame_trace"):
    """One more frame under torch.profiler: the device's busy time (the
    union of its kernel and copy intervals), the frame's host wall time,
    and the device time by kernel name.  The profiler's own host cost
    lengthens the wall time, so the idle share it gives is an upper
    bound.  Writes the gzipped Chrome trace into ``out_dir`` if given."""
    import gzip
    import shutil

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        renderer.render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ev = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda x: x[0])
    if not dev_ev:
        print("  profiled frame: the profiler recorded no device events; "
              "device busy share not measured", flush=True)
        return None
    busy_us, cur_s, cur_e = 0.0, dev_ev[0][0], dev_ev[0][1]
    by_name: dict = {}
    for s, e, name in dev_ev:
        by_name.setdefault(name, [0.0, 0])
        by_name[name][0] += (e - s) / 1e3
        by_name[name][1] += 1
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    busy_ms = busy_us / 1e3
    print(f"  profiled frame (torch.profiler): host wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / wall_ms:.4f}, {len(dev_ev)} device events",
          flush=True)
    by_kind: dict = {}
    for name, (ms, n) in by_name.items():
        kind = next((k for k, keys in PROFILE_KINDS if any(
            key in name for key in keys)), "float elementwise and other")
        by_kind.setdefault(kind, [0.0, 0])
        by_kind[kind][0] += ms
        by_kind[kind][1] += n
    for kind, (ms, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"    {ms:10.3f} ms {n:6d}x  {kind}", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    for name, (ms, n) in top[:20]:
        print(f"    {ms:10.3f} ms {n:6d}x  {name[:110]}", flush=True)
    if out_dir:
        raw = os.path.join(out_dir, f"{tag}.json")
        prof.export_chrome_trace(raw)
        with open(raw, "rb") as src, gzip.open(raw + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.remove(raw)
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, events=len(dev_ev),
                kinds={k: v[0] for k, v in by_kind.items()})


# ------------------------------ phase 4 ----------------------------------


def reset_launches():
    from royaltracer_dx_tpu_torch.ops import stream_trace as st

    for k in st.LAUNCHES:
        st.LAUNCHES[k] = 0


def read_launches(label):
    """The launch counts of the path just driven; fails unless every
    kernel was launched in it."""
    from royaltracer_dx_tpu_torch.ops import stream_trace as st

    got = dict(st.LAUNCHES)
    if not all(v > 0 for v in got.values()):
        fail(f"{label}: a stream kernel was not launched ({got})")
    return got


def kernel_vs_plain(label, name, call, out, rates, mismatches):
    """One kernel's output on a batch against its plain version on the
    same inputs (bit-equal, as in phase 3), and the times of both and the
    bound.  Returns the entry of the kernels line for this scene."""
    from royaltracer_dx_tpu_torch.ops import stream_trace as st

    occ = name == "stream_any"
    kern = st.stream_any if occ else st.stream_closest
    plain_ms, p_out = cuda_ms(lambda: st._stream_plain(*call, occ))
    mm = mismatch(name, out, p_out, int(call[0].shape[0]))
    mismatches[name].append(dict(mm, case=label))
    cuda_ms(lambda: kern(*call))                           # warm
    ms, _ = cuda_ms(lambda: kern(*call), reps=5)
    work = st.stream_work(*call, out[2])
    work["blocks_per_live_chunk"] = (work["blocks_visited"]
                                     / max(int((call[3] > 0).sum()), 1))
    bound = st.bound_ms(work, *rates)
    print(f"  {label} {name}: largest batch {mm['lanes']} lanes, equal to "
          f"the plain version ({mm['ties']} exact-t ties); kernel {ms:.3f} "
          f"ms, plain {plain_ms:.3f} ms, bound {bound['bound_ms']:.3f} ms "
          f"({bound['bound_by']}: bytes {bound['bytes_ms']:.3f} ms, "
          f"operations {bound['ops_ms']:.3f} ms), nofma floor "
          f"{bound['nofma_floor_ms']:.3f} ms; {work}", flush=True)
    return dict(lanes=mm["lanes"], ms=ms, plain_ms=plain_ms,
                max_abs_err=mm["max_abs_err"], **bound, work=work)


def scene_frame(label, renderer, rates, mismatches, profile_dir=None,
                batches=False):
    """One more frame of ``renderer`` with timed launches and timed
    prepare_stream calls; each kernel against its plain version on that
    frame's largest batch.  With ``profile_dir`` (None: no profile; "":
    no trace file) first one frame under torch.profiler; with ``batches``
    one line per launch.  Returns (per-kernel entries, frame info,
    largest calls)."""
    profile = None
    if profile_dir is not None:
        print(f"  {label} profiled frame:", flush=True)
        profile = device_profile(renderer, profile_dir, f"{label}_trace")
    prof_ms, per_kernel, largest = profile_frame(renderer)
    prep = per_kernel.pop("prepare_stream")
    big = max(prep, key=lambda x: x["lanes"])
    print(f"  {label} frame with timed launches: {prof_ms:.3f} ms; "
          f"prepare_stream: {len(prep)} calls, {sum(x['ms'] for x in prep):.3f}"
          f" ms in all; on the largest batch ({big['lanes']} lanes) "
          f"{big['ms']:.3f} ms and {big['peak_gib']:.3f} GiB of peak memory "
          "above what was allocated before it", flush=True)
    from royaltracer_dx_tpu_torch.ops import stream_trace as st

    entries = {}
    for name in KERNELS:
        pk = per_kernel[name]
        if batches:
            print(f"  {label} {name} batches:", flush=True)
            frame_bound = print_batches(pk["batches"], rates)
        else:
            frame_bound = sum(st.bound_ms(b, *rates)["bound_ms"]
                              for b in pk["batches"])
        print(f"  {label} {name}: {pk['frame_launches']} launches, "
              f"{pk['frame_ms']:.3f} ms per frame (bound {frame_bound:.3f} "
              "ms)", flush=True)
        _, call, out = largest[name]
        e = kernel_vs_plain(label, name, call, out, rates, mismatches)
        e.update(frame_ms=pk["frame_ms"], frame_launches=pk["frame_launches"],
                 frame_bound_ms=frame_bound,
                 frame_blocks_per_live_chunk=sum(
                     b["blocks_visited"] for b in pk["batches"])
                 / max(sum(b["live_chunks"] for b in pk["batches"]), 1))
        entries[name] = e
    info = dict(timed_frame_ms=prof_ms, prepare_calls=len(prep),
                prepare_ms=sum(x["ms"] for x in prep),
                prepare_largest=big, profile=profile)
    return entries, info, largest


def cli_scene(label, argv, frames):
    """cli.main on ``argv``; checks the frame count, the accumulation
    and the radiance.  Returns (cli result, launches, peak GiB, s)."""
    from royaltracer_dx_tpu_torch import cli

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(label)
    peak = torch.cuda.max_memory_allocated() / 2**30
    r = res["renderer"]
    img = r.radiance()
    if r.frame != frames:
        fail(f"{label}: the frame counter reads {r.frame}, expected {frames}")
    if not bool((r.fb.count == frames).all()):
        fail(f"{label}: fb.count is not {frames} everywhere")
    if not (np.isfinite(img).all() and img.mean() > 0.0):
        fail(f"{label}: radiance is not finite and positive")
    on = on_card(r)
    if on:
        fail(f"{label}: state tensors off the card: {on}")
    return res, launches, peak, secs


def phase_scenes(out_dir, rates, mismatches, profile_dir=None):
    from royaltracer_dx_tpu_torch.camera import Camera, generate_rays
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.ops import intersect as it
    from royaltracer_dx_tpu_torch.ops import stream_trace as st
    from royaltracer_dx_tpu_torch.render import restir_renderer as rr
    from royaltracer_dx_tpu_torch.scene.procedural import (
        heightfield,
        menger_scene,
    )

    out = {}
    entries = {k: {} for k in KERNELS}
    real_compact = rr.pass1_gi_bounce_compact
    comp_log: list = []

    def logged_compact(scene, cfg, state, bounce=0):
        act = state["active"]
        cnt = int(act.sum())
        comp_log.append(dict(bounce=int(bounce), active=cnt,
                             lanes=int(act.shape[0]),
                             half=cnt <= act.shape[0] // 2))
        return real_compact(scene, cfg, state, bounce)

    rr.pass1_gi_bounce_compact = logged_compact
    size = ["--width", "1920", "--height", "1080"]
    try:
        # ---- (a) sponza through the CLI, then a resumed run
        png = os.path.join(out_dir, "sponza.png")
        ck = os.path.join(out_dir, "sponza_ckpt.npz")
        if os.path.exists(ck):
            os.remove(ck)
        res, launches, peak, secs = cli_scene(
            "sponza", ["--scene", "sponza", *size, "--frames", "3",
                       "--snapshot-every", "3", "--checkpoint", ck,
                       "--aov", "all", "--out", png], 3)
        r = res["renderer"]
        sa = r.scene_arrays
        outputs = [png, ck, os.path.join(out_dir, "sponza_00003.png")] + [
            os.path.join(out_dir, f"sponza.{c}.png")
            for c in ("albedo", "normal", "depth", "material_id")]
        missing = [p for p in outputs if not os.path.exists(p)]
        if missing:
            fail(f"sponza: the CLI did not write {missing}")
        half = [c for c in comp_log if c["half"]]
        print(f"  sponza: {sa.num_triangles} triangles, "
              f"{sa.lights.count} emissive triangles, "
              f"{sa.stream.num_blocks} blocks; cli.main {secs:.1f} s, "
              f"frames {[round(x, 3) for x in res['frame_ms']]} ms, mean "
              f"{float(np.mean(res['frame_ms'])):.3f} ms; peak memory "
              f"{peak:.2f} GiB; launches {launches}; compaction on "
              f"{len(comp_log)} bounces, at half width on {len(half)}: "
              f"{comp_log}", flush=True)
        comp_a = list(comp_log)
        comp_log.clear()
        res2, launches2, _, secs2 = cli_scene(
            "sponza resumed", ["--scene", "sponza", *size, "--frames", "1",
                               "--checkpoint", ck, "--out", png], 4)
        print(f"  sponza resumed from the checkpoint: frame counter "
              f"{res2['renderer'].frame}, fb.count 4; {secs2:.1f} s, frame "
              f"{res2['frame_ms'][0]:.3f} ms; launches {launches2}",
              flush=True)
        e, info, _ = scene_frame("sponza", res2["renderer"], rates,
                                 mismatches, profile_dir)
        for k in KERNELS:
            entries[k]["sponza"] = dict(e[k], launches=launches[k])
        out["sponza"] = dict(
            triangles=sa.num_triangles, emissive=sa.lights.count,
            blocks=sa.stream.num_blocks, frame_ms=res["frame_ms"],
            resumed_frame_ms=res2["frame_ms"], peak_gib=peak,
            launches=launches, compaction=comp_a, **info)
        del r, res, res2, sa
        comp_log.clear()
        torch.cuda.empty_cache()

        # ---- (b) dragon with --animate: a refit update() per frame
        res, launches, peak, secs = cli_scene(
            "dragon", ["--scene", "dragon", *size, "--frames", "3",
                       "--animate", "--out",
                       os.path.join(out_dir, "dragon.png")], 3)
        r = res["renderer"]
        sa = r.scene_arrays
        print(f"  dragon: {sa.num_triangles} triangles, {sa.stream.num_blocks}"
              f" blocks; cli.main {secs:.1f} s, refit update() "
              f"{[round(x, 3) for x in res['refit_ms']]} ms, frames "
              f"{[round(x, 3) for x in res['frame_ms']]} ms; peak memory "
              f"{peak:.2f} GiB; launches {launches}; compaction at half "
              f"width on {sum(c['half'] for c in comp_log)} of "
              f"{len(comp_log)} bounces", flush=True)
        comp_b = list(comp_log)
        e, info, largest = scene_frame("dragon", r, rates, mismatches,
                                       profile_dir)
        for k in KERNELS:
            entries[k]["dragon"] = dict(e[k], launches=launches[k])
        # the refitted accel against brute force on 65,536 of the frame's
        # closest-hit rays (the valid lanes of its largest batch, strided)
        _, call, kout = largest["stream_closest"]
        rows = call[0]
        lanes = torch.nonzero(rows[:, 8] > 0.5)[:, 0]
        pick = lanes[torch.linspace(0, lanes.shape[0] - 1, 65536,
                                    device=lanes.device).long()]
        rw = rows[pick]
        bh = it.closest_hit_brute(rw[:, 0:3], rw[:, 3:6], sa.tri_verts,
                                  rw[:, 6], rw[:, 7], chunk=2048)
        slot = kout[1][pick].long()
        found = slot >= 0
        k_t = torch.where(found, kout[0][pick, 0], it.INF)
        k_tri = torch.where(found, sa.stream.perm[slot.clamp_min(0)].long(),
                            0)
        t_off = int(((k_t - bh.t).abs() > 1e-5).sum())
        tri_off = int(((k_tri != bh.tri) & found & (k_t != bh.t)).sum())
        ties = int(((k_tri != bh.tri) & found & (k_t == bh.t)).sum())
        print(f"  dragon refitted accel vs brute force on 65536 rays: "
              f"{int(found.sum())} hits, {t_off} lanes with t off by more "
              f"than 1e-5, {tri_off} other triangles off exact-t ties, "
              f"{ties} exact-t ties", flush=True)
        if t_off + tri_off > 65536 // 10000:
            fail("dragon: the refitted accel differs from brute force")
        out["dragon"] = dict(
            triangles=sa.num_triangles, blocks=sa.stream.num_blocks,
            refit_ms=res["refit_ms"], frame_ms=res["frame_ms"],
            peak_gib=peak, launches=launches, compaction=comp_b,
            brute=dict(rays=65536, t_off=t_off, tri_off=tri_off, ties=ties),
            **info)
        del r, res, sa, largest, call, kout, rows
        torch.cuda.empty_cache()
    finally:
        rr.pass1_gi_bounce_compact = real_compact

    # ---- (c) terrain: the 1M-triangle accel and the trace rates
    dev = torch.device("cuda")
    v, idx = heightfield(708)
    tris = torch.as_tensor(v[idx], device=dev)
    build = []
    for _ in range(2):
        ms, accel = cuda_ms(lambda: st.build_stream_accel(tris))
        build.append(ms)
    cam = Camera(eye=(2.5, 2.2, 2.5), center=(0.0, 0.0, 0.0))
    ca = {k: torch.as_tensor(x, device=dev)
          for k, x in cam.matrices(1.0).items()}
    o, d = generate_rays(ca, 512, 512)
    order, _ = st.swizzle_order(512, 512, tile_w=8, tile_h=8)
    order = torch.as_tensor(order, device=dev).long()
    o, d = o[order].contiguous(), d[order].contiguous()
    n = o.shape[0]
    reset_launches()
    hit = st.closest_hit_stream(o, d, accel)
    lp = torch.tensor([0.0, 0.9, 0.0], device=dev)
    t_s = torch.where(hit.t < 1e29, hit.t, 2.0)
    p = o + d * (t_s[:, None] * 0.999)
    ld = lp[None, :] - p
    dist = torch.linalg.norm(ld, dim=1, keepdim=True)
    ld = ld / torch.clamp_min(dist, 1e-6)
    tmax = dist[:, 0] - 1e-3
    occ = st.any_hit_stream(p, ld, accel, 1e-3, tmax)
    rates_t = {}
    for label, fn in (
            ("closest_camera", lambda: st.closest_hit_stream(o, d, accel)),
            ("anyhit_shadow",
             lambda: st.any_hit_stream(p, ld, accel, 1e-3, tmax)),
            ("closest_shadow",
             lambda: st.closest_hit_stream(p, ld, accel, 1e-3, tmax))):
        cuda_ms(fn)
        ms, _ = cuda_ms(fn, reps=10)
        rates_t[label] = dict(ms=ms, mrays_per_s=n / ms / 1e3)
    launches = read_launches("terrain")
    calls = {}
    for name, (oo, dd, t0_, t1_) in (("stream_closest", (o, d, 1e-4, 1e4)),
                                     ("stream_any", (p, ld, 1e-3, tmax))):
        rows, wl, went, cnt = st.prepare_stream(oo, dd, accel, t0_, t1_, 64)
        calls[name] = (rows, wl, went, cnt, accel.blk_tris, accel.blk_boxes)
        kern = st.stream_any if name == "stream_any" else st.stream_closest
        kms, kout = cuda_ms(lambda: kern(*calls[name]), reps=10)
        rates_t[name + "_kernel_only"] = dict(ms=kms,
                                              mrays_per_s=n / kms / 1e3)
        entries[name]["terrain"] = dict(
            kernel_vs_plain("terrain", name, calls[name], kout, rates,
                            mismatches), launches=launches[name])
    print(f"  terrain: {tris.shape[0]} triangles, {accel.num_blocks} blocks;"
          f" build {[round(x, 3) for x in build]} ms; 512x512 rays, "
          f"{float(occ.float().mean()):.4f} of the shadow batch occluded; "
          + "; ".join(f"{k} {x['ms']:.3f} ms = {x['mrays_per_s']:.1f} "
                      "Mrays/s" for k, x in rates_t.items())
          + f"; launches {launches}", flush=True)
    out["terrain"] = dict(triangles=int(tris.shape[0]),
                          blocks=accel.num_blocks, build_ms=build,
                          occluded=float(occ.float().mean()), rates=rates_t,
                          launches=launches)
    del tris, accel, calls, hit
    torch.cuda.empty_cache()

    # ---- (d) render_many(3) against 3 render() calls, bit for bit
    reset_launches()
    imgs, states = [], []
    for many in (True, False):
        scene, camera = menger_scene()
        r = rr.RestirRenderer(scene, camera, RenderConfig(width=256,
                                                          height=256))
        if many:
            r.render_many(3)
        else:
            for _ in range(3):
                r.render()
        imgs.append(r.radiance())
        states.append(r.state_dict())
    launches = read_launches("render_many")
    same_img = bool(np.array_equal(imgs[0], imgs[1]))
    diff_keys = [k for k in states[0]
                 if not np.array_equal(states[0][k], states[1][k])]
    print(f"  render_many(3) vs 3 render() on 256x256 menger: images "
          f"bit-equal {same_img}, state arrays that differ {diff_keys}; "
          f"launches {launches}", flush=True)
    if not same_img or diff_keys:
        fail("render_many(3) differs from 3 render() calls")
    out["render_many"] = dict(bit_equal=True, launches=launches)
    return out, entries


# ------------------------------ phase 5 ----------------------------------


def jax_accuracy_rows() -> dict:
    """The JAX package's accuracy rows (bench.py:400-440) as its round-5
    benchmark run recorded them in BENCH_r05.json."""
    with open(os.path.join(ROOT, "BENCH_r05.json")) as f:
        tail = json.load(f)["tail"]
    out = {}
    for key in ("rmse_di_vs_dioracle_64", "rmse_vs_oracle"):
        m = re.search('"%s": ({[^}]*})' % key, tail)
        out[key] = json.loads(m.group(1)) if m else None
    return out


def run_frames(r, budget_s, min_frames, max_frames, chunk):
    """``render_many(chunk)`` until at least ``min_frames`` are done and
    ``budget_s`` has passed, or ``max_frames`` are done (bench.py:386-397
    with a floor: the frames of the CPU harness).  Returns (frames, s)."""
    t0 = time.perf_counter()
    done = 0
    while done < max_frames and (done < min_frames
                                 or time.perf_counter() - t0 < budget_s):
        r.render_many(chunk)
        done += chunk
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0


def accuracy_row(label, oracle, cand, bars, jax_row):
    """rmse and rel_mean of ``cand`` against ``oracle`` (both (renderer,
    budget_s, min_frames, max_frames, chunk)); fails outside ``bars`` =
    (rel_mean low, rel_mean high, rmse high)."""
    from royaltracer_dx_tpu_torch.utils.metrics import rel_mean, rmse

    reset_launches()
    imgs, frames, secs = [], [], []
    for r, *plan in (oracle, cand):
        n, t = run_frames(r, *plan)
        imgs.append(r.radiance())
        frames.append(n)
        secs.append(t)
    launches = read_launches(label)
    a, b = imgs
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        fail(f"{label}: non-finite radiance")
    row = dict(rmse=rmse(b, a), rel_mean=rel_mean(b, a), frames=frames,
               seconds=secs, launches=launches,
               bars=dict(rel_mean=bars[:2], rmse=bars[2]))
    print(f"  {label}: rmse {row['rmse']!r}, rel_mean {row['rel_mean']!r} "
          f"(bars {bars[0]} < rel_mean < {bars[1]}, rmse < {bars[2]}); "
          f"frames reached {frames} in {[round(t, 1) for t in secs]} s; "
          f"the JAX package (BENCH_r05.json, its round-5 bench.py run): "
          f"{jax_row}", flush=True)
    if not (bars[0] < row["rel_mean"] < bars[1] and row["rmse"] < bars[2]):
        fail(f"{label}: outside its bars")
    return row


def phase_oracles(out_dir, rates, mismatches, restir_sponza,
                  profile_dir=None):
    """Phase 5: the megakernel Renderer and the DiOracle on the card.
    ``restir_sponza``: phase 4's sponza entries per kernel, for the walk
    of the ReSTIR frame's any-hit batch beside the megakernel's;
    ``profile_dir`` as for ``scene_frame``."""
    from royaltracer_dx_tpu_torch.camera import Camera, generate_rays
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.render import megakernel
    from royaltracer_dx_tpu_torch.render.di_oracle import DiOracle
    from royaltracer_dx_tpu_torch.render.renderer import Renderer
    from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
    from royaltracer_dx_tpu_torch.scene.procedural import (
        cornell_box,
        menger_scene,
    )
    from royaltracer_dx_tpu_torch.utils.rng import pixel_seed

    out = {}
    entries = {k: {} for k in KERNELS}
    dev = torch.device("cuda")

    # ---- (a) sponza through the CLI with --renderer megakernel
    size = ["--width", "1920", "--height", "1080"]
    png = os.path.join(out_dir, "sponza_megakernel.png")
    ck = os.path.join(out_dir, "sponza_megakernel_ckpt.npz")
    if os.path.exists(ck):
        os.remove(ck)
    argv = ["--renderer", "megakernel", "--scene", "sponza", *size,
            "--checkpoint", ck, "--out", png]
    res, launches, peak, secs = cli_scene("sponza megakernel",
                                          argv + ["--frames", "3"], 3)
    r = res["renderer"]
    if type(r).__name__ != "Renderer" or not os.path.exists(ck):
        fail("sponza megakernel: the CLI did not run the megakernel "
             "Renderer or write its checkpoint")
    m = r.metrics
    frame_ms = res["frame_ms"]
    print(f"  sponza megakernel: cli.main {secs:.1f} s, {r.cfg.max_bounces} "
          f"bounces, frames {[round(x, 3) for x in frame_ms]} ms, "
          f"last frame {m['rays_traced']:.0f} rays, "
          f"{m['mrays_per_s']:.2f} Mrays/s; peak memory {peak:.2f} GiB; "
          f"launches {launches} = {[launches[k] / 3 for k in KERNELS]} per "
          "frame", flush=True)
    del r, res
    res2, launches2, _, secs2 = cli_scene("sponza megakernel resumed",
                                          argv + ["--frames", "1"], 4)
    r = res2["renderer"]
    print(f"  sponza megakernel resumed from the checkpoint: frame counter "
          f"{r.frame}, fb.count 4; frame {res2['frame_ms'][0]:.3f} ms, "
          f"{r.metrics['mrays_per_s']:.2f} Mrays/s; launches {launches2}",
          flush=True)
    e, info, _ = scene_frame("sponza megakernel", r, rates, mismatches,
                             profile_dir, batches=True)
    for k in KERNELS:
        entries[k]["sponza_megakernel"] = dict(e[k], launches=launches[k])
    walk = dict(
        megakernel_frame=e["stream_any"]["frame_blocks_per_live_chunk"],
        megakernel_largest=e["stream_any"]["work"]["blocks_per_live_chunk"],
        restir_frame=restir_sponza["stream_any"].get(
            "frame_blocks_per_live_chunk"),
        restir_largest=restir_sponza["stream_any"]["work"][
            "blocks_per_live_chunk"])
    print(f"  any-hit walk, blocks visited per live chunk on sponza: "
          f"megakernel frame {walk['megakernel_frame']:.3f} (its first "
          f"shadow batch {walk['megakernel_largest']:.3f}); ReSTIR frame "
          f"{walk['restir_frame']:.3f} (its largest batch "
          f"{walk['restir_largest']:.3f}, phase 4)", flush=True)
    out["sponza_megakernel"] = dict(
        frame_ms=frame_ms, peak_gib=peak,
        launches=launches, resumed_frame_ms=res2["frame_ms"],
        metrics=dict(r.metrics), walk=walk, **info)
    del r, res2
    torch.cuda.empty_cache()

    # ---- (b) the cornell_megakernel row of bench.py:721-741
    reset_launches()
    cfg = RenderConfig(width=512, height=512, max_bounces=5)
    scene = cornell_box()
    sa = scene.flatten(scene.build_materials(device=dev), device=dev)
    cam = Camera(eye=(0.5, 0.6, 2.2), center=(0.5, 0.5, 0.0))
    ca = {k: torch.as_tensor(v, device=dev)
          for k, v in cam.matrices(1.0).items()}
    mo, md = generate_rays(ca, 512, 512)
    ys, xs = torch.meshgrid(torch.arange(512, device=dev),
                            torch.arange(512, device=dev), indexing="ij")
    seeds = pixel_seed(xs.reshape(-1), ys.reshape(-1), 2, 1)
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        rad, rays = megakernel.trace_paths(sa, mo, md, seeds, cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches("cornell_megakernel")
    if not bool(torch.isfinite(rad).all()) or float(rad.mean()) <= 0.0:
        fail("cornell_megakernel: radiance is not finite and positive")
    best = min(times[1:])
    row = dict(frame_ms=best, mrays=float(rays) / best / 1e3,
               rays=float(rays), reps_ms=times, launches=launches)
    print(f"  cornell_megakernel (512x512, 5 bounces, bench.py:721-741): "
          f"frame {best:.3f} ms (best of {[round(t, 3) for t in times[1:]]}"
          f" after a warm-up {times[0]:.1f} ms), {row['rays']:.0f} rays, "
          f"{row['mrays']:.2f} Mrays/s; launches {launches}", flush=True)
    out["cornell_megakernel"] = row
    del sa, rad
    torch.cuda.empty_cache()

    # ---- (c) render_many against render(), both oracles
    reset_launches()
    states = []
    for many in (True, False):
        mscene, mcam = menger_scene()
        r = Renderer(mscene, mcam, RenderConfig(width=256, height=256,
                                                max_bounces=5))
        if many:
            r.render_many(3)
        else:
            for _ in range(3):
                r.render()
        states.append(r.state_dict())
    diff_keys = [k for k in states[0]
                 if not np.array_equal(states[0][k], states[1][k])]
    hcam = Camera(eye=(0.5, 0.5, 1.72), center=(0.5, 0.5, 0.0))
    di = [DiOracle(cornell_box(emission=18.0), hcam,
                   RenderConfig(width=64, height=64)) for _ in range(3)]
    for _ in range(4):
        di[0].render()
        di[1].render_many(1)
    di[2].render_many(4)
    launches = read_launches("render_many")
    di_same = bool(torch.equal(di[0]._acc, di[1]._acc))
    di_err = float(np.abs(di[2].radiance() - di[0].radiance()).max())
    print(f"  render_many: Renderer render_many(3) vs 3 render() on 256x256 "
          f"menger, state arrays that differ {diff_keys}; DiOracle on 64x64 "
          f"cornell: 4 x render_many(1) vs 4 x render() bit-equal {di_same}"
          f", render_many(4) (float32 partial sum) within {di_err!r}; "
          f"launches {launches}", flush=True)
    if diff_keys or not di_same or di_err > 1e-5:
        fail("render_many differs from render() calls")
    out["render_many"] = dict(megakernel_bit_equal=True, di_bit_equal=True,
                              di_batch_max_err=di_err, launches=launches)
    del di, r
    torch.cuda.empty_cache()

    # ---- (d) the accuracy rows of bench.py:400-440, time-capped
    jrows = jax_accuracy_rows()
    w3 = RenderConfig(width=64, height=64)
    out["rmse_di_vs_dioracle_64"] = accuracy_row(
        "rmse_di_vs_dioracle_64 (DiOracle vs DI-only ReSTIR, 64x64)",
        (DiOracle(cornell_box(emission=18.0), hcam, w3), 10.0, 600, 12000,
         200),
        (RestirRenderer(cornell_box(emission=18.0), hcam, RenderConfig(
            width=64, height=64, aa_jitter=False, gi_bounces=0)),
         35.0, 100, 8000, 20),
        (0.97, 1.03, 0.05), jrows["rmse_di_vs_dioracle_64"])
    out["rmse_vs_oracle"] = accuracy_row(
        "rmse_vs_oracle (quirk-free 5-bounce megakernel vs ReSTIR, 96x96)",
        (Renderer(cornell_box(emission=18.0), hcam, RenderConfig(
            width=96, height=96, max_bounces=5, aa_jitter=False,
            reference_mis_quirk=False)), 15.0, 250, 2000, 50),
        (RestirRenderer(cornell_box(emission=18.0), hcam, RenderConfig(
            width=96, height=96, aa_jitter=False)), 50.0, 120, 1000, 20),
        (0.94, 1.04, 0.08), jrows["rmse_vs_oracle"])
    out["jax_accuracy_rows"] = jrows
    torch.cuda.empty_cache()

    # ---- (e) a small megakernel frame on the card against the CPU
    out["small_frames_agree"] = small_frames_agree(megakernel=True)
    return out, entries


def write_png(path, img):
    """8-bit RGB PNG from an [H, W, 3] array in [0, 1] (stdlib only)."""
    h, w, _ = img.shape
    raw = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    data = b"".join(b"\x00" + raw[y].tobytes() for y in range(h))

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(data, 6)) + chunk(b"IEND", b""))


# ------------------------------ phase 6 ----------------------------------

BVH_SOURCE = "royaltracer_dx_tpu_torch/csrc/bvh_traverse.cu"
# the JAX functions the LBVH kernels replace: XLA while_loops, not Pallas
BVH_KERNELS = {
    "bvh_closest": ("royaltracer_dx_tpu/ops/traverse.py:117",
                    "closest_hit_bvh (lax.while_loop :224)"),
    "bvh_any": ("royaltracer_dx_tpu/ops/traverse.py:237",
                "any_hit_bvh (lax.while_loop :328)"),
}
SAMPLE_LANES = 65536


def sample_lanes(n, device):
    """SAMPLE_LANES lane indices evenly strided over [0, n) (every lane of
    a smaller batch), in integer arithmetic: a float32 linspace rounds
    past n - 1 on batches of millions of lanes."""
    k = min(n, SAMPLE_LANES)
    return (torch.arange(k, dtype=torch.int64, device=device) * (n - 1)
            // max(k - 1, 1))


def reset_bvh_launches():
    from royaltracer_dx_tpu_torch.ops import traverse as tv

    for k in tv.LAUNCHES:
        tv.LAUNCHES[k] = 0


def read_bvh_launches(label):
    """The LBVH kernels' launch counts of the path just driven; fails
    unless both were launched in it."""
    from royaltracer_dx_tpu_torch.ops import traverse as tv

    got = dict(tv.LAUNCHES)
    if not all(v > 0 for v in got.values()):
        fail(f"{label}: an LBVH kernel was not launched ({got})")
    return got


class BvhLaunches:
    """While a path runs, wraps the LBVH kernels' launch: times every
    launch with CUDA events and keeps a fixed sample of SAMPLE_LANES of its
    lanes (evenly strided; every lane of a smaller batch) with the
    kernel's outputs there, for ``check`` against the plain version
    afterwards.  A lane's answer depends on that lane alone, so a sample
    is a fair check.  With ``work`` each batch is launched once more with
    the walk counts (for its bound) and the largest batch of each kernel
    is kept; with ``stream`` (a StreamAccel of the same triangles) the
    stream kernel traces the same rays, timed alone."""

    def __init__(self, label, work=False, stream=None):
        self.label, self.work, self.stream = label, work, stream
        self.recs: list = []
        self.largest: dict = {}

    def __enter__(self):
        from royaltracer_dx_tpu_torch.ops import traverse as tv

        self.tv = tv
        self.real = tv._launch
        tv._launch = self._launch
        return self

    def __exit__(self, *exc):
        self.tv._launch = self.real

    def _launch(self, name, rays, bvh, outs, stats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        counters = self.real(name, rays, bvh, outs, stats)
        end.record()
        n = rays.shape[0]
        idx = sample_lanes(n, rays.device)
        rec = dict(name=name, lanes=n, start=start, end=end, bvh=bvh,
                   rays=rays[idx], outs=tuple(o[idx] for o in outs))
        if self.work:
            tmp = tuple(torch.empty_like(o) for o in outs)
            st_buf = torch.empty((n, 3), dtype=torch.int32,
                                 device=rays.device)
            counters = self.real(name, rays, bvh, tmp, st_buf)
            rec["work"] = self.tv.bvh_work(rays, bvh, st_buf,
                                           name == "bvh_closest")
            rec["root_tests"] = int(counters[1])
            check_root_tests(f"{self.label} {name}", rec["work"],
                             rec["root_tests"])
            if n > self.largest.get(name, (0,))[0]:
                self.largest[name] = (n, rays, bvh)
        if self.stream is not None:
            from royaltracer_dx_tpu_torch.ops import stream_trace as st

            sname = "stream_any" if name == "bvh_any" else "stream_closest"
            call = st.prepare_stream(rays[:, 0:3], rays[:, 3:6], self.stream,
                                     rays[:, 6], rays[:, 7], 16)
            kern = st.stream_any if name == "bvh_any" else st.stream_closest
            rec["stream_ms"], _ = cuda_ms(lambda: kern(
                *call, self.stream.blk_tris, self.stream.blk_boxes))
            rec["stream_kernel"] = sname
        self.recs.append(rec)
        return counters

    def check(self, mismatches):
        """Every recorded launch's sample against the plain version:
        t/u/v and triangle ids (closest) or the occlusion flags (any)
        bit-equal; for closest also the walk's stats (node tests, triangle
        tests, root transitions: what the bound reads), from one more
        launch with stats on the sampled rays (a lane's walk depends on
        that lane alone).  Call it after the path's launches are read:
        those launches count.  Fails on any difference."""
        tv = self.tv
        for rec in self.recs:
            if rec["name"] == "bvh_closest":
                p_tuv, p_tri, p_st = tv._closest_plain(rec["rays"],
                                                       rec["bvh"])
                k_tuv, k_tri = rec["outs"]
                s_tuv, s_tri, k_st = tv.bvh_closest(rec["rays"], rec["bvh"],
                                                    stats=True)
                bad = int(((k_tuv != p_tuv).any(dim=1) | (k_tri != p_tri)
                           | (s_tuv != k_tuv).any(dim=1) | (s_tri != k_tri)
                           | (k_st != p_st).any(dim=1)).sum())
                err = float((k_tuv - p_tuv).abs().max()) if p_tuv.numel() \
                    else 0.0
            else:
                p_occ, _ = tv._any_plain(rec["rays"], rec["bvh"])
                bad = int((rec["outs"][0] != p_occ).sum())
                err = float(bad)
            mismatches.setdefault(rec["name"], []).append(dict(
                case=self.label, lanes=int(rec["rays"].shape[0]), bad=bad,
                max_abs_err=err))
            if bad:
                fail(f"{self.label}: {rec['name']} differs from its plain "
                     f"version on {bad} of {rec['rays'].shape[0]} sampled "
                     "lanes")
        return len(self.recs)

    def per_kernel(self, rates):
        """Per kernel: launches, the summed ms and bound of its batches,
        and one line per batch."""
        from royaltracer_dx_tpu_torch.ops import stream_trace as st

        out = {}
        for name in BVH_KERNELS:
            recs = [r for r in self.recs if r["name"] == name]
            lines = []
            for r in recs:
                ms = r["start"].elapsed_time(r["end"])
                line = dict(lanes=r["lanes"], ms=ms)
                if "work" in r:
                    w = r["work"]
                    line.update(bound_ms=st.bound_ms(w, *rates)["bound_ms"],
                                dense_top_bound_ms=dense_bound(
                                    w, rates, "dense_top_fp32_ops"),
                                top_tests_per_live_lane=w["top_tests"]
                                / max(w["live_lanes"], 1),
                                nodes_per_lane=w["nodes_per_lane"],
                                tris_per_lane=w["tris_per_lane"],
                                live_lanes=w["live_lanes"],
                                live_share=w["live_lanes"] / max(r["lanes"],
                                                                 1),
                                root_tests_per_live_lane=r["root_tests"]
                                / max(w["live_lanes"], 1))
                if "stream_ms" in r:
                    line["stream_ms"] = r["stream_ms"]
                lines.append(line)
            out[name] = dict(launches=len(recs), batches=lines,
                             ms=sum(x["ms"] for x in lines),
                             bound_ms=sum(x.get("bound_ms", 0.0)
                                          for x in lines),
                             dense_top_bound_ms=sum(
                                 x.get("dense_top_bound_ms", 0.0)
                                 for x in lines))
        return out


def dense_bound(work, rates, key="dense_fp32_ops"):
    """The bound with ``work[key]`` in place of the operations the answer
    needs: the earlier, denser yardstick, to compare with.  For the LBVH
    ``dense_top_fp32_ops`` (S root slab tests a live closest lane, not
    one scan's); for the clusters ``dense_fp32_ops`` (every padded ray,
    and every lane of a walking tile against every triangle of a
    step)."""
    from royaltracer_dx_tpu_torch.ops import stream_trace as st

    return st.bound_ms(dict(work, fp32_ops=work[key]), *rates)["bound_ms"]


def check_root_tests(label, work, scanned):
    """The closest kernel's root scans (counters[1]) make at least the
    slab tests the bound counts for them: the first scan of a lane is the
    needed DFS (all 2S - 1 top nodes above t_max 1e30), rescans come on
    top.  Any hit scans nothing."""
    if scanned < work["top_tests"]:
        fail(f"{label}: the root scans made {scanned} slab tests, fewer "
             f"than the {work['top_tests']} the bound counts")


def print_bvh_batches(label, per_kernel):
    for name, pk in per_kernel.items():
        dense = (f"; {pk['dense_top_bound_ms']:.3f} ms with S root tests a "
                 "live lane" if name == "bvh_closest" else "")
        print(f"  {label} {name}: {pk['launches']} launches, "
              f"{pk['ms']:.3f} ms in all (bound {pk['bound_ms']:.3f} ms"
              f"{dense})", flush=True)
        for b in pk["batches"]:
            extra = ""
            if "bound_ms" in b:
                extra = (f", bound {b['bound_ms']:.3f} ms, "
                         f"{b['nodes_per_lane']:.1f} node and "
                         f"{b['tris_per_lane']:.1f} triangle tests a lane "
                         f"({b['live_lanes']} live, a share of "
                         f"{b['live_share']:.3f})")
                if name == "bvh_closest":
                    extra += (f", {b['root_tests_per_live_lane']:.1f} "
                              "root-scan slab tests a live lane (needed "
                              f"{b['top_tests_per_live_lane']:.1f}; bound "
                              f"with S: {b['dense_top_bound_ms']:.3f} ms)")
            if "stream_ms" in b:
                extra += f"; the stream kernel on the same rays " \
                         f"{b['stream_ms']:.3f} ms"
            print(f"    {b['lanes']:>9} lanes: {b['ms']:.3f} ms{extra}",
                  flush=True)


def bvh_kernel_entry(name, rec, rates, mismatches):
    """The kernels-line numbers of an LBVH kernel on the largest batch of
    a run: its time alone (3 launches), the bound from that batch's walk
    counts, the live share, for closest the root scans' slab tests a live
    lane, and the plain version's time on the batch's fixed sample.  The
    kernel's output with stats is held against the plain version on two
    differently strided samples of the batch (t, u, v, triangle ids and
    the three stats bit-equal; occlusion equal)."""
    from royaltracer_dx_tpu_torch.ops import stream_trace as st
    from royaltracer_dx_tpu_torch.ops import traverse as tv

    n, rays, bvh = rec
    closest = name == "bvh_closest"
    kern = tv.bvh_closest if closest else tv.bvh_any
    cuda_ms(lambda: kern(rays, bvh))
    ms, _ = cuda_ms(lambda: kern(rays, bvh), reps=3)
    outs = ((torch.empty((n, 3), device=rays.device),
             torch.empty((n,), dtype=torch.int32, device=rays.device))
            if closest else
            (torch.empty((n,), dtype=torch.int32, device=rays.device),))
    st_buf = torch.empty((n, 3), dtype=torch.int32, device=rays.device)
    counters = tv._launch(name, rays, bvh, outs, st_buf)
    work = tv.bvh_work(rays, bvh, st_buf, closest)
    check_root_tests(f"{name} on its largest batch", work, int(counters[1]))
    bound = st.bound_ms(work, *rates)
    plain = tv._closest_plain if closest else tv._any_plain
    k = min(n, SAMPLE_LANES)
    samples = (sample_lanes(n, rays.device),
               torch.arange(k, dtype=torch.int64, device=rays.device)
               * 7919 % n)
    for j, idx in enumerate(samples):
        p_out = plain(rays[idx], bvh)
        if closest:
            bad = int(((outs[0][idx] != p_out[0]).any(dim=1)
                       | (outs[1][idx] != p_out[1])
                       | (st_buf[idx] != p_out[2]).any(dim=1)).sum())
        else:
            bad = int((outs[0][idx] != p_out[0]).sum())
        mismatches.setdefault(name, []).append(dict(
            case=f"largest batch, sample {j}", lanes=int(idx.shape[0]),
            bad=bad, max_abs_err=float(bad) if not closest else float(
                (outs[0][idx] - p_out[0]).abs().max())))
        if bad:
            fail(f"{name} on its largest batch differs from its plain "
                 f"version on {bad} of sample {j}'s {idx.shape[0]} lanes")
    sample = rays[samples[0]]
    plain_ms, _ = cuda_ms(lambda: plain(sample, bvh))
    err = max([c["max_abs_err"] for c in mismatches.get(name, [])] + [0.0])
    live = work["live_lanes"]
    return dict(lanes=n, ms=ms, plain_ms=plain_ms,
                plain_lanes=int(sample.shape[0]), max_abs_err=err,
                live_share=live / max(n, 1),
                root_tests_per_live_lane=(int(counters[1]) / max(live, 1)
                                          if closest else None),
                top_tests_per_live_lane=(work["top_tests"] / max(live, 1)
                                         if closest else None),
                dense_top_bound_ms=(dense_bound(
                    work, rates, "dense_top_fp32_ops") if closest else None),
                work=work, **bound)


def phase_sharding(rates, out_dir):
    """(a) The 1080p menger frame on 1, 2 and 4 bands of one card."""
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.io.checkpoint import (
        load_renderer_state,
        save_renderer_state,
    )
    from royaltracer_dx_tpu_torch.ops import stream_trace as st
    from royaltracer_dx_tpu_torch.parallel.shard import ShardedRestirRenderer
    from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    cfg = RenderConfig()
    dev = torch.device("cuda", torch.cuda.current_device())
    halo = min(cfg.spatial_radius, cfg.height // 4)
    # camera moves (orbit pitch, radians): about 4 rows, within the 20-row
    # halo, then about 80 rows, beyond it
    moves = (("static", None), ("move within the halo", 0.004),
             ("move beyond the halo", 0.08))
    ref_imgs: dict = {}
    out = {}

    def make(n):
        scene, camera = menger_scene()
        if n == 1:
            return RestirRenderer(scene, camera, cfg)
        return ShardedRestirRenderer(scene, camera, cfg, devices=[dev] * n)

    for n in (1, 2, 4):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches()
        r = make(n)
        frame_ms, per_frame = [], []
        for _ in range(3):
            prev = dict(st.LAUNCHES)
            t0 = time.perf_counter()
            r.render()
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            per_frame.append({k: st.LAUNCHES[k] - prev[k] for k in prev})
        launches = read_launches(f"menger on {n} band(s)")
        diffs = {}
        for label, pitch in moves:
            if pitch is not None:
                r.update(camera=r.camera.orbited(0.0, pitch))
                r.render()
            img = r.radiance()
            if not (np.isfinite(img).all() and img.mean() > 0.0):
                fail(f"menger on {n} bands: radiance not finite and positive")
            if n == 1:
                ref_imgs[label] = img
                continue
            ref = ref_imgs[label]
            d = np.abs(img - ref)
            ok = bool(np.all(d <= 1e-6 + 1e-5 * np.abs(ref)))
            diffs[label] = dict(max_abs=float(d.max()),
                                pixels_differ=int((d > 0).any(-1).sum()),
                                within_tol=ok)
            if label != "move beyond the halo" and not ok:
                fail(f"menger on {n} bands ({label}): the image is not "
                     f"within rtol=1e-5, atol=1e-6 of one device's "
                     f"({diffs[label]})")
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        row = dict(frame_ms=frame_ms, launches_per_frame=per_frame,
                   launches=launches, peak_gib=peak, vs_single=diffs)
        print(f"  menger 1920x1080 on {n} band(s) of one card: frames "
              f"{[round(x, 3) for x in frame_ms]} ms, launches per frame "
              f"{per_frame[-1]}, peak memory {peak:.2f} GiB; against one "
              f"device: {diffs or 'the reference'}", flush=True)
        if n == 2:
            ck = os.path.join(out_dir, "sharded_ckpt.npz")
            t0 = time.perf_counter()
            save_renderer_state(ck, r)
            b = make(2)
            b.camera = r.camera          # the state holds no camera
            load_renderer_state(ck, b)
            secs = time.perf_counter() - t0
            r.render()
            b.render()
            same = bool(np.array_equal(r.radiance(), b.radiance()))
            print(f"  2 bands: checkpoint saved and loaded in {secs:.1f} s "
                  f"({os.path.getsize(ck) / 2**20:.1f} MiB); the next frame "
                  f"bit-equal after the load: {same}", flush=True)
            if not same or b.frame != r.frame:
                fail("sharded checkpoint round trip changed the frame")
            row["checkpoint"] = dict(seconds=secs, bit_equal=same)
            os.remove(ck)
            del b
        out[f"{n}_bands"] = row
        del r
    print(f"  (one card cannot show scaling: the bands run one after another;"
          f" halo {halo} rows)", flush=True)
    return out


def phase_lbvh(out_dir, rates, mismatches, terrain_stream):
    """(b) sponza --bvh through cli.main, (c) the terrain accel, (d) dragon
    --bvh --animate.  Returns (results, kernel entries)."""
    from royaltracer_dx_tpu_torch import cli
    from royaltracer_dx_tpu_torch.camera import Camera, generate_rays
    from royaltracer_dx_tpu_torch.ops import bvh as tb
    from royaltracer_dx_tpu_torch.ops import stream_trace as st
    from royaltracer_dx_tpu_torch.ops import traverse as tv
    from royaltracer_dx_tpu_torch.scene.procedural import heightfield

    out = {}
    size = ["--width", "1920", "--height", "1080"]

    def cli_bvh(label, argv, frames):
        reset_bvh_launches()
        torch.cuda.reset_peak_memory_stats()
        with BvhLaunches(label) as rec:
            t0 = time.perf_counter()
            res = cli.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = read_bvh_launches(label)
        peak = torch.cuda.max_memory_allocated() / 2**30
        r = res["renderer"]
        img = r.radiance()
        if r.frame != frames or not bool((r.fb.count == frames).all()):
            fail(f"{label}: frame counter {r.frame}, expected {frames}")
        if not (np.isfinite(img).all() and img.mean() > 0.0):
            fail(f"{label}: radiance is not finite and positive")
        if r.scene_arrays.bvh is None or r.scene_arrays.stream is not None:
            fail(f"{label}: the scene was not flattened for the LBVH alone")
        t0 = time.perf_counter()
        checked = rec.check(mismatches)
        check_s = time.perf_counter() - t0
        pk = rec.per_kernel(rates)
        print(f"  {label}: cli.main {secs:.1f} s, frames "
              f"{[round(x, 3) for x in res['frame_ms']]} ms, refit "
              f"{[round(x, 3) for x in res['refit_ms']]} ms, peak memory "
              f"{peak:.2f} GiB, launches {launches}; every launch's "
              f"{SAMPLE_LANES}-lane sample equal to the plain version "
              f"({checked} launches, {check_s:.1f} s)", flush=True)
        return res, dict(frame_ms=res["frame_ms"], refit_ms=res["refit_ms"],
                         peak_gib=peak, launches=launches, cli_s=secs,
                         kernel_ms={k: v["ms"] for k, v in pk.items()})

    # ---- (b) sponza --bvh: 2 ReSTIR frames, 1 megakernel frame
    png = os.path.join(out_dir, "sponza_bvh.png")
    res, row = cli_bvh("sponza --bvh", ["--scene", "sponza", "--bvh", *size,
                                        "--frames", "2", "--out", png], 2)
    restir_launches = row["launches"]
    r = res["renderer"]
    sa = r.scene_arrays
    print(f"  sponza LBVH: {sa.num_triangles} triangles, "
          f"{sa.bvh.num_leaves} leaves of {sa.bvh.leaf_size}", flush=True)
    with BvhLaunches("sponza --bvh timed frame", work=True) as rec:
        r.render()
        torch.cuda.synchronize()
    pk = rec.per_kernel(rates)
    print_bvh_batches("sponza --bvh ReSTIR frame", pk)
    largest = dict(rec.largest)
    row["timed_frame"] = pk
    out["sponza_restir"] = row
    del r, res, rec
    torch.cuda.empty_cache()

    res, row = cli_bvh("sponza --bvh megakernel",
                       ["--scene", "sponza", "--bvh", "--renderer",
                        "megakernel", *size, "--frames", "1", "--out", png], 1)
    r = res["renderer"]
    accel = st.build_stream_accel(r.scene_arrays.tri_verts)
    with BvhLaunches("sponza --bvh megakernel timed frame", work=True,
                     stream=accel) as rec:
        r.render()
        torch.cuda.synchronize()
    pk = rec.per_kernel(rates)
    print_bvh_batches("sponza --bvh megakernel frame", pk)
    row["timed_frame"] = pk
    out["sponza_megakernel"] = row
    del r, res, rec, accel
    torch.cuda.empty_cache()

    entries = {}
    for name, (replaces, fn) in BVH_KERNELS.items():
        e = bvh_kernel_entry(name, largest[name], rates, mismatches)
        res = tv.BUILD_INFO["resources"][name]
        roots = ("" if e["root_tests_per_live_lane"] is None else
                 f", {e['root_tests_per_live_lane']:.1f} root-scan slab "
                 f"tests a live lane (needed "
                 f"{e['top_tests_per_live_lane']:.1f}; the bound with S "
                 f"root tests a live lane {e['dense_top_bound_ms']:.3f} "
                 "ms)")
        print(f"  {name} on sponza's largest ReSTIR batch ({e['lanes']} "
              f"lanes, a live share of {e['live_share']:.3f}): kernel "
              f"{e['ms']:.3f} ms, bound {e['bound_ms']:.3f} ms "
              f"({e['bound_by']}), plain version {e['plain_ms']:.3f} ms on "
              f"its {e['plain_lanes']}-lane sample; "
              f"{e['work']['nodes_per_lane']:.1f} node and "
              f"{e['work']['tris_per_lane']:.1f} triangle tests a lane"
              f"{roots}; {res['ctas_per_sm']} CTAs of {res['threads']} "
              f"threads an SM, {res['registers']} registers; two strided "
              "samples equal to the plain version", flush=True)
        entries[name] = dict(
            e, name=name, route="cuda", source=BVH_SOURCE, replaces=replaces,
            replaces_fn=fn, launches=restir_launches[name], library_ms=None,
            resources={k: v for k, v in tv.BUILD_INFO["resources"].items()
                       if k.startswith(name)})
    del largest
    torch.cuda.empty_cache()

    # ---- (c) the terrain accel: closest and any-hit rates
    dev = torch.device("cuda")
    v, idx = heightfield(708)
    tris = torch.as_tensor(v[idx], device=dev)
    build = []
    for _ in range(2):
        ms, bvh = cuda_ms(lambda: tb.build_lbvh(tris))
        build.append(ms)
    cam = Camera(eye=(2.5, 2.2, 2.5), center=(0.0, 0.0, 0.0))
    ca = {k: torch.as_tensor(x, device=dev)
          for k, x in cam.matrices(1.0).items()}
    o, d = generate_rays(ca, 512, 512)
    order, _ = st.swizzle_order(512, 512, tile_w=8, tile_h=8)
    order = torch.as_tensor(order, device=dev).long()
    o, d = o[order].contiguous(), d[order].contiguous()
    n = o.shape[0]
    with BvhLaunches("terrain") as rec:
        hit = tv.closest_hit_bvh(o, d, bvh)
        lp = torch.tensor([0.0, 0.9, 0.0], device=dev)
        t_s = torch.where(hit.t < 1e29, hit.t, 2.0)
        p = o + d * (t_s[:, None] * 0.999)
        ld = lp[None, :] - p
        dist = torch.linalg.norm(ld, dim=1, keepdim=True)
        ld = ld / torch.clamp_min(dist, 1e-6)
        tmax = dist[:, 0] - 1e-3
        occ = tv.any_hit_bvh(p, ld, bvh, 1e-3, tmax)
    rec.check(mismatches)
    rates_t = {}
    for label, rays, kern in (
            ("closest_camera", tv.pack_rays(o, d, 1e-4, 1e4), tv.bvh_closest),
            ("anyhit_shadow", tv.pack_rays(p, ld, 1e-3, tmax), tv.bvh_any),
            ("closest_shadow", tv.pack_rays(p, ld, 1e-3, tmax),
             tv.bvh_closest)):
        cuda_ms(lambda: kern(rays, bvh))
        ms, _ = cuda_ms(lambda: kern(rays, bvh), reps=10)
        rates_t[label + "_kernel_only"] = dict(ms=ms, mrays_per_s=n / ms / 1e3)
    print(f"  terrain LBVH: {tris.shape[0]} triangles, {bvh.num_leaves} "
          f"leaves; build {[round(x, 3) for x in build]} ms; "
          f"{float(occ.float().mean()):.4f} of the shadow batch occluded "
          "(the samples equal the plain version); "
          + "; ".join(f"{k} {x['ms']:.3f} ms = {x['mrays_per_s']:.1f} Mrays/s"
                      for k, x in rates_t.items())
          + "; phase 4's stream kernels: "
          + "; ".join(f"{k} {x['mrays_per_s']:.1f} Mrays/s"
                      for k, x in terrain_stream.items()), flush=True)
    out["terrain"] = dict(triangles=int(tris.shape[0]),
                          leaves=bvh.num_leaves, build_ms=build,
                          rates=rates_t, stream_rates=terrain_stream)
    del tris, bvh, hit, occ, rec
    torch.cuda.empty_cache()

    # ---- (d) dragon --bvh --animate: one refit update() and one frame
    res, row = cli_bvh("dragon --bvh --animate",
                       ["--scene", "dragon", "--bvh", "--animate", *size,
                        "--frames", "1", "--out",
                        os.path.join(out_dir, "dragon_bvh.png")], 1)
    out["dragon"] = row
    del res
    torch.cuda.empty_cache()
    return out, entries


# ------------------------------ phase 7 ----------------------------------

CLUSTER_SOURCE = "royaltracer_dx_tpu_torch/csrc/cluster_traverse.cu"
# the JAX routines the cluster kernels replace: XLA, not Pallas
CLUSTER_KERNELS = {
    "cluster_mask": ("royaltracer_dx_tpu/ops/cluster_traverse.py:109",
                     "_tile_cluster_mask"),
    "cluster_closest": ("royaltracer_dx_tpu/ops/cluster_traverse.py:268",
                        "closest_hit_clustered (its while loops over "
                        "_mt_tile)"),
    "cluster_any": ("royaltracer_dx_tpu/ops/cluster_traverse.py:387",
                    "any_hit_clustered"),
}
# whole tiles held against the plain versions (a lane sample would break
# the tiles, and a tile's answer depends on all of its rays)
CHECK_TILES = 512
# cluster_study.pack_case's adversarial tiles: (tile, group, sponge level)
PACK_CASES = ((128, 128, 2), (96, 100, 2), (128, 1, 1), (1024, 1024, 2))
# cluster_study.mask_case's adversarial phase A tiles: (tile, clusters)
MASK_CASES = ((128, 38), (96, 2073), (1024, 1), (1024, 38))


def entry_error(a, b) -> float:
    """The largest difference of two entry tables (equal entries, the
    infinite ones included, count 0)."""
    return float(torch.where(a == b, 0.0, (a - b).abs()).max())


def trace_modules():
    from royaltracer_dx_tpu_torch.ops import cluster_traverse as ct
    from royaltracer_dx_tpu_torch.ops import mxu_trace as mx
    from royaltracer_dx_tpu_torch.ops import stream_trace as st
    from royaltracer_dx_tpu_torch.ops import traverse as tv

    return st, tv, ct, mx


def all_launches() -> dict:
    return {k: v for mod in trace_modules() for k, v in mod.LAUNCHES.items()}


def reset_all_launches():
    for mod in trace_modules():
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def read_cluster_launches(label, kernels=tuple(CLUSTER_KERNELS)):
    """The cluster kernels' launch counts of the path just driven; fails
    unless each of ``kernels`` was launched in it, or if a stream or LBVH
    kernel was."""
    got = all_launches()
    mine = {k: got[k] for k in CLUSTER_KERNELS}
    if not all(mine[k] > 0 for k in kernels):
        fail(f"{label}: a cluster kernel was not launched ({mine})")
    other = {k: v for k, v in got.items() if k not in CLUSTER_KERNELS and v}
    if other:
        fail(f"{label}: other trace kernels were launched ({other})")
    return mine


class NoPlain:
    """While a path runs on the card, fails if one of the plain versions
    ``names`` of module ``mod`` runs (every batch must launch the
    kernels); ``saved`` keeps them for the comparisons."""

    def __init__(self, mod, *names):
        self.mod, self.names = mod, names

    def __enter__(self):
        self.saved = {n: getattr(self.mod, n) for n in self.names}

        def refuse(*args, **kw):
            fail(f"a plain version of {self.mod.__name__} ran on the card "
                 "path")

        for n in self.names:
            setattr(self.mod, n, refuse)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.mod, n, fn)


class ClusterLaunches:
    """While a path runs, wraps the three cluster kernels' wrappers: times
    every call with CUDA events, launches each phase B batch once more
    with its per-tile stats for the batch's work (``cluster_work``), and
    keeps each kernel's largest call.  With ``stream`` (a StreamAccel of
    the same triangles) the stream kernel traces each phase B batch's
    rays too, timed alone."""

    def __init__(self, rates, stream=None):
        self.rates, self.stream = rates, stream
        self.recs: list = []
        self.largest: dict = {}

    def __enter__(self):
        from royaltracer_dx_tpu_torch.ops import cluster_traverse as ct

        self.ct = ct
        self.real = {n: getattr(ct, n) for n in CLUSTER_KERNELS}
        for n in CLUSTER_KERNELS:
            setattr(ct, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.ct, n, fn)

    def _wrap(self, name):
        real = self.real[name]

        def call(rows, cl, *args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real(rows, cl, *args)
            end.record()
            tile = args[-1]
            stats = None
            if name != "cluster_mask":
                stats = real(rows, cl, *args, stats=True)[-1]
            work = self.ct.cluster_work(rows, cl, tile, stats,
                                        name == "cluster_closest")
            rec = dict(name=name, lanes=rows.shape[0], start=start, end=end,
                       work=work)
            if self.stream is not None and stats is not None:
                from royaltracer_dx_tpu_torch.ops import stream_trace as st

                call = st.prepare_stream(rows[:, 0:3], rows[:, 3:6],
                                         self.stream, rows[:, 6],
                                         rows[:, 7], 16)
                kern = (st.stream_closest if name == "cluster_closest"
                        else st.stream_any)
                rec["stream_ms"], _ = cuda_ms(lambda: kern(
                    *call, self.stream.blk_tris, self.stream.blk_boxes))
            self.recs.append(rec)
            if rows.shape[0] > self.largest.get(name, (0,))[0]:
                self.largest[name] = (rows.shape[0], (rows, cl, *args))
            return out

        return call

    def per_kernel(self):
        """Per kernel: launches, the summed ms and bound of its batches,
        and one line per batch."""
        from royaltracer_dx_tpu_torch.ops import stream_trace as st

        out = {}
        for name in CLUSTER_KERNELS:
            lines = []
            for r in self.recs:
                if r["name"] != name:
                    continue
                b = st.bound_ms(r["work"], *self.rates)
                lines.append(dict(r["work"], ms=r["start"].elapsed_time(
                    r["end"]), bound_ms=b["bound_ms"],
                    bound_by=b["bound_by"],
                    nofma_floor_ms=b["nofma_floor_ms"],
                    dense_bound_ms=dense_bound(r["work"], self.rates),
                    stream_ms=r.get("stream_ms")))
            out[name] = dict(launches=len(lines), batches=lines,
                             **{k: sum(x[k] for x in lines) for k in (
                                 "ms", "bound_ms", "nofma_floor_ms",
                                 "dense_bound_ms")},
                             stream_ms=sum(x["stream_ms"] or 0.0
                                           for x in lines))
        return out


def cluster_check(label, rows, cl, tile, mismatches, at=None):
    """The three kernels against their plain versions on CHECK_TILES whole
    tiles of a batch (from tile ``at``; default: the middle ones): the
    mask and entry tables, t/u/v, triangle ids, occlusion and the per-tile
    stats (steps, needed tests) bit-equal.  Returns the times of kernel
    and plain version on those tiles."""
    from royaltracer_dx_tpu_torch.ops import cluster_traverse as ct

    n_t = rows.shape[0] // tile
    k = min(CHECK_TILES, n_t)
    t0 = (n_t - k) // 2 if at is None else at
    sub = rows[t0 * tile:(t0 + k) * tile]
    ms, plain = {}, {}
    ms["cluster_mask"], (mask, entry) = cuda_ms(
        lambda: ct.cluster_mask(sub, cl, tile))
    plain["cluster_mask"], (p_mask, p_entry) = cuda_ms(
        lambda: ct._mask_plain(sub, cl, tile))
    wl, went, count = ct.worklists(mask, entry)
    ms["cluster_closest"], kc = cuda_ms(lambda: ct.cluster_closest(
        sub, cl, wl, went, count, tile, stats=True))
    plain["cluster_closest"], pc = cuda_ms(lambda: ct._phase_b_plain(
        sub, cl, wl, went, count, tile, False))
    ms["cluster_any"], ka = cuda_ms(lambda: ct.cluster_any(
        sub, cl, wl, count, tile, stats=True))
    plain["cluster_any"], pa = cuda_ms(lambda: ct._phase_b_plain(
        sub, cl, wl, None, count, tile, True))
    bad = {
        "cluster_mask": int((mask != p_mask).sum() + (
            entry.view(torch.int32) != p_entry.view(torch.int32)).sum()),
        "cluster_closest": int(sum((a != b).sum() for a, b in zip(kc, pc))),
        "cluster_any": int(sum((a != b).sum() for a, b in zip(ka, pa)))}
    errs = {"cluster_mask": entry_error(entry, p_entry),
            "cluster_closest": float((kc[0] - pc[0]).abs().max()),
            "cluster_any": float((ka[0] - pa[0]).abs().max())}
    for name in CLUSTER_KERNELS:
        mismatches.setdefault(name, []).append(dict(
            case=label, lanes=int(sub.shape[0]), bad=bad[name],
            max_abs_err=errs[name]))
    if any(bad.values()):
        fail(f"{label}: the cluster kernels differ from their plain versions "
             f"on {k} tiles of {tile} ({bad} values)")
    hits = int((kc[0][:, 0] < 1e30).sum())
    print(f"  {label}: {k} tiles of {tile} rays from tile {t0} (of {n_t}) "
          f"equal to the plain versions (mask, entry, t/u/v, tri, occlusion,"
          f" steps and tests); {hits} hits, {int(ka[0].sum())} occluded, "
          f"steps a tile {float(kc[2][:, 0].float().mean()):.2f} closest / "
          f"{float(ka[1][:, 0].float().mean()):.2f} any of "
          f"{float(count.float().mean()):.2f} overlapped; kernel / plain ms "
          + ", ".join(f"{n} {ms[n]:.3f} / {plain[n]:.3f}"
                      for n in CLUSTER_KERNELS), flush=True)
    if hits == 0 or int(count.sum()) == 0:
        fail(f"{label}: the checked tiles do no work")
    return dict(lanes=int(sub.shape[0]), ms=ms, plain_ms=plain)


def mask_check(label, rows, cl, tile, mismatches):
    """cluster_mask against its plain version on a whole batch: mask and
    entry bit for bit."""
    from royaltracer_dx_tpu_torch.ops import cluster_traverse as ct

    ms, (mask, entry) = cuda_ms(lambda: ct.cluster_mask(rows, cl, tile))
    plain, (p_mask, p_entry) = cuda_ms(lambda: ct._mask_plain(rows, cl,
                                                              tile))
    bad = int((mask != p_mask).sum() + (
        entry.view(torch.int32) != p_entry.view(torch.int32)).sum())
    mismatches.setdefault("cluster_mask", []).append(dict(
        case=label, lanes=int(rows.shape[0]), bad=bad,
        max_abs_err=entry_error(entry, p_entry)))
    if bad:
        fail(f"{label}: cluster_mask differs from its plain version in {bad}"
             " values")
    live = int((rows[:, 6] <= rows[:, 7]).sum())
    print(f"  {label}: {rows.shape[0] // tile} tiles of {tile} rays ({live} "
          f"live) against {cl.num_clusters} boxes: mask and entry equal to "
          f"the plain version bit for bit ({int(mask.sum())} overlaps); "
          f"kernel / plain ms {ms:.3f} / {plain:.3f}", flush=True)


def cluster_timed(label, rows, cl, tile, rates):
    """The three kernels on a whole batch: ms (3 launches after a warm
    one) and the bound of each (``cluster_work``, from one more launch
    with stats), with the dense bound beside it."""
    from royaltracer_dx_tpu_torch.ops import cluster_traverse as ct
    from royaltracer_dx_tpu_torch.ops import stream_trace as st

    mask, entry = ct.cluster_mask(rows, cl, tile)
    wl, went, count = ct.worklists(mask, entry)
    calls = {
        "cluster_mask": lambda **kw: ct.cluster_mask(rows, cl, tile),
        "cluster_closest": lambda **kw: ct.cluster_closest(
            rows, cl, wl, went, count, tile, **kw),
        "cluster_any": lambda **kw: ct.cluster_any(rows, cl, wl, count, tile,
                                                   **kw)}
    out = {}
    for name, fn in calls.items():
        cuda_ms(fn)
        ms, _ = cuda_ms(fn, reps=3)
        stats = None if name == "cluster_mask" else fn(stats=True)[-1]
        work = ct.cluster_work(rows, cl, tile, stats,
                               name == "cluster_closest")
        out[name] = dict(ms=ms, **st.bound_ms(work, *rates), work=work,
                         dense_bound_ms=dense_bound(work, rates))
    print(f"  {label} ({rows.shape[0]} lanes, {cl.num_clusters} clusters of "
          f"{cl.group}, tiles of {tile}): "
          + "; ".join(f"{n} {v['ms']:.3f} ms, bound {v['bound_ms']:.3f} ms "
                      f"({v['bound_by']}; no-FMA floor "
                      f"{v['nofma_floor_ms']:.3f}; dense "
                      f"{v['dense_bound_ms']:.3f})" for n, v in out.items())
          + f"; closest steps a tile "
          f"{out['cluster_closest']['work']['steps_per_tile']:.2f} (max "
          f"{out['cluster_closest']['work']['max_steps']}), any "
          f"{out['cluster_any']['work']['steps_per_tile']:.2f}", flush=True)
    return out


def varied_bounds(n, dev):
    """t_max per lane: every seventh lane dead (-1), every other one 1.0,
    the rest 1e4."""
    lane = torch.arange(n, device=dev)
    return torch.where(lane % 7 == 0, -1.0,
                       torch.where(lane % 2 == 0, 1.0, 1e4))


def phase_cluster(out_dir, rates, mismatches):
    """(a) the cluster kernels against their plain versions, (b) the
    1080p menger ReSTIR frame under traversal="cluster" (the slice's main
    path), (c) a megakernel and a DiOracle frame under it, (d) the stream
    kernels on morton and median_host accels.  Returns (results, kernel
    entries)."""
    from royaltracer_dx_tpu_torch import cli
    from royaltracer_dx_tpu_torch.camera import generate_rays
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.ops import cluster_traverse as ct
    from royaltracer_dx_tpu_torch.ops import stream_trace as st
    from royaltracer_dx_tpu_torch.render.di_oracle import DiOracle
    from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    dev = torch.device("cuda")
    out = {}

    def camera_batch(scene_name, w, h):
        scene, camera = cli.build_scene(scene_name)
        sa = scene.flatten(scene.build_materials(device=dev),
                           build_clusters=True, device=dev)
        ca = {k: torch.as_tensor(x, device=dev)
              for k, x in camera.matrices(w / h).items()}
        o, d = generate_rays(ca, w, h)
        return sa, o, d

    # ---- (a) kernels against their plain versions
    t0 = time.perf_counter()
    sa, o, d = camera_batch("menger", 1920, 1080)
    cl = sa.clusters
    cpu = ct.build_clusters(sa.tri_verts.cpu(), cl.group)
    if not all(torch.equal(getattr(cl, f).cpu(), getattr(cpu, f))
               for f in ("tri_planes", "tri_index", "aabb_lo", "aabb_hi")):
        fail("menger: the clusters built on the card differ from the CPU's")
    print(f"  menger: {sa.num_triangles} triangles, {cl.num_clusters} "
          f"clusters of {cl.group} (equal to the CPU build)", flush=True)
    n = o.shape[0]
    cluster_check("menger camera rays",
                  ct.prepare_rays(o, d, 1e-4, varied_bounds(n, dev), 128),
                  cl, 128, mismatches)
    for label, count, tile, at in (("menger random rays", 1 << 20, 128, None),
                                   ("menger 100,003 random rays", 100003,
                                    128, -1),
                                   ("menger random rays, tiles of 96",
                                    1 << 18, 96, None)):
        ro, rd = random_rays(count, -0.5, 1.5, 7, dev)
        rows = ct.prepare_rays(ro, rd, 1e-4, varied_bounds(count, dev), tile)
        n_t = rows.shape[0] // tile
        cluster_check(label, rows, cl, tile, mismatches,
                      None if at is None else n_t - min(CHECK_TILES, n_t))
    del sa, o, d, cl, cpu
    from royaltracer_dx_tpu_torch.tools.cluster_study import pack_case

    for tile, group, level in PACK_CASES:
        rows, cl, _ = pack_case(dev, tile, group, level)
        cluster_check(f"adversarial tiles (pack_case), tiles of {tile}, "
                      f"clusters of {group}", rows, cl, tile, mismatches, 0)
    from royaltracer_dx_tpu_torch.tools.cluster_study import mask_case

    for tile, c in MASK_CASES:
        rows, cl, _ = mask_case(dev, tile, c, max(1, 4096 // (tile + 4)))
        mask_check(f"adversarial phase A tiles (mask_case), {c} clusters",
                   rows, cl, tile, mismatches)
    sa, o, d = camera_batch("sponza", 1920, 1080)
    rows = ct.prepare_rays(o, d, 1e-4, 1e4, 128)
    mask_res = {"sponza primary": ct.mask_resources(
        128, sa.clusters.num_clusters)}
    out["sponza_primary"] = dict(
        triangles=sa.num_triangles, clusters=sa.clusters.num_clusters,
        **cluster_timed("sponza primary batch", rows, sa.clusters, 128,
                        rates))
    cluster_check("sponza primary batch", rows, sa.clusters, 128, mismatches)
    sponza_tris = sa.tri_verts
    del sa, o, d, rows
    torch.cuda.empty_cache()
    print(f"  (a) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- (b) the main path: the menger ReSTIR frame under "cluster"
    t0 = time.perf_counter()
    scene, camera = menger_scene()
    renderer = RestirRenderer(scene, camera, RenderConfig(traversal="cluster"))
    rsa = renderer.scene_arrays
    if rsa.clusters is None or rsa.stream is not None or rsa.bvh is not None:
        fail("menger cluster: the scene was not flattened for the clusters "
             "alone")
    renderer.render()                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frames = 3
    reset_all_launches()
    with NoPlain(ct, "_mask_plain", "_phase_b_plain"):
        frame_ms = [cuda_ms(renderer.render)[0] for _ in range(frames)]
    launches = read_cluster_launches("menger cluster frames")
    peak = torch.cuda.max_memory_allocated() / 2**30
    img = renderer.radiance()
    if not (np.isfinite(img).all() and img.mean() > 0.0):
        fail("menger cluster: radiance is not finite and positive")
    if not bool((renderer.fb.count == frames + 1).all()):
        fail("menger cluster: fb.count is not 4 everywhere")
    per_frame = {k: v / frames for k, v in launches.items()}
    n_cl = rsa.clusters.num_clusters
    mask_res["menger"] = ct.mask_resources(renderer.cfg.cluster_tile, n_cl)
    for k, v in mask_res.items():
        print(f"  cluster_mask at {k}'s shape: {v['ctas_per_sm']} CTAs of "
              f"{v['threads']} threads resident per SM, {v['registers']} "
              f"registers, {v['local_bytes']} B spilled, {v['shared_bytes']}"
              " B of shared memory per CTA", flush=True)
    print(f"  menger 1920x1080 ReSTIR, traversal cluster ({n_cl} clusters): "
          f"frames {[round(x, 3) for x in frame_ms]} ms, launches per frame "
          f"{per_frame}, radiance mean {img.mean():.6f}, peak memory "
          f"{peak:.2f} GiB; no stream or LBVH launch, no plain version",
          flush=True)
    if out_dir:
        write_png(os.path.join(out_dir, "menger_cluster.png"),
                  renderer.image())
    stream = st.build_stream_accel(rsa.tri_verts)
    with ClusterLaunches(rates, stream) as rec:
        timed_ms, _ = cuda_ms(renderer.render)
    pk = rec.per_kernel()
    print(f"  menger cluster frame with timed launches: {timed_ms:.3f} ms "
          "(the stream kernels timed on each phase B batch's rays beside "
          "them)", flush=True)
    for name in CLUSTER_KERNELS:
        beside = ("" if name == "cluster_mask" else
                  f"; the stream kernel on the same rays "
                  f"{pk[name]['stream_ms']:.3f} ms")
        print(f"  {name}: {pk[name]['launches']} launches, "
              f"{pk[name]['ms']:.3f} ms a frame (bound "
              f"{pk[name]['bound_ms']:.3f} ms; no-FMA floor "
              f"{pk[name]['nofma_floor_ms']:.3f}; dense "
              f"{pk[name]['dense_bound_ms']:.3f}){beside}; batches:",
              flush=True)
        for b in pk[name]["batches"]:
            extra = ("" if name == "cluster_mask" else
                     f", steps a tile {b['steps_per_tile']:.2f} (max "
                     f"{b['max_steps']}: "
                     f"{b['ms'] * 1e3 / max(b['max_steps'], 1):.1f} us a "
                     f"step of the longest tile; live tiles "
                     f"{b['live_tiles']} of {b['tiles']}); stream kernel "
                     f"{b['stream_ms']:.3f} ms")
            print(f"    {b['lanes']} lanes: {b['ms']:.3f} ms, bound "
                  f"{b['bound_ms']:.3f} ms ({b['bound_by']}; no-FMA floor "
                  f"{b['nofma_floor_ms']:.3f}; dense "
                  f"{b['dense_bound_ms']:.3f}){extra}", flush=True)
    entries = {}
    for name, (replaces, fn) in CLUSTER_KERNELS.items():
        lanes, (rows, cl, *rest) = rec.largest[name]
        tile = rest[-1]
        big = cluster_timed(f"{name}'s largest menger batch", rows, cl, tile,
                            rates)[name]
        chk = cluster_check(f"{name}'s largest menger batch", rows, cl, tile,
                            mismatches)
        entries[name] = dict(
            name=name, route="cuda", source=CLUSTER_SOURCE,
            replaces=replaces, replaces_fn=fn, launches=launches[name],
            ms=big["ms"], bound_ms=big["bound_ms"],
            bound_by=big["bound_by"], dense_bound_ms=big["dense_bound_ms"],
            nofma_floor_ms=big["nofma_floor_ms"],
            bytes_ms=big["bytes_ms"],
            ops_ms=big["ops_ms"], shape_lanes=lanes,
            plain_ms=chk["plain_ms"][name], plain_lanes=chk["lanes"],
            slice_ms=chk["ms"][name], library_ms=None,
            frame_ms=pk[name]["ms"], frame_launches=pk[name]["launches"],
            frame_bound_ms=pk[name]["bound_ms"],
            frame_nofma_floor_ms=pk[name]["nofma_floor_ms"],
            frame_dense_bound_ms=pk[name]["dense_bound_ms"],
            frame_stream_ms=pk[name]["stream_ms"],
            frame_batches=pk[name]["batches"],
            sponza_primary={k: out["sponza_primary"][name][k] for k in (
                "ms", "bound_ms", "nofma_floor_ms", "dense_bound_ms")},
            resources=ct.BUILD_INFO["resources"][name],
            **({"resources_at_batch": mask_res} if name == "cluster_mask"
               else {}))
    out["menger_frame"] = dict(frame_ms=frame_ms, timed_frame_ms=timed_ms,
                               launches_per_frame=per_frame, peak_gib=peak,
                               radiance_mean=float(img.mean()))
    del renderer, rec, rsa, stream
    torch.cuda.empty_cache()
    print(f"  (b) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- (c) the megakernel (the cornell_megakernel row) and the DiOracle
    t0 = time.perf_counter()
    reset_all_launches()
    res = cli.main(["--renderer", "megakernel", "--scene", "cornell",
                    "--width", "512", "--height", "512", "--frames", "2",
                    "--traversal", "cluster", "--out",
                    os.path.join(out_dir, "cornell_mk_cluster.png")])
    mk = read_cluster_launches("cornell megakernel cluster")
    r = res["renderer"]
    img = r.radiance()
    if not (np.isfinite(img).all() and img.mean() > 0.0 and r.frame == 2):
        fail("cornell megakernel cluster: radiance is not finite and positive")
    print(f"  cornell_megakernel 512x512 --traversal cluster: frames "
          f"{[round(x, 3) for x in res['frame_ms']]} ms, "
          f"{r.metrics['mrays_per_s']:.2f} Mrays/s, launches {mk}",
          flush=True)
    out["cornell_megakernel"] = dict(frame_ms=res["frame_ms"], launches=mk,
                                     mrays_per_s=r.metrics["mrays_per_s"])
    del res, r
    scene, camera = menger_scene()
    reset_all_launches()
    oracle = DiOracle(scene, camera, RenderConfig(traversal="cluster"))
    ms, _ = cuda_ms(oracle.render)
    di = read_cluster_launches("menger DiOracle cluster")
    img = oracle.radiance()
    if not (np.isfinite(img).all() and img.mean() > 0.0):
        fail("menger DiOracle cluster: radiance is not finite and positive")
    print(f"  menger DiOracle 1920x1080, traversal cluster: construction and"
          f" one frame ({ms:.3f} ms the frame), launches {di}, radiance mean "
          f"{img.mean():.6f}", flush=True)
    out["di_oracle"] = dict(frame_ms=ms, launches=di)
    del oracle
    torch.cuda.empty_cache()
    print(f"  (c) {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- (d) the stream kernels on the morton and median_host accels
    t0 = time.perf_counter()
    o, d = camera_rays(512, 3.0, dev)
    scale = (sponza_tris.amax(dim=(0, 1)) - sponza_tris.amin(dim=(0, 1)))
    center = 0.5 * (sponza_tris.amax(dim=(0, 1))
                    + sponza_tris.amin(dim=(0, 1)))
    o = o * scale.max() * 0.2 + center                 # inside the atrium
    builds = {}
    for method in ("morton", "median_host"):
        ms, acc = cuda_ms(lambda: st.build_stream_accel(sponza_tris, method))
        if method == "morton":
            cpu = st.build_stream_accel(sponza_tris.cpu(), method)
            if not all(torch.equal(getattr(acc, f).cpu(), getattr(cpu, f))
                       for f in ("perm", "blk_tris", "blk_boxes", "top_lo",
                                 "top_hi")):
                fail("sponza morton: the card's build differs from the CPU's")
        rows, wl, went, cnt = st.prepare_stream(o, d, acc, 1e-4, 1e4, 16)
        got = {}
        for name in KERNELS:
            mm, _ = compare_kernel(name, (rows, wl, went, cnt, acc.blk_tris,
                                          acc.blk_boxes))
            mismatches[name].append(dict(mm, case=f"sponza {method}"))
            got[name] = mm
        builds[method] = dict(build_ms=ms, blocks=acc.num_blocks,
                              checks=got)
        print(f"  sponza {method} accel: {acc.num_blocks} blocks, built in "
              f"{ms:.1f} ms; stream_closest and stream_any on "
              f"{rows.shape[0]} lanes equal to the plain version ("
              f"{got['stream_closest']['ties']} exact-t ties)", flush=True)
    out["stream_builds"] = builds
    print(f"  (d) {time.perf_counter() - t0:.1f} s", flush=True)
    return out, entries


# ------------------------------ phase 8 ----------------------------------

MXU_SOURCE = "royaltracer_dx_tpu_torch/csrc/mxu_trace.cu"
# the JAX routines the matmul-form kernels replace: XLA, not Pallas
MXU_KERNELS = {
    "mxu_closest": ("royaltracer_dx_tpu/ops/mxu_trace.py:142",
                    "closest_hit_mxu (_products, _decide, _closest_chunk)"),
    "mxu_any": ("royaltracer_dx_tpu/ops/mxu_trace.py:177",
                "any_hit_mxu (_anyhit_chunk)"),
}
# (scene, width, height) of the phase's paths: the menger accel's 4,802
# triangles at 1080p, the 32-triangle Cornell box at 512x512
MXU_SCENES = (("menger", 1920, 1080), ("cornell", 512, 512))


def bits(x):
    """A tensor's values as integers: float bits (NaN, -0.0 and all), bools
    and ints as they are, for bit-equality."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def mxu_mismatch(name, k_out, p_out, label, mismatches):
    """Kernel outputs against the plain version's, bit for bit: (t, tri,
    u, v) or (occluded, tests).  Fails on any difference."""
    bad = torch.zeros(k_out[0].shape[0], dtype=torch.bool,
                      device=k_out[0].device)
    err = 0.0
    for k, p in zip(k_out, p_out):
        ne = bits(k) != bits(p)
        bad |= ne
        if ne.any() and k.dtype == torch.float32:
            err = max(err, float((k - p).abs()[ne].nan_to_num(
                float("inf")).max()))
    n_bad = int(bad.sum())
    if n_bad:
        fail(f"{name} on {label}: {n_bad} of {bad.numel()} lanes differ from "
             f"the plain version (largest difference {err!r})")
    mismatches.setdefault(name, []).append(dict(case=label, lanes=bad.numel(),
                                                bad=0, max_abs_err=err))


def shadow_batch(o, d, hit, lights, object_to_world):
    """A shadow ray a lane toward the lights' centroid from the primary
    hit (a point 3 units along a ray that missed), t_min 1e-4, t_max
    short of the light; every third lane masked (t_max -1 < t_min)."""
    from royaltracer_dx_tpu_torch.ops import light_sampling as ls

    wv = ls.light_world_verts(lights, object_to_world, torch.arange(
        lights.count, device=o.device))
    target = wv.reshape(-1, 3).mean(dim=0)
    t = torch.where(hit.t < 1e29, hit.t * (1.0 - 1e-4), 3.0)
    x = o + t[:, None] * d
    to = target - x
    dist = torch.linalg.vector_norm(to, dim=1)
    lane = torch.arange(o.shape[0], device=o.device)
    t_max = torch.where(lane % 3 == 0, -1.0, dist * (1.0 - 1e-3))
    return (x.contiguous(), (to / dist[:, None]).contiguous(),
            torch.full_like(dist, 1e-4), t_max.contiguous())


def brute_agreement(label, k_hit, b_hit):
    """The matmul form against brute force at tests/test_mxu_trace.py's
    bars: hit state and t (within 1e-4 max(1, |t|)) on >= 0.999 of the
    lanes, the same triangle on >= 0.98 of the lanes both hit, u / v
    within 2e-4 there."""
    kt, bt = k_hit[0], b_hit.t
    kh, bh = kt < 1e29, bt < 1e29
    both = kh & bh
    close = (kt - bt).abs() <= 1e-4 * torch.clamp_min(bt.abs(), 1.0)
    frac = float(((kh == bh) & (close | ~both)).float().mean())
    same = both & (k_hit[1] == b_hit.tri)
    tri_frac = float(same.sum()) / max(int(both.sum()), 1)
    uv = max(float((k_hit[2] - b_hit.u).abs()[same].max()),
             float((k_hit[3] - b_hit.v).abs()[same].max())) \
        if same.any() else 0.0
    if not (frac >= 0.999 and tri_frac >= 0.98 and uv <= 2e-4):
        fail(f"mxu_closest on {label}: brute-force agreement {frac}, same "
             f"triangle {tri_frac}, u/v difference {uv}")
    return dict(agree=frac, same_tri=tri_frac, uv_max_diff=uv)


def kernel_device_ms(fn, key, reps=5):
    """Device time a call of ``fn`` spends in kernels whose name holds
    ``key``, from torch.profiler over ``reps`` calls: without the host's
    launch gaps, which CUDA events between calls of a small batch time
    too.  None where the profiler records no device event."""
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


def mxu_path(scene_name, w, h, rates, mismatches, plain, dev):
    """One scene's camera batch and shadow batch: the main path through
    closest_hit_mxu / any_hit_mxu with every count set to 0 just before
    and read just after, the kernels against the plain versions
    (``plain``, the functions NoPlain saved) on the whole batches and
    against brute force on a 65,536-lane sample, what the kernels' filter
    kept (their counted builds), and the times of the kernels, the stream
    and LBVH kernels on the same rays, the plain versions and
    torch.matmul of the product alone."""
    from royaltracer_dx_tpu_torch import cli
    from royaltracer_dx_tpu_torch.camera import generate_rays
    from royaltracer_dx_tpu_torch.ops import mxu_trace as mx
    from royaltracer_dx_tpu_torch.ops import stream_trace as st
    from royaltracer_dx_tpu_torch.ops import traverse as tv
    from royaltracer_dx_tpu_torch.ops.bvh import build_lbvh
    from royaltracer_dx_tpu_torch.ops.intersect import (
        any_hit_brute,
        closest_hit_brute,
    )

    scene, camera = cli.build_scene(scene_name)
    sa = scene.flatten(scene.build_materials(device=dev), device=dev)
    ca = {k: torch.as_tensor(x, device=dev)
          for k, x in camera.matrices(w / h).items()}
    o, d = generate_rays(ca, w, h)
    o, d = o.contiguous(), d.contiguous()
    n = o.shape[0]
    tris = sa.tri_verts
    build_ms, mt = cuda_ms(lambda: mx.build_mxu_tris(tris))
    reset_all_launches()
    hit = mx.closest_hit_mxu(o, d, mt)
    rays = {"closest": (o, d, *mx.prepare_rays(o, d, 1e-4, 1e4)[2:]),
            "any": shadow_batch(o, d, hit, sa.lights, sa.object_to_world)}
    occ = mx.any_hit_mxu(*rays["any"][:2], mt, *rays["any"][2:])
    torch.cuda.synchronize()
    got = all_launches()
    launches = {k: got[k] for k in MXU_KERNELS}
    other = {k: v for k, v in got.items() if k not in MXU_KERNELS and v}
    if not all(launches.values()) or other:
        fail(f"{scene_name} mxu path: launches {launches}, others {other}")
    if not torch.isfinite(hit.t).all() or not bool((hit.t < 1e29).any()):
        fail(f"{scene_name} mxu path: no hit or a non-finite t")
    if bool(occ[rays["any"][3] < rays["any"][2]].any()):
        fail(f"{scene_name} mxu path: a masked shadow lane is occluded")
    outs = {"mxu_closest": (hit.t, hit.tri, hit.u, hit.v)}
    _, tests = mx.mxu_any(*rays["any"], mt, stats=True)
    outs["mxu_any"] = (occ, tests)
    idx = sample_lanes(n, dev)
    res = {"triangles": mt.num_tris, "padded": mt.padded, "lanes": n,
           "build_ms": build_ms, "launches": launches,
           "hits": int((hit.t < 1e29).sum()), "occluded": int(occ.sum())}
    acc = st.build_stream_accel(tris)
    bvh = build_lbvh(tris)
    for name, kind in (("mxu_closest", "closest"), ("mxu_any", "any")):
        args = rays[kind]
        sample = tuple(x[idx] for x in args)
        p_fn = plain[f"_{kind}_plain"]
        extra = () if kind == "closest" else (mt.num_tris,)
        plain_ms, p_out = cuda_ms(lambda: p_fn(*args, mt.coeff, mt.center,
                                                *extra))
        mxu_mismatch(name, outs[name], p_out, f"{scene_name} {kind} batch",
                     mismatches)
        del p_out
        k_sample = tuple(x[idx] for x in outs[name])
        if kind == "closest":
            agree = brute_agreement(scene_name, k_sample, closest_hit_brute(
                sample[0], sample[1], tris, sample[2], sample[3]))
        else:
            b_occ = any_hit_brute(sample[0], sample[1], tris, sample[2],
                                  sample[3])
            agree = dict(agree=float((b_occ == k_sample[0]).float().mean()))
            if not agree["agree"] >= 0.999:
                fail(f"mxu_any on {scene_name}: brute-force agreement "
                     f"{agree['agree']}")
        kern = mx.mxu_closest if kind == "closest" else mx.mxu_any
        # warm with two calls: the timed loop holds two calls' outputs
        cuda_ms(lambda: kern(*args, mt), reps=2)
        ms, _ = cuda_ms(lambda: kern(*args, mt), reps=3)
        live = int((args[2] < args[3]).sum())
        work = mx.mxu_work(n, mt, live, int(tests.sum()), kind == "closest")
        fp32 = st.bound_ms(work, *rates)
        tc = mx.tc_bound_ms(work, *rates)
        # the bound: the least time, with the sums on the tensor cores
        bound = dict(fp32, fp32_bound_ms=fp32["bound_ms"], **tc,
                     bound_ms=tc["tc_bound_ms"],
                     bound_by="bytes" if tc["tc_bound_by"] == "bytes"
                     else "operations")
        counts = mx.filter_counts(*args, mt, closest=kind == "closest")
        share = counts["candidates"] / max(counts["pairs"], 1)
        call = st.prepare_stream(args[0], args[1], acc, args[2], args[3],
                                 16)
        s_kern = st.stream_closest if kind == "closest" else st.stream_any
        cuda_ms(lambda: s_kern(*call, acc.blk_tris, acc.blk_boxes), reps=2)
        stream_ms, _ = cuda_ms(lambda: s_kern(*call, acc.blk_tris,
                                               acc.blk_boxes), reps=3)
        packed = tv.pack_rays(*args)
        b_kern = tv.bvh_closest if kind == "closest" else tv.bvh_any
        cuda_ms(lambda: b_kern(packed, bvh), reps=2)
        bvh_ms, _ = cuda_ms(lambda: b_kern(packed, bvh), reps=3)
        feats = torch.cat([torch.stack(mx._features(args[0], args[1],
                                                    mt.center), dim=1),
                           torch.ones((n, 1), device=dev)], dim=1)
        prod = torch.empty((mx._RAY_CHUNK, mt.coeff.shape[1]), device=dev)

        def library():
            for s in range(0, n, mx._RAY_CHUNK):
                f = feats[s:s + mx._RAY_CHUNK]
                torch.matmul(f, mt.coeff, out=prod[:f.shape[0]])

        library()
        library_ms, _ = cuda_ms(library)
        del feats, prod
        # the three kernels' device time alone (Cornell's batch is shorter
        # than a launch from Python)
        device = {
            "mxu": kernel_device_ms(lambda: kern(*args, mt), "trace_kernel"),
            "stream": kernel_device_ms(
                lambda: s_kern(*call, acc.blk_tris, acc.blk_boxes),
                "stream_kernel"),
            "bvh": kernel_device_ms(lambda: b_kern(packed, bvh),
                                    f"bvh_{kind}_kernel")}
        dev_txt = ", ".join(f"{k} {v:.4f}" if v is not None else
                            f"{k} not measured" for k, v in device.items())
        res[name] = dict(ms=ms, plain_ms=plain_ms, plain_lanes=n,
                         stream_ms=stream_ms, bvh_ms=bvh_ms,
                         library_ms=library_ms, work=work, counts=counts,
                         candidate_share=share, device_ms=device, **bound,
                         **agree)
        print(f"  {scene_name} {name}: {n} lanes ({live} live) x "
              f"{mt.num_tris} triangles ({mt.padded} padded): kernel "
              f"{ms:.3f} ms; tensor-core bound {tc['tc_bound_ms']:.3f} ms "
              f"({tc['tc_bound_by']}: TF32 {tc['tc_tf32_ms']:.3f}, FP32 "
              f"{tc['tc_fp32_ms']:.3f}; the kernel at "
              f"{tc['tc_bound_ms'] / ms:.1%}), "
              f"FP32-only bound {fp32['bound_ms']:.3f} ms "
              f"(the kernel at {fp32['bound_ms'] / ms:.1%}; no-FMA floor "
              f"{fp32['nofma_floor_ms']:.3f}; every padded pair "
              f"{work['dense_fp32_ops'] / rates[0] * 1e3:.3f}); filter "
              f"kept {counts['candidates']} of {counts['pairs']} pairs "
              f"({share:.4%}), {counts['accepted']} accepted, "
              f"{counts['exact_rays']} rays on the exact scan; "
              f"stream_{kind} {stream_ms:.3f} ms, bvh_{kind} {bvh_ms:.3f} "
              f"ms on the same rays; device time alone (torch.profiler) "
              f"{dev_txt} ms; torch.matmul of the product alone "
              f"{library_ms:.3f} ms; plain {plain_ms:.3f} ms on the whole "
              f"batch, bit-equal to the kernel; brute force on {len(idx)} "
              f"lanes {agree}", flush=True)
    return res


def aos_on_card(dev):
    """One function of each A'15 family and coherence_order on CUDA
    tensors (the menger scene, 4,096 lanes): each runs and gives finite
    values on the card."""
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.ops import bsdf, light_sampling, reservoir
    from royaltracer_dx_tpu_torch.ops import restir
    from royaltracer_dx_tpu_torch.ops import stream_trace as st
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene
    from royaltracer_dx_tpu_torch.utils import math3d, rng

    scene, _ = menger_scene()
    sa = scene.flatten(scene.build_materials(device=dev), device=dev)
    n = 4096
    o, d = random_rays(n, 0.0, 1.0, 5, dev)
    x2, n2 = random_rays(n, 0.0, 1.0, 6, dev)
    seed = torch.stack([torch.arange(n, device=dev),
                        torch.arange(n, device=dev) * 7 + 1], dim=1)
    mat = restir.fetch_material(sa, torch.zeros(n, dtype=torch.int32,
                                                device=dev))
    u, seed2 = rng.tea_randoms(seed, 3)
    r0 = reservoir.ReservoirDI.zeros_like_lanes(o)
    r1, took, _ = reservoir.update_reservoir_di(
        r0, torch.ones(n, dtype=torch.bool, device=dev), u[:, 0] + 0.1,
        torch.ones(n, device=dev), x2, n2, x2, seed2)
    order, inverse = st.coherence_order(o, d,
                                        st.build_stream_accel(sa.tri_verts))
    out = {
        "math3d.reflect": math3d.reflect(d, n2),
        "rng.tea_randoms": u,
        "bsdf.eval_bsdf_blend": bsdf.eval_bsdf_blend(
            mat["kd"], mat["ks"], mat["metal"], mat["rough"], mat["lut"],
            n2, -d, -d),
        "reservoir.update_reservoir_di": r1.w_sum,
        "light_sampling.select_light": light_sampling.select_light(
            sa.lights, u[:, 1]).float(),
        "restir.get_p_hat_di": restir.get_p_hat_di(
            sa, o, n2, x2, n2, x2, -d, mat, True, RenderConfig()),
        "stream_trace.coherence_order": order[inverse].float(),
    }
    for k, v in out.items():
        if v.device.type != dev.type:
            fail(f"{k}: its output is on {v.device}, not {dev}")
        if not bool(torch.isfinite(v).all()):
            fail(f"{k} on {dev}: a value is not finite")
    if not torch.equal(order[inverse], torch.arange(n, device=dev,
                                                   dtype=order.dtype)):
        fail("coherence_order: the inverse does not invert the order")
    print(f"  AoS families on the card ({n} lanes, menger): "
          f"{', '.join(out)}: finite, on {dev}", flush=True)
    return sorted(out)


def phase_mxu(rates, mismatches):
    """(a) menger and (b) Cornell through the MXU kernels (``mxu_path``),
    (c) the adversarial cases of tools/mxu_cases.py, kernel against plain
    bit for bit, and one AoS function of each family on the card.
    Returns (results, kernel entries)."""
    from royaltracer_dx_tpu_torch.ops import mxu_trace as mx
    from royaltracer_dx_tpu_torch.tools.mxu_cases import MXU_CASES, mxu_case

    from royaltracer_dx_tpu_torch.ops import stream_trace as st

    dev = torch.device("cuda")
    out = {}
    # the built library's SASS must hold the tensor-core products
    sass = subprocess.run(
        [os.path.join(os.path.dirname(st._nvcc()), "cuobjdump"), "-sass",
         mx.BUILD_INFO["path"]], capture_output=True, text=True, timeout=120,
        check=True).stdout
    hmma = sorted(set(re.findall(r"HMMA\.\S*TF32\S*", sass)))
    if not hmma:
        fail("mxu_trace.cu's SASS holds no TF32 HMMA instruction")
    out["sass"] = {k: sass.count(k) for k in hmma}
    print(f"  SASS (cuobjdump): {out['sass']}", flush=True)
    filt = mx.BUILD_INFO["filter"]
    print(f"  filter: one TF32 pass a sum, margins "
          f"2^{filt['kappa_log2']} F Q + 2^{filt['mu_log2']}, safe range "
          f"2^{filt['safe_log2']}, Q over {filt['step']} triangles, "
          f"{filt['rays_per_cta']} rays a CTA", flush=True)
    for name, res in mx.BUILD_INFO["resources"].items():
        print(f"  {name}: {res['ctas_per_sm']} CTAs of {res['threads']} "
              f"threads resident per SM, {res['registers']} registers per "
              f"thread, {res['local_bytes']} B spilled, "
              f"{res['shared_bytes']} B of shared memory per CTA",
              flush=True)
    # the plain versions refuse to run for the whole phase: a kernel that
    # fails to build or launch cannot hand off to them
    with NoPlain(mx, "_closest_plain", "_any_plain") as guard:
        plain = guard.saved
        for scene_name, w, h in MXU_SCENES:
            t0 = time.perf_counter()
            out[scene_name] = mxu_path(scene_name, w, h, rates, mismatches,
                                       plain, dev)
            print(f"  ({scene_name}) {time.perf_counter() - t0:.1f} s",
                  flush=True)
        t0 = time.perf_counter()
        for case in MXU_CASES:
            tris, o, d, lo, hi = mxu_case(case, dev)
            mt = mx.build_mxu_tris(tris)
            k_c = mx.mxu_closest(o, d, lo, hi, mt)
            k_a = mx.mxu_any(o, d, lo, hi, mt, stats=True)
            torch.cuda.synchronize()
            mxu_mismatch("mxu_closest", k_c, plain["_closest_plain"](
                o, d, lo, hi, mt.coeff, mt.center), case, mismatches)
            mxu_mismatch("mxu_any", k_a, plain["_any_plain"](
                o, d, lo, hi, mt.coeff, mt.center, mt.num_tris), case,
                mismatches)
    print(f"  adversarial cases {', '.join(MXU_CASES)} ({len(o)} rays "
          "each): both kernels bit-equal to the plain versions "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    out["aos_on_card"] = aos_on_card(dev)
    entries = {}
    for name, (replaces, fn) in MXU_KERNELS.items():
        big = out["menger"][name]
        entries[name] = dict(
            name=name, route="cuda", source=MXU_SOURCE, replaces=replaces,
            replaces_fn=fn,
            launches=sum(out[s]["launches"][name] for s, _, _ in MXU_SCENES),
            ms=big["ms"], bound_ms=big["bound_ms"], bound_by=big["bound_by"],
            tc_bound_ms=big["tc_bound_ms"], fp32_bound_ms=big["fp32_bound_ms"],
            nofma_floor_ms=big["nofma_floor_ms"], plain_ms=big["plain_ms"],
            plain_lanes=big["plain_lanes"], library_ms=big["library_ms"],
            shape_lanes=out["menger"]["lanes"],
            candidate_share=big["candidate_share"],
            paths={s: {k: out[s][name][k] for k in (
                "ms", "bound_ms", "fp32_bound_ms", "nofma_floor_ms",
                "plain_ms", "library_ms", "stream_ms", "bvh_ms",
                "candidate_share", "device_ms")} for s, _, _ in MXU_SCENES},
            resources=mx.BUILD_INFO["resources"][name],
            filter=mx.BUILD_INFO["filter"])
    return out, entries


# -------------------------------- main -----------------------------------


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="",
                    help="directory for the image (and the --profile trace)")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more frame with torch.profiler")
    args = ap.parse_args()
    if not os.path.exists(os.path.join(ROOT, SOURCE)):
        fail(f"{SOURCE} is not beside this script: run it from a checkout")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, ROOT)
    import royaltracer_dx_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.ops import cluster_traverse as ct
    from royaltracer_dx_tpu_torch.ops import mxu_trace as mx
    from royaltracer_dx_tpu_torch.ops import stream_trace as st
    from royaltracer_dx_tpu_torch.ops import traverse as tv
    from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    if "jax" in sys.modules or any(m.startswith("royaltracer_dx_tpu.")
                                   for m in sys.modules):
        fail("the port pulled in JAX or the JAX package")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        fail("TF32 is on: the port's geometry needs full float32")

    # ---- phase 1: device and build
    t_start = time.perf_counter()
    name_power = nvidia_smi("name,power.limit")
    print(name_power, flush=True)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(dev)
    kind = torch.cuda.get_device_name(0)
    peak_flops, hbm = st.card_rates(kind, props.multi_processor_count,
                                    clock_mhz)
    print(f"phase 1: {kind}, {props.multi_processor_count} SMs, max SM clock "
          f"{clock_mhz:.0f} MHz -> FP32 peak {peak_flops / 1e12:.2f} TFLOP/s, "
          f"memory {hbm / 1e12:.2f} TB/s; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    # one nvcc per source, started together
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        for fut in [pool.submit(st.build_kernels),
                    pool.submit(tv.build_kernels),
                    pool.submit(ct.build_kernels),
                    pool.submit(mx.build_kernels)]:
            fut.result()
    for info in (st.BUILD_INFO, tv.BUILD_INFO, ct.BUILD_INFO,
                 mx.BUILD_INFO):
        print(f"  built {os.path.relpath(info['path'], ROOT)} in "
              f"{info['seconds']:.1f} s ({' '.join(info['flags'])})",
              flush=True)
        for line in info["log"].splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                print(f"  ptxas: {line.strip()}", flush=True)
    for name, res in st.BUILD_INFO["resources"].items():
        print(f"  {name}: {res['ctas_per_sm']} CTAs of 128 threads resident "
              f"per SM, {res['registers']} registers per thread, "
              f"{res['shared_bytes']} B of shared memory per CTA", flush=True)
        if res["ctas_per_sm"] < 2:
            fail(f"{name}: fewer than 2 CTAs fit an SM")
    for name, res in tv.BUILD_INFO["resources"].items():
        print(f"  {name}: {res['ctas_per_sm']} blocks of {res['threads']} "
              f"threads resident per SM, {res['registers']} registers per "
              f"thread, {res['shared_bytes']} B of dynamic shared memory "
              "per block", flush=True)
    for name, res in ct.BUILD_INFO["resources"].items():
        print(f"  {name}: {res['ctas_per_sm']} CTAs of {res['threads']} "
              f"threads resident per SM at tiles and clusters of 128, "
              f"{res['registers']} registers per thread, "
              f"{res['local_bytes']} B spilled per thread, "
              f"{res['shared_bytes']} B of shared memory per CTA",
              flush=True)
    for name, res in mx.BUILD_INFO["resources"].items():
        print(f"  {name}: {res['ctas_per_sm']} CTAs of {res['threads']} "
              f"threads resident per SM, {res['registers']} registers per "
              f"thread, {res['local_bytes']} B spilled per thread, "
              f"{res['shared_bytes']} B of shared memory per CTA",
              flush=True)

    # ---- the scene of the main path
    scene, camera = menger_scene()
    cfg = RenderConfig()
    renderer = RestirRenderer(scene, camera, cfg)
    sa = renderer.scene_arrays
    print(f"  menger scene: {sa.num_triangles} triangles, stream accel "
          f"{sa.stream.num_blocks} blocks x 32 clusters", flush=True)

    # ---- phase 2: kernels against their plain versions
    print("phase 2: kernels vs plain versions", flush=True)
    mismatches = phase_kernels(dev, sa)

    # ---- phase 3: frames (the counted main-path run)
    print(f"phase 3: {cfg.width}x{cfg.height} menger frames", flush=True)
    torch.cuda.reset_peak_memory_stats()
    frame_ms, launches = phase_frames(renderer)
    img = renderer.radiance()
    if not np.isfinite(img).all():
        fail("radiance has non-finite values")
    if not img.mean() > 0.0:
        fail(f"radiance mean {img.mean()} is not positive")
    count = renderer.fb.count
    if not bool((count == 5).all()):
        fail(f"fb.count is not 5 everywhere (min {float(count.min())}, max "
             f"{float(count.max())})")
    off = on_card(renderer)
    if off:
        fail(f"state tensors off the card: {off}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    timed = frame_ms[1:]
    lanes = renderer.metrics["ray_lanes"]
    print(f"  timed frames: {[round(x, 3) for x in timed]} ms, mean "
          f"{sum(timed) / len(timed):.3f} ms; {lanes} ray lanes per frame "
          f"({renderer.metrics['rays_traced']:.0f} active rays); radiance "
          f"mean {img.mean():.6f}; max memory allocated {peak_gb:.2f} GiB",
          flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        write_png(os.path.join(args.out, "menger_1080p.png"),
                  renderer.image())

    # ---- each kernel at the main path's largest batch: its frame output
    # against the plain version on the same inputs, then the timings
    prof_ms, per_kernel, largest = profile_frame(renderer)
    print(f"  frame with timed launches: {prof_ms:.3f} ms", flush=True)
    entries = []
    for name, replaces in KERNELS.items():
        pk = per_kernel[name]
        lanes_n, call, out = largest[name]
        frame_bound = print_batches(pk["batches"], (peak_flops, hbm))
        print(f"  {name}: {pk['frame_launches']} launches, "
              f"{pk['frame_ms']:.3f} ms per frame (bound {frame_bound:.3f} "
              "ms)", flush=True)
        e = kernel_vs_plain("menger", name, call, out, (peak_flops, hbm),
                            mismatches)
        entries.append(dict(
            e, name=name, route="cuda", source=SOURCE,
            replaces=REPLACES, replaces_fn=replaces,
            launches=launches[name], library_ms=None,
            shape_lanes=lanes_n,
            frame_ms=pk["frame_ms"], frame_bound_ms=frame_bound,
            frame_launches=pk["frame_launches"],
            frame_batches=pk["batches"], mismatch=mismatches[name],
            resources=st.BUILD_INFO["resources"][name]))
    agree = small_frames_agree()
    profile = device_profile(renderer, args.out) if args.profile else None
    del renderer, sa
    torch.cuda.empty_cache()

    # ---- phase 4: the CLI's scenes
    print("phase 4: scenes at 1920x1080", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = args.out or tmp
        os.makedirs(out_dir, exist_ok=True)
        scenes, by_kernel = phase_scenes(
            out_dir, (peak_flops, hbm), mismatches,
            args.out if args.profile else None)
        print(f"  scenes phase {time.perf_counter() - t0:.1f} s", flush=True)

        # ---- phase 5: the megakernel Renderer and the DiOracle
        print("phase 5: oracles", flush=True)
        t0 = time.perf_counter()
        oracles, by_kernel_o = phase_oracles(
            out_dir, (peak_flops, hbm), mismatches,
            {k: by_kernel[k]["sponza"] for k in KERNELS},
            args.out if args.profile else None)
        print(f"  oracles phase {time.perf_counter() - t0:.1f} s", flush=True)

        # ---- phase 6: pixel-band sharding and the LBVH kernels
        print("phase 6: sharding and LBVH", flush=True)
        t0 = time.perf_counter()
        sharding = phase_sharding((peak_flops, hbm), out_dir)
        lbvh, bvh_entries = phase_lbvh(
            out_dir, (peak_flops, hbm), mismatches,
            {k: v for k, v in scenes["terrain"]["rates"].items()})
        print(f"  sharding and LBVH phase {time.perf_counter() - t0:.1f} s",
              flush=True)

        # ---- phase 7: the cluster traversal
        print("phase 7: cluster traversal", flush=True)
        t0 = time.perf_counter()
        cluster, cluster_entries = phase_cluster(out_dir, (peak_flops, hbm),
                                                 mismatches)
        print(f"  cluster phase {time.perf_counter() - t0:.1f} s",
              flush=True)

    # ---- phase 8: the MXU study's kernels
    print("phase 8: mxu", flush=True)
    t0 = time.perf_counter()
    mxu, mxu_entries = phase_mxu((peak_flops, hbm), mismatches)
    print(f"  mxu phase {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- phases 9-10: the kernels line and the ok line
    for e in entries:
        e["scenes"] = dict(by_kernel[e["name"]], **by_kernel_o[e["name"]])
        e["max_abs_err"] = max(c["max_abs_err"] for c in mismatches[e["name"]])
    for name in BVH_KERNELS:
        checks = mismatches[name]
        bvh_entries[name].update(
            max_abs_err=max(c["max_abs_err"] for c in checks),
            mismatch=dict(launches_checked=len(checks),
                          lanes_checked=sum(c["lanes"] for c in checks),
                          lanes_differ=sum(c["bad"] for c in checks)))
        entries.append(bvh_entries[name])
    for name, e in cluster_entries.items():
        checks = mismatches[name]
        e.update(max_abs_err=max(c["max_abs_err"] for c in checks),
                 mismatch=dict(tile_slices_checked=len(checks),
                               lanes_checked=sum(c["lanes"] for c in checks),
                               values_differ=sum(c["bad"] for c in checks)))
        entries.append(e)
    for name, e in mxu_entries.items():
        checks = mismatches[name]
        e.update(max_abs_err=max(c["max_abs_err"] for c in checks),
                 mismatch=dict(cases_checked=len(checks),
                               lanes_checked=sum(c["lanes"] for c in checks),
                               lanes_differ=sum(c["bad"] for c in checks)))
        entries.append(e)
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": entries, "frame_ms": timed,
                      "small_frames_agree": agree, "profile": profile,
                      "scenes": scenes, "oracles": oracles,
                      "sharding": sharding, "lbvh": lbvh,
                      "cluster": cluster, "mxu": mxu,
                      "device": name_power}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
