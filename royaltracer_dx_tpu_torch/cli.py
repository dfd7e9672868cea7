"""Headless CLI of the port (port of royaltracer_dx_tpu/cli.py): the same
flags and scenes, rendering with the port's RestirRenderer (or, with
``--renderer megakernel``, the megakernel ``Renderer``) on the card, or on
the CPU with ``--cpu``.

Usage:
  python -m royaltracer_dx_tpu_torch.cli --scene cornell --frames 64 \\
      --out out.png
  python -m royaltracer_dx_tpu_torch.cli --scene sponza --width 1920 \\
      --height 1080 --frames 100 --snapshot-every 25 --checkpoint ck.npz
  python -m royaltracer_dx_tpu_torch.cli --cpu --scene cornell \\
      --width 64 --height 64 --frames 4
  python -m royaltracer_dx_tpu_torch.cli --renderer megakernel \\
      --scene sponza --width 1920 --height 1080 --frames 16

  python -m royaltracer_dx_tpu_torch.cli --scene sponza --bvh \
      --width 1920 --height 1080 --frames 8
  python -m royaltracer_dx_tpu_torch.cli --cpu --devices 2 --scene cornell \
      --width 32 --height 32 --frames 3
  python -m royaltracer_dx_tpu_torch.cli --scene menger --traversal \
      cluster --width 1920 --height 1080 --frames 8

``--bvh`` (or ``--traversal bvh``) traces through the LBVH kernels,
``--traversal cluster`` through the tile-clustered kernels (both
renderers, and with ``--devices``).  ``--devices N`` shards the ReSTIR
render into N pixel bands (``parallel/shard.py``): with ``--cpu`` N bands
on the CPU (the JAX CLI's virtual host devices), else on cuda:0 ..
cuda:N-1; as in the JAX CLI the megakernel renderer ignores it.
``--scene reference`` reads garage.obj and monke.obj from
$ROYALTRACER_REFERENCE_INCLUDE (default: ``reference/`` at the repo root)
and fails, as the JAX CLI does, when they are absent.  ``main`` returns
the renderer and the per-frame times.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_INCLUDE = os.environ.get("ROYALTRACER_REFERENCE_INCLUDE",
                                   os.path.join(_ROOT, "reference"))


def build_scene(name: str):
    """(Scene, Camera) of a named scene (cli.py:27-101)."""
    from royaltracer_dx_tpu_torch.camera import Camera
    from royaltracer_dx_tpu_torch.scene.procedural import (
        cornell_box,
        many_lights,
        menger_scene,
    )
    from royaltracer_dx_tpu_torch.scene.scene import Scene

    if name == "cornell":
        return cornell_box(emission=18.0), Camera(
            eye=(0.5, 0.5, 1.72), center=(0.5, 0.5, 0.0))
    if name == "reference":
        # the reference's hardcoded scene: garage + monke, identity
        # instances
        s = Scene()
        for model in ("garage.obj", "monke.obj"):
            s.add_instance(s.add_obj(os.path.join(REFERENCE_INCLUDE, model)))
        return s, Camera(eye=(-1.5, 1.5, 3.5), center=(0.0, 1.0, 0.0))
    if name == "many_lights":
        return many_lights(), Camera(eye=(0.0, 1.1, 3.2),
                                     center=(0.0, 0.8, 0.0))
    if name in ("sponza", "bunny", "dragon"):
        from royaltracer_dx_tpu_torch.scene.assets import ensure_asset

        s = Scene()
        if name == "sponza":
            s.add_instance(s.add_obj(ensure_asset("sponza_atrium")))
            return s, Camera(eye=(-9.5, 2.2, 0.0), center=(6.0, 3.4, 0.0))
        mesh = s.add_obj(ensure_asset(name))
        s.add_instance(mesh)
        lo = s.meshes[mesh].vertices.min(axis=0)
        hi = s.meshes[mesh].vertices.max(axis=0)
        ground_y = float(lo[1]) - 0.02
        ext = float(max(hi[0] - lo[0], hi[2] - lo[2])) * 2.0
        grey = s.add_material(kd=(0.55, 0.55, 0.55, 1.0))
        light = s.add_material(ke=(18.0, 17.0, 15.0))
        gv = np.array([[-ext, ground_y, -ext], [ext, ground_y, -ext],
                       [ext, ground_y, ext], [-ext, ground_y, ext]],
                      np.float32)
        gm = s.add_mesh(gv, np.asarray([[0, 2, 1], [0, 3, 2]], np.int32),
                        tri_material=np.asarray([grey, grey], np.int32))
        s.add_instance(gm)
        ly = float(hi[1]) + 0.35 * ext
        lv = np.array([[-0.25 * ext, ly, -0.25 * ext],
                       [0.25 * ext, ly, -0.25 * ext],
                       [0.25 * ext, ly, 0.25 * ext],
                       [-0.25 * ext, ly, 0.25 * ext]], np.float32)
        lm = s.add_mesh(lv, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
                        tri_material=np.asarray([light, light], np.int32))
        s.add_instance(lm)
        size = float(np.linalg.norm(hi - lo))
        c = 0.5 * (lo + hi)
        return s, Camera(eye=(float(c[0]) + 0.9 * size,
                              float(c[1]) + 0.45 * size,
                              float(c[2]) + 0.9 * size),
                         center=(float(c[0]), float(c[1]), float(c[2])))
    if name == "menger":
        return menger_scene()
    raise SystemExit(
        f"unknown scene {name!r} (cornell | reference | many_lights | menger"
        " | sponza | bunny | dragon)")


def _sync(renderer) -> None:
    import torch

    for d in set(getattr(renderer, "devices", [renderer.device])):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _band_devices(args) -> list[str]:
    """The --devices bands: N on the CPU with --cpu, else one per card
    (cli.py:160-166)."""
    if args.cpu:
        return ["cpu"] * args.devices
    import torch

    present = torch.cuda.device_count()
    if present < args.devices:
        raise SystemExit(f"--devices {args.devices} but only {present} "
                         "present")
    return [f"cuda:{i}" for i in range(args.devices)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="cornell")
    ap.add_argument("--renderer", default="restir",
                    choices=("restir", "megakernel"))
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--bvh", action="store_true", help="use the LBVH tracer")
    ap.add_argument("--traversal", default="",
                    choices=("", "brute", "cluster", "bvh"),
                    help="acceleration scheme (default: auto; on the card "
                         "every trace runs the stream kernels, or with bvh "
                         "or cluster the LBVH or cluster kernels)")
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--snapshot-every", type=int, default=0)
    ap.add_argument("--checkpoint", default="", help="save/resume state npz")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (the kernels' plain versions)")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the ReSTIR render over N devices "
                         "(pixel-band data parallelism)")
    ap.add_argument("--animate", action="store_true",
                    help="rotate instance 1 per frame and refit (the "
                         "reference's OnUpdate animation)")
    ap.add_argument("--aov", default="", metavar="CHANNEL",
                    help="also write AOV debug channels: a channel name or "
                         "'all'")
    ap.add_argument("--profile", default="",
                    help="write a torch.profiler trace to this directory")
    ap.add_argument("--seed-mode", default="frame", choices=("frame", "time"),
                    help="TEA seed time term: frame counter (deterministic)"
                         " or wall-clock nanos (the reference's behavior)")
    args = ap.parse_args(argv)

    import torch

    import royaltracer_dx_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from royaltracer_dx_tpu_torch.config import RenderConfig
    from royaltracer_dx_tpu_torch.io.checkpoint import (
        load_renderer_state,
        save_renderer_state,
    )
    from royaltracer_dx_tpu_torch.parallel.shard import ShardedRestirRenderer
    from royaltracer_dx_tpu_torch.render.renderer import Renderer
    from royaltracer_dx_tpu_torch.render.restir_renderer import RestirRenderer
    from royaltracer_dx_tpu_torch.utils.image import write_png

    cfg = RenderConfig(width=args.width, height=args.height,
                       max_bounces=args.bounces, use_bvh=args.bvh,
                       traversal=args.traversal or "auto",
                       seed_mode=args.seed_mode)
    scene, camera = build_scene(args.scene)
    if args.devices > 1 and args.renderer == "restir":
        r = ShardedRestirRenderer(scene, camera, cfg,
                                  devices=_band_devices(args))
    else:
        cls = RestirRenderer if args.renderer == "restir" else Renderer
        r = cls(scene, camera, cfg, device="cpu" if args.cpu else None)
    if args.checkpoint and os.path.exists(args.checkpoint):
        load_renderer_state(args.checkpoint, r)
        print(f"resumed from {args.checkpoint} at frame {r.frame}")

    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if r.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()

    frame_ms, refit_ms = [], []
    t_start = time.perf_counter()
    for i in range(args.frames):
        if args.animate and len(scene.instance_mesh) > 1:
            ang = 1.57 * (i + 1) / max(args.frames, 1)
            c, sn = np.cos(ang), np.sin(ang)
            rot = np.array([[c, 0, sn, 0], [0, 1, 0, 0],
                            [-sn, 0, c, 0], [0, 0, 0, 1]], np.float32)
            scene.set_transform(1, rot)
            t0 = time.perf_counter()
            r.update()
            _sync(r)
            refit_ms.append((time.perf_counter() - t0) * 1e3)
        r.render()
        m = r.metrics
        frame_ms.append(m["frame_time_s"] * 1e3)
        if i == 0 or (i + 1) % 10 == 0:
            refit = f", refit {refit_ms[-1]:.1f} ms" if refit_ms else ""
            print(f"frame {r.frame}: {m['frame_time_s'] * 1e3:.1f} ms"
                  f" ({m['fps']:.1f} fps) {m['mrays_per_s']:.2f} Mrays/s"
                  f"{refit}", flush=True)
        if args.snapshot_every and (i + 1) % args.snapshot_every == 0:
            base, ext = os.path.splitext(args.out)
            write_png(f"{base}_{r.frame:05d}{ext or '.png'}", r.image())
    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"profiler trace -> {trace}")
    write_png(args.out, r.image())
    if args.checkpoint:
        save_renderer_state(args.checkpoint, r)
        print(f"checkpoint -> {args.checkpoint}")
    dt = time.perf_counter() - t_start
    print(f"{args.frames} frames in {dt:.1f}s -> {args.out}")

    if args.aov:
        from royaltracer_dx_tpu_torch.render.aov import CHANNELS, render_aovs

        aovs = render_aovs(r.scene_arrays, r._camera_arrays(), cfg)
        wanted = CHANNELS if args.aov == "all" else (args.aov,)
        base, ext = os.path.splitext(args.out)
        for ch in wanted:
            img = (aovs[ch].to(torch.float32).cpu().numpy()
                   .reshape(cfg.height, cfg.width, -1))
            if img.shape[-1] == 1:
                img = np.repeat(img, 3, axis=-1)
            lo, hi = float(img.min()), float(img.max())
            img = (img - lo) / max(hi - lo, 1e-9)
            write_png(f"{base}.{ch}{ext}", img[..., :3])
            print(f"aov {ch} -> {base}.{ch}{ext}")
    return dict(renderer=r, frame_ms=frame_ms, refit_ms=refit_ms)


if __name__ == "__main__":
    main()
