"""Cell kind ``animated_frames``: the reference's real-time loop
(RoyalTracer-DX ``Renderer::OnUpdate`` moves an instance every frame,
``OnRender`` refits the acceleration structure before the passes).  A
fixed camera; frame 0 is rendered at the rest pose; each frame k >= 1 is
``Scene.set_transform`` of the configuration's ``motion`` instance to its
pose at k (``reference/motion.py``), ``RestirRenderer.update()`` and
``render()``, all three inside the frame's time.  k counts the
``render()`` calls since the renderer was built, warm-ups included, so
every run moves the same way; the seed picks the starting frame counter
(every pass's TEA seeds) and the pixels the check compares.  Traffic
keys: ``warmup_frames``, ``start_frame_span``, ``check_tiles``,
``check_tile``, ``check_grid``, as in the ``frames`` kind.

The check compares the frame from zeros at the rest pose (``start``) and
the window's last frame from the state before it, at its pose with the
previous frame's pose as the previous transform (``last``), each against
the reference baked at those poses.  The first tile's centre ray hits
the moving instance, so the check always holds pixels that move.  Each
traced frame takes one more pose step, ``update()`` inside it; the
reference gives the trace yardstick the first traced frame's pose.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from harness import check, scenes, traffic
from harness.manifest import ManifestError, load_plugin
from reference import camera as rcam
from reference import math3d as m3
from reference import motion
from reference import trace as rtrace

_frames = load_plugin("kinds", "frames",
                      os.path.dirname(os.path.dirname(os.path.abspath(
                          __file__))))


def check_tiles(seed: int, spec: dict, sa, mats, cfg, instance: int) -> list:
    """``check_tiles`` tiles (x0, y0, w, h) of ``check_tile`` pixels a side
    among ``harness.traffic.check_tiles``' candidates (a ``check_grid`` x
    ``check_grid`` grid of positions at least the spatial radius from the
    borders whose centre pixel's camera ray hits a non-emissive surface),
    drawn from the seed: the first among those whose centre ray hits
    ``instance``, the others among the rest."""
    tile = int(spec["check_tile"])
    grid = int(spec["check_grid"])
    margin = cfg.spatial_radius + 1
    w, h = cfg.width, cfg.height
    xs = torch.linspace(margin, w - tile - margin, grid).round().long()
    ys = torch.linspace(margin, h - tile - margin, grid).round().long()
    cand = sorted({(int(x), int(y)) for y in ys for x in xs},
                  key=lambda c: (c[1], c[0]))
    dev = sa.device
    cx = torch.tensor([x + tile // 2 for x, _ in cand], device=dev)
    cy = torch.tensor([y + tile // 2 for _, y in cand], device=dev)
    o, d = rcam.generate_rays(mats, w, h, xs=cx, ys=cy)
    d = m3.normalize(d)
    hit = rtrace.closest_hit(tuple(o[:, c].contiguous() for c in range(3)),
                             tuple(d[:, c] for c in range(3)), sa.tri_verts,
                             1e-4, 1e4)
    tri = hit.tri.clamp(0, sa.num_triangles - 1)
    ke = sa.materials.ke[sa.tri_material[tri].long()].sum(-1)
    ok = (hit.valid & (ke <= 0.0)).cpu().tolist()
    mover = (sa.tri_instance[tri] == instance).cpu().tolist()
    good = [c for c, k in zip(cand, ok) if k]
    moving = [c for c, k, m in zip(cand, ok, mover) if k and m]
    if not moving:
        raise ValueError("no check position sees the moving instance")
    r = traffic.rng(seed ^ 0x5EED)
    first = r.choice(moving)
    rest = [c for c in good if c != first]
    pick = [first] + r.sample(rest, min(int(spec["check_tiles"]) - 1,
                                        len(rest)))
    return [(x, y, tile, tile) for x, y in pick]


class Cell(_frames.Cell):
    def __init__(self, cell, seed: int, device="cuda"):
        super().__init__(cell, seed, device)
        self.motion = cell.config["motion"]
        self.k = 0              # render() calls since the renderer was built
        self.ref_k = 0          # the pose reference() bakes
        self._input = None      # (reference SceneInput, camera, config)
        self._baked = {}        # pose -> reference SceneArrays

    def step(self) -> None:
        """One frame of the loop: at k >= 1 move the instance, update,
        then render."""
        if self.k > 0:
            self.r.scene.set_transform(int(self.motion["instance"]),
                                       motion.pose(self.k, self.motion))
            self.r.update()
        self.r.render()
        self.k += 1

    def setup(self) -> None:
        from royaltracer_dx_tpu_torch.render.restir_renderer import (
            RestirRenderer,
        )

        cfg = self.cell.config
        t = [time.perf_counter()]
        scene, camera, self.path = scenes.program_scene(cfg,
                                                        self.cell.bench_dir)
        t.append(time.perf_counter())
        self.r = RestirRenderer(scene, camera, scenes.program_config(cfg),
                                device=self.device)
        t.append(time.perf_counter())
        self.start = traffic.start_frame(self.seed, self.cell.traffic)
        self.r.frame = self.start
        self.step()
        self.first = _frames._state(self.r)     # the start, for the check
        for _ in range(int(self.cell.traffic["warmup_frames"]) - 1):
            t.append(time.perf_counter())
            self.step()
        t.append(time.perf_counter())
        self.setup_parts = dict(zip(
            ("scene", "renderer", "frame 1", "frame 2", "frame 3"),
            (b - a for a, b in zip(t, t[1:]))))

    def window(self, seconds: float) -> dict:
        end = time.perf_counter() + seconds
        while True:
            pre, k = _frames._state(self.r), self.k
            t0 = time.perf_counter()
            self.step()
            self.frame_s.append(time.perf_counter() - t0)
            if time.perf_counter() >= end:
                break
        self.last_pre, self.last_post = pre, _frames._state(self.r)
        self.last_frame, self.last_k = self.r.frame - 1, k
        return {"frame_ms": 1e3 * sum(self.frame_s) / len(self.frame_s)}

    def traced(self) -> dict:
        self.ref_k = self.k
        ctx = self._traced(self.step)
        return dict(ctx, kind="frame",
                    frame_ms=[1e3 * s for s in self.frame_s],
                    update_tris=self._scene_input()[0].num_triangles)

    def _scene_input(self):
        """(reference SceneInput, camera arrays, RenderConfig), built
        once."""
        if self._input is None:
            from reference.config import from_render

            t0 = time.perf_counter()
            cfg = self.cell.config
            kind = load_plugin("scenes", cfg["scene"]["kind"],
                               self.cell.bench_dir)
            s = kind.reference(cfg, self.path)
            if s.num_triangles != int(cfg["triangles"]):
                raise ManifestError(
                    f"{cfg['name']}: the reference's scene has "
                    f"{s.num_triangles} triangles, the configuration "
                    f"states {cfg['triangles']}")
            rcfg = from_render(cfg["render"])
            cam = rcam.Camera(eye=tuple(cfg["camera"]["eye"]),
                              center=tuple(cfg["camera"]["center"]))
            mats = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                       device=self.device)
                    for k, v in cam.matrices(rcfg.width / rcfg.height).items()}
            self._input = (s, mats, rcfg)
            self.reference_s += time.perf_counter() - t0
        return self._input

    def reference_at(self, k: int):
        """(reference SceneArrays at frame k's pose, camera arrays,
        RenderConfig)."""
        s, mats, rcfg = self._scene_input()
        if k not in self._baked:
            t0 = time.perf_counter()
            self._baked[k] = motion.bake_at(s, self.motion, k, self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.reference_s += time.perf_counter() - t0
        return self._baked[k], mats, rcfg

    def reference(self):
        return self.reference_at(self.ref_k)

    def check(self, control: bool = False) -> dict:
        from reference import passes

        sa, mats, rcfg = self.reference_at(0)
        tiles = check_tiles(self.seed, self.cell.traffic, sa, mats, rcfg,
                            int(self.motion["instance"]))
        pix = passes.tile_pixels(rcfg, tiles, self.device)
        out = {}
        runs = (("start", passes.initial_state(rcfg, self.device),
                 self.start, self.first, 0),
                ("last", self.last_pre, self.last_frame, self.last_post,
                 self.last_k))
        for name, st0, frame, st1, k in runs:
            sa = self.reference_at(k)[0]
            tied = traffic.camera_ties(sa, mats, rcfg, pix)
            ref = passes.frame_at(sa, mats, rcfg, st0, frame, tiles)
            ctl = dataclasses.replace(sa, trace_dtype=torch.bfloat16)
            got = (passes.frame_at(ctl, mats, rcfg, st0, frame, tiles)
                   if control else check.program_pixels(st1, pix))
            out[f"off_pct.{name}"] = check.frame_off_pct(ref, got, tied)
        return out
