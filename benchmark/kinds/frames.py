"""Cell kind ``frames``: progressive ReSTIR frames of a fixed camera
(``RestirRenderer.render()`` back to back).  Traffic keys:
``warmup_frames``, ``start_frame_span`` (the seed picks the first frame's
counter, i.e. every pass's TEA seeds), ``check_tiles``, ``check_tile``,
``check_grid`` (the pixels the check compares)."""

from __future__ import annotations

import dataclasses
import time

import torch

from harness import check, scenes, traffic
from harness.cells import BaseCell


def _state(r) -> dict:
    """References to a RestirRenderer's state (every frame replaces these
    tensors, none is written in place)."""
    return dict(last_di=r.last_di, last_gi=r.last_gi,
                last_sdata=r.last_sdata, fb=r.fb, l1=r.l1,
                prev_view=r._prev_view, prev_proj=r._prev_proj)


class Cell(BaseCell):
    def __init__(self, cell, seed: int, device="cuda"):
        super().__init__(cell, seed, device)
        self.frame_s = []

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
        self.r.render()
        self.first = _state(self.r)         # the start, for the check
        for _ in range(int(self.cell.traffic["warmup_frames"]) - 1):
            t.append(time.perf_counter())
            self.r.render()
        t.append(time.perf_counter())
        self.setup_parts = dict(zip(
            ("scene", "renderer", "frame 1", "frame 2", "frame 3"),
            (b - a for a, b in zip(t, t[1:]))))

    def describe(self) -> str:
        """Frame times of the window, for the log."""
        v = sorted(1e3 * s for s in self.frame_s)
        return (f"frames: {len(v)}, ms min {v[0]:.1f} median "
                f"{v[len(v) // 2]:.1f} max {v[-1]:.1f}")

    def window(self, seconds: float) -> dict:
        end = time.perf_counter() + seconds
        while True:
            pre = _state(self.r)
            t0 = time.perf_counter()
            self.r.render()
            self.frame_s.append(time.perf_counter() - t0)
            if time.perf_counter() >= end:
                break
        self.last_pre, self.last_post = pre, _state(self.r)
        self.last_frame = self.r.frame - 1
        return {"frame_ms": 1e3 * sum(self.frame_s) / len(self.frame_s)}

    @property
    def attempted(self) -> int:
        return len(self.frame_s)

    def traced(self) -> dict:
        ctx = self._traced(self.r.render)
        return dict(ctx, kind="frame",
                    frame_ms=[1e3 * s for s in self.frame_s])

    def free(self) -> None:
        """Drop the renderer; its states that the check reads stay."""
        self.r = None

    def check(self, control: bool = False) -> dict:
        from reference import passes

        sa, mats, rcfg = self.reference()
        tiles = traffic.check_tiles(self.seed, self.cell.traffic, sa, mats,
                                    rcfg)
        pix = passes.tile_pixels(rcfg, tiles, self.device)
        tied = traffic.camera_ties(sa, mats, rcfg, pix)
        ctl = dataclasses.replace(sa, trace_dtype=torch.bfloat16)
        out = {}
        runs = (("start", passes.initial_state(rcfg, self.device),
                 self.start, self.first),
                ("last", self.last_pre, self.last_frame, self.last_post))
        for name, st0, frame, st1 in runs:
            ref = passes.frame_at(sa, mats, rcfg, st0, frame, tiles)
            got = (passes.frame_at(ctl, mats, rcfg, st0, frame, tiles)
                   if control else check.program_pixels(st1, pix))
            out[f"off_pct.{name}"] = check.frame_off_pct(ref, got, tied)
        return out


