"""Cell kind ``wavefront``: batches of rays traced one after another
through the port's ``restir.trace_closest`` / ``trace_occluded``.  Traffic
keys: ``warmup_wavefronts``, ``batches`` (each a ray kind,
``rays/<rays>.py``, with its parameters, and a query, ``closest`` or
``any``), ``check_rays`` (the rays a batch that the check compares)."""

from __future__ import annotations

import dataclasses
import time

import torch

from harness import check, scenes, traffic
from harness.cells import BaseCell


class Cell(BaseCell):
    def __init__(self, cell, seed: int, device="cuda"):
        super().__init__(cell, seed, device)
        self.waves = 0

    def setup(self) -> None:
        cfg = self.cell.config
        t = [time.perf_counter()]
        scene, _, self.path = scenes.program_scene(cfg, self.cell.bench_dir)
        self.cfg = scenes.program_config(cfg)
        self.sa = scene.flatten(scene.build_materials(device=self.device),
                                build_stream=True, device=self.device)
        t.append(time.perf_counter())
        # the rays are made from the reference's scene arrays, whose
        # build (``reference_s``) is not the program's set-up
        ref, mats, rcfg = self.reference()
        self.batches = traffic.wavefront(self.seed, self.cell.traffic, ref,
                                         mats, rcfg, self.cell.bench_dir)
        self.rays = sum(b["o"].shape[0] for b in self.batches)
        t.append(time.perf_counter())
        for _ in range(int(self.cell.traffic["warmup_wavefronts"])):
            self._wave()
        t.append(time.perf_counter())
        parts = [b - a for a, b in zip(t, t[1:])]
        parts[1] -= self.reference_s
        self.setup_parts = dict(zip(("scene", "rays", "warm-up"), parts))

    def describe(self) -> str:
        return (f"wavefronts: {self.waves} of {self.rays} rays, "
                f"{self.elapsed / max(self.waves, 1) * 1e3:.1f} ms each")

    def _wave(self) -> list:
        from royaltracer_dx_tpu_torch.ops import restir

        out = []
        for b in self.batches:
            if b["query"] == "closest":
                out.append(restir.trace_closest(self.sa, b["o"], b["d"],
                                                self.cfg, t_min=b["t_min"]))
            else:
                out.append(restir.trace_occluded(self.sa, b["o"], b["d"],
                                                 b["t_min"], b["t_max"],
                                                 self.cfg))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            self.answers = self._wave()
            self.waves += 1
            if time.perf_counter() >= end:
                break
        self.elapsed = time.perf_counter() - t0
        return {"trace_mrays_per_s":
                self.rays * self.waves / self.elapsed / 1e6}

    @property
    def attempted(self) -> int:
        return self.rays * self.waves

    def traced(self) -> dict:
        return dict(self._traced(self._wave), kind="wavefront",
                    wave_ms=1e3 * self.elapsed / self.waves)

    def free(self) -> None:
        """Drop the program's scene arrays; the answers stay."""
        self.sa = None

    def check(self, control: bool = False) -> dict:
        from reference import restir as rrestir
        from reference import trace as rtrace

        def planes(a):
            return tuple(a[:, c] for c in range(3))

        answers = self.answers
        ref_sa, _, rcfg = self.reference()
        ctl = dataclasses.replace(ref_sa, trace_dtype=torch.bfloat16)
        g = traffic.generator(self.seed ^ 0xC0FFEE, self.device)
        k = int(self.cell.traffic["check_rays"])
        closest, occl = [], []
        for b, got in zip(self.batches, answers):
            n = b["o"].shape[0]
            idx = torch.randperm(n, generator=g, device=self.device)[:k]
            o, d = b["o"][idx], b["d"][idx]
            if b["query"] == "closest":
                hit = rtrace.closest_hit(planes(o), planes(d),
                                         ref_sa.tri_verts, b["t_min"], 1e4)
                ties = rtrace.tie_count(planes(o), planes(d),
                                        ref_sa.tri_verts, b["t_min"], 1e4,
                                        hit.t)
                ref = rrestir.trace_closest(ref_sa, o, d, rcfg, b["t_min"])
                if control:
                    got = rrestir.trace_closest(ctl, o, d, rcfg, b["t_min"])
                else:
                    got = {key: v[idx] for key, v in got.items()}
                closest.append(check.closest_off_pct(ref, got, ties))
            else:
                t_max = b["t_max"][idx]
                ref = rrestir.trace_occluded(ref_sa, o, d, b["t_min"], t_max,
                                             rcfg)
                got = (rrestir.trace_occluded(ctl, o, d, b["t_min"], t_max,
                                              rcfg)
                       if control else got[idx])
                occl.append(check.any_off_pct(ref, got))
        out = {}
        if closest:
            out["closest_off_pct"] = max(closest)
        if occl:
            out["any_off_pct"] = max(occl)
        return out


