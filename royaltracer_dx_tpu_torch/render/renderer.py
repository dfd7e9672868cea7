"""Progressive headless megakernel renderer (port of
royaltracer_dx_tpu/render/renderer.py).

A frame is ``samples_per_pixel`` passes of (prologue: camera rays and
per-pixel seeds -> ``max_bounces`` bounce steps), then the epilogue
accumulates into the framebuffer, which restarts when the view matrix
moved by more than S_BIAS (RayGen.hlsl:161-177).  ``render()`` reads the
ray count once per frame, not once per sample as the JAX package does;
``render_many(k)`` runs k frames with one synchronisation.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from royaltracer_dx_tpu_torch.camera import Camera, generate_rays
from royaltracer_dx_tpu_torch.config import S_BIAS, RenderConfig
from royaltracer_dx_tpu_torch.device import resolve_device
from royaltracer_dx_tpu_torch.render import megakernel
from royaltracer_dx_tpu_torch.render.framebuffer import (
    Framebuffer,
    accumulate,
    resolve,
)
from royaltracer_dx_tpu_torch.render.restir_renderer import bake
from royaltracer_dx_tpu_torch.scene.scene import Scene
from royaltracer_dx_tpu_torch.utils import telemetry
from royaltracer_dx_tpu_torch.utils.rng import pixel_seed, tea_random

_F = torch.float32


def frame_prologue(cam: dict, frame: int, cfg: RenderConfig,
                   spp_jitter: bool = True, sample_index: int = 0) -> dict:
    """Camera rays + per-pixel seeds for one sample pass (:34-48); the
    rays live on the camera tensors' device."""
    dev = cam["view_inv"].device
    ys, xs = torch.meshgrid(torch.arange(cfg.height, device=dev),
                            torch.arange(cfg.width, device=dev),
                            indexing="ij")
    # stream id = samples + 1 (RayGen.hlsl:81-82)
    seed = pixel_seed(xs.reshape(-1), ys.reshape(-1),
                      cfg.samples_per_pixel + 1, frame + sample_index)
    jx, seed = tea_random(seed)
    jy, seed = tea_random(seed)
    jitter = torch.stack([jx, jy], dim=-1) if spp_jitter else None
    origins, dirs = generate_rays(cam, cfg.width, cfg.height, jitter)
    return megakernel.init_path_state(origins, dirs, seed)


def frame_epilogue(fb: Framebuffer, emission_sum, cam_view, prev_view,
                   cfg: RenderConfig) -> Framebuffer:
    """Average the passes and accumulate, restarting on camera motion
    (:51-56); the test stays on the device."""
    sample = emission_sum / cfg.samples_per_pixel
    changed = torch.any(torch.abs(cam_view - prev_view) > S_BIAS)
    return accumulate(fb, sample, changed, cfg.max_accum_frames)


class Renderer:
    """Progressive headless renderer, megakernel backend (:91-183).

    ``device=None`` renders on the card and raises when there is none;
    the tests pass ``device="cpu"``."""

    def __init__(self, scene: Scene, camera: Camera, cfg: RenderConfig,
                 device=None):
        self.device = resolve_device(device)
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.materials = scene.build_materials(device=self.device)
        self.scene_arrays = bake(scene, self.materials, cfg, self.device)
        self.fb = Framebuffer.create(cfg.num_pixels, self.device)
        self.frame = 0
        self._prev_view = torch.zeros((4, 4), dtype=_F, device=self.device)
        self.metrics: dict = {}

    def _camera_arrays(self) -> dict:
        mats = self.camera.matrices(self.cfg.width / self.cfg.height)
        return {k: torch.as_tensor(v, dtype=_F, device=self.device)
                for k, v in mats.items()}

    def update(self, camera: Camera | None = None) -> None:
        """Move the camera and/or refit after ``Scene.set_transform``
        (:121-126), spanned as ``update`` (utils/telemetry.py)."""
        with telemetry.update():
            if camera is not None:
                self.camera = camera
            self.scene_arrays = self.scene.flatten(self.materials,
                                                   prev=self.scene_arrays)

    def _frame(self, cam: dict, frame: int, prev_view):
        """One frame on the device: (framebuffer, rays per sample pass)."""
        cfg = self.cfg
        emission = None
        rays = []
        for s in range(cfg.samples_per_pixel):
            st = frame_prologue(cam, frame, cfg, cfg.aa_jitter, s)
            for bounce in range(cfg.max_bounces):
                st = megakernel.bounce_step(self.scene_arrays, st, bounce,
                                            cfg)
            emission = (st["emission"] if emission is None
                        else emission + st["emission"])
            rays.append(st["rays"])
        fb = frame_epilogue(self.fb, emission, cam["view"], prev_view, cfg)
        return fb, rays

    def render(self) -> None:
        """Trace one frame and accumulate (:128-155)."""
        cam = self._camera_arrays()
        t0 = time.perf_counter()
        self.fb, rays = self._frame(cam, self.frame, self._prev_view)
        # the sample passes' f32 counts, summed in float64 on the host as
        # the JAX package does; the one read waits for the frame
        rays = float(sum(torch.stack(rays).double().cpu().tolist()))
        dt = time.perf_counter() - t0
        self._prev_view = cam["view"]
        self.frame += 1
        self.metrics = dict(frame_time_s=dt, fps=1.0 / max(dt, 1e-9),
                            frame=self.frame, rays_traced=rays,
                            mrays_per_s=rays / dt / 1e6)

    def render_many(self, k: int) -> None:
        """k frames with one synchronisation at the end (:157-173): the
        same frames as k ``render()`` calls; camera and scene stay fixed;
        the metrics are per batch."""
        cam = self._camera_arrays()
        t0 = time.perf_counter()
        prev = self._prev_view
        for i in range(int(k)):
            self.fb, _ = self._frame(cam, self.frame + i, prev)
            prev = cam["view"]
        float(self.fb.count[0])              # the one wait for the batch
        dt = time.perf_counter() - t0
        self._prev_view = prev
        self.frame += int(k)
        self.metrics = dict(frame_time_s=dt / max(k, 1),
                            fps=k / max(dt, 1e-9), frame=self.frame,
                            batch_frames=int(k), batch_time_s=dt)

    def image(self, srgb: bool = True) -> np.ndarray:
        """Resolved [H, W, 3] image in [0, 1] (:175-178)."""
        img = resolve(self.fb, srgb=srgb)
        return img.cpu().numpy().reshape(self.cfg.height, self.cfg.width, 3)

    def radiance(self) -> np.ndarray:
        """Linear accumulated radiance [H, W, 3] (:180-183)."""
        out = self.fb.accum / torch.clamp_min(self.fb.count, 1.0)[:, None]
        return out.cpu().numpy().reshape(self.cfg.height, self.cfg.width, 3)

    # ------------------------------ state --------------------------------

    def state_dict(self) -> dict:
        """Progressive state under the npz key names of the JAX package's
        checkpoint (io/checkpoint.py:36-43): format, frame, prev_view,
        fb.accum, fb.count."""
        return {"format": np.asarray("megakernel"),
                "frame": np.asarray(self.frame),
                "prev_view": self._prev_view.cpu().numpy(),
                "fb.accum": self.fb.accum.cpu().numpy(),
                "fb.count": self.fb.count.cpu().numpy()}

    def load_state(self, state: dict) -> None:
        """Restore a ``state_dict`` (or a JAX-package megakernel
        checkpoint's arrays) of the same resolution onto this renderer's
        device."""
        if str(state.get("format", "megakernel")) != "megakernel":
            raise ValueError(f"state format {state['format']!r} is not a "
                             "megakernel state")
        n = int(np.asarray(state["fb.accum"]).shape[0])
        if n != self.cfg.num_pixels:
            raise ValueError(f"state has {n} pixels, the renderer "
                             f"{self.cfg.num_pixels}")

        def t(key):
            return torch.as_tensor(np.asarray(state[key]), dtype=_F,
                                   device=self.device)

        self.frame = int(np.asarray(state["frame"]))
        self._prev_view = t("prev_view")
        self.fb = Framebuffer(accum=t("fb.accum"), count=t("fb.count"))
