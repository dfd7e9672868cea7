"""MIS-free direct-illumination oracle, pure NEE quadrature (port of
royaltracer_dx_tpu/render/di_oracle.py).

One uniform-area light sample per pixel and frame with the v6 blended
BRDF: light-area NEE alone covers all direct transport of area lights, so
this is an unbiased oracle for ReSTIR's pass-1 DI (the megakernel at
max_bounces=1 is not: its NEE carries an MIS weight whose complement
arrives with the next bounce, :3-14).  The primary geometry comes from the
port's own ``pass1_di``, so the oracle and the ReSTIR renderer share their
primary hits bit for bit; shadow-ray epsilons mirror
``visibility_check_p``.  Frames accumulate into a float64 total on the
renderer's device.
"""

from __future__ import annotations

import numpy as np
import torch

from royaltracer_dx_tpu_torch.camera import Camera
from royaltracer_dx_tpu_torch.config import S_BIAS, RenderConfig
from royaltracer_dx_tpu_torch.device import resolve_device
from royaltracer_dx_tpu_torch.ops import bsdf, light_sampling, restir
from royaltracer_dx_tpu_torch.render import restir_renderer as rr
from royaltracer_dx_tpu_torch.utils import pvec as pv
from royaltracer_dx_tpu_torch.utils.rng import pixel_seed, tea_batch_major


class DiOracle:
    """Progressive pure-NEE DI renderer over a Scene (:36-106).

    ``frame`` is the seed counter (callers may offset it for independent
    streams); ``device=None`` renders on the card and raises when there is
    none."""

    def __init__(self, scene, camera: Camera, cfg: RenderConfig,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        # the JAX package flattens without any accel (:41), so its oracle
        # fails under traversal "stream", "bvh" or "cluster"; the port
        # builds what the megakernel Renderer would
        sa = rr.bake(scene, scene.build_materials(device=dev), cfg, dev)
        self.scene_arrays = sa
        ca = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
              for k, v in camera.matrices(cfg.width / cfg.height).items()}
        ca["prev_view"] = torch.zeros((4, 4), dtype=torch.float32, device=dev)
        ca["prev_proj"] = torch.zeros((4, 4), dtype=torch.float32, device=dev)
        _, sdata, gi_in, _ = rr.pass1_di(sa, ca, 0, cfg)
        self._mat = restir.fetch_material_p(sa, sdata["mid"])
        self._shading = gi_in["sampling"]
        self._x1 = sdata["x1"]
        self._n1 = sdata["n1"]
        self._outgoing = sdata["o"]
        self._l1 = sdata["l1"]
        self._xs, self._ys = rr._pixel_grid(cfg, dev)
        self._acc = torch.zeros((cfg.num_pixels, 3), dtype=torch.float64,
                                device=dev)
        self.frame = 0
        self._n_frames = 0

    def _frame(self, frame: int) -> tuple:
        """One frame's sample planes (:123-152)."""
        sa = self.scene_arrays
        x1, n1 = self._x1, self._n1
        seed = pixel_seed(self._xs, self._ys, 7, frame)
        us, seed = tea_batch_major(seed, 3)
        rec = light_sampling.select_light_records(sa.light_table,
                                                  sa.lights.cdf, us[0])
        lv = [tuple(rec[0:3]), tuple(rec[3:6]), tuple(rec[6:9])]
        nl = tuple(rec[9:12])
        pdf = rec[12]
        em = tuple(rec[13:16])
        bu, bv, bw = light_sampling.fold_barycentric(us[1], us[2])
        y = tuple(bu * a + bv * b + bw * c for a, b, c in zip(*lv))
        lvec = pv.sub(y, x1)
        dist = pv.length(lvec)
        ln = pv.scale(lvec, 1.0 / torch.clamp_min(dist, 1e-20))
        cosx = torch.clamp_min(pv.dot(n1, ln), 0.0)
        # one-sided emitters, like the pipelines' NEE
        cosy = torch.clamp_min(pv.dot(nl, pv.neg(ln)), 0.0)
        g = cosx * cosy / torch.clamp_min(dist * dist, 1e-12)
        occ = restir.trace_occluded(
            sa, pv.add(x1, pv.scale(n1, S_BIAS)), ln, torch.zeros_like(dist),
            torch.clamp_min(dist - 10.0 * S_BIAS, 2.0 * S_BIAS), self.cfg)
        vis = torch.where(occ, 0.0, 1.0)
        mat = self._mat
        f = bsdf.eval_bsdf_blend_p(mat["kd"], mat["ks"], mat["metal"],
                                   mat["rough"], mat["lut"], n1, ln,
                                   self._outgoing)
        c = pv.scale(pv.mul(em, f), g * vis / torch.clamp_min(pdf, 1e-20))
        c = pv.where(self._shading, c, pv.splat(torch.zeros_like(dist)))
        return pv.add(c, self._l1)

    def render(self) -> None:
        """One frame into the float64 total (:82-87)."""
        self._acc += torch.stack(self._frame(self.frame), dim=1).double()
        self.frame += 1
        self._n_frames += 1

    def render_many(self, k: int) -> None:
        """k frames summed in float32 on the device, then added to the
        float64 total (:89-101): within ~sqrt(k) f32 ulps of k ``render()``
        calls, far below the noise it averages."""
        acc = None
        for i in range(int(k)):
            c = self._frame(self.frame + i)
            acc = c if acc is None else tuple(a + p for a, p in zip(acc, c))
        if acc is not None:
            self._acc += torch.stack(acc, dim=1).double()
        self.frame += int(k)
        self._n_frames += int(k)

    def radiance(self) -> np.ndarray:
        cfg = self.cfg
        out = (self._acc / max(self._n_frames, 1)).to(torch.float32)
        return out.cpu().numpy().reshape(cfg.height, cfg.width, 3)
