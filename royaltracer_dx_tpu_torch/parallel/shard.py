"""Pixel-band data parallelism over several devices (port of
royaltracer_dx_tpu/parallel/shard.py).

The image shards by rows into one band per device; the scene (and its
accel) is placed once on every distinct device, and each band's state --
its packed DI/GI records, ``l1`` and framebuffer rows -- lives on its own
device.  The frame is the single-device ReSTIR frame run band by band:
pass 1 and the GI path sampling are per pixel; pass 2's temporal
reprojections and pass 3's spatial taps read the packed records of the
band's rows extended by ``halo_rows = min(spatial_radius, band_h)`` rows
of each neighbour (zero rows at the image's outer edges, which the
globally mirrored taps never address), so every tap within the halo, and
every reprojection landing in it, equals the single-device frame's.  A
reprojection that jumps further than the halo rejects temporal reuse, as
in the JAX package (its documented deviation).

Where the JAX package runs one ``shard_map`` program over a device mesh,
the port is a single controller too: one process takes a list of
``torch.device``s, one per band, and drives them in turn from one thread.
  * ``ppermute`` of the halo rows becomes a copy of the neighbour band's
    edge rows to the band's own device (``.to(dev, non_blocking=True)``,
    a no-op when both bands share a device);
  * ``pmean`` / ``psum`` become a host-side mean / sum over the bands,
    which are equal in size;
  * a device may repeat: ``["cpu"] * 4`` is the counterpart of JAX's
    virtual CPU devices, and ``["cuda:0"] * 4`` runs four bands on one
    card, one after another.
``torch.distributed`` is not used: NCCL refuses two ranks on one GPU, so a
process-per-band design could not run the repeated-device case at all.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from royaltracer_dx_tpu_torch.config import S_BIAS, RenderConfig
from royaltracer_dx_tpu_torch.ops import restir
from royaltracer_dx_tpu_torch.render import restir_renderer as rr
from royaltracer_dx_tpu_torch.render.framebuffer import Framebuffer, accumulate
from royaltracer_dx_tpu_torch.render.megakernel import trace_paths
from royaltracer_dx_tpu_torch.render.restir_renderer import _wants_stream
from royaltracer_dx_tpu_torch.utils import math3d as m3
from royaltracer_dx_tpu_torch.utils import pvec as pv

_F = torch.float32


def pad_to_devices(n: int, n_devices: int) -> int:
    """Smallest N' >= n divisible by n_devices (shard.py:50-52)."""
    return ((n + n_devices - 1) // n_devices) * n_devices


def band_devices(devices=None) -> list[torch.device]:
    """The band devices as ``torch.device``s: ``None`` means every visible
    card (and raises when there is none, as the port's entry points do);
    a ``cuda`` device without an index means the current card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "royaltracer_dx_tpu_torch runs on the GPU by default and no "
                "CUDA device is visible; pass devices=['cpu'] * n to run the "
                "bands on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {d} requested but no CUDA device "
                                   "is visible")
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("no devices given")
    return out


def to_device(obj, dev: torch.device):
    """A copy of a tensor, or of a dataclass of tensors (SceneArrays with
    its accels, Materials, ...), on ``dev``."""
    if torch.is_tensor(obj):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj)})
    return obj


def _sync(devices) -> None:
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def make_sharded_trace(devices, cfg: RenderConfig):
    """The megakernel's rays split over the bands (shard.py:55-72).

    Returns fn(scene, origins [N, 3], dirs [N, 3], seeds [N, 2]) ->
    (radiance [N, 3] on the rays' device, rays traced summed over the
    bands, a float).  N must divide by the band count, as the JAX
    package's shard_map requires; the scene is placed on each distinct
    device once per call."""
    devs = band_devices(devices)
    n_dev = len(devs)

    def fn(scene, origins, dirs, seeds):
        n = origins.shape[0]
        if n % n_dev:
            raise ValueError(f"{n} rays do not split into {n_dev} bands; "
                             "pad them (pad_to_devices)")
        scenes = {d: to_device(scene, d) for d in set(devs)}
        band = n // n_dev
        outs, rays = [], 0.0
        for i, d in enumerate(devs):
            sl = slice(i * band, (i + 1) * band)
            rad, r = trace_paths(scenes[d], origins[sl].to(d),
                                 dirs[sl].to(d), seeds[sl].to(d), cfg)
            outs.append(rad)
            rays += float(r)
        return torch.cat([o.to(origins.device) for o in outs]), rays

    return fn


def _band_geometry(n_dev: int, cfg: RenderConfig):
    """(n_dev, band_h, halo_rows) (shard.py:75-81)."""
    if cfg.height % n_dev:
        raise ValueError(f"height {cfg.height} not divisible by {n_dev} "
                         "devices")
    band_h = cfg.height // n_dev
    return n_dev, band_h, min(cfg.spatial_radius, band_h)


def halo_extend(tables: list, devices: list, hw: int) -> list:
    """Per band, its packed-record shard tuple extended by the last ``hw``
    rows of the band above and the first ``hw`` rows of the band below,
    copied to its device; zero rows at the image's outer edges
    (shard.py:84-101, ``ppermute`` there)."""
    out = []
    for i, (tab, dev) in enumerate(zip(tables, devices)):
        ext = []
        for c, a in enumerate(tab):
            zero = a.new_zeros((hw,) + tuple(a.shape[1:]))
            if i > 0:
                up = tables[i - 1][c]
                above = up[up.shape[0] - hw:].to(dev, non_blocking=True)
            else:
                above = zero
            below = (tables[i + 1][c][:hw].to(dev, non_blocking=True)
                     if i + 1 < len(tables) else zero)
            ext.append(torch.cat([above, a, below]))
        out.append(tuple(ext))
    return out


def _stage1_local(scene, cam, frame, xs, ys, cfg, compact: bool):
    """Pass 1 and the GI path sampling on one band (shard.py:104-123).
    Returns (res_di, res_gi, sdata, occ [1 + gi_bounces] on the band's
    device: the sampling share, then each GI bounce's active share)."""
    res_di, sdata, gi_in, seed = rr.pass1_di(scene, cam, frame, cfg, xs, ys)
    st = rr.pass1_gi_init(scene, gi_in, seed, cfg)
    occ = [gi_in["sampling"].to(_F).mean()]
    bounce_fn = rr.pass1_gi_bounce_compact if compact else rr.pass1_gi_bounce
    for b in range(cfg.gi_bounces):
        occ.append(st["active"].to(_F).mean())
        st = bounce_fn(scene, cfg, st, b)
    res_gi, _ = rr.pass1_gi_final(scene, gi_in, st, cfg)
    return res_di, res_gi, sdata, torch.stack(occ)


def _stage3_local(scene, cam, frame, res_di, res_gi, sdata, packed_di,
                  packed_gi, ext_cur_di, ext_cur_gi, xs, ys, cfg, row0: int,
                  bh_ext: int):
    """Spatial reuse and shade on one band over the halo-extended current
    tables, then the ping-pong of its last tables, which move only for
    shaded lanes (shard.py:142-168).  Returns (sample [n, 3], new packed
    DI, new packed GI, l1 [n, 3])."""
    rd = rr._rec_dtype(cfg)
    sample, shaded, out_di, out_gi = rr.pass3_spatial(
        scene, cam, frame, res_di, res_gi, sdata, cfg, xs=xs, ys=ys,
        row0=row0, band_h=bh_ext, packed_di_ext=ext_cur_di,
        packed_gi_ext=ext_cur_gi)
    sh = shaded[:, None]
    new_di = tuple(torch.where(sh, new, old) for new, old in zip(
        rr._pack_record(sdata, out_di, rr._DI_KEYS, rd), packed_di))
    new_gi = tuple(torch.where(sh, new, old) for new, old in zip(
        rr._pack_record(sdata, out_gi, rr._GI_KEYS, rd), packed_gi))
    return sample, new_di, new_gi, pv.to_aos(sdata["l1"], 1)


def mean_occupancy(occ: list) -> np.ndarray:
    """The bands' occupancy vectors averaged on the host, float64 (the
    JAX package's ``pmean``; the bands are equal in size).  Reading them
    waits for the work enqueued before."""
    return np.mean([o.double().cpu().numpy() for o in occ], axis=0)


def make_sharded_restir_stages(devices, cfg: RenderConfig,
                               compact: bool = False):
    """The sharded frame as three stages over all bands (shard.py:221-254):

      s1(scenes, cams, frame, xs, ys) -> (res_di, res_gi, sdata, occ)
      s2(scenes, cams, frame, res_di, res_gi, sdata, packed_di, packed_gi,
         xs, ys) -> (res_di, res_gi)
      s3(scenes, cams, frame, res_di, res_gi, sdata, packed_di, packed_gi,
         xs, ys) -> (sample, new packed_di, new packed_gi, l1)

    Every argument but ``frame`` is a per-band list (scenes and cams: the
    band's device's), and so is every output; ``occ`` holds each band's
    occupancy vector on its device (``mean_occupancy`` averages them)."""
    devs = band_devices(devices)
    n_dev, band_h, halo = _band_geometry(len(devs), cfg)
    hw = halo * cfg.width
    bh_ext = band_h + 2 * halo
    row0 = [i * band_h - halo for i in range(n_dev)]

    def s1(scenes, cams, frame, xs, ys):
        outs = [_stage1_local(scenes[i], cams[i], frame, xs[i], ys[i], cfg,
                              compact) for i in range(n_dev)]
        return tuple(list(x) for x in zip(*outs))

    def s2(scenes, cams, frame, res_di, res_gi, sdata, packed_di, packed_gi,
           xs, ys):
        # temporal reuse over the halo-extended last tables (:126-139)
        if not cfg.temporal_reuse:
            return res_di, res_gi
        ext_di = halo_extend(packed_di, devs, hw)
        ext_gi = halo_extend(packed_gi, devs, hw)
        outs = [rr.pass2_temporal(scenes[i], cams[i], frame, res_di[i],
                                  res_gi[i], sdata[i], ext_di[i], ext_gi[i],
                                  cfg, xs=xs[i], ys=ys[i], row0=row0[i],
                                  band_h=bh_ext)
                for i in range(n_dev)]
        return [o[0] for o in outs], [o[1] for o in outs]

    def s3(scenes, cams, frame, res_di, res_gi, sdata, packed_di, packed_gi,
           xs, ys):
        rd = rr._rec_dtype(cfg)
        cur_di = [rr._pack_record(sdata[i], res_di[i], rr._DI_KEYS, rd)
                  for i in range(n_dev)]
        cur_gi = [rr._pack_record(sdata[i], res_gi[i], rr._GI_KEYS, rd)
                  for i in range(n_dev)]
        ext_di = halo_extend(cur_di, devs, hw)
        ext_gi = halo_extend(cur_gi, devs, hw)
        outs = [_stage3_local(scenes[i], cams[i], frame, res_di[i],
                              res_gi[i], sdata[i], packed_di[i],
                              packed_gi[i], ext_di[i], ext_gi[i], xs[i],
                              ys[i], cfg, row0[i], bh_ext)
                for i in range(n_dev)]
        return tuple(list(x) for x in zip(*outs))

    return s1, s2, s3


def make_sharded_restir_frame(devices, cfg: RenderConfig,
                              compact: bool = False):
    """The ReSTIR DI+GI frame under pixel-band data parallelism
    (shard.py:171-218).  Returns fn(scenes, cams, frame, xs, ys,
    packed_di, packed_gi) -> (sample, new packed_di, new packed_gi, l1,
    occ): per-band lists (see ``make_sharded_restir_stages``) and the
    bands' mean occupancy vector (float64, host), read once the frame is
    enqueued."""
    s1, s2, s3 = make_sharded_restir_stages(devices, cfg, compact)

    def fn(scenes, cams, frame, xs, ys, packed_di, packed_gi):
        res_di, res_gi, sdata, occ = s1(scenes, cams, frame, xs, ys)
        res_di, res_gi = s2(scenes, cams, frame, res_di, res_gi, sdata,
                            packed_di, packed_gi, xs, ys)
        sample, new_di, new_gi, l1 = s3(scenes, cams, frame, res_di, res_gi,
                                        sdata, packed_di, packed_gi, xs, ys)
        return sample, new_di, new_gi, l1, mean_occupancy(occ)

    return fn


@dataclasses.dataclass
class Band:
    """One band's rows and state, all on ``device``."""

    device: torch.device
    xs: torch.Tensor          # [n] global pixel columns
    ys: torch.Tensor          # [n] global pixel rows
    packed_di: tuple          # three [n, 8] shards in the record dtype
    packed_gi: tuple
    l1: torch.Tensor          # [n, 3]
    fb: Framebuffer


class ShardedRestirRenderer:
    """Multi-device RestirRenderer (shard.py:272-444): ``render``,
    ``update``, ``radiance``, ``image``, ``metrics`` (with the same keys
    and values as RestirRenderer's, plus ``devices``), ``profile`` mode
    (per-stage times and occupancy), ``seed_mode="time"`` and
    ``state_dict`` / ``load_state`` (the "sharded_restir" checkpoint
    format).  ``devices``: one device per band (None: every visible
    card); a device may repeat."""

    def __init__(self, scene, camera, cfg: RenderConfig, devices=None):
        rr.check_config(scene, cfg)
        self.devices = band_devices(devices)
        n_dev, self.band_h, self.halo_rows = _band_geometry(
            len(self.devices), cfg)
        self.device = self.devices[0]
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        # the scene, its accel and materials once per distinct device
        first = self.devices[0]
        mats = scene.build_materials(device=first)
        sa = scene.flatten(mats, build_stream=_wants_stream(scene, cfg),
                           build_bvh=cfg.accel == "bvh",
                           bvh_leaf_size=cfg.bvh_leaf_size, device=first)
        rr.check_world(sa, cfg)
        self._materials = {first: mats}
        self._scenes = {first: sa}
        for d in dict.fromkeys(self.devices):
            if d not in self._scenes:
                self._materials[d] = to_device(mats, d)
                self._scenes[d] = to_device(sa, d)
        self._stages = make_sharded_restir_stages(
            self.devices, cfg, restir.wants_gi_compaction(sa, cfg))
        # opt-in per-stage timing and occupancy (each stage ends in a sync)
        self.profile = False

        rd = rr._rec_dtype(cfg)
        n = self.band_h * cfg.width
        self.bands = []
        for i, d in enumerate(self.devices):
            rows = torch.arange(i * self.band_h, (i + 1) * self.band_h,
                                device=d)
            ys, xs = torch.meshgrid(rows, torch.arange(cfg.width, device=d),
                                    indexing="ij")
            # zero records: mid = the miss sentinel, flags = 1 (|l1| == 0,
            # not valid), as _pack_record gives for a fresh state
            s0 = torch.zeros((n, 8), dtype=_F, device=d)
            s0[:, 6] = float(restir.MISS_ID_I32)
            s0[:, 7] = 1.0
            zero = torch.zeros((n, 8), dtype=rd, device=d)
            packed = (s0.to(rd), zero, zero)
            self.bands.append(Band(
                device=d, xs=xs.reshape(-1), ys=ys.reshape(-1),
                packed_di=packed, packed_gi=packed,
                l1=torch.zeros((n, 3), dtype=_F, device=d),
                fb=Framebuffer.create(n, d)))
        self.frame = 0
        self._prev_view = torch.zeros((4, 4), dtype=_F, device=first)
        self._prev_proj = torch.zeros((4, 4), dtype=_F, device=first)
        self.metrics: dict = {}

    # ------------------------------ views --------------------------------

    @property
    def scene_arrays(self):
        """The scene on the first band's device."""
        return self._scenes[self.devices[0]]

    @property
    def fb(self) -> Framebuffer:
        """The whole framebuffer, gathered on the first band's device."""
        return Framebuffer(
            accum=torch.cat([b.fb.accum.to(self.device) for b in self.bands]),
            count=torch.cat([b.fb.count.to(self.device) for b in self.bands]))

    @property
    def l1(self) -> torch.Tensor:
        return torch.cat([b.l1.to(self.device) for b in self.bands])

    def _camera_arrays(self, device=None) -> dict:
        """The camera matrices on ``device`` (the first band's by
        default), with the previous frame's view and projection."""
        dev = device or self.device
        mats = self.camera.matrices(self.cfg.width / self.cfg.height)
        cam = {k: torch.as_tensor(v, dtype=_F, device=dev)
               for k, v in mats.items()}
        cam["prev_view"] = self._prev_view.to(dev)
        cam["prev_proj"] = self._prev_proj.to(dev)
        return cam

    # ------------------------------ frames -------------------------------

    def update(self, camera=None) -> None:
        """Move the camera and/or refit every device's scene after
        ``Scene.set_transform`` (shard.py:345-349)."""
        if camera is not None:
            self.camera = camera
        for d, sa in self._scenes.items():
            self._scenes[d] = self.scene.flatten(self._materials[d], prev=sa)
        rr.check_world(self.scene_arrays, self.cfg)

    def render(self) -> None:
        """One progressive frame over all bands (shard.py:351-429)."""
        cfg = self.cfg
        if cfg.seed_mode == "time":
            frame = time.time_ns() & 0xFFFFFFFF
        else:
            frame = self.frame
        cams_by_dev = {d: self._camera_arrays(d) for d in self._scenes}
        scenes = [self._scenes[b.device] for b in self.bands]
        cams = [cams_by_dev[b.device] for b in self.bands]
        xs = [b.xs for b in self.bands]
        ys = [b.ys for b in self.bands]
        pdi = [b.packed_di for b in self.bands]
        pgi = [b.packed_gi for b in self.bands]
        t0 = time.perf_counter()
        pass_times: dict = {}
        tick = (rr.pass_timer(self._scenes, t0, pass_times) if self.profile
                else (lambda label: None))
        s1, s2, s3 = self._stages
        res_di, res_gi, sdata, occ = s1(scenes, cams, frame, xs, ys)
        tick("pass1")
        res_di, res_gi = s2(scenes, cams, frame, res_di, res_gi, sdata, pdi,
                            pgi, xs, ys)
        tick("pass2_temporal")
        sample, new_di, new_gi, l1 = s3(scenes, cams, frame, res_di, res_gi,
                                        sdata, pdi, pgi, xs, ys)
        tick("pass3_spatial")
        for i, b in enumerate(self.bands):
            cam = cams[i]
            changed = torch.any(torch.abs(cam["view"] - cam["prev_view"])
                                > S_BIAS)
            b.fb = accumulate(b.fb, sample[i], changed, cfg.max_accum_frames)
            b.packed_di, b.packed_gi, b.l1 = new_di[i], new_gi[i], l1[i]
        ov = mean_occupancy(occ)          # waits for the frame
        _sync(self.devices)
        dt = time.perf_counter() - t0
        self._prev_view = cams_by_dev[self.device]["view"]
        self._prev_proj = cams_by_dev[self.device]["proj"]
        self.frame += 1
        self.metrics = dict(rr.ray_metrics(cfg, ov, dt, self.frame),
                            devices=len(self.devices))
        if self.profile:
            self.metrics["pass_times_s"] = pass_times
            self.metrics["occupancy"] = rr.occupancy_metrics(cfg, ov)

    def radiance(self) -> np.ndarray:
        """Linear image: accumulated shade, L1 passthrough for
        emissive-primary pixels (shard.py:431-436)."""
        parts = []
        for b in self.bands:
            avg = b.fb.accum / torch.clamp_min(b.fb.count, 1.0)[:, None]
            emissive = torch.any(b.l1 != 0, dim=-1)
            parts.append(torch.where(emissive[:, None], b.l1, avg).cpu())
        return torch.cat(parts).numpy().reshape(self.cfg.height,
                                                self.cfg.width, 3)

    def image(self, srgb: bool = True) -> np.ndarray:
        img = np.nan_to_num(self.radiance(), nan=0.0, posinf=0.0)
        if srgb:
            img = m3.srgb_gamma(torch.clamp_min(torch.as_tensor(img),
                                                0.0)).numpy()
        return np.clip(img, 0.0, 1.0)

    # ------------------------------ state --------------------------------

    def state_dict(self) -> dict:
        """Progressive state under the JAX package's "sharded_restir" npz
        keys (io/checkpoint.py:36-56), as global [N, ...] arrays: the
        packed tables in the record dtype (bf16 as float32, which holds
        its values exactly: numpy has no bf16)."""
        def table(c, name):
            a = torch.cat([getattr(b, name)[c].cpu() for b in self.bands])
            return (a.float() if a.dtype == torch.bfloat16 else a).numpy()

        fb = self.fb
        out = {"format": np.asarray("sharded_restir"),
               "frame": np.asarray(self.frame),
               "prev_view": self._prev_view.cpu().numpy(),
               "prev_proj": self._prev_proj.cpu().numpy(),
               "fb.accum": fb.accum.cpu().numpy(),
               "fb.count": fb.count.cpu().numpy(),
               "l1": self.l1.cpu().numpy()}
        for c in range(3):
            out[f"packed_di.{c}"] = table(c, "packed_di")
            out[f"packed_gi.{c}"] = table(c, "packed_gi")
        return out

    def load_state(self, state: dict) -> None:
        """Restore a ``state_dict`` (or a JAX-package sharded checkpoint's
        arrays, including the legacy monolithic [N, 26] ``packed_di`` /
        ``packed_gi`` tables) onto the bands' devices."""
        if str(state.get("format", "sharded_restir")) != "sharded_restir":
            raise ValueError(f"state format {state['format']!r} is not a "
                             "sharded ReSTIR state")
        n = int(np.asarray(state["fb.accum"]).shape[0])
        if n != self.cfg.num_pixels:
            raise ValueError(f"state has {n} pixels, the renderer "
                             f"{self.cfg.num_pixels}")
        rd = rr._rec_dtype(self.cfg)
        if "packed_di.0" in state:
            pdi = tuple(torch.as_tensor(np.asarray(state[f"packed_di.{c}"]))
                        for c in range(3))
            pgi = tuple(torch.as_tensor(np.asarray(state[f"packed_gi.{c}"]))
                        for c in range(3))
        else:
            pdi = rr._shards_from_legacy(
                torch.as_tensor(np.asarray(state["packed_di"])), rr._DI_KEYS)
            pgi = rr._shards_from_legacy(
                torch.as_tensor(np.asarray(state["packed_gi"])), rr._GI_KEYS)
        accum = torch.as_tensor(np.asarray(state["fb.accum"]), dtype=_F)
        count = torch.as_tensor(np.asarray(state["fb.count"]), dtype=_F)
        l1 = torch.as_tensor(np.asarray(state["l1"]), dtype=_F)
        m = self.band_h * self.cfg.width
        for i, b in enumerate(self.bands):
            sl = slice(i * m, (i + 1) * m)
            b.packed_di = tuple(a[sl].to(b.device, rd) for a in pdi)
            b.packed_gi = tuple(a[sl].to(b.device, rd) for a in pgi)
            b.fb = Framebuffer(accum=accum[sl].to(b.device),
                               count=count[sl].to(b.device))
            b.l1 = l1[sl].to(b.device)
        self.frame = int(np.asarray(state["frame"]))
        self._prev_view = torch.as_tensor(np.asarray(state["prev_view"]),
                                          dtype=_F, device=self.device)
        self._prev_proj = torch.as_tensor(np.asarray(state["prev_proj"]),
                                          dtype=_F, device=self.device)
