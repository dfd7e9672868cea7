"""The one generator of every traffic mix: what a cell sends, made from
the seed and the traffic file's parameters (``traffic/<name>.json``).

Kinds:

* ``frames`` — progressive ``render()`` calls of a fixed camera.  The seed
  picks the starting frame index (the TEA seeds of every pass) and the
  pixel tiles that the check compares.
* ``wavefront`` — batches of rays traced one after another through the
  port's ``trace_closest`` / ``trace_occluded``, each of a ray kind
  ``rays/<kind>.py`` built from the helpers here: ``camera`` (one ray per
  pixel through the pixel corner), ``diffuse`` (area-weighted points on
  the non-emissive triangles, cosine-weighted directions about a face
  normal whose side the seed picks), ``shadow`` (segments from another
  batch's points to area-weighted points on the emissive triangles).

Rays are plain torch on the card from a ``torch.Generator`` seeded with
``--seed``, made from the reference's own scene arrays, never from the
program's output.
"""

from __future__ import annotations

import random

import torch

from harness.manifest import BENCH_DIR, load_plugin
from reference import camera as rcam
from reference import math3d as m3
from reference import trace

S_BIAS = 2.0e-5


def rng(seed: int) -> random.Random:
    return random.Random(int(seed))


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & ((1 << 63) - 1))
    return g


def start_frame(seed: int, traffic: dict) -> int:
    """The frame counter of the first frame (the TEA seeds' time term)."""
    return rng(seed).randrange(int(traffic["start_frame_span"]))


def check_tiles(seed: int, traffic: dict, sa, mats, cfg) -> list:
    """``check_tiles`` tiles (x0, y0, w, h) of ``check_tile`` pixels a side,
    drawn from the seed among a ``check_grid`` x ``check_grid`` grid of
    positions whose centre pixel's camera ray hits a non-emissive surface
    (the reference's own trace), at least the spatial radius from the
    image's borders."""
    tile = int(traffic["check_tile"])
    grid = int(traffic["check_grid"])
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
    hit = trace.closest_hit(tuple(o[:, c].contiguous() for c in range(3)),
                            tuple(d[:, c] for c in range(3)), sa.tri_verts,
                            1e-4, 1e4)
    ke = sa.materials.ke[sa.tri_material[hit.tri].long()].sum(-1)
    ok = (hit.valid & (ke <= 0.0)).cpu().tolist()
    good = [c for c, k in zip(cand, ok) if k]
    r = rng(seed ^ 0x5EED)
    pick = r.sample(good, min(int(traffic["check_tiles"]), len(good)))
    return [(x, y, tile, tile) for x, y in pick]


def camera_ties(sa, mats, cfg, pix):
    """Whether the camera ray of each pixel ``pix`` (linear indices) meets
    more than one triangle at its closest hit (the reference's trace)."""
    o, d = rcam.generate_rays(mats, cfg.width, cfg.height,
                              xs=pix % cfg.width, ys=pix // cfg.width)
    o = tuple(o[:, c].contiguous() for c in range(3))
    d = m3.normalize(d)
    d = tuple(d[:, c] for c in range(3))
    hit = trace.closest_hit(o, d, sa.tri_verts, 1e-4, 1e4)
    return trace.tie_count(o, d, sa.tri_verts, 1e-4, 1e4, hit.t) > 1


def camera_rays(mats, cfg):
    o, d = rcam.generate_rays(mats, cfg.width, cfg.height)
    return o.contiguous(), m3.normalize(d).contiguous()


def surface_points(sa, count: int, g):
    """Area-weighted points on the non-emissive triangles and a face normal
    each, its side picked at random."""
    tv = sa.tri_verts
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    cr = torch.linalg.cross(e1, e2, dim=-1)
    area = 0.5 * torch.linalg.norm(cr, dim=-1)
    lit = sa.materials.ke[sa.tri_material.long()].sum(-1) > 0.0
    weight = torch.where(lit, torch.zeros_like(area), area)
    idx = torch.multinomial(weight, count, replacement=True, generator=g)
    u = torch.rand((count, 3), generator=g, device=tv.device)
    su = torch.sqrt(u[:, 0:1])
    b1 = (1.0 - su)
    b2 = u[:, 1:2] * su
    p = tv[idx, 0] + b1 * e1[idx] + b2 * e2[idx]
    n = m3.normalize(cr[idx])
    side = torch.where(u[:, 2:3] < 0.5, -1.0, 1.0)
    return p, n * side


def cosine_dirs(n, g):
    """Cosine-weighted directions about the unit normals ``n`` [N, 3]."""
    count = n.shape[0]
    u = torch.rand((count, 2), generator=g, device=n.device)
    r = torch.sqrt(u[:, 0])
    phi = 6.283185307179586 * u[:, 1]
    a = torch.where(torch.abs(n[:, 0:1]) > 0.9,
                    torch.tensor([0.0, 1.0, 0.0], device=n.device),
                    torch.tensor([1.0, 0.0, 0.0], device=n.device))
    t = m3.normalize(torch.linalg.cross(a, n, dim=-1))
    b = torch.linalg.cross(n, t, dim=-1)
    local_z = torch.sqrt(torch.clamp_min(1.0 - u[:, 0], 0.0))
    d = ((r * torch.cos(phi))[:, None] * t + (r * torch.sin(phi))[:, None] * b
         + local_z[:, None] * n)
    return m3.normalize(d)


def light_points(sa, count: int, g):
    tv = sa.tri_verts
    lit = sa.materials.ke[sa.tri_material.long()].sum(-1) > 0.0
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    area = 0.5 * torch.linalg.norm(torch.linalg.cross(e1, e2, dim=-1), dim=-1)
    weight = torch.where(lit, area, torch.zeros_like(area))
    idx = torch.multinomial(weight, count, replacement=True, generator=g)
    u = torch.rand((count, 2), generator=g, device=tv.device)
    su = torch.sqrt(u[:, 0:1])
    return tv[idx, 0] + (1.0 - su) * e1[idx] + (u[:, 1:2] * su) * e2[idx]


def wavefront(seed: int, traffic: dict, sa, mats, cfg,
              bench_dir: str = BENCH_DIR) -> list:
    """The batches of one wavefront: dicts of name, query ("closest" or
    "any"), o / d [N, 3] float32 and t_min (and t_max for "any").  Each
    batch's ``rays`` is the file ``rays/<rays>.py``, whose
    ``make(spec, ctx)`` returns its o, d (and t_max); ``ctx`` holds the
    reference's scene arrays ``sa``, camera ``mats`` and config ``cfg``,
    the generator ``g``, and ``points``, where a batch of rays leaving
    surface points leaves them (name -> (points, normals)) for a later
    batch."""
    ctx = dict(sa=sa, mats=mats, cfg=cfg, g=generator(seed, sa.device),
               points={})
    out = []
    for spec in traffic["batches"]:
        b = load_plugin("rays", spec["rays"], bench_dir).make(spec, ctx)
        b.update(name=spec["name"], query=spec["query"],
                 t_min=float(spec.get("t_min", 0.0)))
        out.append(b)
    return out
