"""Frozen copy for the benchmark's plain reference: Ray/triangle intersection: batched Möller–Trumbore (port of
royaltracer_dx_tpu/ops/intersect.py).

``closest_hit_brute`` / ``any_hit_brute`` are plain tensor code on every
device: the plain versions of the brute-force kernels (ops/brute_trace.py,
which the dispatch calls wherever the JAX package picks brute force, and
which run them for CPU tensors) and the oracle that every trace kernel is
held against.
"""

from __future__ import annotations

import dataclasses

import torch

from reference import pvec as pv

INF = 1e30
_DET_EPS = 1e-12
_MIN_CHUNK = 128


@dataclasses.dataclass
class Hit:
    """Closest-hit record (intersect.py:39-50)."""

    t: torch.Tensor     # [N]; >= INF means miss
    tri: torch.Tensor   # [N] int64 triangle index (valid only if hit)
    u: torch.Tensor
    v: torch.Tensor

    @property
    def valid(self) -> torch.Tensor:
        return self.t < INF


def _mt_terms(o, d, v0, e1, e2):
    """The MT terms of all rays x one chunk of triangles in the plain
    association order (intersect.py:62-98): (big = |det| > eps, u, v, t),
    each [N, C].  o/d: 3-tuples of [N, 1]; v0/e1/e2: 3-tuples of [C]."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z = v0
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    big = torch.abs(det) > _DET_EPS
    inv_det = torch.where(big, 1.0 / det, torch.zeros_like(det))
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    return big, u, v, t


def _mt_chunk_planar(o, d, v0, e1, e2, t_min, t_max):
    """MT for all rays x one chunk of triangles (intersect.py:62-98).
    o/d: 3-tuples of [N, 1]; v0/e1/e2: 3-tuples of [C].  Returns
    (t [N, C] with misses at INF, u, v)."""
    big, u, v, t = _mt_terms(o, d, v0, e1, e2)
    ok = (big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > t_min) & (t < t_max))
    return torch.where(ok, t, torch.full_like(t, INF)), u, v


def _chunk_planes(tri_verts, chunk):
    t_count = tri_verts.shape[0]
    pad = (-t_count) % chunk
    tv = torch.nn.functional.pad(tri_verts, (0, 0, 0, 0, 0, pad))
    nc = tv.shape[0] // chunk

    def planes(a):
        return tuple(a[:, c].reshape(nc, chunk) for c in range(3))

    return nc, (planes(tv[:, 0]), planes(tv[:, 1] - tv[:, 0]),
                planes(tv[:, 2] - tv[:, 0]))


def as_planes3(a):
    """[N, 3] AoS or a 3-tuple of [N] planes -> 3-tuple of planes."""
    if isinstance(a, (tuple, list)):
        return tuple(a)
    return pv.from_aos(a, 1)


def _ray_setup(origins, dirs, t_min, t_max, chunk, t_count):
    o = tuple(c[:, None] for c in as_planes3(origins))
    d = tuple(c[:, None] for c in as_planes3(dirs))
    n = o[0].shape[0]
    dev = o[0].device
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev)
    t_min = t_min.expand(n)[:, None]
    t_max = t_max.expand(n)[:, None]
    chunk = max(min(chunk, -(-t_count // _MIN_CHUNK) * _MIN_CHUNK),
                _MIN_CHUNK)
    return o, d, n, t_min, t_max, chunk


def closest_hit_brute(origins, dirs, tri_verts, t_min=1e-4, t_max=1e4,
                      chunk: int = 512) -> Hit:
    """Closest hit of each ray against all triangles (intersect.py:142-201):
    per chunk the first-minimum lane; a later chunk wins only if strictly
    closer."""
    o, d, n, t_min, t_max, chunk = _ray_setup(
        origins, dirs, t_min, t_max, chunk, tri_verts.shape[0])
    nc, (v0, e1, e2) = _chunk_planes(tri_verts, chunk)
    dev = o[0].device
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_tri = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    for c in range(nc):
        t, u, v = _mt_chunk_planar(
            o, d, tuple(p[c] for p in v0), tuple(p[c] for p in e1),
            tuple(p[c] for p in e2), t_min, t_max)
        t_c, idx = torch.min(t, dim=-1)
        # torch.min returns the first minimal index, like jnp.argmin
        u_c = torch.gather(u, 1, idx[:, None])[:, 0]
        v_c = torch.gather(v, 1, idx[:, None])[:, 0]
        better = t_c < best_t
        best_t = torch.where(better, t_c, best_t)
        best_tri = torch.where(better, c * chunk + idx, best_tri)
        best_u = torch.where(better, u_c, best_u)
        best_v = torch.where(better, v_c, best_v)
    return Hit(t=best_t, tri=best_tri, u=best_u, v=best_v)


def any_hit_brute(origins, dirs, tri_verts, t_min, t_max,
                  chunk: int = 512) -> torch.Tensor:
    """Boolean occlusion (ShadowRay.hlsl semantics, intersect.py:204-235)."""
    o, d, n, t_min, t_max, chunk = _ray_setup(
        origins, dirs, t_min, t_max, chunk, tri_verts.shape[0])
    nc, (v0, e1, e2) = _chunk_planes(tri_verts, chunk)
    occ = torch.zeros((n,), dtype=torch.bool, device=o[0].device)
    for c in range(nc):
        t, _, _ = _mt_chunk_planar(
            o, d, tuple(p[c] for p in v0), tuple(p[c] for p in e1),
            tuple(p[c] for p in e2), t_min, t_max)
        occ = occ | torch.any(t < INF, dim=-1)
    return occ


def _shade_attrs_from_planes(v, nv, u_bary, v_bary):
    """Planar shading attributes (intersect.py:238-262)."""
    w0 = 1.0 - u_bary - v_bary
    w1, w2 = u_bary, v_bary
    e1 = tuple(v[3 + c] - v[c] for c in range(3))
    e2 = tuple(v[6 + c] - v[c] for c in range(3))
    cr = pv.cross(e1, e2)
    area = 0.5 * pv.length(cr)
    flat = pv.normalize(cr)
    smooth = []
    for c in range(3):
        acc = 0.0
        for k, wk in enumerate((w0, w1, w2)):
            has_n = ((nv[3 * k] != 0.0) | (nv[3 * k + 1] != 0.0)
                     | (nv[3 * k + 2] != 0.0))
            acc = acc + wk * torch.where(has_n, nv[3 * k + c], flat[c])
        smooth.append(acc)
    smooth = tuple(smooth)
    use_smooth = pv.length(smooth) > 1e-4
    normal = pv.where(use_smooth, pv.normalize(smooth), flat)
    return normal, flat, area


def hit_attributes_p(hit: Hit, tri_table: torch.Tensor):
    """All per-hit shading attributes from ONE [T, 20] row gather
    (intersect.py:265-279).  Returns (normal, flat, area, mid, obj)."""
    row = tri_table[hit.tri]
    v = [row[:, k] for k in range(9)]
    nv = [row[:, 9 + k] for k in range(9)]
    mid = row[:, 18].to(torch.int32)
    obj = row[:, 19].to(torch.int32)
    normal, flat, area = _shade_attrs_from_planes(v, nv, hit.u, hit.v)
    return normal, flat, area, mid, obj


def interpolate_hit_p(hit: Hit, tri_verts, tri_normals):
    """Planar interpolate_hit (intersect.py:282-299): (pos, normal, flat,
    area) with vectors as planar tuples."""
    t_count = tri_verts.shape[0]
    tv9 = tri_verts.reshape(t_count, 9)[hit.tri]
    tn9 = tri_normals.reshape(t_count, 9)[hit.tri]
    v = [tv9[:, k] for k in range(9)]
    nv = [tn9[:, k] for k in range(9)]
    w0 = 1.0 - hit.u - hit.v
    w1, w2 = hit.u, hit.v
    pos = tuple(w0 * v[c] + w1 * v[3 + c] + w2 * v[6 + c] for c in range(3))
    normal, flat, area = _shade_attrs_from_planes(v, nv, hit.u, hit.v)
    return pos, normal, flat, area


def interpolate_hit(hit: Hit, tri_verts, tri_normals):
    """AoS shading attributes (intersect.py:302-326): (pos [N, 3],
    normal [N, 3], flat [N, 3], area [N]); no flip toward the ray."""
    pos, normal, flat, area = interpolate_hit_p(hit, tri_verts, tri_normals)
    return pv.to_aos(pos, 1), pv.to_aos(normal, 1), pv.to_aos(flat, 1), area
