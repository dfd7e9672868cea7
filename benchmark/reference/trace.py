"""Brute-force ray queries: the reference's answer to every trace.

Each ray is tested against every triangle with the Möller–Trumbore terms
of ``reference/intersect.py`` (the plain association order of the port's
``ops/intersect.py``), in blocks of rays x triangles so that a
1080p frame's batches fit the card.  Closest hit keeps the first minimal
triangle index on ties, as the plain version does; occlusion is "some
triangle hits within (t_min, t_max)".  Rays whose t_max is not above their
t_min cannot hit and are not tested.

``dtype=torch.bfloat16`` computes the same terms in bfloat16 (rays and
triangles rounded to it): the control of the comparisons, the nearest
precision below the configurations' float32.
"""

from __future__ import annotations

import torch

from reference.intersect import INF, Hit, _mt_terms


def _blocks(device) -> tuple[int, int]:
    """(rays, triangles) per block: some 32M pairs on the card, 1M on the
    CPU."""
    return (4096, 8192) if device.type == "cuda" else (1024, 1024)


def _prepare(o, d, tri_verts, t_min, t_max, dtype):
    dev = o[0].device
    n = o[0].shape[0]
    lo = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
    hi = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    live = torch.nonzero(hi > lo).flatten()
    v0 = tri_verts[:, 0]
    e1 = tri_verts[:, 1] - tri_verts[:, 0]
    e2 = tri_verts[:, 2] - tri_verts[:, 0]
    tris = tuple(tuple(p[:, c].to(dtype) for c in range(3))
                 for p in (v0, e1, e2))
    return n, lo, hi, live, tris


def _terms(o, d, idx, tris, lo, hi, c0, c1, dtype):
    """MT of rays ``idx`` x triangles [c0, c1): (t with misses at INF, u,
    v), float32 [R, C]."""
    oc = tuple(x[idx].to(dtype)[:, None] for x in o)
    dc = tuple(x[idx].to(dtype)[:, None] for x in d)
    v0, e1, e2 = (tuple(p[c0:c1] for p in q) for q in tris)
    big, u, v, t = _mt_terms(oc, dc, v0, e1, e2)
    u, v, t = u.float(), v.float(), t.float()
    ok = (big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > lo[idx][:, None]) & (t < hi[idx][:, None]))
    return torch.where(ok, t, torch.full_like(t, INF)), u, v


def closest_hit(o, d, tri_verts, t_min=1e-4, t_max=1e4,
                dtype=torch.float32) -> Hit:
    """Closest hit of the planar rays ``o`` / ``d`` (3-tuples of [N])
    against ``tri_verts`` [T, 3, 3]."""
    n, lo, hi, live, tris = _prepare(o, d, tri_verts, t_min, t_max, dtype)
    dev = o[0].device
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_tri = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    rb, cb = _blocks(dev)
    count = tri_verts.shape[0]
    for r0 in range(0, live.numel(), rb):
        idx = live[r0:r0 + rb]
        bt = torch.full((idx.numel(),), INF, dtype=torch.float32, device=dev)
        bi = torch.zeros((idx.numel(),), dtype=torch.int64, device=dev)
        bu = torch.zeros_like(bt)
        bv = torch.zeros_like(bt)
        for c0 in range(0, count, cb):
            c1 = min(count, c0 + cb)
            t, u, v = _terms(o, d, idx, tris, lo, hi, c0, c1, dtype)
            t_c, k = torch.min(t, dim=-1)     # the first minimal index
            better = t_c < bt
            bt = torch.where(better, t_c, bt)
            bi = torch.where(better, c0 + k, bi)
            bu = torch.where(better, torch.gather(u, 1, k[:, None])[:, 0], bu)
            bv = torch.where(better, torch.gather(v, 1, k[:, None])[:, 0], bv)
        best_t[idx], best_tri[idx], best_u[idx], best_v[idx] = bt, bi, bu, bv
    return Hit(t=best_t, tri=best_tri, u=best_u, v=best_v)


def any_hit(o, d, tri_verts, t_min, t_max,
            dtype=torch.float32) -> torch.Tensor:
    """Occlusion of the planar segments: bool [N]."""
    n, lo, hi, live, tris = _prepare(o, d, tri_verts, t_min, t_max, dtype)
    dev = o[0].device
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    rb, cb = _blocks(dev)
    count = tri_verts.shape[0]
    for r0 in range(0, live.numel(), rb):
        open_ = live[r0:r0 + rb]
        for c0 in range(0, count, cb):
            if open_.numel() == 0:
                break
            t, _, _ = _terms(o, d, open_, tris, lo, hi, c0,
                             min(count, c0 + cb), dtype)
            hit = torch.any(t < INF, dim=-1)
            occ[open_[hit]] = True
            open_ = open_[~hit]
    return occ


def tie_count(o, d, tri_verts, t_min, t_max, t_best, rtol: float = 1e-5,
              dtype=torch.float32) -> torch.Tensor:
    """How many triangles each ray hits within ``rtol`` of ``t_best`` (its
    closest hit): above 1 where coincident or meeting triangles tie, so
    that which of them answers is not defined by the query."""
    n, lo, hi, live, tris = _prepare(o, d, tri_verts, t_min, t_max, dtype)
    dev = o[0].device
    count = torch.zeros((n,), dtype=torch.int64, device=dev)
    live = live[t_best[live] < INF]
    rb, cb = _blocks(dev)
    for r0 in range(0, live.numel(), rb):
        idx = live[r0:r0 + rb]
        tb = t_best[idx][:, None]
        for c0 in range(0, tri_verts.shape[0], cb):
            t, _, _ = _terms(o, d, idx, tris, lo, hi, c0,
                             min(tri_verts.shape[0], c0 + cb), dtype)
            count[idx] += (torch.abs(t - tb) <= rtol * tb).sum(dim=-1)
    return count
