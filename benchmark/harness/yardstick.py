"""The trace kernels' roofline yardstick: the least time an H100 could
take for a batch of ray queries, from the work the rays need, whatever
kernel answers them.  It never reads a kernel's own statistics.

Work: the benchmark builds its own two-level accel over the reference's
triangles (a frozen copy of the port's median build: equal-count median
splits of the centroids along the widest axis, 64-triangle clusters, 32
clusters a block, padded to a power of two) and walks a seeded sample of
each batch's live rays through it in plain torch:

* every ray tests every real block's box;
* closest hit opens the blocks whose box it enters before its hit (or
  t_max), tests the real cluster boxes of an opened block, and the
  triangles of every cluster it enters before its hit;
* occlusion walks blocks near to far, clusters near to far inside a
  block, and stops at the first cluster holding a hit.

A slab test counts ``SLAB_OPS`` FP32 operations; a triangle test the
Möller–Trumbore stages it reaches (``STAGE_OPS``: 14 to the determinant,
10 more to u, 16 more to v and u + v, 6 more to t).  The sample's sum is
scaled by live rays over sampled rays.  Bytes: each ray row (origin,
direction, t_min, t_max) read once, each answer written once (16 bytes a
closest hit, 1 an occlusion flag) and the triangles read once.

Least time = max(operations / ``PEAK_FP32``, bytes / ``PEAK_HBM``): the
published FP32 (non-tensor) peak and HBM rate of the H100 SXM.
"""

from __future__ import annotations

import dataclasses

import torch

from reference.intersect import _mt_terms

G = 64
S = 32
PEAK_FP32 = 67e12
PEAK_HBM = 3.35e12
SLAB_OPS = 24
STAGE_OPS = (14, 10, 16, 6)
RAY_BYTES = 32
OUT_BYTES = {"closest": 16, "any": 1}
TRI_BYTES = 36
SAMPLE = 4096
_BIG = 3.0e38
_INF = 1e30


@dataclasses.dataclass
class Accel:
    planes: tuple      # v0, e1, e2: 3-tuples of [B, S, G] planes
    real: torch.Tensor         # [B, S, G] bool
    cl_lo: torch.Tensor        # [B, S, 3]
    cl_hi: torch.Tensor
    cl_real: torch.Tensor      # [B, S]
    blk_lo: torch.Tensor       # [B, 3]
    blk_hi: torch.Tensor
    blk_real: torch.Tensor     # [B]
    num_tris: int

    @property
    def blocks(self) -> int:
        return self.blk_lo.shape[0]


def _median_order(centroid, tri_id):
    """Equal-split recursive median order (the port's
    ``stream_trace._median_perm_device``)."""
    p = centroid.shape[0]
    levels = max(0, (p // G).bit_length() - 1)
    cx, cy, cz = centroid[:, 0], centroid[:, 1], centroid[:, 2]
    tid = tri_id
    iota = torch.arange(p, dtype=torch.int64, device=centroid.device)
    for lvl in range(levels):
        nseg = 1 << lvl
        seglen = p >> lvl
        segid = iota >> (seglen.bit_length() - 1)

        def ext(c):
            cc = c.reshape(nseg, seglen)
            fin = cc < _BIG
            lo = torch.amin(torch.where(fin, cc, torch.full_like(cc, _BIG)),
                            dim=1)
            hi = torch.amax(torch.where(fin, cc, torch.full_like(cc, -_BIG)),
                            dim=1)
            return lo, hi

        xlo, xhi = ext(cx)
        ylo, yhi = ext(cy)
        zlo, zhi = ext(cz)
        ex, ey, ez = xhi - xlo, yhi - ylo, zhi - zlo

        def expand(a):
            return a[:, None].expand(nseg, seglen).reshape(p)

        use_y = expand((ey >= ex) & (ey >= ez))
        use_z = expand((ez > ex) & (ez > ey) & ~((ey >= ex) & (ey >= ez)))
        val = torch.where(use_y, cy, torch.where(use_z, cz, cx))
        lo_e = torch.where(use_y, expand(ylo),
                           torch.where(use_z, expand(zlo), expand(xlo)))
        hi_e = torch.where(use_y, expand(yhi),
                           torch.where(use_z, expand(zhi), expand(xhi)))
        frac = (val - lo_e) / torch.clamp_min(hi_e - lo_e, 1e-30)
        frac = torch.where(val < _BIG, frac, torch.full_like(frac, _INF))
        o1 = torch.argsort(frac, stable=True)
        order = o1[torch.argsort(segid[o1], stable=True)]
        cx, cy, cz, tid = cx[order], cy[order], cz[order], tid[order]
    return tid


def build(tri_verts) -> Accel:
    """The yardstick's accel over [T, 3, 3] triangles on their device."""
    t = tri_verts.shape[0]
    dev = tri_verts.device
    p = max(S * G, 1 << max(0, (t - 1).bit_length()))
    tv = torch.cat([tri_verts.float(),
                    torch.zeros((p - t, 3, 3), device=dev)], dim=0)
    centroid = (tv[:, 0] + tv[:, 1] + tv[:, 2]) * (1.0 / 3.0)
    real = torch.arange(p, device=dev) < t
    centroid = torch.where(real[:, None], centroid,
                           torch.full_like(centroid, _INF))
    tid = torch.where(real, torch.arange(p, device=dev),
                      torch.full((p,), -1, device=dev))
    order = _median_order(centroid, tid)
    b = p // (S * G)
    real = (order >= 0).reshape(b, S, G)
    st = tv[torch.clamp_min(order, 0)].reshape(b, S, G, 3, 3)
    v0 = st[..., 0, :]
    e1 = st[..., 1, :] - v0
    e2 = st[..., 2, :] - v0
    big = torch.full((), _BIG, device=dev)
    lo = torch.where(real[..., None], st.amin(dim=3), big)
    hi = torch.where(real[..., None], st.amax(dim=3), -big)
    cl_lo, cl_hi = lo.amin(dim=2), hi.amax(dim=2)
    cl_real = real.any(dim=2)
    return Accel(
        planes=tuple(tuple(a[..., c] for c in range(3)) for a in (v0, e1, e2)),
        real=real, cl_lo=cl_lo, cl_hi=cl_hi, cl_real=cl_real,
        blk_lo=torch.where(cl_real[..., None], cl_lo, big).amin(dim=1),
        blk_hi=torch.where(cl_real[..., None], cl_hi, -big).amax(dim=1),
        blk_real=cl_real.any(dim=1), num_tris=t)


def _slab(o, inv, lo, hi, t0, t1):
    """Entry and overlap of rays [R] (o, inv [R, 3]) with boxes [..., 3]
    inside (t0, t1): entry [R, ...], ok [R, ...]."""
    shape = (o.shape[0],) + (1,) * (lo.dim() - 1) + (3,)
    o = o.reshape(shape)
    inv = inv.reshape(shape)
    a = (lo[None] - o) * inv
    b = (hi[None] - o) * inv
    near = torch.amax(torch.minimum(a, b), dim=-1)
    far = torch.amin(torch.maximum(a, b), dim=-1)
    ext = (o.shape[0],) + (1,) * (lo.dim() - 1)
    entry = torch.maximum(near, t0.reshape(ext))
    exit_ = torch.minimum(far, t1.reshape(ext))
    return entry, entry <= exit_


def _cluster_tables(acc: Accel, o, d, t0, t1, step: int = 4):
    """Per ray and cluster [R, B, S]: the stage operations of its real
    triangles and its nearest hit inside (t0, t1) (INF if none)."""
    r = o.shape[0]
    b = acc.blocks
    ops = torch.zeros((r, b, S), device=o.device)
    tmin = torch.full((r, b, S), _INF, device=o.device)
    oc = tuple(o[:, c][:, None, None, None] for c in range(3))
    dc = tuple(d[:, c][:, None, None, None] for c in range(3))
    lo, hi = t0[:, None, None, None], t1[:, None, None, None]
    for b0 in range(0, b, step):
        sl = slice(b0, min(b, b0 + step))
        v0, e1, e2 = (tuple(x[sl][None] for x in q) for q in acc.planes)
        big, u, v, t = _mt_terms(oc, dc, v0, e1, e2)
        u_ok = big & (u >= 0.0) & (u <= 1.0)
        v_ok = u_ok & (v >= 0.0) & (u + v <= 1.0)
        real = acc.real[sl][None]
        stage = (STAGE_OPS[0] + STAGE_OPS[1] * big.float()
                 + STAGE_OPS[2] * u_ok.float() + STAGE_OPS[3] * v_ok.float())
        ops[:, sl] = torch.where(real, stage, 0.0).sum(dim=-1)
        hit = v_ok & (t > lo) & (t < hi) & real
        tmin[:, sl] = torch.where(hit, t, _INF).amin(dim=-1)
    return ops, tmin


def _ray_ops(acc: Accel, o, d, t0, t1, query: str):
    """FP32 operations the rays [R] need (a tensor [R])."""
    inv = torch.where(torch.abs(d) > 1e-20, 1.0 / d,
                      torch.where(d >= 0.0, 1e30, -1e30))
    b_entry, b_ok = _slab(o, inv, acc.blk_lo, acc.blk_hi, t0, t1)
    b_ok &= acc.blk_real[None]
    c_entry, c_ok = _slab(o, inv, acc.cl_lo, acc.cl_hi, t0, t1)
    c_ok &= acc.cl_real[None] & b_ok[..., None]
    tri_ops, tmin = _cluster_tables(acc, o, d, t0, t1)
    per_block = acc.cl_real.sum(dim=1).float()            # [B]
    if query == "closest":
        limit = torch.minimum(tmin.amin(dim=(1, 2)), t1)
        opened = b_ok & (b_entry <= limit[:, None])
        tested = c_ok & opened[..., None] & (c_entry <= limit[:, None, None])
    else:
        bkey = torch.where(b_ok, b_entry, _INF)
        b_rank = torch.argsort(torch.argsort(bkey, dim=1, stable=True),
                               dim=1, stable=True)
        ckey = torch.where(c_ok, c_entry, _INF)
        c_rank = torch.argsort(torch.argsort(ckey, dim=2, stable=True),
                               dim=2, stable=True)
        pos = b_rank[..., None] * S + c_rank
        first = torch.where(c_ok & (tmin < _INF), pos,
                            torch.iinfo(torch.int64).max).amin(dim=(1, 2))
        tested = c_ok & (pos <= first[:, None, None])
        opened = b_ok & (b_rank <= torch.div(first, S, rounding_mode="floor")
                         [:, None])
    slabs = (acc.blk_real.sum().float()
             + (opened.float() * per_block[None]).sum(dim=1))
    return SLAB_OPS * slabs + (tri_ops * tested.float()).sum(dim=(1, 2))


def batch_work(acc: Accel, query: str, o, d, t_min, t_max,
               gen: torch.Generator, sample: int = SAMPLE) -> dict:
    """(operations, bytes, least seconds) of one batch; o / d planar
    3-tuples of [N]."""
    n = o[0].shape[0]
    dev = o[0].device
    t0 = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
    t1 = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    live = torch.nonzero(t1 > t0).flatten()
    ops = 0.0
    if live.numel():
        pick = live[torch.randperm(live.numel(), generator=gen,
                                   device=dev)[:sample]]
        oo = torch.stack([c[pick] for c in o], dim=1).float()
        dd = torch.stack([c[pick] for c in d], dim=1).float()
        per_ray = []
        for r0 in range(0, pick.numel(), 1024):
            sl = slice(r0, r0 + 1024)
            per_ray.append(_ray_ops(acc, oo[sl], dd[sl], t0[pick][sl],
                                    t1[pick][sl], query))
        ops = float(torch.cat(per_ray).sum()) * live.numel() / pick.numel()
    nbytes = float(n * (RAY_BYTES + OUT_BYTES[query])
                   + acc.num_tris * TRI_BYTES)
    return dict(ops=ops, bytes=nbytes,
                least_s=max(ops / PEAK_FP32, nbytes / PEAK_HBM))


def least_seconds(acc: Accel, batches, seed: int) -> float | None:
    """The least time of the captured batches (``TraceSpans.batches``),
    summed; None where there were none."""
    if not batches:
        return None
    gen = torch.Generator(device=acc.real.device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    return sum(batch_work(acc, q, o, d, lo, hi, gen)["least_s"]
               for q, o, d, lo, hi in batches)
