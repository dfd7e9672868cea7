"""Stream traversal: the two-level StreamAccel and its trace kernels (port
of royaltracer_dx_tpu/ops/stream_trace.py).

Build half: ``build_stream_accel(method="median")`` ->
``_build_device_median`` / ``_median_perm_device`` -> ``_layout_device``
(stream_trace.py:129-404), producing exactly the fields the kernels read:
``blk_tris`` [B, 9S, G], ``blk_boxes`` [B, 6, 128], ``top_lo`` / ``top_hi``
[B, 3] and ``perm``; ``refit_stream_accel`` (:396-405) re-lays moved
triangles out in the build's order.  The bf16 box rows and the
thick-plane slabs serve only the JAX package's XLA paths and are not
ported.

Trace half: the per-chunk block worklists (``_interval_slab``,
``_build_worklists``, :431-504) are tensor code; the per-chunk traversal
is the hand-written CUDA kernel pair in ``csrc/stream_trace.cu``
(``stream_closest`` / ``stream_any``, replacing both modes of the Pallas
``_make_kernel``, :514-725).  On the H100 a batch of a rendered frame is
mostly a stream of lanes whose chunk has an empty worklist (bound by
bytes), and the chunks that do walk are sparse: each hot cluster is
wanted by a handful of the chunk's 128 rays.  So the kernels stage
nothing in shared memory (a ring of bulk-copied cluster tiles was
measured slower than reading the tiles in place), read boxes and tiles
through the read-only cache, let a warp take its few wanting rays one at
a time with the lanes spread over the triangles (or over the boxes),
cross one CTA-wide barrier per block step, and keep registers low enough
for 8 CTAs per SM; the source's header note gives the measured reasons.
Each kernel's wrapper launches it for CUDA tensors (or raises) and runs
its plain PyTorch version — the same worklist-ordered algorithm in
tensor ops — for CPU tensors only.

Per-chunk stats, [chunks, 3] int32, equal for kernel and plain version:
blocks visited, clusters tested (hot for some ray of the chunk), and
ray-cluster candidate pairs (the sum over the chunk's valid rays and
visited blocks of the clusters whose box the ray's own slab test
passed).  ``stream_work`` turns them into the bytes and FP32 operations
a call needs whatever implements it, and ``bound_ms`` into the least time
a card could take for them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from royaltracer_dx_tpu_torch.ops.intersect import INF, Hit, as_planes3

G = 64                 # triangles per cluster
S = 32                 # clusters per block (block = 2048 triangles)
RAYS_PER_CHUNK = 128   # rays per kernel chunk (one CTA)
_DET_EPS = 1e-12
_BIG = 3.0e38

# one launch count per kernel, bumped only where the kernel is launched
LAUNCHES = {"stream_closest": 0, "stream_any": 0}


@dataclasses.dataclass
class StreamAccel:
    """Two-level stream-traversal structure (stream_trace.py:64-106).

    Block b, cluster s, lane g address sorted-triangle slot (b*S + s)*G + g;
    ``perm`` maps slots to original triangle ids (-1 for padding)."""

    blk_tris: torch.Tensor   # [B, 9S, G] v0/e1/e2 planes, cluster-major
    blk_boxes: torch.Tensor  # [B, 6, 128] cluster AABB planes (lanes >= S pad)
    top_lo: torch.Tensor     # [B, 3] block AABBs
    top_hi: torch.Tensor     # [B, 3]
    perm: torch.Tensor       # [B*S*G] int32

    @property
    def num_blocks(self) -> int:
        return self.blk_tris.shape[0]


# ------------------------------- build ----------------------------------


def _layout_device(sorted_tris, perm, b: int) -> StreamAccel:
    """Flat-row layout from sorted triangles (stream_trace.py:129-164)."""
    pad = perm < 0
    tv = torch.where(pad[:, None, None], torch.zeros_like(sorted_tris),
                     sorted_tris)
    v0 = tv[:, 0]
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    planes = torch.cat([v0, e1, e2], dim=1)                   # [slots, 9]
    blk_tris = (planes.reshape(b, S, G, 9).permute(0, 1, 3, 2)
                .reshape(b, 9 * S, G).contiguous())
    big = torch.full_like(tv[:, 0], _BIG)
    tmin = torch.where(pad[:, None], big, torch.amin(tv, dim=1))
    tmax = torch.where(pad[:, None], -big, torch.amax(tv, dim=1))
    cl_lo = torch.amin(tmin.reshape(b, S, G, 3), dim=2)       # [b, S, 3]
    cl_hi = torch.amax(tmax.reshape(b, S, G, 3), dim=2)
    # empty clusters/blocks are the far point [+BIG, +BIG], never an
    # inverted box (which would pass every slab test, :146-153)
    real_cl = torch.any((perm >= 0).reshape(b, S, G), dim=2)
    big_cl = torch.full_like(cl_lo, _BIG)
    cl_lo = torch.where(real_cl[..., None], cl_lo, big_cl)
    cl_hi = torch.where(real_cl[..., None], cl_hi, big_cl)
    boxes = torch.full((b, 6, 128), _BIG, dtype=torch.float32,
                       device=tv.device)
    boxes[:, 0:3, :S] = cl_lo.permute(0, 2, 1)
    boxes[:, 3:6, :S] = cl_hi.permute(0, 2, 1)
    real_blk = torch.any(real_cl, dim=1)
    top_lo = torch.amin(torch.where(real_cl[..., None], cl_lo, big_cl), dim=1)
    top_hi = torch.amax(torch.where(real_cl[..., None], cl_hi, -big_cl), dim=1)
    top_hi = torch.where(real_blk[:, None], top_hi, torch.full_like(top_hi,
                                                                    _BIG))
    return StreamAccel(blk_tris=blk_tris, blk_boxes=boxes.contiguous(),
                       top_lo=top_lo, top_hi=top_hi,
                       perm=perm.to(torch.int32).contiguous())


def _median_perm_device(centroid, tri_id):
    """Equal-split recursive median ordering (stream_trace.py:249-299).

    Each level orders every segment by its widest centroid axis with a
    lexicographic stable sort on (segment id, normalized value): a stable
    sort by the value, then a stable sort by the segment id.  Menger-like
    geometry has many equal centroid coordinates, so the stable
    two-pass form is what makes ``perm`` match the JAX build."""
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
        frac = torch.where(val < _BIG, frac, torch.full_like(frac, INF))
        o1 = torch.argsort(frac, stable=True)
        order = o1[torch.argsort(segid[o1], stable=True)]
        cx, cy, cz, tid = cx[order], cy[order], cz[order], tid[order]
    return tid


def _build_device_median(tri_padded, num_tris: int) -> StreamAccel:
    """Median ordering + flat-row layout (stream_trace.py:302-318)."""
    p = tri_padded.shape[0]
    dev = tri_padded.device
    # XLA-CPU computes jnp.mean(axis=1) as sum * (1/3); so does this
    centroid = (tri_padded[:, 0] + tri_padded[:, 1] + tri_padded[:, 2]) \
        * (1.0 / 3.0)
    real = torch.arange(p, device=dev) < num_tris
    centroid = torch.where(real[:, None], centroid,
                           torch.full_like(centroid, INF))
    tid = torch.where(real, torch.arange(p, dtype=torch.int32, device=dev),
                      torch.full((p,), -1, dtype=torch.int32, device=dev))
    order = _median_perm_device(centroid, tid)
    safe = torch.clamp_min(order, 0).long()
    sorted_tris = torch.where((order >= 0)[:, None, None], tri_padded[safe],
                              torch.zeros_like(tri_padded))
    return _layout_device(sorted_tris, order, p // (S * G))


def refit_stream_accel(accel: StreamAccel, tri_verts_new) -> StreamAccel:
    """Refit with moved vertices, keeping the build's ``perm`` (the TLAS
    updateOnly analog, stream_trace.py:396-405): one gather through perm
    and the same layout; padding slots stay masked by ``perm < 0``.  A
    refitted accel differs from a fresh build of the moved triangles."""
    gathered = tri_verts_new.to(torch.float32)[
        torch.clamp_min(accel.perm, 0).long()]
    return _layout_device(gathered, accel.perm, accel.num_blocks)


def build_stream_accel(tri_verts, method: str = "median") -> StreamAccel:
    """Build over [T, 3, 3] world-space triangles on their device
    (stream_trace.py:358-394).  Only the default device median build is
    ported; it pads to a power of two >= one block."""
    if method != "median":
        raise NotImplementedError(
            f"stream build method {method!r} is not ported (median only)")
    t = tri_verts.shape[0]
    p = max(S * G, 1 << (t - 1).bit_length())
    tv = tri_verts.to(torch.float32)
    if p > t:
        tv = torch.cat([tv, torch.zeros((p - t, 3, 3), dtype=tv.dtype,
                                        device=tv.device)], dim=0)
    return _build_device_median(tv, t)


# --------------------------- chunk worklists -----------------------------


def swizzle_order(width: int, height: int, tile_w: int = 16, tile_h: int = 8):
    """Pixel permutation making each 128-ray chunk a tile_w x tile_h pixel
    rectangle (stream_trace.py:410-430), host numpy.  Returns (order,
    inverse) int32 arrays of length width*height; apply as
    ``rays[order]``, undo as ``result[inverse]``."""
    assert width % tile_w == 0 and height % tile_h == 0
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    tile_id = (ys // tile_h) * (width // tile_w) + (xs // tile_w)
    in_tile = (ys % tile_h) * tile_w + (xs % tile_w)
    key = tile_id.astype(np.int64) * (tile_w * tile_h) + in_tile
    order = np.argsort(key.ravel(), kind="stable").astype(np.int32)
    inverse = np.argsort(order, kind="stable").astype(np.int32)
    return order, inverse


def _interval_slab(o_lo, o_hi, d_lo, d_hi, lo, hi, t_lo, t_hi):
    """Conservative chunk-frustum vs AABB overlap by interval arithmetic
    (stream_trace.py:431-469).  Returns (pass [chunks, X], entry lower
    bound [chunks, X])."""
    chunks = o_lo.shape[0]
    x = lo.shape[0]
    tn = t_lo[:, None].expand(chunks, x)
    tf = t_hi[:, None].expand(chunks, x)
    one = torch.ones((), dtype=torch.float32, device=lo.device)
    for c in range(3):
        dl = d_lo[:, c:c + 1]
        dh = d_hi[:, c:c + 1]
        unc = (dl <= 0.0) & (dh >= 0.0)
        il = torch.where(unc, one, 1.0 / torch.where(dh == 0.0, one, dh))
        ih = torch.where(unc, one, 1.0 / torch.where(dl == 0.0, one, dl))
        a1 = lo[None, :, c] - o_hi[:, c:c + 1]
        a2 = lo[None, :, c] - o_lo[:, c:c + 1]
        b1 = hi[None, :, c] - o_hi[:, c:c + 1]
        b2 = hi[None, :, c] - o_lo[:, c:c + 1]
        mn, mx = torch.minimum, torch.maximum
        p_min = mn(mn(mn(a1 * il, a1 * ih), mn(a2 * il, a2 * ih)),
                   mn(mn(b1 * il, b1 * ih), mn(b2 * il, b2 * ih)))
        p_max = mx(mx(mx(a1 * il, a1 * ih), mx(a2 * il, a2 * ih)),
                   mx(mx(b1 * il, b1 * ih), mx(b2 * il, b2 * ih)))
        near = torch.where(unc, torch.full_like(p_min, -_BIG), p_min)
        far = torch.where(unc, torch.full_like(p_max, _BIG), p_max)
        tn = torch.maximum(tn, near)
        tf = torch.minimum(tf, far)
    return tn <= tf, torch.clamp_min(tn, 0.0)


def _build_worklists(origins, dirs, t_min, t_max, accel: StreamAccel,
                     wb: int):
    """Per-chunk near-to-far block worklists (stream_trace.py:472-504).

    origins/dirs [N_pad, 3].  Returns (wl [chunks, wb] int32, went
    [chunks, wb] f32 entry lower bounds, cnt [chunks] int32).  The sort is
    stable (``lax.sort`` is not, :495): ties between equal entries order
    by block id, which can change only the slot of an exact-t tie.

    The chunk bounds take only the lanes with t_max > t_min, as the JAX
    package's XLA path bounds its tiles (``_block_sort``, :834-848); the
    Pallas path's bounds (:482-489) take every lane.  A lane that fails
    the test never hits (its slab and Moller-Trumbore tests need t_min <
    t), so every other lane's answer stands; but a dead lane no longer
    widens its chunk, and a NaN t_min (a megakernel shadow ray of a lane
    that missed) no longer turns the chunk's bounds to NaN, which emptied
    its worklist and left its live lanes unoccluded."""
    n = origins.shape[0]
    chunks = n // RAYS_PER_CHUNK
    b = accel.num_blocks
    live = (t_max > t_min).reshape(chunks, RAYS_PER_CHUNK, 1)
    big = torch.full((), _BIG, dtype=torch.float32, device=origins.device)

    def lo(a):
        return torch.amin(torch.where(live, a, big), dim=1)

    def hi(a):
        return torch.amax(torch.where(live, a, -big), dim=1)

    o = origins.reshape(chunks, RAYS_PER_CHUNK, 3)
    d = dirs.reshape(chunks, RAYS_PER_CHUNK, 3)
    ok, entry = _interval_slab(
        lo(o), hi(o), lo(d), hi(d), accel.top_lo, accel.top_hi,
        lo(t_min.reshape(chunks, RAYS_PER_CHUNK, 1))[:, 0],
        hi(t_max.reshape(chunks, RAYS_PER_CHUNK, 1))[:, 0])
    key = torch.where(ok, entry, torch.full_like(entry, INF))
    skey, sbid = torch.sort(key, dim=1, stable=True)
    if b < wb:
        skey = torch.nn.functional.pad(skey, (0, wb - b), value=INF)
        sbid = torch.nn.functional.pad(sbid, (0, wb - b), value=0)
    wl = sbid[:, :wb].to(torch.int32).contiguous()
    went = skey[:, :wb].contiguous()
    cnt = torch.clamp_max(ok.sum(dim=1), wb).to(torch.int32).contiguous()
    return wl, went, cnt


# ------------------------- the kernels' plain form -----------------------


def _safe_inv(d):
    big = torch.where(d >= 0.0, torch.full_like(d, 1e30),
                      torch.full_like(d, -1e30))
    return torch.where(torch.abs(d) > 1e-20, 1.0 / d, big)


# chunks per step of the plain version: bounds its [chunks, 128, 64]
# temporaries, whatever the batch size, to ~134 MB each on the CPU and
# ~1 GB on an 80 GB card
_PLAIN_GROUP = {"cpu": 4096, "cuda": 32768}


def _stream_plain(rows, wl, went, cnt, blk_tris, blk_boxes,
                  occlusion: bool):
    """The kernels' plain PyTorch version: the same worklist-ordered walk
    (visit order, per-ray slab bound at the block start, first-minimum
    lane per cluster, strictly-closer across clusters, per-chunk early
    exit), vectorized over the chunks still walking at each step and run
    over groups of chunks (chunks are independent).  Returns (tuv [N_pad,
    3] f32, slot [N_pad] int32, stats [chunks, 3] int32 = blocks visited,
    clusters tested, ray-cluster candidate pairs)."""
    chunks = rows.shape[0] // RAYS_PER_CHUNK
    cnt = cnt.reshape(chunks)
    step = _PLAIN_GROUP.get(rows.device.type, _PLAIN_GROUP["cpu"])
    parts = [_plain_group(rows[c * RAYS_PER_CHUNK:(c + g) * RAYS_PER_CHUNK],
                          wl[c:c + g], went[c:c + g], cnt[c:c + g], blk_tris,
                          blk_boxes, occlusion)
             for c in range(0, chunks, step)
             for g in [min(step, chunks - c)]]
    return tuple(torch.cat(p) for p in zip(*parts))


def _plain_group(rows, wl, went, cnt, blk_tris, blk_boxes, occlusion: bool):
    dev = rows.device
    n_pad = rows.shape[0]
    chunks = n_pad // RAYS_PER_CHUNK
    wb = wl.shape[1]
    R = RAYS_PER_CHUNK
    o = rows[:, 0:3].reshape(chunks, R, 3)
    d = rows[:, 3:6].reshape(chunks, R, 3)
    t_min = rows[:, 6].reshape(chunks, R)
    tcur = rows[:, 7].reshape(chunks, R)
    valid = (rows[:, 8] > 0.5).reshape(chunks, R)
    inv = _safe_inv(d)
    oi = o * inv
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    big = torch.full((), _BIG, dtype=torch.float32, device=dev)
    lane = torch.arange(G, device=dev)

    tbest = tcur.clone()
    slot = torch.full((chunks, R), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros((chunks, R), dtype=torch.float32, device=dev)
    bv = torch.zeros((chunks, R), dtype=torch.float32, device=dev)
    stats = torch.zeros((chunks, 3), dtype=torch.int64, device=dev)
    cnt = cnt.long()

    def chunk_bound(tb, vl):
        if occlusion:
            return torch.where(torch.any(vl & (tb > 0.0), dim=1), 1.0, -_BIG)
        return torch.amax(torch.where(vl, tb, zero), dim=1)

    bound = chunk_bound(tcur, valid) if not occlusion else torch.where(
        torch.any(valid, dim=1), 1.0, -_BIG)
    walking = torch.ones(chunks, dtype=torch.bool, device=dev)
    for w in range(wb):
        more = (bound > 0.0) if occlusion else (went[:, w] < bound)
        walking = walking & (w < cnt) & more
        ci = torch.nonzero(walking)[:, 0]
        if ci.numel() == 0:
            break
        bid = wl[ci, w].long()
        a_o, a_inv, a_oi = o[ci], inv[ci], oi[ci]            # [A, R, 3]
        a_d = d[ci]
        a_tmin, a_valid = t_min[ci], valid[ci]               # [A, R]
        tb = tbest[ci]
        a_slot, a_u, a_v = slot[ci], bu[ci], bv[ci]
        boxes = blk_boxes[bid][:, :, :S]                     # [A, 6, S]
        tn = a_tmin[..., None].expand(-1, -1, S)
        tf = tb[..., None].expand(-1, -1, S)
        for c in range(3):
            t0 = boxes[:, None, c, :] * a_inv[..., c:c + 1] - a_oi[..., c:c + 1]
            t1 = (boxes[:, None, 3 + c, :] * a_inv[..., c:c + 1]
                  - a_oi[..., c:c + 1])
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        cand = (tn <= tf) & a_valid[..., None]               # [A, R, S]
        hot = torch.any(cand, dim=1)                         # [A, S]
        stats[ci, 0] += 1
        stats[ci, 1] += hot.sum(dim=1)
        stats[ci, 2] += cand.sum(dim=(1, 2))
        ox, oy, oz = (a_o[..., c:c + 1] for c in range(3))   # [A, R, 1]
        dx, dy, dz = (a_d[..., c:c + 1] for c in range(3))
        # each cluster is tested on the chunks where it is hot, in cluster
        # order (a chunk where it is not hot gets nothing from it): the
        # (cluster, chunk) pairs in one sort, split with one host read
        per_s = torch.sum(hot, dim=0).tolist()
        pairs = torch.nonzero(hot.t())[:, 1]
        for s, h in zip(range(S), torch.split(pairs, per_s)):
            if h.numel() == 0:
                continue
            p = blk_tris[bid[h], s * 9:(s + 1) * 9, :][:, :, None, :]
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = p.unbind(1)
            hx, hy, hz = dx[h], dy[h], dz[h]                 # [H, R, 1]
            px = hy * e2z - hz * e2y
            py = hz * e2x - hx * e2z
            pz = hx * e2y - hy * e2x
            det = e1x * px + e1y * py + e1z * pz
            okd = torch.abs(det) > _DET_EPS
            inv_det = torch.where(okd, 1.0 / det, zero)
            tx = ox[h] - v0x
            ty = oy[h] - v0y
            tz = oz[h] - v0z
            uu = (tx * px + ty * py + tz * pz) * inv_det
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            vv = (hx * qx + hy * qy + hz * qz) * inv_det
            tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            tb_h = tb[h]
            ok = (okd & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                  & (tt > a_tmin[h][..., None]) & (tt < tb_h[..., None])
                  & cand[h][..., s:s + 1])
            tt = torch.where(ok, tt, big)
            if occlusion:
                tb[h] = torch.where(torch.any(tt < _BIG, dim=-1), zero, tb_h)
                continue
            t_c = torch.amin(tt, dim=-1)
            # the first minimum lane, as the Pallas kernel picks it (:620)
            idx = torch.amin(torch.where(tt <= t_c[..., None], lane, G),
                             dim=-1)
            u_c = torch.gather(uu, -1, idx[..., None])[..., 0]
            v_c = torch.gather(vv, -1, idx[..., None])[..., 0]
            better = t_c < tb_h
            slot_c = (bid[h][:, None] * S + s) * G + idx
            tb[h] = torch.where(better, t_c, tb_h)
            a_slot[h] = torch.where(better, slot_c, a_slot[h])
            a_u[h] = torch.where(better, u_c, a_u[h])
            a_v[h] = torch.where(better, v_c, a_v[h])
        tbest[ci] = tb
        slot[ci], bu[ci], bv[ci] = a_slot, a_u, a_v
        bound = bound.clone()
        bound[ci] = chunk_bound(tb, a_valid)

    if occlusion:
        slot = torch.where(tbest <= 0.0, 1, -1)
    else:
        slot = torch.where(tbest < tcur, slot, -1)
    tuv = torch.stack([tbest, bu, bv], dim=-1).reshape(n_pad, 3)
    return (tuv, slot.reshape(n_pad).to(torch.int32),
            stats.to(torch.int32))


# -------------------------- the work of a call ---------------------------

# FP32 operations per Moller-Trumbore test and per ray x cluster-box slab
# test, counted from the plain version: adds, subtracts, multiplies, the
# one division and the slab's min/max; compares and selects are not counted
MT_OPS = 46
SLAB_OPS = 24


def stream_work(rows, wl, went, cnt, blk_tris, blk_boxes, stats) -> dict:
    """Bytes and FP32 operations one stream_closest / stream_any call
    needs, from its inputs and its per-chunk stats: the same numbers for
    any implementation that gives the same answers.

    Operations: every ray-cluster candidate pair (stats column 2) costs
    G Moller-Trumbore tests, and every valid ray costs S slab tests in
    each block its chunk visited (column 0).  Rays whose slab test
    rejected a cluster, and invalid lanes, need nothing.

    Bytes: what the function reads, once, and what it writes, once.  Of a
    row that is its 9 used floats (columns 9-15 are padding); of the
    worklists, the ``cnt`` entries of each chunk; of the accel, the
    smaller of the whole of it (its 32 real boxes a block) and one
    768-byte box set per visited block plus one 2,304-byte tile per
    tested cluster; and the outputs tuv, slot and stats."""
    n_pad = rows.shape[0]
    chunks = n_pad // RAYS_PER_CHUNK
    valid = (rows[:, 8] > 0.5).reshape(chunks, RAYS_PER_CHUNK).sum(dim=1)
    pairs = int(stats[:, 2].sum())
    ray_blocks = int((valid * stats[:, 0]).sum())
    blocks_visited = int(stats[:, 0].sum())
    clusters_tested = int(stats[:, 1].sum())
    tile, boxes = 9 * G * 4, 6 * S * 4
    accel = min(blk_tris.shape[0] * (S * tile + boxes),
                clusters_tested * tile + blocks_visited * boxes)
    nbytes = (n_pad * 9 * 4 + int(cnt.sum()) * (4 + 4) + chunks * 4 + accel
              + n_pad * (3 * 4 + 4) + chunks * 3 * 4)
    return dict(bytes=nbytes,
                fp32_ops=pairs * G * MT_OPS + ray_blocks * S * SLAB_OPS,
                pairs=pairs, ray_blocks=ray_blocks,
                blocks_visited=blocks_visited,
                clusters_tested=clusters_tested,
                valid_lanes=int(valid.sum()))


# H100 device-memory rate (NVIDIA data sheet), bytes per second
_HBM_SXM, _HBM_PCIE = 3.35e12, 2.0e12


def card_rates(name: str, sm_count: int, sm_clock_mhz: float):
    """(FP32 operations per second, device-memory bytes per second) of
    an H100: 128 lanes x 2 operations (one FMA) per SM and clock at the
    card's maximum SM clock, and the data sheet's memory rate."""
    return (sm_count * 128 * 2 * sm_clock_mhz * 1e6,
            _HBM_PCIE if "PCIe" in name else _HBM_SXM)


def bound_ms(work: dict, peak_flops: float, hbm: float) -> dict:
    """The least time a card could take for a call's work (``stream_work``):
    the larger of its bytes over the memory rate and its operations over
    the FP32 peak.  ``nofma_floor_ms`` is the operations at one per lane
    per clock, half the peak's two: what a build without FMA contraction
    can reach."""
    t_bytes = work["bytes"] / hbm * 1e3
    t_ops = work["fp32_ops"] / peak_flops * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bytes_ms=t_bytes, ops_ms=t_ops, nofma_floor_ms=2.0 * t_ops)


# ----------------------------- CUDA build --------------------------------

_SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc",
                    "stream_trace.cu")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v"]
_LIB = None
BUILD_INFO: dict = {}
# the C interface of csrc/stream_trace.cu: ctypes argument types by name
STREAM_SIGNATURES = {
    name: [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    for name in ("stream_closest", "stream_any")}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/*.cu at first use on a CUDA machine")


def build_library(src_path: str, extra=(), signatures=None):
    """Compile one CUDA source with nvcc for sm_90a (the package's flags
    plus ``extra``) into _build/, named after the source and keyed by the
    hash of source and flags so that an edit rebuilds, and load it with
    ctypes, binding ``signatures`` ({function: argtypes}, each returning
    an int error code; the stream kernels' by default).  Returns (library,
    info); info holds the path, the seconds the build took, nvcc's log and
    the flags."""
    flags = [*_NVCC_FLAGS, *extra]
    with open(src_path, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(os.path.basename(src_path))[0]
    so = os.path.join(_BUILD_DIR, f"lib{stem}_{key}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, src_path],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src_path}:\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in (signatures or STREAM_SIGNATURES).items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, dict(path=so, seconds=time.perf_counter() - t0, log=log,
                     flags=flags)


def kernel_resources(lib) -> dict:
    """What the CUDA runtime reports for each kernel of a built library:
    resident CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    registers per thread and static shared memory per CTA."""
    lib.stream_resources.argtypes = [ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]
    lib.stream_resources.restype = ctypes.c_int
    out = {}
    for name, occ in (("stream_closest", 0), ("stream_any", 1)):
        vals = (ctypes.c_int * 3)()
        err = lib.stream_resources(occ, vals)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} querying resources")
        out[name] = dict(ctas_per_sm=vals[0], registers=vals[1],
                         shared_bytes=vals[2])
    return out


def build_kernels():
    """Build csrc/stream_trace.cu and load it.  Called at the first
    launch; idempotent."""
    global _LIB
    if _LIB is None:
        lib, info = build_library(_SRC)
        BUILD_INFO.update(info, resources=kernel_resources(lib))
        _LIB = lib
    return _LIB


# ---------------------------- kernel wrappers ----------------------------


def _check(rows, wl, went, cnt, blk_tris, blk_boxes):
    n_pad = rows.shape[0]
    chunks = n_pad // RAYS_PER_CHUNK
    dev = rows.device
    wb = wl.shape[-1]
    want = [
        (rows, torch.float32, (n_pad, 16)),
        (wl, torch.int32, (chunks, wb)),
        (went, torch.float32, (chunks, wb)),
        (cnt, torch.int32, (chunks,)),
        (blk_tris, torch.float32, (blk_tris.shape[0], 9 * S, G)),
        (blk_boxes, torch.float32, (blk_tris.shape[0], 6, 128)),
    ]
    if n_pad % RAYS_PER_CHUNK:
        raise ValueError(f"rows: {n_pad} lanes is not a multiple of "
                         f"{RAYS_PER_CHUNK}")
    for t, dtype, shape in want:
        if t.device != dev:
            raise ValueError("stream kernel inputs must share one device")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"stream kernel input {tuple(t.shape)} "
                             f"{t.dtype}: expected {shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError("stream kernel inputs must be contiguous")
        if dev.type == "cuda" and t.data_ptr() % 16:
            raise ValueError("stream kernel inputs must be 16-byte aligned")


def _launch(name, rows, wl, went, cnt, blk_tris, blk_boxes, lib=None):
    """Launch kernel ``name`` of the package's library (or of ``lib``, a
    build of the same C interface) on PyTorch's current stream of the
    inputs' device, made the current device for the launch (a launch on
    another card's stream computes nothing valid)."""
    lib = lib or build_kernels()
    n_pad = rows.shape[0]
    chunks = n_pad // RAYS_PER_CHUNK
    dev = rows.device
    tuv = torch.empty((n_pad, 3), dtype=torch.float32, device=dev)
    slot = torch.empty((n_pad,), dtype=torch.int32, device=dev)
    stats = torch.empty((chunks, 3), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, name)(
            rows.data_ptr(), wl.data_ptr(), went.data_ptr(), cnt.data_ptr(),
            blk_tris.data_ptr(), blk_boxes.data_ptr(), tuv.data_ptr(),
            slot.data_ptr(), stats.data_ptr(), chunks, wl.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1
    return tuv, slot, stats


def stream_closest(rows, wl, went, cnt, blk_tris, blk_boxes):
    """Closest-hit stream kernel.  rows [N_pad, 16] f32 (o, d, t_min, t_max,
    valid, pad); wl / went [chunks, wb]; cnt [chunks] int32; blk_tris
    [B, 288, 64]; blk_boxes [B, 6, 128].  Returns (tuv [N_pad, 3], slot
    [N_pad] int32, -1 = none; stats [chunks, 3] int32).  CUDA tensors launch
    the kernel; CPU tensors run the plain version."""
    _check(rows, wl, went, cnt, blk_tris, blk_boxes)
    if rows.is_cuda:
        return _launch("stream_closest", rows, wl, went, cnt, blk_tris,
                       blk_boxes)
    return _stream_plain(rows, wl, went, cnt, blk_tris, blk_boxes, False)


def stream_any(rows, wl, went, cnt, blk_tris, blk_boxes):
    """Any-hit stream kernel; slot is 1 where occluded, -1 elsewhere (same
    layout as stream_closest)."""
    _check(rows, wl, went, cnt, blk_tris, blk_boxes)
    if rows.is_cuda:
        return _launch("stream_any", rows, wl, went, cnt, blk_tris,
                       blk_boxes)
    return _stream_plain(rows, wl, went, cnt, blk_tris, blk_boxes, True)


# ------------------------------- tracing --------------------------------


def prepare_stream(origins, dirs, accel: StreamAccel, t_min, t_max,
                   wb: int):
    """Pad to whole chunks and build the kernel inputs
    (stream_trace.py:731-761).  Padding lanes get dirs 1.0, t_max -1 and
    valid 0, so they never hit.  Returns (rows, wl, went, cnt)."""
    o = torch.stack(as_planes3(origins), dim=1).to(torch.float32)
    d = torch.stack(as_planes3(dirs), dim=1).to(torch.float32)
    n = o.shape[0]
    dev = o.device
    t_min = torch.as_tensor(t_min, dtype=torch.float32, device=dev).expand(n)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    n_pad = -(-n // RAYS_PER_CHUNK) * RAYS_PER_CHUNK
    pad = n_pad - n
    rows = torch.zeros((n_pad, 16), dtype=torch.float32, device=dev)
    rows[:n, 0:3] = o
    rows[:n, 3:6] = d
    rows[:n, 6] = t_min
    rows[:n, 7] = t_max
    rows[:n, 8] = 1.0
    if pad:
        rows[n:, 3:6] = 1.0
        rows[n:, 7] = -1.0
    # a worklist covering EVERY block never overflows (:752-756)
    wb_eff = max(wb, accel.num_blocks)
    wl, went, cnt = _build_worklists(rows[:, 0:3], rows[:, 3:6], rows[:, 6],
                                     rows[:, 7], accel, wb_eff)
    return rows, wl, went, cnt


def closest_hit_stream(origins, dirs, accel: StreamAccel, t_min=1e-4,
                       t_max=1e4, wb: int = 64) -> Hit:
    """Closest hit of [N] rays through the stream kernel
    (stream_trace.py:766-782).  origins/dirs: [N, 3] or planar tuples."""
    rows, wl, went, cnt = prepare_stream(origins, dirs, accel, t_min, t_max,
                                         wb)
    n = as_planes3(origins)[0].shape[0]
    tuv, slot, _ = stream_closest(rows, wl, went, cnt, accel.blk_tris,
                                  accel.blk_boxes)
    tuv, slot = tuv[:n], slot[:n].long()
    found = slot >= 0
    tri = torch.where(found, accel.perm[torch.clamp_min(slot, 0)].long(), 0)
    return Hit(t=torch.where(found, tuv[:, 0], INF), tri=tri, u=tuv[:, 1],
               v=tuv[:, 2])


def any_hit_stream(origins, dirs, accel: StreamAccel, t_min, t_max,
                   wb: int = 64) -> torch.Tensor:
    """Boolean occlusion through the stream kernel (stream_trace.py:785-796).
    Lanes with t_max <= t_min never read as occluded."""
    rows, wl, went, cnt = prepare_stream(origins, dirs, accel, t_min, t_max,
                                         wb)
    n = as_planes3(origins)[0].shape[0]
    _, slot, _ = stream_any(rows, wl, went, cnt, accel.blk_tris,
                            accel.blk_boxes)
    live = rows[:n, 7] > rows[:n, 6]
    return (slot[:n] >= 0) & live
