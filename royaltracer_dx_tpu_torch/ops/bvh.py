"""LBVH: a Morton-ordered complete-tree BVH, built and refit on the device
(port of royaltracer_dx_tpu/ops/bvh.py).

Build: Morton-code the triangle centroids, sort them (stably, as
``jnp.argsort`` does), group ``leaf_size`` consecutive triangles per leaf
and reduce the AABBs up a complete binary tree.  Refit re-runs the
reduction over moved vertices in the build's order.  The topology depends
only on the padded leaf count, so the traversal (ops/traverse.py) computes
its child and skip links analytically; ``dfs_links`` tabulates the same
links in numpy for the tests.

``nodes``, ``sorted_tris`` and ``perm`` equal the JAX package's bit for
bit.  Torch's CPU uint32 has no shifts, so the Morton codes are computed
in int64 masked to 32 bits.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

INF = 1e30
_MASK32 = 0xFFFFFFFF


# ----------------------------- morton codes -----------------------------


def _expand_bits_10(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd bit (bvh.py:42-48), int64 holding
    uint32 values."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(points: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) of points normalized into [lo, hi]
    (bvh.py:51-61)."""
    extent = torch.clamp_min(hi - lo, 1e-12)
    q = torch.clamp((points - lo) / extent, 0.0, 0.99999994)
    q = torch.clamp_max((q * 1024.0).to(torch.int64), 1023)
    return ((_expand_bits_10(q[..., 0]) << 2)
            | (_expand_bits_10(q[..., 1]) << 1)
            | _expand_bits_10(q[..., 2])) & _MASK32


# ------------------------- static DFS skip links ------------------------


@functools.lru_cache(maxsize=32)
def dfs_links(num_leaves_pow2: int, leaf_base: int) -> tuple[np.ndarray,
                                                              np.ndarray]:
    """(hit_link, skip_link) int32 tables of the heap-indexed complete
    tree of ``num_leaves_pow2`` leaves (bvh.py:67-98): node k has children
    2k, 2k+1; skip(k) climbs while k is a right child, then steps to the
    sibling (0 = done); hit(k) descends for internal nodes and equals
    skip(k) for leaves."""
    p = num_leaves_pow2
    total = 2 * p
    k = np.arange(total, dtype=np.int64)
    tmp = np.where(k > 0, k, 1)
    trailing_ones = np.zeros(total, dtype=np.int64)
    for _ in range(int(np.log2(max(p, 2))) + 2):
        is_odd = (tmp & 1) == 1
        trailing_ones += is_odd
        tmp = np.where(is_odd, tmp >> 1, tmp)
    anc = k >> np.minimum(trailing_ones, 62)
    skip = np.where(anc <= 1, 0, anc + 1)
    hit = np.where(k < p, 2 * k, skip)
    skip[0] = 0
    hit[0] = 0
    return hit.astype(np.int32), skip.astype(np.int32)


# ------------------------------ structure -------------------------------


@dataclasses.dataclass
class LBVH:
    """Complete-tree LBVH over Morton-sorted triangles (bvh.py:104-135).

    Heap node k in [1, 2P) stores its AABB as one 6-float row (min_xyz |
    max_xyz); leaves are nodes [P, 2P), leaf j holding sorted_tris[j*ls :
    (j+1)*ls] (padding slots sit at +1e30 and never intersect); ``perm``
    maps a sorted slot to its original triangle id, -1 for padding."""

    nodes: torch.Tensor        # [2P, 6] f32
    sorted_tris: torch.Tensor  # [P*ls, 3, 3] f32
    perm: torch.Tensor         # [P*ls] int32

    @property
    def num_leaves(self) -> int:
        return self.nodes.shape[0] // 2

    @property
    def leaf_size(self) -> int:
        return self.sorted_tris.shape[0] // self.num_leaves

    @property
    def device(self) -> torch.device:
        return self.nodes.device


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _reduce_levels(leaf_min: torch.Tensor,
                   leaf_max: torch.Tensor) -> torch.Tensor:
    """Bottom-up pairwise AABB reduction into the heap rows [2P, 6]
    (bvh.py:145-164); row 0 stays (INF | -INF)."""
    p = leaf_min.shape[0]
    nodes = torch.cat([torch.full((2 * p, 3), INF, dtype=leaf_min.dtype,
                                  device=leaf_min.device),
                       torch.full((2 * p, 3), -INF, dtype=leaf_min.dtype,
                                  device=leaf_min.device)], dim=1)
    mn, mx, base = leaf_min, leaf_max, p
    while True:
        nodes[base:2 * base] = torch.cat([mn, mx], dim=1)
        if base == 1:
            return nodes
        mn = torch.amin(mn.reshape(-1, 2, 3), dim=1)
        mx = torch.amax(mx.reshape(-1, 2, 3), dim=1)
        base //= 2


def _leaf_boxes(sorted_tris: torch.Tensor, real: torch.Tensor, p: int,
                ls: int):
    smin = torch.where(real[:, None], torch.amin(sorted_tris, dim=1), INF)
    smax = torch.where(real[:, None], torch.amax(sorted_tris, dim=1), -INF)
    return (torch.amin(smin.reshape(p, ls, 3), dim=1),
            torch.amax(smax.reshape(p, ls, 3), dim=1))


def _build_device(tri_verts: torch.Tensor, leaf_size: int, num_tris: int):
    """Morton sort + reduction over triangles already padded to P*ls with
    +INF triangles (bvh.py:167-197)."""
    slots = tri_verts.shape[0]
    p = slots // leaf_size
    tmin = torch.amin(tri_verts, dim=1)
    tmax = torch.amax(tri_verts, dim=1)
    centroid = 0.5 * (tmin + tmax)
    real = torch.arange(slots, device=tri_verts.device) < num_tris
    lo = torch.amin(torch.where(real[:, None], centroid, INF), dim=0)
    hi = torch.amax(torch.where(real[:, None], centroid, -INF), dim=0)
    codes = morton_codes(centroid, lo, hi)
    # padding sorts last whatever its coordinates
    codes = torch.where(real, codes, _MASK32)
    order = torch.argsort(codes, stable=True)
    sorted_tris = tri_verts[order]
    perm = torch.where(real[order], order, -1).to(torch.int32)
    leaf_min, leaf_max = _leaf_boxes(sorted_tris, perm >= 0, p, leaf_size)
    return _reduce_levels(leaf_min, leaf_max), sorted_tris, perm


def build_lbvh(tri_verts: torch.Tensor, leaf_size: int = 4) -> LBVH:
    """Build an LBVH over [T, 3, 3] triangles on their device
    (bvh.py:200-211)."""
    t = tri_verts.shape[0]
    p = _next_pow2(max(1, -(-t // leaf_size)))
    pad = p * leaf_size - t
    tv = tri_verts.to(torch.float32)
    if pad:
        tv = torch.cat([tv, torch.full((pad, 3, 3), INF, dtype=tv.dtype,
                                       device=tv.device)])
    nodes, sorted_tris, perm = _build_device(tv, leaf_size, t)
    return LBVH(nodes=nodes.contiguous(), sorted_tris=sorted_tris.contiguous(),
                perm=perm.contiguous())


def refit_lbvh(bvh: LBVH, tri_verts_new: torch.Tensor) -> LBVH:
    """Refit with moved vertices ([T, 3, 3] in the ORIGINAL triangle
    order), keeping order and topology (bvh.py:214-232)."""
    real = bvh.perm >= 0
    gathered = tri_verts_new[torch.clamp_min(bvh.perm, 0).long()]
    sorted_tris = torch.where(real[:, None, None], gathered, INF)
    p, ls = bvh.num_leaves, bvh.leaf_size
    leaf_min, leaf_max = _leaf_boxes(sorted_tris, real, p, ls)
    return LBVH(nodes=_reduce_levels(leaf_min, leaf_max),
                sorted_tris=sorted_tris.contiguous(), perm=bvh.perm)
