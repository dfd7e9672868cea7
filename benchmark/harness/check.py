"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference/``), as numbers each held to a
limit from ``limits/<workload>.json``.

Frames: the pixels of the seed's tiles, in the state the program left
after a frame (framebuffer and the records the next frame reads), against
the reference's frame from the same state.  A pixel is off when any of
its values differs beyond ``RTOL`` / ``ATOL`` (material ids exactly); the
number is the share of off pixels among the pixels that the reference's
camera ray hits (and the off ones), in %.  Pixels whose camera ray meets
two triangles at its hit (an edge or coincident faces: which of them
answers is not defined by the query) are left out.

Wavefronts: a seeded sample of every batch's rays, the program's answer
against the reference's: closest hit off when hit / miss or the position
(beyond ``POS_RTOL`` of the distance) differ, or, where no other triangle
ties the reference's hit (``trace.tie_count``), material, instance or
normal (beyond ``NORMAL_ATOL``); occlusion off when it differs.
"""

from __future__ import annotations

import torch

RTOL = 1e-4
ATOL = 1e-6
POS_RTOL = 1e-4
NORMAL_ATOL = 1e-3
MISS_ID_I32 = 4294967294 - (1 << 32)

# the per-pixel values compared: (state group, key) or a framebuffer field
FRAME_FIELDS = (("fb_accum", None), ("fb_count", None), ("l1", None),
                ("last_di", "w_sum"), ("last_di", "w"), ("last_di", "m"),
                ("last_di", "x2"), ("last_gi", "w_sum"), ("last_gi", "w"),
                ("last_gi", "m"), ("last_gi", "xn"), ("last_sdata", "x1"),
                ("last_sdata", "n1"))


def _close(a, b):
    a = a.float()
    b = b.float()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    near = torch.abs(a - b) <= RTOL * torch.abs(b) + ATOL
    ok = same | near
    return ok.reshape(ok.shape[0], -1).all(dim=1)


def program_pixels(state: dict, pix) -> dict:
    """The program's state (RestirRenderer's fields) at the pixels
    ``pix``, in the reference's ``frame_at`` layout."""
    return dict(
        fb_accum=state["fb"].accum[pix], fb_count=state["fb"].count[pix],
        l1=state["l1"][pix],
        last_di={k: v[pix] for k, v in state["last_di"].items()},
        last_gi={k: v[pix] for k, v in state["last_gi"].items()},
        last_sdata={k: v[pix] for k, v in state["last_sdata"].items()})


def frame_off_pct(ref: dict, prog: dict, tied) -> float:
    """``tied``: per pixel, whether its camera ray's hit is a tie."""
    ok = None
    for group, key in FRAME_FIELDS:
        a = prog[group] if key is None else prog[group][key]
        b = ref[group] if key is None else ref[group][key]
        c = _close(a.to(b.device), b)
        ok = c if ok is None else ok & c
    ok &= prog["last_sdata"]["mid"].to(ok.device) == ref["last_sdata"]["mid"]
    off = ~ok & ~tied
    counted = off | ((ref["last_sdata"]["mid"] != MISS_ID_I32) & ~tied)
    return 100.0 * float(off.sum()) / max(int(counted.sum()), 1)


def closest_off_pct(ref: dict, prog: dict, ties) -> float:
    """``ties``: per ray, the triangles hit within a tie of the
    reference's closest hit."""
    valid_r, valid_p = ref["valid"], prog["valid"]
    pos_gap = torch.amax(torch.abs(prog["pos"] - ref["pos"]), dim=-1)
    scale = 1.0 + torch.amax(torch.abs(ref["pos"]), dim=-1)
    nrm_gap = torch.amax(torch.abs(prog["normal"] - ref["normal"]), dim=-1)
    which = ((nrm_gap > NORMAL_ATOL) | (prog["mid"] != ref["mid"])
             | (prog["obj"] != ref["obj"]))
    off = (valid_r != valid_p) | (valid_r & (
        (pos_gap > POS_RTOL * scale) | (which & (ties <= 1))))
    return 100.0 * float(off.float().mean())


def any_off_pct(ref, prog) -> float:
    return 100.0 * float((ref != prog).float().mean())


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {value, limit}}): every number within its limit
    and every limit read."""
    out = {}
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        out[name] = {"value": v, "limit": limit}
        if v is None or not v <= limit:
            ok = False
    return ok, out
