"""Checkpoint/resume of the progressive render state (port of
royaltracer_dx_tpu/io/checkpoint.py).

The state is the ``RestirRenderer.state_dict`` arrays, saved as one npz
under the JAX package's key names (format, frame, prev_view, prev_proj,
fb.accum, fb.count, l1, last_di.*, last_gi.*, last_sdata.*), so a
checkpoint crosses between the two packages in either direction.  The
megakernel and sharded-ReSTIR formats belong to renderers the port does
not have yet; loading them raises a ValueError that names them.
"""

from __future__ import annotations

import numpy as np

_UNPORTED = {"megakernel": "the megakernel oracle (ROADMAP A'6)",
             "sharded_restir": "the sharded ReSTIR renderer (ROADMAP A'9)"}


def _format_of_npz(data) -> str:
    if "format" in data:
        return str(data["format"])
    if "packed_di" in data or "packed_di.0" in data:
        return "sharded_restir"
    return "restir" if "last_di.x2" in data else "megakernel"


def save_renderer_state(path: str, renderer) -> None:
    """Save a RestirRenderer's progressive state as a compressed npz."""
    np.savez_compressed(path, **renderer.state_dict())


def load_renderer_state(path: str, renderer) -> None:
    """Restore a state saved by either package's ``save_renderer_state``
    into a RestirRenderer of the same resolution.  Raises ValueError on a
    format or resolution mismatch instead of restoring part of a state."""
    with np.load(path) as data:
        have = _format_of_npz(data)
        if have in _UNPORTED:
            raise ValueError(
                f"checkpoint format {have!r} is not ported: it needs "
                f"{_UNPORTED[have]}; this package restores 'restir' states")
        if have != "restir":
            raise ValueError(f"unknown checkpoint format {have!r}")
        fb_n = int(data["fb.accum"].shape[0])
        if fb_n != renderer.cfg.num_pixels:
            raise ValueError(
                f"checkpoint resolution ({fb_n} pixels) does not match the "
                f"renderer ({renderer.cfg.num_pixels})")
        renderer.load_state({k: data[k] for k in data.files})
