"""Checkpoint/resume of the progressive render state (port of
royaltracer_dx_tpu/io/checkpoint.py).

The state is the renderer's ``state_dict`` arrays, saved as one npz under
the JAX package's key names, so a checkpoint crosses between the two
packages in either direction:

  restir          format, frame, prev_view, prev_proj, fb.accum,
                  fb.count, l1, last_di.*, last_gi.*, last_sdata.*
                  (``RestirRenderer``)
  sharded_restir  format, frame, prev_view, prev_proj, fb.accum,
                  fb.count, l1, packed_di.{0,1,2}, packed_gi.{0,1,2}, as
                  global [N, ...] arrays (``ShardedRestirRenderer``; the
                  legacy monolithic [N, 26] packed_di / packed_gi tables
                  load too)
  megakernel      format, frame, prev_view, fb.accum, fb.count
                  (``Renderer``)
"""

from __future__ import annotations

import numpy as np


def _format_of(renderer) -> str:
    """The format a renderer saves and restores (checkpoint.py:28-33)."""
    if hasattr(renderer, "bands"):
        return "sharded_restir"
    return "restir" if hasattr(renderer, "last_di") else "megakernel"


def _format_of_npz(data) -> str:
    if "format" in data:
        return str(data["format"])
    if "packed_di" in data or "packed_di.0" in data:
        return "sharded_restir"
    return "restir" if "last_di.x2" in data else "megakernel"


def save_renderer_state(path: str, renderer) -> None:
    """Save a Renderer's, RestirRenderer's or ShardedRestirRenderer's
    progressive state as a compressed npz."""
    np.savez_compressed(path, **renderer.state_dict())


def load_renderer_state(path: str, renderer) -> None:
    """Restore a state saved by either package's ``save_renderer_state``
    into a renderer of the same format and resolution.  Raises ValueError
    on a format or resolution mismatch instead of restoring part of a
    state."""
    with np.load(path) as data:
        have = _format_of_npz(data)
        want = _format_of(renderer)
        if have != want:
            raise ValueError(
                f"checkpoint format {have!r} does not match renderer "
                f"{type(renderer).__name__} (expects {want!r})")
        fb_n = int(data["fb.accum"].shape[0])
        if fb_n != renderer.cfg.num_pixels:
            raise ValueError(
                f"checkpoint resolution ({fb_n} pixels) does not match the "
                f"renderer ({renderer.cfg.num_pixels})")
        renderer.load_state({k: data[k] for k in data.files})
