"""Device selection for the port's entry points.

The card is the default: ``device=None`` means ``cuda``.  Without a GPU the
caller must ask for the CPU explicitly (``device="cpu"``, as the tests do);
an implicit request raises instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no GPU is visible); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "royaltracer_dx_tpu_torch runs on the GPU by default and no "
                "CUDA device is visible; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but no CUDA device is "
                           "visible")
    return dev
