"""Image-comparison metrics for the RMSE harness (port of
royaltracer_dx_tpu/utils/metrics.py, host numpy)."""

from __future__ import annotations

import numpy as np


def rmse(img: np.ndarray, ref: np.ndarray) -> float:
    """Root-mean-square error over all pixels and channels."""
    img = np.asarray(img, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((img - ref) ** 2)))


def rel_mean(img: np.ndarray, ref: np.ndarray) -> float:
    """Energy ratio: mean(img) / mean(ref)."""
    return float(np.asarray(img).mean() / max(np.asarray(ref).mean(), 1e-12))


def rmse_report(img: np.ndarray, ref: np.ndarray) -> dict:
    d = np.abs(np.asarray(img) - np.asarray(ref)).max(axis=-1)
    return dict(
        rmse=rmse(img, ref),
        rel_mean=rel_mean(img, ref),
        p95_abs_diff=float(np.percentile(d, 95)),
        max_abs_diff=float(d.max()),
    )
