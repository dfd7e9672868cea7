"""Render configuration (port of royaltracer_dx_tpu/config.py:1-158).

Field names and defaults are identical to the JAX package's
``RenderConfig`` (equality-tested), so a configuration crosses between the
two packages unchanged.
"""

from __future__ import annotations

import dataclasses

# The reference defines PI as 3.1415f (config.py:13-16).
REF_PI = 3.1415

# Shadow-ray bias and float epsilon (config.py:18-21).
S_BIAS = 2.0e-5
EPSILON = 1.0e-6

# auto traversal threshold (config.py:23-28): the JAX package's dispatch
# sends scenes below this many triangles to brute force.  The port takes
# the same decisions on every device (ops/restir.py ``trace_mode``).
STREAM_AUTO_MIN_TRIS = 1500

LUT_SIZE_THETA = 16

# Sentinel materialID written by the miss shader (config.py:32-34).
MISS_MATERIAL_ID = 4294967294


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Tunable render parameters (config.py:37-158; defaults = the
    reference's).  Comments on each knob live in the JAX package."""

    width: int = 1920
    height: int = 1080

    max_bounces: int = 8
    rr_threshold: int = 3
    samples_per_pixel: int = 1
    ris_m: int = 10

    nee_samples: int = 4
    nee_samples_di: int = 4
    bsdf_samples_di: int = 1
    gi_bounces: int = 3
    gi_rr_threshold: int = 1
    spatial_candidate_count: int = 3
    spatial_max_tries: int = 9
    spatial_radius: int = 20
    spatial_exponent: float = 1.0
    spatial_m_cap: int = 128
    spatial_m_cap_gi: int = 128
    temporal_m_cap: int = 16
    retire_dead_lanes: bool = True
    temporal_m_cap_gi: int = 16
    temporal_r_threshold: float = 0.09
    w_sum_threshold: float = 5.0
    j_threshold: float = 5.0
    exposure: float = 1.0

    max_accum_frames: int = 2_000_000

    aa_jitter: bool = True

    # "auto" | "brute" | "stream" | "bvh" | "cluster" (ops/restir.py)
    traversal: str = "auto"
    stream_wb: int = 16
    # GI wavefront compaction: "on" | "off" | "auto" ("auto" turns it on
    # for scenes of more than 128 clusters, restir.py:115-127).
    gi_compaction: str = "auto"
    # traversal "cluster": triangles a cluster and rays a tile (1-1024 on
    # the card, ops/cluster_traverse.py)
    cluster_group: int = 128
    cluster_tile: int = 128
    use_bvh: bool = False
    bvh_leaf_size: int = 4

    @property
    def accel(self) -> str:
        """Effective traversal mode (config.py:113-116)."""
        return "bvh" if self.use_bvh else self.traversal

    s_bias: float = S_BIAS
    epsilon: float = EPSILON

    reference_mis_quirk: bool = True
    temporal_reuse: bool = True
    seed_mode: str = "frame"
    # Payload record storage: "f32" | "f16" | "bf16" (compute stays f32);
    # pass 3's f16 ACCEPT tables ship at every record_dtype, as in JAX.
    record_dtype: str = "f32"

    @property
    def num_pixels(self) -> int:
        return self.width * self.height
