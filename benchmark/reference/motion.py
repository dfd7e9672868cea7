"""The reference's moving scene: the motion a configuration's ``motion``
block states (one instance turned about the vertical axis through a
pivot by ``amplitude_deg`` x sin(2 pi k / ``period_frames``) at frame k),
and the scene baked at frame k's pose with frame k - 1's pose as the
previous transform, which the frozen passes reproject through.  Plain
numpy and PyTorch in float32; nothing of the program is imported.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from reference import scene as rscene


def angle_deg(k: int, motion: dict) -> float:
    """The moving instance's turn at frame ``k``, in degrees."""
    return float(motion["amplitude_deg"]) * math.sin(
        2.0 * math.pi * int(k) / int(motion["period_frames"]))


def pose(k: int, motion: dict) -> np.ndarray:
    """The moving instance's 4x4 float32 object-to-world transform at
    frame ``k``: a turn by ``angle_deg(k)`` about the y axis through
    ``motion["pivot"]``, composed in float64; + 0.0 turns the negative
    zeros into positive ones, so frame 0 is the identity bit for bit."""
    th = math.radians(angle_deg(k, motion))
    c, s = math.cos(th), math.sin(th)
    rot = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    pivot = np.asarray(motion["pivot"], np.float64)
    m = np.eye(4)
    m[:3, :3] = rot
    m[:3, 3] = pivot - rot @ pivot
    return (m + 0.0).astype(np.float32)


def posed(scene: rscene.SceneInput, instance: int,
          transform) -> rscene.SceneInput:
    """A copy of ``scene`` whose instance ``instance`` has ``transform``
    (meshes and materials shared)."""
    inst = list(scene.instances)
    inst[instance] = (inst[instance][0], np.asarray(transform, np.float32))
    return dataclasses.replace(scene, instances=inst)


def bake_at(scene: rscene.SceneInput, motion: dict, k: int,
            device) -> rscene.SceneArrays:
    """``scene`` baked at frame ``k``'s pose, its previous transforms
    those of frame k - 1 (frame 0: the rest pose for both)."""
    i = int(motion["instance"])
    cur = rscene.bake(posed(scene, i, pose(k, motion)), device)
    prev = cur.object_to_world.clone()
    prev[i] = torch.as_tensor(pose(max(int(k) - 1, 0), motion),
                              device=prev.device)
    return dataclasses.replace(cur, prev_object_to_world=prev)
