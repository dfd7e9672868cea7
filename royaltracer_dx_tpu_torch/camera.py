"""Camera: view/projection matrices and primary-ray generation (port of
royaltracer_dx_tpu/camera.py:26-246).

``look_at`` / ``perspective_rh`` / ``Camera`` are host numpy, as in the JAX
package; ``generate_rays`` runs on the tensors' device.  The interactive
``Manipulator`` (camera.py:264) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def look_at(eye, center, up) -> np.ndarray:
    """glm::lookAtRH as a 4x4 column-vector-convention matrix
    (camera.py:26-43)."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def perspective_rh(fov_y_rad: float, aspect: float, z_near: float,
                   z_far: float) -> np.ndarray:
    """XMMatrixPerspectiveFovRH in column-vector convention
    (camera.py:46-60)."""
    y_scale = 1.0 / math.tan(fov_y_rad / 2.0)
    x_scale = y_scale / aspect
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = x_scale
    m[1, 1] = y_scale
    m[2, 2] = z_far / (z_near - z_far)
    m[2, 3] = z_near * z_far / (z_near - z_far)
    m[3, 2] = -1.0
    return m


def _rotate_axis(v: np.ndarray, axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    c, s = math.cos(angle), math.sin(angle)
    return v * c + np.cross(axis, v) * s + axis * np.dot(axis, v) * (1.0 - c)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera with the reference's defaults (camera.py:63-100)."""

    eye: tuple[float, float, float] = (-1.5, 1.5, 3.5)
    center: tuple[float, float, float] = (0.0, 1.0, 0.0)
    up: tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov_y_deg: float = 60.0
    z_near: float = 0.1
    z_far: float = 1000.0

    def view(self) -> np.ndarray:
        return look_at(self.eye, self.center, self.up)

    def proj(self, aspect: float) -> np.ndarray:
        return perspective_rh(math.radians(self.fov_y_deg), aspect,
                              self.z_near, self.z_far)

    def matrices(self, aspect: float) -> dict[str, np.ndarray]:
        v = self.view()
        p = self.proj(aspect)
        return {
            "view": v,
            "proj": p,
            "view_inv": np.linalg.inv(v),
            "proj_inv": np.linalg.inv(p),
        }

    def orbited(self, dx: float, dy: float) -> "Camera":
        """Orbit eye around center (camera.py:104-126)."""
        eye = np.asarray(self.eye, np.float64)
        center = np.asarray(self.center, np.float64)
        up = np.asarray(self.up, np.float64)
        offset = eye - center
        phi = -dx * 2.0 * math.pi
        theta = -dy * 2.0 * math.pi
        offset = _rotate_axis(offset, up, phi)
        f = -offset / np.linalg.norm(offset)
        right = np.cross(f, up)
        rn = np.linalg.norm(right)
        if rn > 1e-8:
            right = right / rn
            cand = _rotate_axis(offset, right, theta)
            cf = -cand / np.linalg.norm(cand)
            if abs(np.dot(cf, up / np.linalg.norm(up))) < 0.99:
                offset = cand
        return dataclasses.replace(
            self, eye=tuple((center + offset).astype(np.float32)))


def generate_rays(camera_arrays: dict, width: int, height: int,
                  xs: torch.Tensor | None = None,
                  ys: torch.Tensor | None = None):
    """Primary rays, flattened row-major (camera.py:195-244,
    RayGen_v6_pass1.hlsl:79-95; v6 uses pixel corners, no jitter).

    camera_arrays: 'view_inv' / 'proj_inv' [4, 4] float32 tensors; the rays
    live on their device.  Returns (origins [N, 3], directions [N, 3])."""
    view_inv = camera_arrays["view_inv"]
    proj_inv = camera_arrays["proj_inv"]
    dev = view_inv.device
    if xs is None:
        ys, xs = torch.meshgrid(
            torch.arange(height, dtype=torch.float32, device=dev),
            torch.arange(width, dtype=torch.float32, device=dev),
            indexing="ij")
        xs, ys = xs.reshape(-1), ys.reshape(-1)
    pix = torch.stack([xs.to(torch.float32), ys.to(torch.float32)], dim=-1)
    dims = torch.tensor([width, height], dtype=torch.float32, device=dev)
    d = (pix / dims) * 2.0 - 1.0
    one = torch.ones_like(d[:, 0])
    ndc = torch.stack([d[:, 0], -d[:, 1], one, one], dim=-1)
    # explicit fp32 broadcasts, as in the JAX package
    target = torch.sum(ndc[:, None, :] * proj_inv[None, :, :], dim=-1)
    dirs_view = target[:, :3]
    dirs_world = torch.sum(dirs_view[:, None, :] * view_inv[None, :3, :3],
                           dim=-1)
    dirs_world = dirs_world * torch.rsqrt(torch.clamp_min(
        torch.sum(dirs_world * dirs_world, dim=-1, keepdim=True), 1e-20))
    origins = view_inv[:3, 3].expand(dirs_world.shape)
    return origins, dirs_world
