"""Camera matrices and primary rays: a frozen copy of the port's
``camera.py`` (``look_at``, ``perspective_rh``, ``Camera.matrices``,
``generate_rays``) as the benchmark's plain reference; the orbit and
manipulator helpers are left out.
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

    def basis(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(right, up, forward) world-space camera basis (camera.py:80-90)."""
        eye = np.asarray(self.eye, np.float32)
        center = np.asarray(self.center, np.float32)
        up = np.asarray(self.up, np.float32)
        f = center - eye
        f = f / np.linalg.norm(f)
        s = np.cross(f, up)
        s = s / np.linalg.norm(s)
        u = np.cross(s, f)
        return s, u, f

    def matrices(self, aspect: float) -> dict[str, np.ndarray]:
        v = self.view()
        p = self.proj(aspect)
        return {
            "view": v,
            "proj": p,
            "view_inv": np.linalg.inv(v),
            "proj_inv": np.linalg.inv(p),
        }


def generate_rays(camera_arrays: dict, width: int, height: int,
                  jitter: torch.Tensor | None = None,
                  xs: torch.Tensor | None = None,
                  ys: torch.Tensor | None = None):
    """Primary rays, flattened row-major (camera.py:195-244,
    RayGen_v6_pass1.hlsl:79-95): through the pixel corners, or with
    ``jitter`` [N, 2] in [0, 1) added (the megakernel's antialiasing).

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
    if jitter is not None:
        pix = pix + jitter
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
