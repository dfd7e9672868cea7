"""Camera: view/projection matrices and primary-ray generation (port of
royaltracer_dx_tpu/camera.py:26-246).

``look_at`` / ``perspective_rh`` / ``Camera`` / ``Manipulator`` are host
numpy, as in the JAX package; ``generate_rays`` runs on the tensors'
device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from royaltracer_dx_tpu_torch.utils import telemetry


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

    def dollied(self, factor: float) -> "Camera":
        """Move eye toward/away from center (camera.py:128-134)."""
        eye = np.asarray(self.eye, np.float64)
        center = np.asarray(self.center, np.float64)
        return dataclasses.replace(
            self,
            eye=tuple((center + (eye - center) * factor).astype(np.float32)))

    def panned(self, dx: float, dy: float) -> "Camera":
        """Translate eye+center along the image plane (camera.py:136-147)."""
        right, u, _ = self.basis()
        eye = np.asarray(self.eye, np.float64)
        center = np.asarray(self.center, np.float64)
        d = np.linalg.norm(eye - center)
        delta = (-dx * right + dy * u) * d
        return dataclasses.replace(
            self,
            eye=tuple((eye + delta).astype(np.float32)),
            center=tuple((center + delta).astype(np.float32)))

    def flown(self, forward: float, strafe: float = 0.0,
              lift: float = 0.0) -> "Camera":
        """Fly mode: translate eye and center along the camera basis, the
        look direction kept (camera.py:149-159)."""
        right, u, f = self.basis()
        delta = forward * f + strafe * right + lift * u
        eye = np.asarray(self.eye, np.float64) + delta
        center = np.asarray(self.center, np.float64) + delta
        return dataclasses.replace(
            self, eye=tuple(eye.astype(np.float32)),
            center=tuple(center.astype(np.float32)))

    def walked(self, forward: float, strafe: float = 0.0) -> "Camera":
        """Walk mode: fly with the world-up component of the motion dropped
        (camera.py:161-177)."""
        right, _, f = self.basis()
        up = np.asarray(self.up, np.float64)
        up = up / np.linalg.norm(up)

        def flatten(v):
            v = v - np.dot(v, up) * up
            n = np.linalg.norm(v)
            return v / n if n > 1e-9 else v

        delta = forward * flatten(f) + strafe * flatten(right)
        eye = np.asarray(self.eye, np.float64) + delta
        center = np.asarray(self.center, np.float64) + delta
        return dataclasses.replace(
            self, eye=tuple(eye.astype(np.float32)),
            center=tuple(center.astype(np.float32)))

    def looked(self, dx: float, dy: float) -> "Camera":
        """Rotate the look direction around the eye (camera.py:179-192)."""
        right, _, _ = self.basis()
        eye = np.asarray(self.eye, np.float64)
        center = np.asarray(self.center, np.float64)
        offset = center - eye
        offset = _rotate_axis(offset, np.asarray(self.up, np.float64),
                              -dx * 2.0 * math.pi)
        offset2 = _rotate_axis(offset, right, -dy * 2.0 * math.pi)
        nf = offset2 / np.linalg.norm(offset2)
        if abs(np.dot(nf, np.asarray(self.up) / np.linalg.norm(self.up))) \
                < 0.99:
            offset = offset2
        return dataclasses.replace(
            self, center=tuple((eye + offset).astype(np.float32)))


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
    dims = telemetry.to_device("camera_dims", [width, height], dev,
                               torch.float32)
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


# ----------------------- interactive manipulator -------------------------
#
# camera.py:253-460: rdn/manipulator.{h,cpp} (nv_helpers_dx12::Manipulator)
# with its four modes, its mouse-mode state machine and its orbit / pan /
# dolly / trackball math, quirks included: the orbit pole guard keyed on
# sign(x) (manipulator.cpp:381-383) and the trackball axis transformed by
# the VIEW matrix rather than its inverse (manipulator.cpp:270).


class Manipulator:
    """Stateful camera manipulator (camera.py:264-460).  Drive it with
    ``mouse_move(x, y, lmb=..., ...)`` and read ``camera`` or ``matrix()``
    (the glm::lookAt view matrix)."""

    EXAMINE, FLY, WALK, TRACKBALL = "examine", "fly", "walk", "trackball"
    NONE, ORBIT, DOLLY, PAN, LOOKAROUND = (
        "none", "orbit", "dolly", "pan", "lookaround")

    def __init__(self, camera: Camera | None = None, width: int = 1920,
                 height: int = 1080):
        cam = camera or Camera()
        self.pos = np.asarray(cam.eye, np.float64)
        self.int = np.asarray(cam.center, np.float64)
        self.up = np.asarray(cam.up, np.float64)
        self.width = int(width)
        self.height = int(height)
        self.mode = self.EXAMINE
        self.speed = 30.0          # m_speed (manipulator.h:137)
        self.tbsize = 0.8          # m_tbsize (manipulator.h:142)
        self.mouse = np.zeros(2, np.float64)

    @property
    def camera(self) -> Camera:
        return Camera(eye=tuple(np.float32(self.pos)),
                      center=tuple(np.float32(self.int)),
                      up=tuple(np.float32(self.up)))

    def matrix(self) -> np.ndarray:
        """m_matrix = glm::lookAt(pos, int, up) (manipulator.cpp:303)."""
        return look_at(self.pos, self.int, self.up)

    def set_lookat(self, eye, center, up) -> None:
        self.pos = np.asarray(eye, np.float64)
        self.int = np.asarray(center, np.float64)
        self.up = np.asarray(up, np.float64)

    def set_mouse_position(self, x: float, y: float) -> None:
        self.mouse[:] = (x, y)

    def set_window_size(self, w: int, h: int) -> None:
        self.width, self.height = int(w), int(h)

    def mouse_move(self, x: float, y: float, *, lmb=False, mmb=False,
                   rmb=False, shift=False, ctrl=False, alt=False) -> str:
        """Button/modifier -> action (manipulator.cpp:176-197); returns the
        action taken."""
        action = self.NONE
        if lmb:
            if (ctrl and shift) or alt:
                action = (self.LOOKAROUND if self.mode == self.EXAMINE
                          else self.ORBIT)
            elif shift:
                action = self.DOLLY
            elif ctrl:
                action = self.PAN
            else:
                action = (self.ORBIT if self.mode == self.EXAMINE
                          else self.LOOKAROUND)
        elif mmb:
            action = self.PAN
        elif rmb:
            action = self.DOLLY
        if action != self.NONE:
            self._motion(x, y, action)
        return action

    def wheel(self, value: int) -> None:
        """Dolly by value*|value|/width (manipulator.cpp:200-211)."""
        fval = float(value)
        dx = (fval * abs(fval)) / float(self.width)
        self._dolly(dx * self.speed, dx * self.speed)

    def _motion(self, x: float, y: float, action: str) -> None:
        dx = (x - self.mouse[0]) / self.width
        dy = (y - self.mouse[1]) / self.height
        if action == self.ORBIT:
            self._orbit(dx, dy, invert=self.mode == self.TRACKBALL)
        elif action == self.DOLLY:
            self._dolly(dx, dy)
        elif action == self.PAN:
            self._pan(dx, dy)
        elif action == self.LOOKAROUND:
            if self.mode == self.TRACKBALL:
                self._trackball(x, y)
            else:
                self._orbit(dx, -dy, invert=True)
        self.mouse[:] = (x, y)

    def _orbit(self, dx: float, dy: float, invert: bool) -> None:
        """manipulator.cpp:345-399, with the sign(x) pole guard."""
        if abs(dx) < 1e-12 and abs(dy) < 1e-12:
            return
        dx *= 2.0 * math.pi
        dy *= 2.0 * math.pi
        origin = self.pos if invert else self.int
        position = self.int if invert else self.pos
        center_to_eye = position - origin
        radius = np.linalg.norm(center_to_eye)
        center_to_eye = center_to_eye / radius
        axe_z = center_to_eye
        center_to_eye = _rotate_axis(center_to_eye, self.up, dx)
        axe_x = np.cross(self.up, axe_z)
        axe_x = axe_x / np.linalg.norm(axe_x)
        vect_rot = _rotate_axis(center_to_eye, axe_x, dy)
        if np.sign(vect_rot[0]) == np.sign(center_to_eye[0]):
            center_to_eye = vect_rot
        new_position = center_to_eye * radius + origin
        if invert:
            self.int = new_position
        else:
            self.pos = new_position

    def _pan(self, dx: float, dy: float) -> None:
        """manipulator.cpp:319-339."""
        if self.mode == self.FLY:
            dx, dy = -dx, -dy
        z = self.pos - self.int
        length = np.linalg.norm(z) / 0.785
        z = z / np.linalg.norm(z)
        x = np.cross(self.up, z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        y = y / np.linalg.norm(y)
        delta = x * (-dx * length) + y * (dy * length)
        self.pos = self.pos + delta
        self.int = self.int + delta

    def _dolly(self, dx: float, dy: float) -> None:
        """manipulator.cpp:404-445 (never crosses the interest point)."""
        z = self.int - self.pos
        length = np.linalg.norm(z)
        if length < 1e-12:
            return
        if self.mode != self.EXAMINE:
            dd = -dy
        else:
            dd = dx if abs(dx) > abs(dy) else -dy
        factor = self.speed * dd / length
        length = max(length / 10.0, 0.001)
        factor *= length
        if factor >= 1.0:
            return
        z = z * factor
        if self.mode == self.WALK:
            if self.up[1] > self.up[2]:
                z[1] = 0.0
            else:
                z[2] = 0.0
        self.pos = self.pos + z
        if self.mode != self.EXAMINE:
            self.int = self.int + z

    def _project_tb(self, p: np.ndarray) -> float:
        """projectOntoTBSphere (manipulator.cpp:283-299): sphere inside
        r/sqrt(2), hyperbolic sheet outside."""
        d = np.linalg.norm(p)
        if d < self.tbsize * 0.70710678118654752440:
            return math.sqrt(self.tbsize * self.tbsize - d * d)
        t = self.tbsize / 1.41421356237309504880
        return t * t / max(d, 1e-12)

    def _trackball(self, x: float, y: float) -> None:
        """Deformed trackball (manipulator.cpp:236-276); the axis is
        rotated by the view matrix, as the reference does (:270)."""
        p0 = np.array([2 * (self.mouse[0] - self.width / 2) / self.width,
                       2 * (self.height / 2 - self.mouse[1]) / self.height])
        p1 = np.array([2 * (x - self.width / 2) / self.width,
                       2 * (self.height / 2 - y) / self.height])
        ptb0 = np.array([p0[0], p0[1], self._project_tb(p0)])
        ptb1 = np.array([p1[0], p1[1], self._project_tb(p1)])
        axis = np.cross(ptb0, ptb1)
        norm = np.linalg.norm(axis)
        if norm < 1e-12:
            return
        axis = axis / norm
        t = np.linalg.norm(ptb0 - ptb1) / (2.0 * self.tbsize)
        t = min(max(t, -1.0), 1.0)
        rad = 2.0 * math.asin(t)
        rot_axis = self.matrix().astype(np.float64)[:3, :3] @ axis
        pnt = self.pos - self.int
        self.pos = self.int + _rotate_axis(pnt, rot_axis, rad)
        self.up = _rotate_axis(self.up, rot_axis, rad)
