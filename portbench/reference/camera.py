"""The camera and the fly-camera controller: a frozen copy of the port's
``loupiote_tpu_torch/render/camera.py``.

Pixel dimensions, a camera-to-world transform (columns = right, up,
forward, origin) and the perspective used for motion-vector
reprojection, in numpy float32 as the reference has them; the
``CameraController`` is the reference's numpy host code, copied.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

VFOV_DEG = 45.0  # vertical field of view


@dataclass
class Camera:
    transform: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    dimensions: tuple = (0, 0)
    vfov: float = np.deg2rad(VFOV_DEG)

    def perspective(self, near: float = 0.01,
                    far: float = 100.0) -> np.ndarray:
        """Right-handed perspective projection (glam's perspective_rh)."""
        w, h = self.dimensions
        aspect = w / max(h, 1)
        f = 1.0 / np.tan(self.vfov / 2.0)
        m = np.zeros((4, 4), np.float32)
        m[0, 0] = f / aspect
        m[1, 1] = f
        m[2, 2] = far / (near - far)
        m[2, 3] = near * far / (near - far)
        m[3, 2] = -1.0
        return m

    def world_to_screen(self, near: float = 0.01,
                        far: float = 100.0) -> np.ndarray:
        """perspective @ view^-1. The camera looks along +forward while
        the projection looks along -z, so the view basis negates the
        forward column."""
        cam_to_world = np.asarray(self.transform, np.float32).copy()
        cam_to_world[:3, 2] = -cam_to_world[:3, 2]
        view = np.linalg.inv(cam_to_world)
        return self.perspective(near, far) @ view


class CameraMoveCommand:
    NONE = 0
    FORWARD = 1
    BACKWARD = 2
    LEFT = 4
    RIGHT = 8


class CameraController:
    """Fly camera: velocity with damping (0.5), move speed 2.0, rotation
    speed 20, quaternion rotation about the local up and right axes;
    ``is_static`` gates accumulation."""

    def __init__(self):
        self.move_speed_factor = 2.0
        self.move_velocity = np.zeros(3, np.float32)
        self.rot_velocity = np.zeros(2, np.float32)
        self.rot_speed_factor = np.array([20.0, 20.0], np.float32)
        self.move_damping_factor = 0.5
        self.rot_damping_factor = 0.5
        self.origin = np.zeros(3, np.float32)
        self.direction = np.array([0.0, 0.0, -1.0], np.float32)
        self.commands = 0
        self.rotation_enabled = False
        self.translation_enabled = True

    @staticmethod
    def from_origin_dir(origin, direction) -> "CameraController":
        c = CameraController()
        c.origin = np.asarray(origin, np.float32)
        c.direction = np.asarray(direction, np.float32)
        return c

    def rotate(self, x: float, y: float) -> None:
        if self.rotation_enabled:
            self.rot_velocity += (x, y)

    def set_command(self, cmd: int) -> None:
        if self.translation_enabled:
            self.commands |= cmd

    def unset_command(self, cmd: int) -> None:
        self.commands &= ~cmd

    def update(self, delta: float) -> np.ndarray:
        def norm(v):
            return v / max(np.linalg.norm(v), 1e-12)

        world_up = np.array([0.0, 1.0, 0.0], np.float32)
        right = norm(np.cross(self.direction, world_up))
        up = norm(np.cross(right, self.direction))

        rv = self.rot_velocity * self.rot_speed_factor * delta
        rot = _quat_axis_angle(up, -rv[0]) @ _quat_axis_angle(right, -rv[1])
        self.direction = norm(rot @ self.direction)
        right = norm(np.cross(self.direction, world_up))
        up = norm(np.cross(right, self.direction))

        if self.commands & CameraMoveCommand.LEFT:
            self.move_velocity[0] += -1.0
        if self.commands & CameraMoveCommand.RIGHT:
            self.move_velocity[0] += 1.0
        if self.commands & CameraMoveCommand.FORWARD:
            self.move_velocity[2] += 1.0
        if self.commands & CameraMoveCommand.BACKWARD:
            self.move_velocity[2] += -1.0
        mv = self.move_velocity * self.move_speed_factor * delta
        self.origin = self.origin + right * mv[0] + self.direction * mv[2]

        self.rot_velocity *= np.clip(1.0 - self.rot_damping_factor, 0, 1)
        self.move_velocity *= np.clip(1.0 - self.move_damping_factor, 0, 1)

        m = np.eye(4, dtype=np.float32)
        m[:3, 0] = right
        m[:3, 1] = up
        m[:3, 2] = self.direction
        m[:3, 3] = self.origin
        return m

    def is_static(self) -> bool:
        return (not self.rotation_enabled
                and float(self.rot_velocity @ self.rot_velocity) < 1e-8
                and float(self.move_velocity @ self.move_velocity) < 1e-8)


def _quat_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    """3x3 rotation matrix about ``axis`` by ``angle`` radians."""
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    c, s = np.cos(angle), np.sin(angle)
    x, y, z = axis
    K = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], np.float32)
    return np.eye(3, dtype=np.float32) * c + s * K + (1 - c) * np.outer(axis, axis)
