"""Camera uniform (counterpart of ``loupiote_tpu/render/camera.py``).

Pixel dimensions, a camera-to-world transform (columns = right, up,
forward, origin) and the perspective used for motion-vector
reprojection, in numpy float32 as the reference has them. The fly-camera
``CameraController`` belongs to the app layer, which is not ported yet.
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
