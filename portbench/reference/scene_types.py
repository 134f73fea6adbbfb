"""The scene data model: a frozen copy of the port's
``loupiote_tpu_torch/scene/types.py``.

The benchmark's generator (``harness/inputs.py``) fills it; the
reference's tables (``tables.py``) read it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

INVALID_INDEX = np.uint32(0xFFFFFFFF)


@dataclass
class Material:
    """PBR metallic-roughness material."""

    color: np.ndarray = field(default_factory=lambda: np.ones(4, np.float32))
    roughness: float = 1.0
    reflectivity: float = 0.0  # metallic factor
    albedo_texture: int = int(INVALID_INDEX)
    mra_texture: int = int(INVALID_INDEX)
    emission: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))


@dataclass
class Light:
    """Quad area light: origin + two edges + emission."""

    origin: np.ndarray = field(default_factory=lambda: np.array([-0.5, 0.999, -0.5], np.float32))
    edge_u: np.ndarray = field(default_factory=lambda: np.array([1.0, 0.0, 0.0], np.float32))
    edge_v: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 1.0], np.float32))
    emission: np.ndarray = field(default_factory=lambda: np.array([1.0, 1.0, 1.0], np.float32))
    intensity: float = 10.0

    @staticmethod
    def fit_to_scene(bounds_min, bounds_max, intensity: float = 10.0) -> "Light":
        """Overhead quad light sized and placed for the given bounds."""
        bounds_min = np.asarray(bounds_min, np.float32)
        bounds_max = np.asarray(bounds_max, np.float32)
        ext = bounds_max - bounds_min
        cx = (bounds_min + bounds_max) * 0.5
        w = max(float(ext[0]) * 0.3, 1e-3)
        d = max(float(ext[2]) * 0.3, 1e-3)
        y = float(bounds_max[1]) - 0.02 * max(float(ext[1]), 1e-3)
        return Light(
            origin=np.array([cx[0] - w / 2, y, cx[2] - d / 2], np.float32),
            edge_u=np.array([w, 0.0, 0.0], np.float32),
            edge_v=np.array([0.0, 0.0, d], np.float32),
            emission=np.array([1.0, 0.98, 0.95], np.float32),
            intensity=intensity)


@dataclass
class ImageData:
    """RGBA8 image."""

    data: np.ndarray  # (H, W, 4) uint8
    width: int
    height: int

    @staticmethod
    def from_array(arr: np.ndarray) -> "ImageData":
        assert arr.ndim == 3 and arr.shape[2] == 4 and arr.dtype == np.uint8
        return ImageData(arr, arr.shape[1], arr.shape[0])


@dataclass
class Mesh:
    """One mesh primitive: indexed triangle soup in object space."""

    positions: np.ndarray  # (V, 3) float32
    normals: Optional[np.ndarray]  # (V, 3) float32 or None
    texcoords: Optional[np.ndarray]  # (V, 2) float32 or None
    indices: np.ndarray  # (I,) uint32, I % 3 == 0


@dataclass
class Instance:
    """Mesh instance: mesh, model-to-world transform, material."""

    mesh_index: int
    model_to_world: np.ndarray  # (4, 4) float32
    material_index: int


@dataclass
class Scene:
    """CPU-side scene, filled by the procedural builders and the loaders."""

    materials: List[Material] = field(default_factory=list)
    meshes: List[Mesh] = field(default_factory=list)
    instances: List[Instance] = field(default_factory=list)
    lights: List[Light] = field(default_factory=list)
    images: List[ImageData] = field(default_factory=list)

    @staticmethod
    def default() -> "Scene":
        # One dummy material and one default light.
        return Scene(materials=[Material()], lights=[Light()])

    def add_default_light_if_empty(self) -> None:
        if not self.lights:
            self.lights.append(Light())

    def bounds(self):
        """World-space AABB over all instanced geometry (numpy)."""
        lo = np.full(3, np.inf, np.float32)
        hi = np.full(3, -np.inf, np.float32)
        for inst in self.instances:
            mesh = self.meshes[inst.mesh_index]
            m = inst.model_to_world
            pos = mesh.positions @ m[:3, :3].T + m[:3, 3]
            lo = np.minimum(lo, pos.min(axis=0))
            hi = np.maximum(hi, pos.max(axis=0))
        if not np.isfinite(lo).all():
            lo, hi = -np.ones(3, np.float32), np.ones(3, np.float32)
        return lo, hi

    def fit_default_light(self, intensity: float = 10.0) -> None:
        """Place an overhead quad light sized to the scene bounds."""
        lo, hi = self.bounds()
        self.lights = [Light.fit_to_scene(lo, hi, intensity)]

    def stats(self) -> dict:
        return {
            "meshes": len(self.meshes),
            "instances": len(self.instances),
            "triangles": sum(len(m.indices) // 3 for m in self.meshes),
            "vertices": sum(len(m.positions) for m in self.meshes),
            "materials": len(self.materials),
            "lights": len(self.lights),
            "images": len(self.images),
        }


def pad_rows(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad the leading dimension of ``arr`` to ``n`` rows with ``fill``."""
    if arr.shape[0] == n:
        return arr
    pad = np.full((n - arr.shape[0],) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)
