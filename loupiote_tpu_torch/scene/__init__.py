"""Scene model, procedural scenes and device tables."""

from .buffers import SceneBuffers, build_scene_buffers, from_reference
from .procedural import arch_camera, build_arch_scene
from .types import Instance, Light, Material, Mesh, Scene

__all__ = ["SceneBuffers", "build_scene_buffers", "from_reference",
           "arch_camera", "build_arch_scene",
           "Instance", "Light", "Material", "Mesh", "Scene"]
