"""Scene model, procedural scenes, atlas, probe and device tables."""

from .atlas import Atlas, pack_atlas
from .blue_noise import generate_blue_noise
from .buffers import SceneBuffers, build_scene_buffers, from_reference
from .hdr import Probe, build_probe, load_probe, read_hdr, rgbe_to_float
from .procedural import arch_camera, build_arch_scene
from .types import (INVALID_INDEX, ImageData, Instance, Light, Material,
                    Mesh, Scene)

__all__ = ["Atlas", "pack_atlas", "generate_blue_noise",
           "SceneBuffers", "build_scene_buffers", "from_reference",
           "Probe", "build_probe", "load_probe", "read_hdr", "rgbe_to_float",
           "arch_camera", "build_arch_scene",
           "INVALID_INDEX", "ImageData", "Instance", "Light", "Material",
           "Mesh", "Scene"]
