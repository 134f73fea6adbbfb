"""Scene model, loaders, procedural scenes, atlas, probe and device
tables."""

from .atlas import Atlas, pack_atlas
from .binary import load_binary, load_binary_from_path
from .blue_noise import generate_blue_noise, load_noise_png
from .buffers import SceneBuffers, build_scene_buffers, from_reference
from .gltf import GltfError, load_gltf, load_gltf_path
from .hdr import Probe, build_probe, load_probe, read_hdr, rgbe_to_float
from .procedural import arch_camera, build_arch_scene
from .types import (INVALID_INDEX, ImageData, Instance, Light, Material,
                    Mesh, Scene)

__all__ = ["Atlas", "pack_atlas", "load_binary", "load_binary_from_path",
           "generate_blue_noise", "load_noise_png",
           "SceneBuffers", "build_scene_buffers", "from_reference",
           "GltfError", "load_gltf", "load_gltf_path",
           "Probe", "build_probe", "load_probe", "read_hdr", "rgbe_to_float",
           "arch_camera", "build_arch_scene",
           "INVALID_INDEX", "ImageData", "Instance", "Light", "Material",
           "Mesh", "Scene"]
