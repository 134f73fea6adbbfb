"""loupiote_tpu_torch: the PyTorch / CUDA port of loupiote_tpu.

Runs the path tracer on an NVIDIA H100: plain torch for the wavefront
stages and the A-SVGF denoiser, hand-written CUDA for the BVH traversals
and for the opt-in treelet traversal's sort, scatter and walks
(``csrc/``; ``build_scene_buffers(scene, treelets=True)`` turns the
treelet traversal on, ``treelet/``). Entry points put their tensors on
the card unless the caller names another device. Imports torch, numpy
and (for blue noise) scipy only; never jax, the ``loupiote_tpu`` package
or ``experiments/``, which stay beside it as the reference.
"""

from .config import BlitMode, RenderConfig
from .denoise import denoise
from .render import Camera, Renderer, trace_paths
from .scene import (Atlas, ImageData, Probe, Scene, SceneBuffers,
                    arch_camera, build_arch_scene, build_probe,
                    build_scene_buffers, from_reference, generate_blue_noise,
                    load_probe, pack_atlas, read_hdr, rgbe_to_float)

__all__ = [
    "BlitMode", "Camera", "RenderConfig", "Renderer", "denoise",
    "trace_paths",
    "Atlas", "ImageData", "Probe", "Scene", "SceneBuffers", "arch_camera",
    "build_arch_scene", "build_probe", "build_scene_buffers",
    "from_reference", "generate_blue_noise", "load_probe", "pack_atlas",
    "read_hdr", "rgbe_to_float",
]
