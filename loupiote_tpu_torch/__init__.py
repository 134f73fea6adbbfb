"""loupiote_tpu_torch: the PyTorch / CUDA port of loupiote_tpu.

Runs the path tracer on an NVIDIA H100: plain torch for the wavefront
stages and the A-SVGF denoiser, hand-written CUDA for the BVH traversals
and for the opt-in treelet traversal's sort, scatter and walks
(``csrc/``; ``build_scene_buffers(scene, treelets=True)`` turns the
treelet traversal on, ``treelet/``). The app layer (``app/``: driver,
viewer server, checkpoints) and the CLI (``python -m
loupiote_tpu_torch render|flythrough|serve|info``) sit on top, with the
glTF, binary and PNG loaders. Entry points put their tensors on the card
unless the caller names another device; ``parallel`` splits a frame's
rows over several devices (``Renderer(mesh=...)``); ``spans`` keeps each
frame's host spans and counters while a recording is on. Imports torch,
numpy and scipy only; never jax, the ``loupiote_tpu`` package,
``experiments/`` or an image library: PNG and JPEG are ``image_codec``'s
own.
"""

from . import app, config, denoise, ops, parallel, render, scene, spans
from .config import BlitMode, RenderConfig, Settings
from .device import Device
from .errors import AccelBuild, Error, FileNotFound, TextureToBufferReadFail
from .render import Camera, CameraController, Renderer, trace_paths
from .scene import (Atlas, ImageData, Probe, Scene, SceneBuffers,
                    arch_camera, build_arch_scene, build_probe,
                    build_scene_buffers, from_reference, generate_blue_noise,
                    load_binary_from_path, load_gltf, load_gltf_path,
                    load_probe, pack_atlas, read_hdr, rgbe_to_float)

__all__ = [
    "app", "config", "denoise", "ops", "parallel", "render", "scene",
    "spans",
    "BlitMode", "RenderConfig", "Settings", "Device",
    "AccelBuild", "Error", "FileNotFound", "TextureToBufferReadFail",
    "Camera", "CameraController", "Renderer",
    "Scene", "SceneBuffers", "build_scene_buffers",
    "load_binary_from_path", "load_gltf", "load_gltf_path", "load_probe",
    "trace_paths",
    "Atlas", "ImageData", "Probe", "arch_camera", "build_arch_scene",
    "build_probe", "from_reference", "generate_blue_noise", "pack_atlas",
    "read_hdr", "rgbe_to_float",
]
