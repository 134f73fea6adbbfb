"""Renderer: owns frame state and runs the frame (counterpart of
``loupiote_tpu/render/renderer.py``, pathtrace mode).

    r = Renderer((1920, 1080), RenderConfig(downsample_factor=1.0,
                                            denoise=False))
    r.set_resources(build_scene_buffers(scene, device="cuda"))
    r.accumulate = True
    r.raytrace(cam_to_world)   # one progressive frame
    rgb = r.blit()             # (H, W, 3) uint8

State lives on the scene's device: the running average, the frame count
and a ``torch.Generator`` seeded from ``seed``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import BlitMode, RenderConfig, clamp_size, downsampled_size
from ..ops.tonemap import to_display
from .integrator import accumulate, trace_paths


def render_frame(scene, accum: torch.Tensor, frame_count: int,
                 cam_to_world: torch.Tensor, accumulate_flag: bool, *,
                 width: int, height: int, bounces: int, nee: bool,
                 vfov: float, generator: torch.Generator):
    """One progressive pathtrace frame. Returns (accum, frame_count)."""
    sample = trace_paths(scene, cam_to_world, width, height, generator,
                         bounces=bounces, vfov=vfov, nee=nee)
    img = sample.reshape(height, width, 3)
    new_accum = accumulate(accum, img, frame_count)
    return new_accum, (frame_count + 1 if accumulate_flag else 1)


def _blit_rgb(img: torch.Tensor, out_hw, tonemap: str) -> torch.Tensor:
    """Radiance -> display uint8, bilinearly resized to ``out_hw`` when set
    (before tonemapping, as the reference's blit samples the HDR target)."""
    if out_hw is not None:
        img = F.interpolate(img.permute(2, 0, 1)[None], size=tuple(out_hw),
                            mode="bilinear", align_corners=False)[0]
        img = img.permute(1, 2, 0)
    return to_display(img, tonemap)


class Renderer:
    """Stateful facade over the frame (pathtrace blit mode only)."""

    def __init__(self, size: tuple, config: Optional[RenderConfig] = None,
                 seed: int = 0, device=None):
        self.config = config or RenderConfig()
        if self.config.denoise:
            raise NotImplementedError(
                "A-SVGF denoising comes with the denoiser slice of the port; "
                "use RenderConfig(denoise=False)")
        if self.config.samples_per_frame > 1:
            raise NotImplementedError(
                "samples_per_frame > 1 comes with the spp-batching slice of "
                "the port")
        self.device = torch.device(device) if device is not None else None
        self._seed = seed
        self.accumulate = False
        self.mode = BlitMode.PATHTRACE
        self.scene = None
        self._set_size(size)

    def _set_size(self, size: tuple) -> None:
        w, h = clamp_size(size[0], size[1], self.config)
        self.window_size = (max(w, 1), max(h, 1))
        w, h = downsampled_size(w, h, self.config.downsample_factor)
        self.size = (max(w, 1), max(h, 1))
        self._reset_state()

    def _reset_state(self) -> None:
        dev = self.device or torch.device("cpu")
        w, h = self.size
        self.accum = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
        self.frame_count = 1
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(self._seed)

    def set_resources(self, scene) -> None:
        """Bind a scene (its device becomes the renderer's); resets
        accumulation."""
        if scene.has_probe or scene.has_textures:
            raise NotImplementedError(
                "probe and textured scenes come with a later slice of the "
                "port")
        self.scene = scene
        if self.device != scene.device:
            self.device = scene.device
            self._reset_state()
        self.frame_count = 1

    def set_blit_mode(self, mode: BlitMode) -> None:
        if mode != BlitMode.PATHTRACE:
            raise NotImplementedError(
                f"blit mode {mode.value} comes with the denoiser / G-buffer "
                "slice of the port")
        self.mode = mode

    def reset_accumulation(self) -> None:
        """frame_count = 1: restart the running average."""
        self.frame_count = 1

    def raytrace(self, view_transform: np.ndarray) -> None:
        """Render one progressive frame with the given camera-to-world."""
        if self.scene is None:
            return  # no scene bound: nothing to do
        cam = torch.as_tensor(np.asarray(view_transform, np.float32),
                              device=self.device)
        bounces = (self.config.bounces_static if self.accumulate
                   else self.config.bounces_moving)
        self.accum, self.frame_count = render_frame(
            self.scene, self.accum, self.frame_count, cam, self.accumulate,
            width=self.size[0], height=self.size[1], bounces=bounces,
            nee=self.config.nee, vfov=math.radians(self.config.vfov_deg),
            generator=self.generator)

    def blit(self, display_size: bool = True) -> np.ndarray:
        """(H, W, 3) uint8 display image at the window resolution
        (``display_size=False``: at the internal resolution)."""
        hw = None
        if display_size:
            hw = (self.window_size[1], self.window_size[0])
            if hw == (self.size[1], self.size[0]):
                hw = None
        return _blit_rgb(self.accum, hw, self.config.tonemap).cpu().numpy()

    def read_pixels(self) -> bytes:
        """RGBA8 bytes of the displayed image at window resolution."""
        rgb = self.blit()
        rgba = np.concatenate(
            [rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=2)
        return rgba.tobytes()
