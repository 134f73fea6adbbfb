"""Renderer: owns frame state and runs the frame (counterpart of
``loupiote_tpu/render/renderer.py``).

    r = Renderer((1920, 1080), RenderConfig())        # on the card
    r.set_resources(build_scene_buffers(scene))
    r.set_blit_mode(BlitMode.DENOISED_PATHTRACE)
    r.raytrace(cam_to_world)   # one frame: trace, G-buffer, motion, A-SVGF
    rgb = r.blit()             # (H, W, 3) uint8 at the window size

State lives on the renderer's device (the card unless the caller names
another): the running average and frame count, the previous frame's
world-to-screen matrix, the G-buffer, motion vectors, the blue-noise
texture, the A-SVGF history and a ``torch.Generator`` seeded from
``seed``. ``RenderConfig.samples_per_frame`` samples of each pixel go
through each wave together.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import BlitMode, RenderConfig, clamp_size, downsampled_size
from ..denoise.asvgf import denoise, demodulate, modulate, temporal_reproject
from ..ops.tonemap import to_display
from .camera import Camera
from .integrator import accumulate, trace_paths


@dataclass
class RenderState:
    """Per-session frame state (the reference's RenderState, without its
    completion probe)."""

    accum: torch.Tensor  # (H, W, 3) running average
    frame_count: int
    prev_world_to_screen: torch.Tensor  # (4, 4)
    gb_normal: torch.Tensor  # (H, W, 3) first-bounce G-buffer
    gb_depth: torch.Tensor  # (H, W)
    gb_mesh: torch.Tensor  # (H, W) int32
    gb_albedo: torch.Tensor  # (H, W, 3)
    motion: torch.Tensor  # (H, W, 2) uv motion vectors
    # (Hn, Wn, 2) blue noise in [0, 1): every sample dimension's base
    # plane when blue noise is on (rotated per frame, blue_noise_uv).
    noise_tex: torch.Tensor
    asvgf_illum: torch.Tensor  # (H, W, 3) integrated illumination
    asvgf_moments: torch.Tensor  # (H, W, 2)
    asvgf_history: torch.Tensor  # (H, W)
    denoised: torch.Tensor  # (H, W, 3) last denoiser output
    temporal_rgb: torch.Tensor  # (H, W, 3) temporal pass output


def init_state(width: int, height: int, device) -> RenderState:
    h, w = height, width

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return RenderState(
        accum=z(h, w, 3), frame_count=1,
        prev_world_to_screen=torch.eye(4, dtype=torch.float32,
                                       device=device),
        gb_normal=z(h, w, 3), gb_depth=z(h, w),
        gb_mesh=torch.full((h, w), -1, dtype=torch.int32, device=device),
        gb_albedo=torch.ones((h, w, 3), dtype=torch.float32, device=device),
        motion=z(h, w, 2),
        noise_tex=torch.full((64, 64, 2), 0.5, dtype=torch.float32,
                             device=device),
        asvgf_illum=z(h, w, 3), asvgf_moments=z(h, w, 2),
        asvgf_history=z(h, w), denoised=z(h, w, 3), temporal_rgb=z(h, w, 3))


# The R2 sequence's two generators, and the offset between dimensions.
_R2 = (0.7548776662, 0.5698402910)
_DIM_STEP = 0.38196601


def blue_noise_uv(noise_tex: torch.Tensor, frame_count: int, width: int,
                  height: int, dim: int = 0) -> torch.Tensor:
    """(height * width, 2) blue-noise pairs of dimension ``dim`` for frame
    ``frame_count``: the texture tiled over the image, under an R2
    Cranley-Patterson rotation of the frame, offset by the dimension.
    Computed in float32 as the reference: ``frame_count`` is rounded to
    float32 before the product, ``dim * 0.38196601`` after it."""
    hn, wn = noise_tex.shape[:2]
    dev = noise_tex.device
    yy = torch.arange(height, device=dev) % hn
    xx = torch.arange(width, device=dev) % wn
    base = noise_tex[yy[:, None], xx[None, :]].reshape(-1, 2)
    g = torch.tensor(_R2, dtype=torch.float32, device=dev)
    rot = torch.remainder(
        torch.tensor(float(frame_count), dtype=torch.float32, device=dev) * g
        + torch.tensor(dim * _DIM_STEP, dtype=torch.float32, device=dev),
        1.0)
    return torch.remainder(base + rot, 1.0)


def project_uv(world_to_screen: torch.Tensor, pos: torch.Tensor):
    """World (R,3) -> screen uv in [0,1] (y down) and clip w. The (R,4) x
    (4,4) product is written out term by term, so no matrix-product path
    (and no TF32, whatever ``torch.backends.cuda.matmul.allow_tf32`` says)
    is involved."""
    m = world_to_screen

    def row(j):
        return (pos[:, 0] * m[j, 0] + pos[:, 1] * m[j, 1]
                + pos[:, 2] * m[j, 2] + m[j, 3])

    w = row(3)
    safe_w = torch.where(w.abs() > 1e-9, w, 1e-9)
    ndc_x, ndc_y = row(0) / safe_w, row(1) / safe_w
    uv = torch.stack([(ndc_x + 1.0) * 0.5, (1.0 - ndc_y) * 0.5], dim=1)
    return uv, w


def motion_vectors(prev_world_to_screen: torch.Tensor, gbuffer,
                   width: int, height: int) -> torch.Tensor:
    """(H, W, 2): previous-frame screen uv minus this pixel's uv, where
    the pixel has a hit in front of the previous camera; else 0."""
    uv_prev, w_prev = project_uv(prev_world_to_screen, gbuffer.world_pos)
    dev = uv_prev.device
    yy, xx = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    uv_curr = torch.stack([(xx.reshape(-1) + 0.5) / width,
                           (yy.reshape(-1) + 0.5) / height], dim=1)
    valid = (gbuffer.mesh_id >= 0) & (w_prev > 0)
    return torch.where(valid[:, None], uv_prev - uv_curr,
                       0.0).reshape(height, width, 2)


def render_frame(scene, state: RenderState, cam_to_world: torch.Tensor,
                 world_to_screen: torch.Tensor, accumulate_flag: bool, *,
                 width: int, height: int, bounces: int, nee: bool,
                 vfov: float, mode: str = "pathtrace",
                 atrous_iterations: int = 4,
                 generator: Optional[torch.Generator] = None,
                 uniforms=None, use_noise: bool = False,
                 spp: int = 1) -> RenderState:
    """One frame. Returns the new state.

    ``mode``: 'pathtrace' accumulates; 'denoised' runs the whole A-SVGF
    chain; 'temporal' only its temporal pass; 'none' neither (the debug
    blit modes). Every mode writes the G-buffer and motion vectors.
    ``uniforms``: the frame's random numbers (drawn from ``generator``
    when None). ``use_noise``: the jitter (dimension 0), the bounce-0
    light sample (dimension 1) and every BSDF and lobe draw come from
    ``state.noise_tex``. ``spp``: samples per pixel, in one wave.
    """
    jitter = nee_uv = None
    if use_noise:
        fc = state.frame_count
        jitter = blue_noise_uv(state.noise_tex, fc, width, height, dim=0)
        nee_uv = blue_noise_uv(state.noise_tex, fc, width, height, dim=1)
    sample, gb = trace_paths(
        scene, cam_to_world, width, height, generator, bounces=bounces,
        vfov=vfov, nee=nee, uniforms=uniforms, jitter=jitter, nee_uv=nee_uv,
        noise_tex=state.noise_tex if use_noise else None,
        frame_count=state.frame_count if use_noise else None, spp=spp)
    img = sample.reshape(height, width, 3)
    motion = motion_vectors(state.prev_world_to_screen, gb, width, height)
    normal = gb.normal.reshape(height, width, 3)
    depth = gb.depth.reshape(height, width)
    mesh = gb.mesh_id.reshape(height, width)
    albedo = gb.albedo.reshape(height, width, 3)
    new = dict(prev_world_to_screen=world_to_screen, gb_normal=normal,
               gb_depth=depth, gb_mesh=mesh, gb_albedo=albedo, motion=motion)
    prev = (state.gb_normal, state.gb_depth, state.gb_mesh,
            state.asvgf_illum, state.asvgf_moments, state.asvgf_history)
    if mode == "pathtrace":
        new["accum"] = accumulate(state.accum, img, state.frame_count)
        new["frame_count"] = (state.frame_count + 1 if accumulate_flag
                              else 1)
    elif mode == "denoised":
        out, t = denoise(img, albedo, motion, normal, depth, mesh, *prev,
                         iterations=atrous_iterations)
        new["denoised"] = out
    elif mode == "temporal":
        t = temporal_reproject(demodulate(img, albedo), motion, normal,
                               depth, mesh, *prev)
    elif mode != "none":
        raise ValueError(f"unknown frame mode {mode!r}")
    if mode in ("denoised", "temporal"):
        new.update(asvgf_illum=t.illum, asvgf_moments=t.moments,
                   asvgf_history=t.history,
                   temporal_rgb=modulate(t.illum, albedo))
    return replace(state, **new)


def _blit_rgb(img: torch.Tensor, out_hw, tonemap: str) -> torch.Tensor:
    """Radiance -> display uint8, bilinearly resized to ``out_hw`` when set
    (before tonemapping, as the reference's blit samples the HDR target)."""
    if out_hw is not None:
        img = F.interpolate(img.permute(2, 0, 1)[None], size=tuple(out_hw),
                            mode="bilinear", align_corners=False)[0]
        img = img.permute(1, 2, 0)
    return to_display(img, tonemap)


_FRAME_MODE = {
    BlitMode.PATHTRACE: "pathtrace",
    BlitMode.DENOISED_PATHTRACE: "denoised",
    BlitMode.TEMPORAL: "temporal",
    BlitMode.GBUFFER: "none",
    BlitMode.MOTION_VECTOR: "none",
}


class Renderer:
    """Stateful facade over the frame."""

    def __init__(self, size: tuple, config: Optional[RenderConfig] = None,
                 seed: int = 0, device="cuda"):
        self.config = config or RenderConfig()
        # An empty tensor names the device in full ("cuda" -> "cuda:0")
        # and raises at once where there is no such device.
        self.device = torch.empty(0, device=device).device
        self._seed = seed
        self.accumulate = False
        self.mode = BlitMode.PATHTRACE
        self.scene = None
        self.use_noise = False
        self.noise_texture: Optional[np.ndarray] = None
        self._set_size(size)

    # -- sizing ----------------------------------------------------------
    def _set_size(self, size: tuple) -> None:
        w, h = clamp_size(size[0], size[1], self.config)
        self.window_size = (max(w, 1), max(h, 1))
        w, h = downsampled_size(w, h, self.config.downsample_factor)
        self.size = (max(w, 1), max(h, 1))
        self.state = init_state(self.size[0], self.size[1], self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self._seed)
        if self.noise_texture is not None:
            self.upload_noise_texture(self.noise_texture)

    def resize(self, size: tuple) -> None:
        """Reallocate the frame state for a new window size."""
        self._set_size(size)

    def get_size(self) -> tuple:
        """Internal render size (width, height)."""
        return self.size

    # -- resources -------------------------------------------------------
    def set_resources(self, scene) -> None:
        """Bind a scene on the renderer's device; resets accumulation."""
        if scene.device != self.device:
            raise ValueError(f"the scene is on {scene.device}, the renderer "
                             f"on {self.device}")
        self.scene = scene
        self.state = replace(self.state, frame_count=1)

    def upload_noise_texture(self, data) -> None:
        """Bind a blue-noise texture, (Hn, Wn, >= 2) uint8: its first two
        channels at texel centres, (c + 0.5) / 256. Kept across
        ``resize``."""
        self.noise_texture = np.asarray(data, np.uint8)
        tex = (self.noise_texture[..., :2].astype(np.float32) + 0.5) / 256.0
        self.state = replace(self.state,
                             noise_tex=torch.from_numpy(tex).to(self.device))

    def use_noise_texture(self, flag: bool) -> None:
        """Draw the frame's samples from the uploaded blue noise (once one
        is uploaded) instead of the pseudo-random generator."""
        self.use_noise = bool(flag)

    def set_blit_mode(self, mode: BlitMode) -> None:
        self.mode = BlitMode(mode)

    def reset_accumulation(self) -> None:
        """frame_count = 1: restart the running average."""
        self.state = replace(self.state, frame_count=1)

    @property
    def frame_count(self) -> int:
        return self.state.frame_count

    @property
    def accum(self) -> torch.Tensor:
        return self.state.accum

    # -- frame -----------------------------------------------------------
    def raytrace(self, view_transform: np.ndarray) -> None:
        """Render one frame with the given camera-to-world."""
        if self.scene is None:
            return  # no scene bound: nothing to do
        cam = Camera(np.asarray(view_transform, np.float32), self.size,
                     math.radians(self.config.vfov_deg))
        w2s = cam.world_to_screen(self.config.near, self.config.far)
        bounces = (self.config.bounces_static if self.accumulate
                   else self.config.bounces_moving)
        self.state = render_frame(
            self.scene, self.state,
            torch.as_tensor(cam.transform, device=self.device),
            torch.as_tensor(w2s, device=self.device), self.accumulate,
            width=self.size[0], height=self.size[1], bounces=bounces,
            nee=self.config.nee, vfov=math.radians(self.config.vfov_deg),
            mode=_FRAME_MODE[self.mode],
            atrous_iterations=self.config.atrous_iterations,
            generator=self.generator,
            use_noise=self.use_noise and self.noise_texture is not None,
            spp=self.config.samples_per_frame)

    def measure_passes(self, view_transform, queries=None,
                       method: str = "auto") -> dict:
        raise NotImplementedError(
            "per-pass timing comes with the app-layer slice of the port")

    def reload_shaders(self) -> None:
        raise NotImplementedError(
            "kernel hot-reload comes with the app-layer slice of the port")

    # -- display ---------------------------------------------------------
    def blit(self, display_size: bool = True) -> np.ndarray:
        """(H, W, 3) uint8 display image of the current mode at the window
        resolution (``display_size=False``: at the internal resolution)."""
        s = self.state
        hw = self._display_hw(display_size)
        rgb = {BlitMode.PATHTRACE: s.accum,
               BlitMode.DENOISED_PATHTRACE: s.denoised,
               BlitMode.TEMPORAL: s.temporal_rgb}.get(self.mode)
        if rgb is not None:
            return _blit_rgb(rgb, hw, self.config.tonemap).cpu().numpy()
        if self.mode == BlitMode.GBUFFER:
            vis = s.gb_normal.cpu().numpy() * 0.5 + 0.5
            vis[s.gb_mesh.cpu().numpy() < 0] = 0.0
        else:
            mv = s.motion.cpu().numpy()
            vis = np.zeros(mv.shape[:2] + (3,), np.float32)
            vis[..., :2] = np.clip(np.abs(mv) * 20.0, 0, 1)
        if hw is not None:
            # Debug views upscale nearest: they show raw buffer texels.
            yy = np.minimum((np.arange(hw[0]) * vis.shape[0]) // hw[0],
                            vis.shape[0] - 1)
            xx = np.minimum((np.arange(hw[1]) * vis.shape[1]) // hw[1],
                            vis.shape[1] - 1)
            vis = vis[yy[:, None], xx[None, :]]
        return (vis * 255).astype(np.uint8)

    def _display_hw(self, display_size: bool):
        if not display_size:
            return None
        hw = (self.window_size[1], self.window_size[0])
        return None if hw == (self.size[1], self.size[0]) else hw

    def read_pixels(self) -> bytes:
        """RGBA8 bytes of the displayed image at window resolution."""
        rgb = self.blit()
        rgba = np.concatenate(
            [rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=2)
        return rgba.tobytes()
