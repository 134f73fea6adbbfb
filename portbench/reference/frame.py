"""The reference's frame: a frozen copy of the port's
``loupiote_tpu_torch/render/renderer.py`` frame functions (the state,
motion vectors, accumulation or A-SVGF, the blit), over the reference's
own integrator and tables.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .asvgf import denoise, demodulate, modulate, temporal_reproject
from .integrator import accumulate, trace_paths
from .tonemap import to_display


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
                  height: int, dim: int = 0, row_offset: int = 0,
                  rows: Optional[int] = None) -> torch.Tensor:
    """(rows * width, 2) blue-noise pairs of dimension ``dim`` for frame
    ``frame_count``: the texture tiled over the image, under an R2
    Cranley-Patterson rotation of the frame, offset by the dimension.
    Computed in float32 as the reference: ``frame_count`` is rounded to
    float32 before the product, ``dim * 0.38196601`` after it.
    ``row_offset`` / ``rows``: the plane of the row slab [row_offset,
    row_offset + rows) only (``rows`` None: all ``height`` rows), as
    ``parallel/tiles.py`` traces it."""
    if rows is None:
        rows = height
    hn, wn = noise_tex.shape[:2]
    dev = noise_tex.device
    yy = (row_offset + torch.arange(rows, device=dev)) % hn
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
                 spp: int = 1,
                 lowp: Optional[torch.dtype] = None) -> RenderState:
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
        frame_count=state.frame_count if use_noise else None, spp=spp,
        lowp=lowp)
    return finish_frame(state, sample.reshape(height, width, 3), gb,
                        world_to_screen, accumulate_flag, width=width,
                        height=height, mode=mode,
                        atrous_iterations=atrous_iterations)


def finish_frame(state: RenderState, img: torch.Tensor, gb,
                 world_to_screen: torch.Tensor, accumulate_flag: bool, *,
                 width: int, height: int, mode: str,
                 atrous_iterations: int) -> RenderState:
    """The rest of a frame once its sample ``img`` (H, W, 3) and pixel-major
    ``GBuffer`` are traced: motion vectors, then accumulation or A-SVGF
    by ``mode`` (see ``render_frame``). Returns the new state."""
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
        with record_function("asvgf"):
            out, t = denoise(img, albedo, motion, normal, depth, mesh,
                             *prev, iterations=atrous_iterations)
        new["denoised"] = out
    elif mode == "temporal":
        with record_function("asvgf"):
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
