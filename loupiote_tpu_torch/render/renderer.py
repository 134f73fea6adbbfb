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

from .. import spans
from ..config import BlitMode, RenderConfig, clamp_size, downsampled_size
from ..denoise.asvgf import denoise, temporal
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
    return finish_frame(state, sample.reshape(height, width, 3), gb,
                        world_to_screen, accumulate_flag, width=width,
                        height=height, mode=mode,
                        atrous_iterations=atrous_iterations)


def finish_frame(state: RenderState, img: torch.Tensor, gb,
                 world_to_screen: torch.Tensor, accumulate_flag: bool, *,
                 width: int, height: int, mode: str,
                 atrous_iterations: int) -> RenderState:
    """The rest of a frame once its sample ``img`` (H, W, 3) and pixel-major
    ``GBuffer`` are traced, under the ``finish`` span: motion vectors, then
    accumulation or A-SVGF (its ``asvgf`` span) by ``mode`` (see
    ``render_frame``). Returns the new state."""
    with spans.span("finish"):
        motion = motion_vectors(state.prev_world_to_screen, gb, width,
                                height)
        normal = gb.normal.reshape(height, width, 3)
        depth = gb.depth.reshape(height, width)
        mesh = gb.mesh_id.reshape(height, width)
        albedo = gb.albedo.reshape(height, width, 3)
        new = dict(prev_world_to_screen=world_to_screen, gb_normal=normal,
                   gb_depth=depth, gb_mesh=mesh, gb_albedo=albedo,
                   motion=motion)
        prev = (state.gb_normal, state.gb_depth, state.gb_mesh,
                state.asvgf_illum, state.asvgf_moments, state.asvgf_history)
        if mode == "pathtrace":
            new["accum"] = accumulate(state.accum, img, state.frame_count)
            new["frame_count"] = (state.frame_count + 1 if accumulate_flag
                                  else 1)
        elif mode == "denoised":
            with spans.span("asvgf"):
                new["denoised"], t, t_rgb = denoise(
                    img, albedo, motion, normal, depth, mesh, *prev,
                    iterations=atrous_iterations)
        elif mode == "temporal":
            with spans.span("asvgf"):
                t, t_rgb = temporal(img, albedo, motion, normal, depth, mesh,
                                    *prev)
        elif mode != "none":
            raise ValueError(f"unknown frame mode {mode!r}")
        if mode in ("denoised", "temporal"):
            new.update(asvgf_illum=t.illum, asvgf_moments=t.moments,
                       asvgf_history=t.history, temporal_rgb=t_rgb)
        return replace(state, **new)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _traced_passes(fn, labels, device) -> dict:
    """Device ms per label of one call of ``fn`` under ``torch.profiler``
    (a warm-up step traced and dropped, then the step read)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from ..app.trace_parse import attribute_passes

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    got = []
    with profile(activities=acts, schedule=schedule(wait=0, warmup=1,
                                                    active=1),
                 on_trace_ready=lambda p: got.extend(p.events())) as prof:
        for _ in range(2):
            fn()
            _sync(device)
            prof.step()
    return attribute_passes(got, labels)


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
    """Stateful facade over the frame.

    ``mesh`` (``parallel.make_mesh``): trace each frame as row slabs over
    the mesh's devices (``parallel/tiles.py::render_frame_sharded``), one
    sample a pixel whatever ``samples_per_frame`` says, as the reference
    does; the height is rounded down to a multiple of the tiles, and the
    state lives on the mesh's first device. ``device`` defaults to that
    device with a mesh, to the card without one.
    """

    def __init__(self, size: tuple, config: Optional[RenderConfig] = None,
                 seed: int = 0, device=None, mesh=None):
        self.config = config or RenderConfig()
        self.mesh = mesh
        if device is None:
            device = "cuda" if mesh is None else mesh.devices[0, 0]
        # An empty tensor names the device in full ("cuda" -> "cuda:0")
        # and raises at once where there is no such device.
        self.device = torch.empty(0, device=device).device
        if mesh is not None and mesh.devices[0, 0] != self.device:
            raise ValueError(f"the renderer is on {self.device}, the mesh's "
                             f"first device is {mesh.devices[0, 0]}")
        self._seed = seed
        self.accumulate = False
        self.mode = BlitMode.PATHTRACE
        self.scene = None
        self.use_noise = False
        self.noise_texture: Optional[np.ndarray] = None
        self.last_reload_error: Optional[str] = None
        self._set_size(size)

    # -- sizing ----------------------------------------------------------
    def _set_size(self, size: tuple) -> None:
        w, h = clamp_size(size[0], size[1], self.config)
        self.window_size = (max(w, 1), max(h, 1))
        w, h = downsampled_size(w, h, self.config.downsample_factor)
        if self.mesh is not None:
            # Row slabs must divide the height across the tiles.
            tiles = self.mesh.shape["tiles"]
            h = max((h // tiles) * tiles, tiles)
        self.size = (max(w, 1), max(h, 1))
        self.state = init_state(self.size[0], self.size[1], self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self._seed)
        self._mesh_frames = 0  # a mesh frame's key: (seed, this count)
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
        """Bind a scene on the renderer's device (with a mesh: copied to
        each of its devices); resets accumulation."""
        if self.mesh is not None:
            from ..parallel.tiles import replicate_scene

            self._replicas = replicate_scene(scene, self.mesh)
            scene = self._replicas[self.device]
        elif scene.device != self.device:
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

    def enable_aot_cache(self, cache_dir: Optional[str] = None) -> None:
        """Kept as API and does nothing: the reference persists its compiled
        frame across processes; the port compiles no frame (its kernels
        are built once into ``_build/``)."""

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
        if self.mesh is None:
            self.state = self._frame(view_transform, self.generator)
            return
        from ..parallel.tiles import render_frame_sharded

        cam_t, w2s, bounces = self._frame_args(view_transform)
        self.state = render_frame_sharded(
            self._replicas, self.state, cam_t, w2s, self.accumulate,
            mesh=self.mesh, width=self.size[0], height=self.size[1],
            bounces=bounces, nee=self.config.nee,
            vfov=math.radians(self.config.vfov_deg),
            mode=_FRAME_MODE[self.mode],
            atrous_iterations=self.config.atrous_iterations,
            key=(self._seed, self._mesh_frames),
            use_noise=self.use_noise and self.noise_texture is not None)
        self._mesh_frames += 1

    def _frame(self, view_transform, generator) -> RenderState:
        """The session's next frame state, its numbers drawn from
        ``generator``."""
        cam_t, w2s, bounces = self._frame_args(view_transform)
        return render_frame(
            self.scene, self.state, cam_t, w2s, self.accumulate,
            width=self.size[0], height=self.size[1], bounces=bounces,
            nee=self.config.nee, vfov=math.radians(self.config.vfov_deg),
            mode=_FRAME_MODE[self.mode],
            atrous_iterations=self.config.atrous_iterations,
            generator=generator,
            use_noise=self.use_noise and self.noise_texture is not None,
            spp=self.config.samples_per_frame)

    def _frame_args(self, view_transform):
        cam = Camera(np.asarray(view_transform, np.float32), self.size,
                     math.radians(self.config.vfov_deg))
        w2s = cam.world_to_screen(self.config.near, self.config.far)
        with spans.sync("camera"):
            cam_t = torch.as_tensor(cam.transform, device=self.device)
        with spans.sync("camera"):
            w2s_t = torch.as_tensor(w2s, device=self.device)
        return cam_t, w2s_t, self._bounces()

    def _bounces(self) -> int:
        return (self.config.bounces_static if self.accumulate
                else self.config.bounces_moving)

    def measure_passes(self, view_transform, method: str = "auto") -> dict:
        """Per-pass times of the frame the user runs, labelled as the
        reference's performance window ("ray generation", "primary
        intersection", "sort N", "intersection N", "shading N", "shadow
        N", "asvgf"; ``app/trace_parse.py::frame_scope_labels``), in ms.

        ``method``:
          - "trace": device times. One warm-up frame, then one frame under
            ``torch.profiler``, each rendered from a copy of the
            generator's state and dropped, so the session does not
            change; each device kernel counts under the innermost
            labelled span it was launched in. On the card a second
            profiler session in one process has missed its first
            kernels, so the profiler's schedule traces a warm-up step it
            drops.
          - "spans": host times of the last frame kept by the recording
            that is on (``spans.recording``), no frame rendered: each
            span's self time counts under the innermost labelled span
            around it. Off the card, where an op has done its work when
            it returns, these are the passes' times.
          - "auto": "trace" on the card, "spans" elsewhere.

        Returns the labels' ms, "other" (the rest: device work, or host
        time of the frame's spans, under no label) and "method"; {} with
        no scene bound, or for "spans" with no frame recorded.
        """
        from ..app.trace_parse import attribute_spans, frame_scope_labels

        if self.scene is None:
            return {}
        labels = frame_scope_labels(
            self._bounces(),
            denoised=_FRAME_MODE[self.mode] in ("denoised", "temporal"))
        if method == "auto":
            method = "trace" if self.device.type == "cuda" else "spans"
        if method == "trace":
            def frame():
                g = torch.Generator(device=self.device)
                g.set_state(self.generator.get_state())
                return self._frame(view_transform, g)

            out = _traced_passes(frame, labels, self.device)
        elif method == "spans":
            rec = spans.active()
            if rec is None or rec.frame == 0:
                return {}
            out = attribute_spans(rec, rec.frame, labels)
        else:
            raise ValueError(f"unknown method {method!r}")
        out["method"] = method
        return out

    # Modules re-read on reload (the "shader sources"), in import order:
    # each after the modules it imports from. Then the integrator, which
    # binds their functions with from-imports.
    _RELOADABLE = tuple("loupiote_tpu_torch." + m for m in (
        "ops.intersect", "ops.raygen", "ops.sampling", "ops.env",
        "ops.texture", "ops.sort", "ops.wide", "ops.bvh2", "scene.instanced",
        "ops.slab_sort", "treelet.lane_top", "treelet.lane_bottom",
        "treelet.regroup", "treelet.pipeline", "ops.shade", "ops.tonemap",
        "ops.lightmap", "denoise.asvgf"))
    _REBINDERS = ("loupiote_tpu_torch.render.integrator",)

    def reload_shaders(self) -> None:
        """Hot reload: re-import the kernel modules and rebuild the CUDA
        libraries the scene's path loads, so the next frame runs the new
        code.

        Every other module of the package that bound a function or class
        of a reloaded module (this module's ``trace_paths``, the packages'
        exports) is pointed at the new one. ``_build``'s cached libraries
        of the path are dropped and loaded again: a source whose hash
        changed is rebuilt under a new name (ctypes cannot reload a path
        that is already open, so each build has its own hashed name), an
        unchanged one loads the same library, and an entry point's C
        signature is declared again on the library that replaces it.
        ``_build`` itself is not reloaded: it holds the locks, the cache
        and the launch counts.

        Validation builds every library of the path and renders a
        one-bounce 32x16 frame on the renderer's device from a generator
        of its own. On any error the old state is kept: the module dicts,
        the bindings and ``_build``'s libraries (with the signatures
        declared on them) are restored, the error is kept in
        ``last_reload_error``, and the session renders on with the old
        pipeline.
        """
        import importlib
        import sys

        from .. import _build

        pkg = "loupiote_tpu_torch"
        names = [n for n in self._RELOADABLE + self._REBINDERS
                 if n in sys.modules]
        snapshots = {n: dict(sys.modules[n].__dict__) for n in names}
        libs = dict(_build._libs)
        others = {n: dict(m.__dict__) for n, m in list(sys.modules.items())
                  if m is not None and (n == pkg or n.startswith(pkg + "."))
                  and n not in snapshots}
        try:
            for n in names:
                importlib.reload(sys.modules[n])
            for n in others:
                mod = sys.modules[n]
                for attr, val in list(mod.__dict__.items()):
                    src = getattr(val, "__module__", None)
                    if (src in snapshots and callable(val)
                            and hasattr(sys.modules[src], attr)):
                        setattr(mod, attr, getattr(sys.modules[src], attr))
            # Off the card the twins run and no library is loaded.
            if self.scene is not None and self.device.type == "cuda":
                from ..ops.intersect import path_libraries

                for lib in path_libraries(self.scene):
                    _build._libs.pop(lib, None)
                    _build.load(lib)
            if self.scene is not None:
                self._validation_frame()
        except Exception as e:  # keep the old pipeline
            for n, d in list(snapshots.items()) + list(others.items()):
                mod = sys.modules[n]
                mod.__dict__.clear()
                mod.__dict__.update(d)
            _build._libs.clear()
            _build._libs.update(libs)
            self.last_reload_error = f"{type(e).__name__}: {e}"
            return
        self.last_reload_error = None

    def _validation_frame(self) -> None:
        w, h = 32, 16
        g = torch.Generator(device=self.device)
        g.manual_seed(0)
        cam_t, w2s, _ = self._frame_args(np.eye(4, dtype=np.float32))
        st = render_frame(self.scene, init_state(w, h, self.device), cam_t,
                          w2s, True, width=w, height=h, bounces=1,
                          nee=self.config.nee,
                          vfov=math.radians(self.config.vfov_deg),
                          mode="pathtrace", generator=g)
        if not bool(torch.isfinite(st.accum).all()):
            raise RuntimeError("the validation frame is not finite")

    # -- display ---------------------------------------------------------
    def blit(self, display_size: bool = True) -> np.ndarray:
        """(H, W, 3) uint8 display image of the current mode at the window
        resolution (``display_size=False``: at the internal resolution),
        under the ``blit`` span."""
        with spans.span("blit"):
            return self._blit(display_size)

    def _blit(self, display_size: bool) -> np.ndarray:
        s = self.state
        hw = self._display_hw(display_size)
        rgb = {BlitMode.PATHTRACE: s.accum,
               BlitMode.DENOISED_PATHTRACE: s.denoised,
               BlitMode.TEMPORAL: s.temporal_rgb}.get(self.mode)
        if rgb is not None:
            img = _blit_rgb(rgb, hw, self.config.tonemap)
            with spans.sync("readback"):
                return img.cpu().numpy()
        if self.mode == BlitMode.GBUFFER:
            with spans.sync("readback"):
                normal = s.gb_normal.cpu().numpy()
            with spans.sync("readback"):
                mesh = s.gb_mesh.cpu().numpy()
            vis = normal * 0.5 + 0.5
            vis[mesh < 0] = 0.0
        else:
            with spans.sync("readback"):
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
