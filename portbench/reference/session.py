"""The reference's session: the frames a user's session renders, worked
out from the benchmark's own inputs (the scene before it was written as
GLB, the sky's ``.hdr`` bytes, the camera of each frame, the seed) with
the plain torch path of this package. Nothing here reads the program.

It follows what the port's ``app.Driver.step`` and ``Renderer`` do for a
frame: the view from the fly camera, accumulation restarted unless the
settings accumulate, the frame's random numbers drawn from a generator
seeded with the run's seed in the order the frame draws them
(``sampling.draw_uniforms``, once a frame), then ``frame.render_frame``
and the blit.
"""

from __future__ import annotations

import copy
import math
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from .camera import Camera, CameraController
from .frame import RenderState, _blit_rgb, init_state, render_frame
from .instanced import build_instanced_tables
from .probe import build_probe, read_hdr
from .sampling import draw_uniforms
from .scene_types import Scene
from .tables import build_tables

def internal_size(window, downsample_factor: float, max_pixels: int):
    """The render size the port's ``Renderer`` takes for a window: the
    pixel budget's clamp, then the downsampling's truncating cast."""
    w, h = window
    if w * h > max_pixels:
        ratio = max_pixels / (w * h)
        w, h = max(int(w * ratio), 1), max(int(h * ratio), 1)
    win = (max(w, 1), max(h, 1))
    w, h = int(w * downsample_factor), int(h * downsample_factor)
    return win, (max(w, 1), max(h, 1))


class Session:
    """``config``: the cell's configuration file (its ``render`` and
    ``window``); ``mode``: "pathtrace" or "denoised"; ``accumulate``: the
    settings' accumulate switch. ``lowp``: the control's precision (see
    ``integrator.trace_paths``). ``tables``: another session's tables of
    the same inputs, shared instead of built again. A configuration whose
    ``render`` has ``instancing: true`` is rendered two-level
    (``instanced.py``)."""

    def __init__(self, scene: Scene, hdr: Optional[bytes], config: dict,
                 mode: str, accumulate: bool, seed: int, device,
                 dt: float, lowp: Optional[torch.dtype] = None,
                 tables=None):
        render = config["render"]
        self.render = render
        if mode not in ("pathtrace", "denoised"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.accumulate = accumulate
        self.dt = dt
        self.lowp = lowp
        self.device = torch.device(device)
        max_pixels = render["max_buffer_bytes"] // render["bytes_per_pixel"]
        self.window, self.size = internal_size(
            config["window"], render["downsample_factor"], max_pixels)
        if tables is None:
            scene = copy.copy(scene)
            scene.lights = list(scene.lights)
            scene.fit_default_light(float(config["scene"]["light_intensity"]))
            probe = build_probe(read_hdr(hdr)) if hdr is not None else None
            # ``render.instancing`` (absent: false) asks for the
            # two-level tables, traced through the instance loop.
            build = (build_instanced_tables if render.get("instancing")
                     else build_tables)
            tables = build(scene, probe=probe,
                           atlas_size=render["atlas_size"],
                           device=self.device)
        self.tables = tables
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.drawn = 0  # frames whose numbers the generator has given

    # -- one frame ---------------------------------------------------------
    def view(self, origin, direction):
        """(camera-to-world (4, 4) float32, world-to-screen (4, 4)) of a
        frame whose fly camera stands at ``origin`` facing ``direction``
        with no velocity, as ``Driver.step`` updates it."""
        c = CameraController.from_origin_dir(origin, direction)
        m = c.update(self.dt)
        cam = Camera(np.asarray(m, np.float32), self.size,
                     math.radians(self.render["vfov_deg"]))
        return cam.transform, cam.world_to_screen(self.render["near"],
                                                  self.render["far"])

    def uniforms(self, k: int):
        """Frame ``k``'s random numbers (1-based): the generator is run
        through the frames before it, which must not be behind it."""
        if k <= self.drawn:
            raise ValueError(f"frame {k}'s numbers were drawn already")
        w, h = self.size
        n = self.render["samples_per_frame"] * w * h
        while True:
            u = draw_uniforms(n, self.render["bounces_static"],
                              self.generator, self.device,
                              env=self.tables.has_probe)
            self.drawn += 1
            if self.drawn == k:
                return u
            del u

    def init_state(self) -> RenderState:
        w, h = self.size
        return init_state(w, h, self.device)

    def step(self, prev: RenderState, k: int, camera, prev_camera=None
             ) -> RenderState:
        """Frame ``k`` from the state ``prev`` the frame before left:
        ``camera`` is (origin, direction) of frame ``k``, ``prev_camera``
        that of frame ``k - 1`` (None for the first frame, whose previous
        world-to-screen is the state's own)."""
        if prev_camera is not None:
            prev = replace(prev, prev_world_to_screen=torch.as_tensor(
                self.view(*prev_camera)[1], device=self.device))
        if not self.accumulate:
            prev = replace(prev, frame_count=1)
        cam_t, w2s = self.view(*camera)
        w, h = self.size
        r = self.render
        bounces = r["bounces_static"] if self.accumulate \
            else r["bounces_moving"]
        return render_frame(
            self.tables, prev, torch.as_tensor(cam_t, device=self.device),
            torch.as_tensor(w2s, device=self.device), self.accumulate,
            width=w, height=h, bounces=bounces, nee=r["nee"],
            vfov=math.radians(r["vfov_deg"]), mode=self.mode,
            atrous_iterations=r["atrous_iterations"],
            uniforms=self.uniforms(k), spp=r["samples_per_frame"],
            lowp=self.lowp)

    def image(self, state: RenderState) -> torch.Tensor:
        """The frame's displayed radiance: the running average, or the
        denoiser's output."""
        return state.denoised if self.mode == "denoised" else state.accum

    def blit(self, state: RenderState) -> np.ndarray:
        """(H, W, 3) uint8 at the window size, as ``Renderer.blit``."""
        hw = (self.window[1], self.window[0])
        if hw == (self.size[1], self.size[0]):
            hw = None
        return _blit_rgb(self.image(state), hw,
                         self.render["tonemap"]).cpu().numpy()
