"""Application driver: the app context, headless (counterpart of
``loupiote_tpu/app/driver.py``).

Owns the renderer, scene, settings, camera controller and the frame loop;
drives an offline fly-through (camera path -> frame files) or a viewer
server instead of a window. Entry points run on the card unless the
caller names another device (``device="cpu"`` in the CPU tests).

  - run loop               -> Driver.run_flythrough / step
  - resize clamp           -> config.clamp_size inside Renderer
  - load_blue_noise/env/gltf -> Driver.load_* (.glb / .gltf vs. an HDR
    probe by name or signature, as the reference's file drop)
  - screenshot             -> Driver.save_screenshot (PNG, image_codec)
  - accumulation gating    -> camera.is_static()
  - per-pass timing + FPS  -> spans.recording (each step a frame of
    spans), Renderer.measure_passes
  - Space toggles accumulate -> EditorCommand.TOGGLE_ACCUMULATION
  - shader hot reload      -> Renderer.reload_shaders, polled on the
    mtimes of the kernel modules and csrc/ sources
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np

from .. import _build, spans
from ..config import BlitMode, RenderConfig, Settings
from ..errors import FileNotFound, TextureToBufferReadFail
from ..image_codec import write_png
from ..ops.intersect import uses_bvh2
from ..render import CameraController, Renderer
from ..scene import (Scene, build_scene_buffers, load_binary_from_path,
                     load_gltf, load_gltf_path, load_probe)
from ..scene.blue_noise import generate_blue_noise, load_noise_png
from ..scene.instanced import build_instanced_buffers


class EditorCommand:
    TOGGLE_ACCUMULATION = "toggle_accumulation"


class Driver:
    """Headless application context."""

    def __init__(self, size=(1280, 720), config: Optional[RenderConfig] = None,
                 device="cuda"):
        self.settings = Settings()
        self.settings.blit_mode = BlitMode.DENOISED_PATHTRACE
        self.renderer = Renderer(size, config, device=device)
        self.scene = Scene.default()
        self.probe = None
        # The last measure_passes result and its method.
        self.last_passes: dict = {}
        self.last_pass_method: Optional[str] = None
        # The reference app's default camera.
        d = np.array([1.0, 0.35, 0.0], np.float32)
        self.camera_controller = CameraController.from_origin_dir(
            np.array([-10.0, 1.0, 0.0], np.float32), d / np.linalg.norm(d))
        self.last_time = time.perf_counter()
        self._fps = 0.0
        # Shader-source auto reload: poll the kernel modules' and the
        # csrc/ sources' mtimes each step, throttled, and hot-reload when
        # one changes.
        self._watch_shaders = False
        self._watch_mtimes: dict = {}
        self._watch_last_poll = 0.0

    # -- shader watching ------------------------------------------------------
    def _shader_source_mtimes(self) -> dict:
        import glob
        import sys

        paths = []
        names = (self.renderer._RELOADABLE + self.renderer._REBINDERS)
        for name in names:
            mod = sys.modules.get(name)
            paths.append(getattr(mod, "__file__", None))
        paths += glob.glob(os.path.join(_build.CSRC_DIR, "*.cu*"))
        return {p: os.stat(p).st_mtime_ns for p in paths
                if p and os.path.exists(p)}

    def watch_shaders(self, enabled: bool = True) -> None:
        """Enable/disable auto hot-reload on kernel-source changes."""
        self._watch_shaders = enabled
        if enabled:
            self._watch_mtimes = self._shader_source_mtimes()

    def poll_shader_watch(self, min_interval_s: float = 0.5) -> bool:
        """Check watched sources; reload on change. Returns True if a
        reload fired. Called from step(); callable directly by servers."""
        now = time.perf_counter()
        if now - self._watch_last_poll < min_interval_s:
            return False
        self._watch_last_poll = now
        mtimes = self._shader_source_mtimes()
        if mtimes != self._watch_mtimes:
            self._watch_mtimes = mtimes
            self.renderer.reload_shaders()
            return True
        return False

    # -- loading ---------------------------------------------------------------
    def load_gltf_path(self, path: str) -> None:
        if not os.path.exists(path):
            raise FileNotFound(path)
        load_gltf_path(path, self.scene)

    def load_file(self, data: bytes, name: str = "") -> None:
        """File dispatch like the reference's file drop: .glb / .gltf ->
        scene, else an HDR environment probe."""
        if name.endswith((".glb", ".gltf")) or data[:4] == b"glTF":
            load_gltf(data, self.scene)
        else:
            from ..scene.hdr import build_probe, read_hdr

            self.probe = build_probe(read_hdr(data))

    def load_binary_path(self, path: str) -> None:
        """Raw binary mesh (scene/binary.py's format)."""
        if not os.path.exists(path):
            raise FileNotFound(path)
        load_binary_from_path(path, self.scene)

    def load_env_path(self, path: str) -> None:
        if not os.path.exists(path):
            raise FileNotFound(path)
        self.probe = load_probe(path)

    def load_blue_noise(self, path: Optional[str] = None) -> None:
        noise = load_noise_png(path) if path else generate_blue_noise()
        self.renderer.upload_noise_texture(noise)

    def upload_scene(self) -> None:
        """Build the scene's tables on the renderer's device, bind them and
        keep the scene's stats. ``RenderConfig.instancing`` builds
        upstream's two-level layout (``build_instanced_buffers``: one BLAS
        a mesh under the instance table), else every instance is
        flattened into one BVH. ``bvh_nodes`` is the node count the
        renderer's sort gate reads (a two-level scene's shell: one node);
        a two-level scene's stats add its BLASes, how many take K1 and
        K2 (``ops/intersect.py``'s dispatch) and their summed nodes."""
        self.scene.add_default_light_if_empty()
        build = (build_instanced_buffers if self.renderer.config.instancing
                 else build_scene_buffers)
        bufs = build(self.scene, probe=self.probe,
                     atlas_size=self.renderer.config.atlas_size,
                     device=self.renderer.device)
        self.renderer.set_resources(bufs)
        stats = self.scene.stats()
        stats["bvh_nodes"] = bufs.num_nodes
        if bufs.blas is not None:
            k2 = sum(uses_bvh2(b) for b in bufs.blas)
            stats.update(blas=len(bufs.blas), blas_k1=len(bufs.blas) - k2,
                         blas_k2=k2,
                         blas_nodes=sum(b.num_nodes for b in bufs.blas))
        self.stats = stats

    # -- commands --------------------------------------------------------------
    def run_command(self, command: str) -> None:
        if command == EditorCommand.TOGGLE_ACCUMULATION:
            self.settings.accumulate = not self.settings.accumulate

    # -- frame loop --------------------------------------------------------------
    def step(self, dt: Optional[float] = None) -> None:
        """One frame, under a ``step`` span that opens a new frame of
        spans (``spans.py``)."""
        now = time.perf_counter()
        if dt is None:
            dt = now - self.last_time
        self.last_time = now
        self._fps = 1.0 / max(dt, 1e-6)

        with spans.span("step", new_frame=True):
            if self._watch_shaders:
                self.poll_shader_watch()
            view = self.camera_controller.update(dt)
            if (not self.settings.accumulate
                    or not self.camera_controller.is_static()):
                self.renderer.reset_accumulation()
                self.renderer.accumulate = False
            else:
                self.renderer.accumulate = True
            self.renderer.use_noise_texture(self.settings.use_blue_noise)
            self.renderer.set_blit_mode(self.settings.blit_mode)
            self.renderer.raytrace(view)

    def measure_passes(self) -> dict:
        """Per-pass times for the performance window ("ray generation",
        "primary intersection", "shading N", "asvgf", ...): on the card
        the device times of one profiled frame (method "trace"), else the
        host times of the last frame of the recording that is on (method
        "spans"; Renderer.measure_passes). Kept in ``self.last_passes``
        and ``self.last_pass_method``, and returned."""
        view = self.camera_controller.update(0.0)
        out = self.renderer.measure_passes(view)
        self.last_passes = out
        self.last_pass_method = out.get("method")
        return out

    def save_screenshot(self, path: str) -> None:
        """PNG screenshot at window resolution."""
        rgba = np.frombuffer(self.renderer.read_pixels(), np.uint8)
        w, h = self.renderer.window_size
        try:
            write_png(path, rgba.reshape(h, w, 4))
        except OSError as e:
            raise TextureToBufferReadFail(
                f"screenshot write failed: {path}: {e}") from e

    @property
    def fps(self) -> float:
        return self._fps

    # -- offline fly-through --------------------------------------------------
    def run_flythrough(self, waypoints: List[np.ndarray], frames_per_leg: int,
                       out_dir: Optional[str] = None,
                       spp_at_rest: int = 1) -> List[np.ndarray]:
        """Fly the camera through origin waypoints, dumping one frame per
        step. Returns the frames (and writes PNGs when out_dir given).

        ``spp_at_rest``: extra accumulation steps taken whenever the camera
        holds still this frame (the last frame of each leg, and any leg with
        coincident endpoints) — the offline analog of the reference's
        free-running accumulation while the camera is static.
        """
        frames = []
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        idx = 0
        for a, b in zip(waypoints[:-1], waypoints[1:]):
            for f in range(frames_per_leg):
                t = f / max(frames_per_leg - 1, 1)
                prev = self.camera_controller.origin.copy()
                self.camera_controller.origin = (
                    np.asarray(a) * (1 - t) + np.asarray(b) * t).astype(np.float32)
                moved = not np.array_equal(prev, self.camera_controller.origin)
                self.step(dt=1.0 / 60.0)
                if not moved and self.settings.accumulate:
                    for _ in range(max(spp_at_rest - 1, 0)):
                        self.step(dt=1.0 / 60.0)
                img = self.renderer.blit()
                frames.append(img)
                if out_dir:
                    write_png(os.path.join(out_dir, f"frame_{idx:04d}.png"),
                              img)
                idx += 1
        return frames
