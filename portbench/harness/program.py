"""The program under test, driven as a user's session drives it: the
app's ``Driver`` built with its loaders, then frames of ``Driver.step``
followed by ``Renderer.blit``, each started when the previous frame's
image is on the host (one user, a closed loop).

The harness holds a reference to the renderer's state before and after
the frames it checks: the renderer replaces its state each frame and
writes none of it in place, so holding it costs no copy.
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import inputs


@dataclass
class Capture:
    """One frame the comparison checks: its number, the renderer's state
    before and after it, and the image ``blit`` returned."""

    k: int
    before: object
    after: object
    blit: np.ndarray


@dataclass
class Session:
    driver: object
    path: inputs.CameraPath
    dt: float
    scene_build_s: float
    frames: int = 0  # frames rendered so far
    captures: list = field(default_factory=list)

    def frame(self) -> np.ndarray:
        """The next frame: the camera set, ``step``, ``blit``."""
        self.frames += 1
        origin, direction = self.path.at(self.frames)
        cc = self.driver.camera_controller
        cc.origin = origin
        cc.direction = direction
        self.driver.step(dt=self.dt)
        return self.driver.renderer.blit()

    def captured_frame(self) -> np.ndarray:
        before = self.driver.renderer.state
        img = self.frame()
        self.captures.append(Capture(self.frames, before,
                                     self.driver.renderer.state, img))
        return img


def build(cell, scene, hdr: Optional[bytes], seed: int, device) -> Session:
    """The ``Driver`` of ``cell`` on ``device``: the scene written as GLB
    and the sky as ``.hdr`` into a scratch directory, read back by the
    app's loaders; the light fitted to the scene as the CLI's
    ``--fit-light``; the tables uploaded; the renderer's generator seeded
    with ``seed``. ``scene_build_s``: host seconds of the loaders and the
    upload."""
    import torch

    from loupiote_tpu_torch.app import Driver
    from loupiote_tpu_torch.config import BlitMode, RenderConfig

    cfg, traffic = cell.config, cell.traffic
    driver = Driver(size=tuple(cfg["window"]),
                    config=RenderConfig(**cfg["render"]), device=device)
    glb = inputs.scene_glb(scene)
    with tempfile.TemporaryDirectory() as tmp:
        glb_path = os.path.join(tmp, "scene.glb")
        with open(glb_path, "wb") as f:
            f.write(glb)
        hdr_path = None
        if hdr is not None:
            hdr_path = os.path.join(tmp, "sky.hdr")
            with open(hdr_path, "wb") as f:
                f.write(hdr)
        dev = torch.device(device)
        t0 = time.perf_counter()
        driver.load_gltf_path(glb_path)
        if hdr_path is not None:
            driver.load_env_path(hdr_path)
        driver.scene.fit_default_light(float(cfg["scene"]["light_intensity"]))
        driver.upload_scene()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        scene_build_s = time.perf_counter() - t0
    driver.renderer.generator.manual_seed(seed)
    driver.settings.blit_mode = {
        "pathtrace": BlitMode.PATHTRACE,
        "denoised": BlitMode.DENOISED_PATHTRACE}[traffic["mode"]]
    driver.settings.accumulate = bool(traffic["accumulate"])
    driver.settings.use_blue_noise = False
    return Session(driver=driver, path=inputs.CameraPath(traffic["camera"],
                                                         seed),
                   dt=float(traffic["dt"]), scene_build_s=scene_build_s)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profiled(session: Session, frames: int, cpu: bool, device):
    """(events, wall seconds) of ``frames`` frames under ``torch.profiler``
    (CUDA activity, and CPU activity where ``cpu``), after one traced
    frame that the schedule drops: a second profiler session in one
    process has missed its first kernels on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] if torch.device(device).type == "cuda" \
        else []
    if cpu or not acts:
        acts.append(ProfilerActivity.CPU)
    got = []
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=frames),
                 on_trace_ready=lambda p: got.extend(p.events())) as prof:
        session.frame()
        _sync(device)
        prof.step()
        t0 = time.perf_counter()
        for i in range(frames):
            session.frame()
            _sync(device)
            if i == frames - 1:
                # The last step hands the trace over: not the frames' time.
                wall = time.perf_counter() - t0
            prof.step()
    return got, wall
