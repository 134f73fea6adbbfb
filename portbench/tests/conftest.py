"""Shared set-up of the benchmark's own tests (``python -m pytest
portbench/tests``): the repository's root on ``sys.path``, the ``card``
marker, and small cells for CPU runs of the harness."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the kernels on the card")
    return torch.device("cuda")


def small_cell(name: str, triangles: int = 100_000, scale: int = 1):
    """The cell ``name`` at a CPU size: its scene's triangle budget (over
    the integrator's 16,384-node sort gate at 100,000), a window of 128 x
    64 internal pixels (8 x 128 tiles) times ``scale``, a 64 x 128 sky."""
    from portbench.harness.cells import find_cell

    cell = find_cell(name)
    cfg = cell.config
    cfg["scene"]["triangles"] = triangles
    f = cfg["render"]["downsample_factor"]
    cfg["window"] = [int(128 * scale / f), int(64 * scale / f)]
    if cfg["scene"].get("sky"):
        cfg["scene"]["sky"] = {"height": 64, "width": 128}
    return cell


def two_level_cell(name: str, **small):
    """The cell ``name`` at a CPU size (``small_cell``'s keywords) with its
    configuration asking for the two-level scene (``render.instancing``);
    without ``small``, at its own size."""
    from portbench.harness.cells import find_cell

    cell = small_cell(name, **small) if small else find_cell(name)
    cell.config["render"]["instancing"] = True
    return cell


def two_level_frames(cell, seed: int, device, window_frames: int = 3):
    """The program's frames of ``cell`` on two-level buffers: the app's
    ``Driver`` built as a run builds it (its configuration less
    ``instancing``, which the port's settings do not take), its renderer
    bound to ``build_instanced_buffers`` of the loaded scene, then the
    traffic's warm-up frames and ``window_frames`` flight frames, each
    ``Driver.step`` + ``Renderer.blit``. Returns (warm-up captures,
    window captures, each window frame's ms)."""
    import copy
    import dataclasses
    import time

    import torch

    from loupiote_tpu_torch.scene.instanced import build_instanced_buffers
    from portbench.harness import program, runner

    cfg = copy.deepcopy(cell.config)
    cfg["render"].pop("instancing", None)
    scene, hdr = runner.make_inputs(cell, seed)
    session = program.build(dataclasses.replace(cell, config=cfg), scene,
                            hdr, seed, device)
    d = session.driver
    d.renderer.set_resources(build_instanced_buffers(
        d.scene, probe=d.probe, atlas_size=d.renderer.config.atlas_size,
        device=d.renderer.device))
    for _ in range(int(cell.traffic["warmup_frames"])):
        session.captured_frame()
    warm = list(session.captures)
    session.captures.clear()
    ms = []
    for _ in range(window_frames):
        t0 = time.perf_counter()
        session.captured_frame()
        ms.append((time.perf_counter() - t0) * 1e3)
    window = list(session.captures)
    del session, d
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return warm, window, ms


def judged(cell, seed: int, device, warm, window) -> dict:
    """The comparison's numbers of captured frames against the reference
    of ``cell``'s configuration."""
    import torch

    from portbench.harness import inputs, judge, runner
    from portbench.reference.session import Session

    traffic = cell.traffic
    scene, hdr = runner.make_inputs(cell, seed)
    ref = Session(scene, hdr, cell.config, traffic["mode"],
                  bool(traffic["accumulate"]), seed, torch.device(device),
                  float(traffic["dt"]))
    return judge.judge(ref, warm, window,
                       inputs.CameraPath(traffic["camera"], seed))
