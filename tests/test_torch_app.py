"""The port's app layer (loupiote_tpu_torch/app/, render/camera.py's
controller, the CLI, measure_passes, reload_shaders, the lightmap bake)
against the reference's on the CPU (the port's kernels run their twins).

Standards:
- CameraController: view matrices within 1e-6 of the reference's over a
  scripted run of commands, drags and time steps; is_static equal.
- Driver: the port's and the reference's on the same in-memory arch-20k
  glb, 8 accumulated pathtrace frames at 64x64: PSNR > 26 dB of the
  linear radiance (peak the reference's maximum) and mean within 3% (the
  golden gate's standards and measure: the two RNGs differ).
- Checkpoints: every shared frame-state field equal after a round trip
  in either direction (the reference's PRNG key and the port's generator
  are the packages' own).
- Lightmap: the port's bake on the reference's replayed random draws,
  64 points of arch-8k: within 1e-4 relative on 99% of the points, mean
  within 1e-4.
"""

import json
import os
import subprocess
import sys
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import loupiote_tpu_torch as lt
from loupiote_tpu_torch import __main__ as cli
from loupiote_tpu_torch.app import Driver, EditorCommand, checkpoint, gui
from loupiote_tpu_torch.app import trace_parse as tp
from loupiote_tpu_torch.app.server import ViewerServer
from loupiote_tpu_torch.app.timing import Queries
from loupiote_tpu_torch.render import CameraController
from loupiote_tpu_torch.render.camera import CameraMoveCommand
from loupiote_tpu_torch.scene.fixtures import write_glb
from torch_port_helpers import numpy_bvh, psnr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HALL_ORIGIN = np.array([0.0, 5.0, 34.0], np.float32)
HALL_DIR = np.array([0.15, -0.12, -1.0], np.float32) / np.linalg.norm(
    np.array([0.15, -0.12, -1.0], np.float32))


@pytest.fixture(scope="module")
def hall_glb(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("app") / "arch20k.glb")
    write_glb(lt.build_arch_scene(20_000), path)
    return path


def port_driver(size, glb, mode=lt.BlitMode.PATHTRACE, **cfg):
    d = Driver(size, lt.RenderConfig(**cfg), device="cpu")
    d.load_gltf_path(glb)
    d.scene.fit_default_light(10.0)
    d.upload_scene()
    d.camera_controller = CameraController.from_origin_dir(HALL_ORIGIN,
                                                           HALL_DIR)
    d.settings.blit_mode = mode
    return d


# -- the camera controller ------------------------------------------------------

def test_camera_controller_matches_reference():
    from loupiote_tpu.render.camera import CameraController as RefCC
    from loupiote_tpu.render.camera import CameraMoveCommand as RefCmd

    assert (RefCmd.FORWARD, RefCmd.LEFT) == (CameraMoveCommand.FORWARD,
                                             CameraMoveCommand.LEFT)
    rng = np.random.default_rng(9)
    a = RefCC.from_origin_dir(HALL_ORIGIN, HALL_DIR)
    b = CameraController.from_origin_dir(HALL_ORIGIN, HALL_DIR)
    cmds = [CameraMoveCommand.FORWARD, CameraMoveCommand.BACKWARD,
            CameraMoveCommand.LEFT, CameraMoveCommand.RIGHT]
    for step in range(60):
        roll = rng.random()
        if roll < 0.2:
            c = int(rng.choice(cmds))
            a.set_command(c)
            b.set_command(c)
        elif roll < 0.35:
            c = int(rng.choice(cmds))
            a.unset_command(c)
            b.unset_command(c)
        elif roll < 0.45:
            a.rotation_enabled = b.rotation_enabled = bool(rng.random() < .7)
        elif roll < 0.7:
            dx, dy = rng.normal(size=2) * 5
            a.rotate(dx, dy)
            b.rotate(dx, dy)
        dt = float(rng.choice([0.0, 1 / 60, 1 / 30, 0.1]))
        va, vb = a.update(dt), b.update(dt)
        np.testing.assert_allclose(vb, va, atol=1e-6, rtol=0)
        assert a.is_static() == b.is_static()
    assert not np.allclose(b.origin, HALL_ORIGIN)


# -- the Driver -------------------------------------------------------------------

def _psnr(a, b):
    mse = ((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean()
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


def test_driver_matches_reference_driver(hall_glb):
    """8 accumulated pathtrace frames of the same glb, camera and light."""
    from loupiote_tpu.app import Driver as RefDriver
    from loupiote_tpu.config import BlitMode as RefMode
    from loupiote_tpu.config import RenderConfig as RefConfig
    from loupiote_tpu.render import CameraController as RefCC

    ref = RefDriver(size=(64, 64), config=RefConfig(downsample_factor=1.0))
    ref.load_gltf_path(hall_glb)
    ref.scene.fit_default_light(10.0)
    with numpy_bvh():
        ref.upload_scene()
    ref.camera_controller = RefCC.from_origin_dir(HALL_ORIGIN, HALL_DIR)
    ref.settings.blit_mode = RefMode.PATHTRACE
    port = port_driver((64, 64), hall_glb, downsample_factor=1.0)
    for d in (ref, port):
        d.settings.accumulate = True
        for _ in range(8):
            d.step(dt=1.0 / 60.0)
    assert port.renderer.frame_count == 9
    # The gate's measure: linear radiance, peak the reference's maximum.
    a = np.asarray(ref.renderer.state.accum)
    b = port.renderer.accum.numpy()
    assert a.shape == b.shape == (64, 64, 3)
    assert psnr(b, a) > 26.0
    assert abs(b.mean() / a.mean() - 1.0) < 0.03
    assert ref.renderer.blit().shape == port.renderer.blit().shape
    assert ref.stats["triangles"] == port.stats["triangles"]


def test_driver_defaults_gating_and_toggle(hall_glb):
    d = Driver((48, 32), device="cpu")
    assert d.settings.blit_mode == lt.BlitMode.DENOISED_PATHTRACE
    assert not d.settings.accumulate
    np.testing.assert_array_equal(d.camera_controller.origin,
                                  [-10.0, 1.0, 0.0])
    assert d.renderer.window_size == (48, 32) and d.renderer.size == (24, 16)
    d.load_gltf_path(hall_glb)
    d.upload_scene()
    assert d.stats["bvh_nodes"] > 0 and d.stats["triangles"] > 19_000
    d.settings.blit_mode = lt.BlitMode.PATHTRACE
    d.step(dt=0.1)  # accumulate off: every frame restarts the average
    d.step(dt=0.1)
    assert d.renderer.frame_count == 1 and not d.renderer.accumulate
    d.run_command(EditorCommand.TOGGLE_ACCUMULATION)
    assert d.settings.accumulate
    d.step(dt=0.1)
    d.step(dt=0.1)
    assert d.renderer.frame_count == 3 and d.renderer.accumulate
    d.camera_controller.set_command(CameraMoveCommand.FORWARD)
    d.step(dt=0.1)  # moving: gated off
    assert d.renderer.frame_count == 1 and not d.renderer.accumulate
    d.camera_controller.unset_command(CameraMoveCommand.FORWARD)
    assert d.fps > 0 and d.queries.frame_ms > 0
    assert "raytrace" in d.queries.labels()
    status = gui.render_status(d)
    assert "fps" in status and "tris" in status
    assert gui.toolbar_state(d.settings)["blit_mode"] == "pathtrace"
    assert gui.scene_info_window(d)["adapter"]["platform"] == "cpu"


def test_driver_screenshot_flythrough_and_errors(hall_glb, tmp_path):
    from loupiote_tpu_torch.image_codec import read_png

    d = port_driver((40, 24), hall_glb)
    d.step(dt=1 / 60)
    shot = str(tmp_path / "shot.png")
    d.save_screenshot(shot)
    img = read_png(shot)
    assert img.shape == (24, 40, 4) and (img[..., 3] == 255).all()
    frames = d.run_flythrough([HALL_ORIGIN, HALL_ORIGIN + [0, 0, -2]], 3,
                              out_dir=str(tmp_path / "fly"))
    assert len(frames) == 3
    assert sorted(os.listdir(tmp_path / "fly")) == [
        f"frame_{i:04d}.png" for i in range(3)]
    assert read_png(str(tmp_path / "fly" / "frame_0002.png"))[..., :3] \
        .tobytes() == frames[2].tobytes()
    with pytest.raises(lt.FileNotFound):
        d.load_gltf_path(str(tmp_path / "missing.glb"))
    with pytest.raises(lt.FileNotFound):
        d.load_env_path(str(tmp_path / "missing.hdr"))
    with pytest.raises(lt.TextureToBufferReadFail):
        d.save_screenshot(str(tmp_path / "no" / "such" / "dir.png"))
    assert issubclass(lt.TextureToBufferReadFail, lt.Error)


def test_driver_loads_files_by_kind(hall_glb, tmp_path):
    from loupiote_tpu_torch.scene.hdr import float_to_rgbe

    d = Driver((16, 16), device="cpu")
    with open(hall_glb, "rb") as f:
        d.load_file(f.read(), "hall.glb")
    assert len(d.scene.meshes) > 0
    rad = np.full((8, 16, 3), 0.5, np.float32)
    hdr = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 8 +X 16\n"
           + float_to_rgbe(rad).tobytes())
    d.load_file(hdr, "sky.hdr")
    assert d.probe is not None
    d.load_blue_noise()
    assert d.renderer.noise_texture is not None
    d.upload_scene()
    assert d.renderer.scene.has_probe


# -- the CLI -----------------------------------------------------------------------

def test_cli_info_render_and_multi_scene(hall_glb, tmp_path, capsys):
    from loupiote_tpu_torch.image_codec import read_png

    cli.main(["info", hall_glb])
    info = json.loads(capsys.readouterr().out)
    assert info["triangles"] > 19_000
    out = str(tmp_path / "r.png")
    cli.main(["render", hall_glb, out, "--size", "32x16", "--scale", "1.0",
              "--spp", "2", "--mode", "pathtrace", "--fit-light", "10",
              "--camera", "0,5,34,0.15,-0.12,-1", "--device", "cpu"])
    assert "ms a frame" in capsys.readouterr().out
    img = read_png(out)
    assert img.shape == (16, 32, 4) and (img[..., :3] > 0).any()
    # Two scenes in one session, the second moved by (5, 0, 0), through
    # main(argv): the driver is caught where it saves the image.
    seen = []
    real_save = Driver.save_screenshot

    def save(self, path):
        seen.append(self)
        real_save(self, path)

    Driver.save_screenshot = save
    try:
        cli.main(["render", hall_glb, hall_glb + "@5,0,0", out, "--size",
                  "16x16", "--spp", "1", "--bounces", "1", "--mode",
                  "gbuffer", "--device", "cpu"])
    finally:
        Driver.save_screenshot = real_save
    d = seen[0]
    n = len(d.scene.instances) // 2
    np.testing.assert_array_equal(
        d.scene.instances[n].model_to_world[:3, 3]
        - d.scene.instances[0].model_to_world[:3, 3], [5, 0, 0])
    assert d.settings.blit_mode == lt.BlitMode.GBUFFER
    assert d.renderer.config.bounces_static == 1
    fly = tmp_path / "fly"
    cli.main(["flythrough", hall_glb, str(fly), "--frames", "2", "--size",
              "16x8", "--bounces", "1", "--device", "cpu"])
    assert len(os.listdir(fly)) == 2


def test_cli_runs_as_a_module(hall_glb):
    proc = subprocess.run([sys.executable, "-m", "loupiote_tpu_torch",
                           "info", hall_glb], cwd=REPO, capture_output=True,
                          text=True, timeout=300, check=True)
    assert json.loads(proc.stdout)["meshes"] > 0
    bad = subprocess.run([sys.executable, "-m", "loupiote_tpu_torch",
                          "render"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert bad.returncode != 0


# -- measure_passes and the trace parser -----------------------------------------

def test_measure_passes_reports_the_reference_labels():
    d = Driver((32, 16), lt.RenderConfig(downsample_factor=1.0,
                                         bounces_static=2, bounces_moving=2),
               device="cpu")
    d.scene = lt.build_arch_scene(2_000)
    d.upload_scene()
    d.camera_controller = CameraController.from_origin_dir(HALL_ORIGIN,
                                                           HALL_DIR)
    d.settings.blit_mode = lt.BlitMode.PATHTRACE
    d.settings.accumulate = True
    d.step(dt=1 / 60)
    before = (d.renderer.frame_count, d.renderer.generator.get_state())
    out = d.measure_passes()
    labels = tp.frame_scope_labels(2)
    # No device time on the CPU: "auto" falls back to the replay.
    assert out["method"] == d.last_pass_method == "replay"
    assert all(out[lab] >= 0 for lab in labels.values())
    assert out["frame (fused)"] > 0
    assert abs(sum(out[lab] for lab in labels.values())
               - out["frame (fused)"]) < 1e-6 * out["frame (fused)"] + 1e-9
    assert set(labels.values()) <= set(d.queries.labels())
    # The measured frames do not advance the session.
    assert d.renderer.frame_count == before[0]
    assert torch.equal(d.renderer.generator.get_state(), before[1])
    d.renderer.set_blit_mode(lt.BlitMode.DENOISED_PATHTRACE)
    traced = d.renderer.measure_passes(d.camera_controller.update(0.0),
                                       method="trace")
    assert traced["method"] == "trace"
    assert set(tp.frame_scope_labels(2, denoised=True).values()) <= set(
        traced)
    assert gui.performance_window(d)["pass_timing_method"] == "replay"


def _evt(name, eid, parent=None, device=None, ms=0.0, kind=None):
    """A torch.profiler FunctionEvent's fields that the parser reads."""
    return SimpleNamespace(
        name=name, id=eid, cpu_parent=parent,
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        activity_type=kind,
        time_range=SimpleNamespace(start=0.0, end=ms * 1e3))


def test_attribute_passes_counts_the_nested_shadow_range_once():
    """Kernels reach the ranges through the runtime call that launched
    them (same id)."""
    frame = _evt("frame", 1)
    shade = _evt("shade1", 2, frame)
    shadow = _evt("shadow", 3, shade)
    add = _evt("aten::add", 4, shade)
    occl = _evt("aten::index", 5, shadow)  # a torch op in the wave
    intersect = _evt("intersect1", 6, frame)
    other_op = _evt("aten::mul", 7, frame)
    events = [frame, shade, shadow, add, occl, intersect, other_op,
              # runtime calls: torch ops', then two ctypes launches
              _evt("cudaLaunchKernel", 100, add),
              _evt("cudaLaunchKernel", 101, shadow),
              _evt("cudaLaunchKernel", 102, occl),
              _evt("cuLaunchKernel", 103, intersect),
              _evt("cudaMemcpyAsync", 104, other_op),
              _evt("elementwise_kernel", 100, device=True, ms=2.0),
              _evt("wide_trace_kernel", 101, device=True, ms=5.0),
              _evt("index_kernel", 102, device=True, ms=1.0),
              _evt("wide_trace_kernel", 103, device=True, ms=0.5),
              _evt("Memcpy DtoH", 104, device=True, ms=0.25),
              # its runtime call is not in the trace
              _evt("unlinked_kernel", 105, device=True, ms=0.125),
              # the device's copy of a range is not an activity
              _evt("shade1", 106, device=True, ms=9.0,
                   kind="gpu_user_annotation"),
              _evt("shadow", 107, device=True, ms=9.0),
              _evt("ProfilerStep#1", 108, device=True, ms=20.0)]
    labels = tp.frame_scope_labels(2)
    sums = tp.attribute_passes(events, labels)
    assert sums["shadow 1"] == 6.0
    assert sums["shading 1"] == 2.0
    assert sums["intersection 1"] == 0.5
    assert sums["other"] == 0.375
    assert sum(sums.values()) == 8.875
    assert tp.matched_share(sums) == pytest.approx(8.5 / 8.875)
    assert list(labels)[:4] == ["raygen", "intersect0", "shade0/shadow",
                                "shade0"]


def test_queries_and_profiler_trace(tmp_path):
    from loupiote_tpu_torch.app.timing import profiler_trace

    q = Queries(max_queries=2, sync=True)
    q.start_frame()
    with q.scope("a"):
        pass
    q.start("b")
    q.end(torch.ones(3))
    q.record("c", 1.5)  # past max_queries: dropped
    q.resolve()
    q.end_frame()
    assert q.labels() == ["a", "b"] and q.frame_ms >= 0
    with profiler_trace(str(tmp_path / "trace")) as prof:
        torch.ones(4) + 1
    assert prof is not None
    assert os.path.exists(tmp_path / "trace" / "trace.json")


# -- hot reload ----------------------------------------------------------------------

@pytest.fixture()
def small_renderer(hall_glb):
    d = port_driver((32, 16), hall_glb, mode=lt.BlitMode.DENOISED_PATHTRACE,
                    downsample_factor=1.0)
    return d.renderer


def test_reload_rebinds_every_importer(small_renderer):
    r = small_renderer
    rmod = sys.modules["loupiote_tpu_torch.render.renderer"]
    old_trace = rmod.trace_paths
    r.reload_shaders()
    assert r.last_reload_error is None
    oi = sys.modules["loupiote_tpu_torch.ops.intersect"]
    osh = sys.modules["loupiote_tpu_torch.ops.shade"]
    integ = sys.modules["loupiote_tpu_torch.render.integrator"]
    den = sys.modules["loupiote_tpu_torch.denoise.asvgf"]
    tl = sys.modules["loupiote_tpu_torch.treelet.pipeline"]
    assert rmod.trace_paths is not old_trace
    assert integ.intersect_any is oi.intersect_any
    assert integ.shade_step is osh.shade_step
    assert rmod.trace_paths is integ.trace_paths
    assert rmod.accumulate is integ.accumulate
    assert rmod.denoise is den.denoise
    assert lt.trace_paths is integ.trace_paths
    assert lt.render.trace_paths is integ.trace_paths
    assert lt.denoise.denoise is den.denoise
    assert sys.modules["loupiote_tpu_torch.treelet"].treelet_intersect \
        is tl.treelet_intersect


def test_reload_keeps_the_old_pipeline_on_error(small_renderer, monkeypatch):
    import importlib

    r = small_renderer
    rmod = sys.modules["loupiote_tpu_torch.render.renderer"]
    integ = sys.modules["loupiote_tpu_torch.render.integrator"]
    before = (rmod.trace_paths, integ.intersect_any, lt.trace_paths)
    real = importlib.reload

    def reload(mod):
        if mod.__name__ == "loupiote_tpu_torch.ops.tonemap":
            raise SyntaxError("synthetic kernel module error")
        return real(mod)

    monkeypatch.setattr(importlib, "reload", reload)
    r.reload_shaders()
    assert "synthetic" in r.last_reload_error
    assert (rmod.trace_paths, integ.intersect_any, lt.trace_paths) == before
    assert integ.intersect_any is sys.modules[
        "loupiote_tpu_torch.ops.intersect"].intersect_any
    monkeypatch.undo()
    r.reload_shaders()
    assert r.last_reload_error is None


def test_frame_after_reload_equals_frame_before(small_renderer):
    r = small_renderer
    view = lt.arch_camera()
    gs, st = r.generator.get_state(), r.state
    r.raytrace(view)
    a = r.state.denoised.clone()
    r.reload_shaders()
    assert r.last_reload_error is None
    r.generator.set_state(gs)
    r.state = st
    r.raytrace(view)
    assert torch.equal(a, r.state.denoised)
    r.enable_aot_cache()  # kept as API, does nothing


@pytest.mark.parametrize("nodes, treelet, want", [
    (8191, False, ["bvh2_traverse"]),
    (8192, False, ["wide_traverse"]),
    (8191, True, ["bvh2_traverse", "treelet_traverse", "slab_sort",
                  "regroup"]),
    (8192, True, ["wide_traverse", "treelet_traverse", "slab_sort",
                  "regroup"])])
def test_path_libraries_follow_the_dispatch(nodes, treelet, want):
    """The libraries reload_shaders rebuilds on the card are the
    dispatch's: K2 / K3 below 8,192 BVH2 nodes, K1 from there on, and the
    treelet traversal's E6 / E7, K4 and E5 beside them; each a source in
    csrc/."""
    from loupiote_tpu_torch import _build
    from loupiote_tpu_torch.ops.intersect import path_libraries

    scene = SimpleNamespace(num_nodes=nodes,
                            treelet=object() if treelet else None)
    assert path_libraries(scene) == want
    for name in want:
        assert os.path.exists(os.path.join(_build.CSRC_DIR, name + ".cu"))


# -- checkpoints ----------------------------------------------------------------------

def _filled(renderer):
    """A renderer whose state fields hold distinct values."""
    rng = np.random.default_rng(11)
    st = renderer.state
    new = {}
    for f in st.__dataclass_fields__:
        v = getattr(st, f)
        if isinstance(v, torch.Tensor):
            new[f] = torch.from_numpy(
                rng.integers(-5, 5, tuple(v.shape)).astype(
                    v.numpy().dtype))
    import dataclasses
    renderer.state = dataclasses.replace(st, frame_count=7, **new)
    renderer.accumulate = True
    renderer.mode = lt.BlitMode.TEMPORAL
    torch.rand(5, generator=renderer.generator)
    return renderer


@pytest.mark.parametrize("fmt", ["npz", "torch"])
def test_checkpoint_round_trip(tmp_path, fmt):
    a = _filled(lt.Renderer((24, 16), device="cpu"))
    save, load = ((checkpoint.save_session, checkpoint.load_session)
                  if fmt == "npz" else (checkpoint.save_session_torch,
                                        checkpoint.load_session_torch))
    save(str(tmp_path), a)
    b = lt.Renderer((24, 16), device="cpu")
    load(str(tmp_path), b)
    for f in a.state.__dataclass_fields__:
        x, y = getattr(a.state, f), getattr(b.state, f)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), f
    assert b.accumulate and b.mode == lt.BlitMode.TEMPORAL
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    manifest, frames = checkpoint.checkpoint_info(str(tmp_path))
    assert manifest["version"] == 1 and frames == 7
    with pytest.raises(ValueError, match="size"):
        load(str(tmp_path), lt.Renderer((32, 16), device="cpu"))


def test_checkpoints_load_across_packages(tmp_path):
    import jax.numpy as jnp

    from loupiote_tpu.app import checkpoint as ref_ckpt
    from loupiote_tpu.render import Renderer as RefRenderer

    shared = [f for f in lt.render.RenderState.__dataclass_fields__]
    # The reference's checkpoint into the port.
    ref = RefRenderer((24, 16))
    rng = np.random.default_rng(12)
    ref.state = ref.state.replace(**{
        f: jnp.asarray(rng.random(np.shape(getattr(ref.state, f)))
                       .astype(np.float32))
        for f in ("accum", "gb_depth", "asvgf_illum", "denoised")},
        frame_count=jnp.int32(4))
    ref.accumulate = True
    ref_ckpt.save_session(str(tmp_path / "ref"), ref)
    port = lt.Renderer((24, 16), device="cpu")
    checkpoint.load_session(str(tmp_path / "ref"), port)
    for f in shared:
        x = np.asarray(getattr(ref.state, f))
        y = getattr(port.state, f)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.tobytes() == y.astype(x.dtype).tobytes(), f
    assert port.frame_count == 4 and port.accumulate
    # The port's checkpoint into the reference.
    _filled(port)
    checkpoint.save_session(str(tmp_path / "port"), port)
    back = RefRenderer((24, 16))
    ref_ckpt.load_session(str(tmp_path / "port"), back)
    for f in shared:
        y = getattr(port.state, f)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        x = np.asarray(getattr(back.state, f))
        assert x.tobytes() == y.astype(x.dtype).tobytes(), f
    assert back.mode.value == port.mode.value


# -- the viewer server ------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, dict(r.headers), r.read()


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status


def test_viewer_server_on_loopback(hall_glb, tmp_path):
    d = port_driver((32, 16), hall_glb, mode=lt.BlitMode.DENOISED_PATHTRACE)
    shots = tmp_path / "shots"
    srv = ViewerServer(d, port=0, max_fps=200.0,
                       screenshot_dir=str(shots)).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        status, _, page = _get(base + "/")
        assert status == 200 and b"<img" in page
        ids = []
        for _ in range(3):
            _, hdr, body = _get(f"{base}/frame?after={ids[-1] if ids else -1}")
            assert body[:2] == b"\xff\xd8" and body[-2:] == b"\xff\xd9"
            ids.append(int(hdr["X-Frame-Id"]))
        assert ids == sorted(set(ids))
        origin = d.camera_controller.origin.copy()
        assert _post(base + "/input", {"type": "key", "key": "w",
                                       "pressed": True}) == 200
        for _ in range(3):
            _, hdr, _ = _get(f"{base}/frame?after={ids[-1]}")
            ids.append(int(hdr["X-Frame-Id"]))
        _post(base + "/input", {"type": "key", "key": "w", "pressed": False})
        assert not np.array_equal(d.camera_controller.origin, origin)
        _post(base + "/input", {"type": "setting", "name": "blit_mode",
                                "value": "gbuffer"})
        _post(base + "/input", {"type": "command",
                                "command": EditorCommand.TOGGLE_ACCUMULATION})
        _post(base + "/input", {"type": "setting", "name": "nonsense",
                                "value": 1})
        # A client-supplied path is ignored: the shot lands in the
        # server's own directory.
        outside = tmp_path / "outside.png"
        _post(base + "/input", {"type": "screenshot", "path": str(outside)})
        for _ in range(3):
            _, hdr, _ = _get(f"{base}/frame?after={ids[-1]}")
            ids.append(int(hdr["X-Frame-Id"]))
        stats = json.loads(_get(base + "/stats")[2])
        assert stats["triangles"] > 19_000 and stats["fps"] > 0
        assert stats["blit_mode"] == "gbuffer" and stats["accumulate"]
        assert d.renderer.mode == lt.BlitMode.GBUFFER
        assert not hasattr(d.settings, "nonsense")
        assert not outside.exists()
        assert [p.suffix for p in shots.iterdir()] == [".png"]
        assert set(srv.loop_ms) == {"step", "blit", "encode"}
        with pytest.raises(urllib.error.HTTPError):
            _get(base + "/nothing")
    finally:
        srv.stop()
    assert srv.render_error is None


# -- the device and the lightmap bake --------------------------------------------------

def test_device_on_the_cpu_and_without_a_card():
    dev = lt.Device(device="cpu")
    info = dev.adapter_info()
    assert info["platform"] == "cpu" and dev.kind == "cpu"
    assert dev.memory_stats() == {} and dev.unwrap().type == "cpu"
    assert dev.default_textures.noise.shape == (1, 1, 4)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            lt.Device()


def test_lightmap_bake_matches_reference():
    """The reference's bake of 64 points of arch-8k, its jax.random draws
    replayed into the port's (as the frame tests replay them): irradiance
    equal within the frame tests' 1e-4 relative on 99% of the points and
    the mean within 1e-4 (the reference's XLA code contracts
    multiply-adds, so a shadow ray may flip)."""
    import jax.numpy as jnp
    import jax.random as jr

    from loupiote_tpu.ops.lightmap import bake_vertex_irradiance as ref_bake
    from loupiote_tpu.scene import build_scene_buffers as ref_buffers
    from loupiote_tpu.scene.procedural import build_arch_scene as ref_arch
    from loupiote_tpu_torch.ops.lightmap import bake_vertex_irradiance
    from loupiote_tpu_torch.ops.sampling import FrameUniforms
    from torch_port_helpers import step_uniforms

    with numpy_bvh():
        ref = ref_buffers(ref_arch(8_000))
    port = lt.from_reference(ref, device="cpu")
    tp_ = port.tri_pack
    real = torch.nonzero(tp_[:, 0].abs() < 1e29).flatten()
    V, samples, bounces = 64, 2, 2
    pick = real[torch.linspace(0, len(real) - 1, V).long()]
    pos = tp_[pick, 0:3] + (tp_[pick, 3:6] + tp_[pick, 6:9]) / 3.0
    nrm = port.tri_shade[pick, 17:20]
    key = jr.PRNGKey(1)
    want = np.asarray(ref_bake(ref, jnp.asarray(pos.numpy()),
                               jnp.asarray(nrm.numpy()), key,
                               samples=samples, bounces=bounces))
    replay = []
    for _ in range(samples):  # the reference's key schedule
        key, k_dir, _ = jr.split(key, 3)
        u1 = np.array(jr.uniform(k_dir, (V,)))
        u2 = np.array(jr.uniform(jr.fold_in(k_dir, 1), (V,)))
        steps = []
        for _ in range(bounces):
            key, k_step = jr.split(key)
            steps.append(step_uniforms(k_step, V))
        replay.append(FrameUniforms(torch.from_numpy(np.stack([u1, u2], 1)),
                                    steps))
    got = bake_vertex_irradiance(port, pos, nrm, None, samples=samples,
                                 bounces=bounces, uniforms=replay).numpy()
    assert got.shape == (V, 3) and np.isfinite(got).all()
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(1).mean()
    assert close >= 0.99
    assert abs(got.mean() / want.mean() - 1.0) < 1e-4
    assert (got.sum(1) > 0).mean() > 0.5
    # Drawn from a generator: the same on a copy of the scene.
    g1, g2 = (torch.Generator().manual_seed(4) for _ in range(2))
    a = bake_vertex_irradiance(port, pos, nrm, g1, samples=2)
    b = bake_vertex_irradiance(port.to("cpu"), pos, nrm, g2, samples=2)
    assert torch.equal(a, b)
