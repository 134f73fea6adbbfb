"""The port's interactive frame (G-buffer, camera, motion vectors, A-SVGF
frames, blit modes) against the reference's, on arch-8k.

- G-buffer: the same tables, rays and uniforms. Bounce-0 hits agree except
  on t-ties, where two triangles meeting at an edge may carry different
  normals, so normals, depth and mesh ids must agree on 99.5% of pixels
  (rtol 1e-5 / atol 1e-6 for the floats), albedo likewise.
- Camera.world_to_screen is the reference's numpy code: exact. Projection:
  XLA evaluates the (R,4) x (4,4) product as a dot with its own rounding,
  the port term by term, hence 1e-5 relative.
- Two denoised frames with the reference's own uniforms: the exact-frame
  test's standard, >= 99.5% of pixels within rtol 1e-4 / atol 1e-5 and the
  mean within 1e-4, for the denoised image and the motion vectors.
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from loupiote_tpu.render import renderer as ref_renderer
from loupiote_tpu.render.camera import Camera as RefCamera
from loupiote_tpu.render.integrator import trace_paths as ref_trace_paths
from loupiote_tpu.scene import build_scene_buffers as ref_buffers
from loupiote_tpu.scene.procedural import arch_camera, build_arch_scene
from loupiote_tpu_torch import (BlitMode, Camera, RenderConfig, Renderer,
                                build_scene_buffers, from_reference,
                                trace_paths)
from loupiote_tpu_torch import build_arch_scene as port_arch
from loupiote_tpu_torch.render import renderer
from torch_port_helpers import numpy_bvh, replay_uniforms

W, H, B = 128, 64, 3
VFOV = float(np.deg2rad(45.0))


@pytest.fixture(scope="module")
def arch8k():
    with numpy_bvh():
        ref = ref_buffers(build_arch_scene(8_000))
    return ref, from_reference(ref, device="cpu")


def _moved(i):
    cam = arch_camera().copy()
    cam[0, 3] += 1e-3 * i
    return cam


def _close_frac(a, b, rtol=1e-5, atol=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    ok = np.isclose(a, b, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(axis=1).mean()


def test_gbuffer_matches_reference(arch8k):
    ref, port = arch8k
    key = jr.PRNGKey(9)
    cam = arch_camera()
    _, ref_gb = ref_trace_paths(ref, jnp.asarray(cam), W, 8, key, bounces=1)
    _, gb = trace_paths(port, torch.from_numpy(cam), W, 8, bounces=1,
                        uniforms=replay_uniforms(key, W * 8, 1))
    mesh = gb.mesh_id.numpy()
    assert mesh.dtype == np.int32
    assert (mesh == np.asarray(ref_gb.mesh_id)).mean() >= 0.995
    assert (mesh >= 0).mean() > 0.5 and len(np.unique(mesh)) > 2
    for name in ("normal", "depth", "albedo", "world_pos"):
        frac = _close_frac(getattr(gb, name).numpy(),
                           getattr(ref_gb, name))
        assert frac >= 0.995, (name, frac)
    # Misses: normal 0, albedo 1, mesh -1.
    miss = mesh < 0
    assert (gb.normal.numpy()[miss] == 0).all()
    assert (gb.albedo.numpy()[miss] == 1).all()


def test_camera_and_projection_match_reference():
    for i in (0, 3):
        cam = _moved(i)
        want = RefCamera(cam, (W, H), VFOV).world_to_screen(0.01, 100.0)
        got = Camera(cam, (W, H), VFOV).world_to_screen(0.01, 100.0)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            Camera(cam, (W, H), VFOV).perspective(),
            RefCamera(cam, (W, H), VFOV).perspective())
    rng = np.random.default_rng(12)
    pos = ((rng.random((4096, 3)) - 0.5) * 60).astype(np.float32)
    m = Camera(_moved(1), (W, H), VFOV).world_to_screen()
    uv, w = renderer.project_uv(torch.from_numpy(m), torch.from_numpy(pos))
    ruv, rw = ref_renderer._project_uv(jnp.asarray(m), jnp.asarray(pos))
    front = np.asarray(rw) > 0.1
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(uv.numpy()[front], np.asarray(ruv)[front],
                               rtol=1e-5, atol=1e-5)


def test_two_denoised_frames_match_reference(arch8k):
    """Two frames, the camera moving 1e-3 along x: the second reprojects
    the first through its motion vectors."""
    ref, port = arch8k
    kw = dict(width=W, height=H, bounces=B, nee=True, vfov=VFOV,
              mode="denoised", atrous_iterations=4)
    ref_state = ref_renderer._init_state(W, H, seed=4)
    state = renderer.init_state(W, H, "cpu")
    for i in range(2):
        cam = _moved(i)
        w2s = Camera(cam, (W, H), VFOV).world_to_screen()
        key, k_frame = jr.split(ref_state.key)
        ref_state = ref_renderer.render_frame(
            ref, ref_state, jnp.asarray(cam), jnp.asarray(w2s),
            jnp.bool_(False), **kw)
        assert (np.asarray(ref_state.key) == np.asarray(key)).all()
        state = renderer.render_frame(
            port, state, torch.from_numpy(cam), torch.from_numpy(w2s), False,
            uniforms=replay_uniforms(k_frame, W * H, B), **kw)
    den, ref_den = state.denoised.numpy(), np.asarray(ref_state.denoised)
    close = _close_frac(den.reshape(-1, 3), ref_den.reshape(-1, 3),
                        rtol=1e-4, atol=1e-5)
    assert close >= 0.995, close
    assert abs(den.mean() / ref_den.mean() - 1) < 1e-4
    assert np.isfinite(den).all() and (den.sum(-1) > 0).mean() > 0.9
    motion = state.motion.numpy()
    assert _close_frac(motion.reshape(-1, 2),
                       np.asarray(ref_state.motion).reshape(-1, 2),
                       rtol=1e-4, atol=1e-5) >= 0.995
    assert np.abs(motion).max() > 0
    hist = state.asvgf_history.numpy()
    assert _close_frac(hist.reshape(-1, 1),
                       np.asarray(ref_state.asvgf_history).reshape(-1, 1)
                       ) >= 0.995
    assert (hist == 2).mean() > 0.5  # most pixels reprojected
    # Only pathtrace mode moves the running average.
    assert state.frame_count == 1 and not state.accum.any()


def test_blit_modes_and_resize():
    r = Renderer((64, 32), RenderConfig(), seed=2, device="cpu")
    r.set_resources(build_scene_buffers(port_arch(2_000), device="cpu"))
    assert r.get_size() == (32, 16)
    for mode in BlitMode:
        r.set_blit_mode(mode)
        r.raytrace(arch_camera())
        img = r.blit()
        assert img.shape == (32, 64, 3) and img.dtype == np.uint8, mode
        assert r.blit(display_size=False).shape == (16, 32, 3)
        assert img.any(), mode
        assert len(r.read_pixels()) == 64 * 32 * 4
    r.set_blit_mode(BlitMode.GBUFFER)
    gb = r.blit(display_size=False)
    vis = r.state.gb_normal.numpy() * 0.5 + 0.5
    vis[r.state.gb_mesh.numpy() < 0] = 0
    np.testing.assert_array_equal(gb, (vis * 255).astype(np.uint8))
    r.resize((48, 40))
    assert r.get_size() == (24, 20) and r.window_size == (48, 40)
    assert r.state.accum.shape == (20, 24, 3) and r.frame_count == 1
    r.raytrace(arch_camera())
    assert r.blit().shape == (40, 48, 3)
