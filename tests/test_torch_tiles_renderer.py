"""Tile-parallel frames through ``render_frame_sharded`` and
``Renderer(mesh=...)`` against the reference's, on the CPU.

- ``render_frame_sharded`` against the reference's (jitted on
  tests/conftest.py's 8 virtual CPU devices), the shard streams replayed
  from the reference's key chain ``key, k_frame = split(state.key)`` then
  ``fold_in(fold_in(k_frame, ti), si)``: two accumulated pathtrace frames
  on a 2x2 mesh; two denoised frames on a 2x1 mesh, the camera moving;
  two blue-noise frames on a 1x2 mesh, where the spp shards trace the
  same planes and so the same radiance (ROADMAP R10), in the reference
  and in the port. Tolerances as tests/test_torch_interactive.py's
  denoised frames: 99.5% of pixels within rtol 1e-4 / atol 1e-5, the
  mean within 1e-4.
- ``Renderer`` with a mesh, as the reference's
  tests/test_multichip_renderer.py: the height rounded down to the tiles,
  the mean of an accumulated frame against a one-device renderer's, a
  denoised frame on 8 tiles; ``samples_per_frame`` does not apply under a
  mesh; a mesh on another device than the renderer's raises.
- The spp axis: a 2x2 mesh's radiance is the mean of its shards' own
  traces, and a 1x8 mesh lowers the spread of a pixel over frames, as the
  reference's tests/test_parallel.py asserts.

Two a-trous iterations in the denoised frames: the reference takes an
even count, and its four-iteration frame compiles ~2.5x longer.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from loupiote_tpu.parallel import make_mesh as ref_make_mesh
from loupiote_tpu.parallel.tiles import \
    render_frame_sharded as ref_render_sharded
from loupiote_tpu.render import renderer as ref_renderer
from loupiote_tpu.scene import build_scene_buffers as ref_buffers
from loupiote_tpu.scene.procedural import arch_camera
from loupiote_tpu.scene.procedural import build_arch_scene as ref_arch
from loupiote_tpu_torch import (BlitMode, Camera, RenderConfig, Renderer,
                                from_reference, generate_blue_noise)
from loupiote_tpu_torch.parallel import make_mesh, trace_paths_sharded
from loupiote_tpu_torch.parallel.tiles import render_frame_sharded
from loupiote_tpu_torch.render import renderer
from loupiote_tpu_torch.render.integrator import trace_paths
from torch_port_helpers import numpy_bvh, shard_uniforms

CPU = torch.device("cpu")
VFOV = float(np.deg2rad(45.0))


def cpu_mesh(n_tiles, n_spp):
    return make_mesh(n_tiles, n_spp, devices=[CPU] * (n_tiles * n_spp))


def close_frac(a, b):
    a, b = np.asarray(a), np.asarray(b)
    ok = np.isclose(a, b, rtol=1e-4, atol=1e-5)
    return ok.reshape(ok.shape[0] * ok.shape[1], -1).all(axis=1).mean()


def _moved(i):
    cam = arch_camera().copy()
    cam[0, 3] += 1e-3 * i
    return cam


@pytest.fixture(scope="module")
def arch20k():
    with numpy_bvh():
        ref = ref_buffers(ref_arch(20_000))
    return ref, from_reference(ref, device="cpu")


@pytest.mark.parametrize("mode,mesh_shape,noise", [
    ("pathtrace", (2, 2), False), ("denoised", (2, 1), False),
    ("pathtrace", (1, 2), True)],
    ids=["pathtrace_2x2", "denoised_2x1", "pathtrace_blue_noise_1x2"])
def test_render_frame_sharded_matches_reference(arch20k, mode, mesh_shape,
                                                noise):
    ref, port = arch20k
    W, H, B = 128, 16, 2
    n_tiles, n_spp = mesh_shape
    rows = H // n_tiles
    kw = dict(width=W, height=H, bounces=B, nee=True, vfov=VFOV, mode=mode,
              atrous_iterations=2, use_noise=noise)
    ref_state = ref_renderer._init_state(W, H, seed=5)
    state = renderer.init_state(W, H, "cpu")
    if noise:
        tex = (generate_blue_noise()[..., :2].astype(np.float32) + 0.5) / 256
        ref_state = ref_state.replace(noise_tex=jnp.asarray(tex))
        state = replace(state, noise_tex=torch.from_numpy(tex))
    ref_mesh, mesh = ref_make_mesh(n_tiles, n_spp), cpu_mesh(n_tiles, n_spp)
    for i in range(2):
        cam = _moved(i if mode == "denoised" else 0)
        w2s = Camera(cam, (W, H), VFOV).world_to_screen()
        _, k_frame = jr.split(ref_state.key)
        uni = shard_uniforms(k_frame, mesh_shape, rows * W, B)
        ref_state = ref_render_sharded(
            ref, ref_state, jnp.asarray(cam), jnp.asarray(w2s),
            jnp.bool_(True), mesh=ref_mesh, **kw)
        # Back to one device, so the second frame's inputs are placed as
        # the first's and its compiled program is reused.
        ref_state = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)),
                                 ref_state)
        state = render_frame_sharded(
            port, state, torch.from_numpy(cam), torch.from_numpy(w2s), True,
            mesh=mesh, uniforms=uni, **kw)
    if mode == "pathtrace":
        assert state.frame_count == int(ref_state.frame_count) == 3
        out, ref_out = state.accum.numpy(), np.asarray(ref_state.accum)
    else:
        out, ref_out = state.denoised.numpy(), np.asarray(ref_state.denoised)
        assert close_frac(state.asvgf_history.numpy()[..., None],
                          np.asarray(ref_state.asvgf_history)[..., None]
                          ) >= 0.995
        assert (state.asvgf_history.numpy() == 2).mean() > 0.5
        assert np.abs(state.motion.numpy()).max() > 0
    assert out.shape == (H, W, 3) and np.isfinite(out).all()
    assert close_frac(out, ref_out) >= 0.995
    assert abs(out.mean() / ref_out.mean() - 1) < 1e-4
    assert close_frac(state.motion.numpy(), np.asarray(ref_state.motion)
                      ) >= 0.995
    assert (out.sum(-1) > 0).mean() > 0.4
    if noise:
        # R10: under blue noise the spp shards share every plane, and with
        # one light and no probe no draw of theirs differs, so a 1x2 mesh
        # traces what shard 0 alone does.
        cam_t = torch.from_numpy(arch_camera())
        planes = dict(
            jitter=renderer.blue_noise_uv(state.noise_tex, 3, W, H, dim=0),
            nee_uv=renderer.blue_noise_uv(state.noise_tex, 3, W, H, dim=1),
            noise_tex=state.noise_tex, frame_count=3)
        two = trace_paths_sharded(port, cam_t, mesh=mesh, width=W, height=H,
                                  bounces=B, uniforms=uni, **planes)[0]
        one = trace_paths_sharded(port, cam_t, mesh=cpu_mesh(1, 1), width=W,
                                  height=H, bounces=B, uniforms=[uni[0][:1]],
                                  **planes)[0]
        assert torch.equal(two, one)


def test_mesh_renderer_height_rounding():
    """tests/test_multichip_renderer.py::test_multichip_height_rounding."""
    rm = Renderer((64, 36), RenderConfig(downsample_factor=1.0,
                                         denoise=False), mesh=cpu_mesh(8, 1))
    assert rm.device == CPU
    assert rm.get_size() == (64, 32)
    assert rm.state.accum.shape == (32, 64, 3)


def test_mesh_renderer_matches_single(arch20k):
    """tests/test_multichip_renderer.py::
    test_multichip_renderer_matches_single: a 4x2 mesh against one
    device, six accumulated frames; other streams, the same integrand."""
    _, port = arch20k
    cfg = RenderConfig(downsample_factor=1.0, denoise=False)
    rm = Renderer((32, 32), cfg, mesh=cpu_mesh(4, 2))
    r1 = Renderer((32, 32), cfg, device="cpu")
    for r in (rm, r1):
        r.set_resources(port)
        r.accumulate = True
        for _ in range(6):
            r.raytrace(arch_camera())
    a, b = rm.state.accum.numpy(), r1.state.accum.numpy()
    assert np.isfinite(a).all()
    assert rm.frame_count == r1.frame_count == 7
    assert abs(a.mean() - b.mean()) < 0.15 * b.mean() + 0.02
    assert rm.blit().shape == (32, 32, 3)


def test_mesh_renderer_denoised(arch20k):
    """tests/test_multichip_renderer.py::test_multichip_denoised_mode."""
    _, port = arch20k
    rm = Renderer((32, 32), RenderConfig(downsample_factor=1.0),
                  mesh=cpu_mesh(8, 1))
    rm.set_resources(port)
    rm.set_blit_mode(BlitMode.DENOISED_PATHTRACE)
    for _ in range(3):
        rm.raytrace(arch_camera())
    out = rm.state.denoised.numpy()
    assert np.isfinite(out).all() and out.mean() > 0.01
    assert float(rm.state.asvgf_history.mean()) > 1.0


def test_mesh_renderer_ignores_samples_per_frame(arch20k):
    """As the reference's shards, a mesh frame traces one sample a pixel
    whatever samples_per_frame says; the frames' keys follow the seed."""
    _, port = arch20k
    accums = []
    for spp, seed in ((1, 3), (4, 3), (1, 4)):
        r = Renderer((32, 16), RenderConfig(downsample_factor=1.0,
                                            denoise=False,
                                            samples_per_frame=spp),
                     seed=seed, mesh=cpu_mesh(2, 1))
        r.set_resources(port)
        r.raytrace(arch_camera())
        accums.append(r.accum)
    assert torch.equal(accums[0], accums[1])
    assert not torch.equal(accums[0], accums[2])


def test_mesh_on_another_device_raises():
    cuda_mesh = make_mesh(devices=[torch.device("cuda", 0)])
    with pytest.raises(ValueError):
        Renderer((32, 32), device="cpu", mesh=cuda_mesh)


def test_spp_axis_is_the_mean_of_its_shards(arch20k):
    """A 2x2 mesh's radiance is (shard 0 + shard 1) / 2 of each slab's
    own traces, summed in that order; its G-buffer is shard 0's."""
    _, port = arch20k
    W, H = 128, 16
    cam = torch.from_numpy(arch_camera())
    uni = shard_uniforms(jr.PRNGKey(8), (2, 2), 8 * W, 3)
    img, gb = trace_paths_sharded(port, cam, mesh=cpu_mesh(2, 2), width=W,
                                  height=H, bounces=3, uniforms=uni)
    for ti in range(2):
        own = [trace_paths(port, cam, W, H, bounces=3, uniforms=uni[ti][si],
                           row_offset=ti * 8, rows=8) for si in range(2)]
        want = ((own[0][0] + own[1][0]) / 2).reshape(8, W, 3)
        assert torch.equal(img[ti * 8:(ti + 1) * 8], want)
        assert not torch.equal(own[0][0], own[1][0])
        for name in ("normal", "depth", "mesh_id", "albedo", "world_pos"):
            got = gb[name][ti * 8:(ti + 1) * 8]
            assert torch.equal(got.reshape(getattr(own[0][1], name).shape),
                               getattr(own[0][1], name)), name


def test_spp_axis_reduces_variance(arch20k):
    """tests/test_parallel.py::test_spp_axis_reduces_variance on the port:
    over 8 frames a pixel's spread on a 1x8 mesh is under 0.7x the 1x1
    mesh's, and the means agree."""
    _, port = arch20k
    W = H = 32
    cam = torch.from_numpy(arch_camera())
    mesh1, mesh8 = cpu_mesh(1, 1), cpu_mesh(1, 8)

    def run(mesh, k):
        return trace_paths_sharded(port, cam, (k,), mesh=mesh, width=W,
                                   height=H, bounces=2)[0].numpy()

    f1 = np.stack([run(mesh1, k) for k in range(8)])
    f8 = np.stack([run(mesh8, k) for k in range(8)])
    v1, v8 = f1.std(axis=0).mean(), f8.std(axis=0).mean()
    assert v8 < 0.7 * v1, (v1, v8)
    assert abs(f1.mean() - f8.mean()) < 0.2 * f1.mean() + 0.05
