"""Whole frames of the port (loupiote_tpu_torch.trace_paths / Renderer)
against the reference's.

- Exact frame: the same tables and the reference's own uniforms (its
  jax.random streams replayed), on arch-90k (past the 16384-node gate, so
  shadow waves self-sort), and on a textured arch-30k hall with 20 props
  under an HDR sky (atlas sampling, the environment on a miss, env NEE and
  the final gather's probe term; K2/K3's twins trace it). A t-tie or an
  ulp at an edge (atan2, acos, pow differ by ulps) can send a path
  elsewhere, hence 99.5% of pixels within rtol 1e-4 / atol 1e-5 and the
  mean within 1e-4. Pseudo-random frames keep the inter-bounce sort off:
  a one-ulp key change moves the slot of every later ray, and with it the
  uniforms each ray draws. Blue-noise frames (1 spp, and 2 spp in one
  wave) draw every sample but the light choice (one light) from the noise
  planes of each ray's pixel, which follow it through the sort: 2 spp runs
  with the sort off and on, through the port's own primary rays. The
  textured-probe case traces the reference's primary rays: its
  generate_rays normalises in another order (directions within 2 ulp,
  test_torch_shade.py::test_generate_rays), and under a bright sky one
  shadow ray flipped by an ulp moves a 1,024-pixel frame's mean by ~1e-3
  (measured on that case: 3 pixels apart, mean -5.9e-4 with the port's
  rays; 1 pixel, -4.4e-5 with the reference's).
- Sort on: the same mean radiance as sort off (statistical, 3%), so the
  permutation and the scatter back keep each sample with its pixel.
- Golden gate: the port's Renderer converges to the reference's arch-40k
  golden image (PSNR > 26 dB, mean within 3%).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from loupiote_tpu.ops.raygen import generate_rays as ref_generate_rays
from loupiote_tpu.render.integrator import trace_paths as ref_trace_paths
from loupiote_tpu.render.renderer import blue_noise_uv as ref_blue_noise_uv
from loupiote_tpu.scene import build_probe as ref_build_probe
from loupiote_tpu.scene import build_scene_buffers as ref_buffers
from loupiote_tpu.scene.procedural import arch_camera
from loupiote_tpu.scene.procedural import build_arch_scene as ref_arch
from loupiote_tpu_torch import (BlitMode, RenderConfig, Renderer,
                                build_arch_scene, build_scene_buffers,
                                from_reference, generate_blue_noise,
                                trace_paths)
from loupiote_tpu_torch.render import integrator
from loupiote_tpu_torch.render.renderer import blue_noise_uv
from torch_port_helpers import (numpy_bvh, psnr, replay_uniforms,
                                sky_equirect)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "arch40k_48x48_24spp.npy")


@pytest.fixture(scope="module")
def arch90k():
    with numpy_bvh():
        ref = ref_buffers(ref_arch(90_000))
    return ref, from_reference(ref, device="cpu")


@pytest.fixture(scope="module")
def content30k():
    with numpy_bvh():
        ref = ref_buffers(ref_arch(30_000, textured=True, props=20),
                          probe=ref_build_probe(sky_equirect(64, 128)))
    return ref, from_reference(ref, device="cpu")


@pytest.mark.parametrize("case", ["plain", "textured_probe", "blue_noise",
                                  "spp2_sort_off", "spp2_sort_on"])
def test_frame_matches_reference_with_replayed_uniforms(arch90k, content30k,
                                                        case, monkeypatch):
    ref, port = content30k if case == "textured_probe" else arch90k
    if case == "textured_probe":
        def reference_rays(cam, width, height, vfov, jitter):
            o, d = ref_generate_rays(jnp.asarray(cam.numpy()), width,
                                     height, vfov, jnp.asarray(jitter.numpy()))
            return torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))

        monkeypatch.setattr(integrator, "generate_rays", reference_rays)
    assert port.num_nodes > 16384 or case == "textured_probe"
    assert port.has_probe == port.has_textures == (case == "textured_probe")
    W, H, B = 128, 8, 3
    spp = 2 if case.startswith("spp2") else 1
    sort = case == "spp2_sort_on"
    key = jr.PRNGKey(5)
    cam = arch_camera()
    ref_kw, kw = {}, {}
    if case not in ("plain", "textured_probe"):
        tex = (generate_blue_noise()[..., :2].astype(np.float32) + 0.5) / 256
        fc = 3
        ref_kw = dict(noise_tex=jnp.asarray(tex), frame_count=jnp.int32(fc))
        kw = dict(noise_tex=torch.from_numpy(tex), frame_count=fc)
        if spp == 1:
            for d, name in ((0, "jitter"), (1, "nee_uv")):
                ref_kw[name] = ref_blue_noise_uv(ref_kw["noise_tex"],
                                                 ref_kw["frame_count"], W, H,
                                                 dim=d)
                kw[name] = blue_noise_uv(kw["noise_tex"], fc, W, H, dim=d)
    def frame(bufs, k, extra):
        return ref_trace_paths(bufs, jnp.asarray(cam), W, H, k, bounces=B,
                               sort_rays=sort, spp=spp, **extra)[0]

    if case != "textured_probe":
        # The reference's env NEE does not trace under jit (R8): eager.
        frame = jax.jit(frame)
    ref_img = np.asarray(frame(ref, key, ref_kw))
    img = trace_paths(port, torch.from_numpy(cam), W, H, bounces=B,
                      sort_rays=sort, spp=spp,
                      uniforms=replay_uniforms(key, spp * W * H, B),
                      **kw)[0].numpy()
    close = np.isclose(img, ref_img, rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(img.mean() / ref_img.mean() - 1) < 1e-4
    assert (img.sum(axis=1) > 0).mean() > 0.4


def test_sort_on_keeps_samples_with_their_pixels(arch90k):
    _, port = arch90k
    cam = torch.from_numpy(arch_camera())
    means = {}
    for sort in (False, True):
        g = torch.Generator().manual_seed(11)
        acc = sum(trace_paths(port, cam, 32, 32, g, sort_rays=sort)[0]
                  for _ in range(16)) / 16
        means[sort] = acc.reshape(32, 32, 3)
    a, b = means[False], means[True]
    assert abs(float(b.mean()) / float(a.mean()) - 1) < 0.03
    # Per-pixel structure, not just the mean: rows keep their brightness.
    rows_a, rows_b = a.mean(dim=(1, 2)), b.mean(dim=(1, 2))
    assert float(torch.corrcoef(torch.stack([rows_a, rows_b]))[0, 1]) > 0.9


def test_renderer_passes_the_arch_golden_gate():
    golden = np.load(GOLDEN)
    cfg = RenderConfig(downsample_factor=1.0, denoise=False,
                       bounces_static=2, bounces_moving=2)
    r = Renderer((48, 48), cfg, seed=1, device="cpu")
    r.set_resources(build_scene_buffers(build_arch_scene(40_000),
                                        device="cpu"))
    # Under both node gates: the K2/K3 twins trace it, unsorted.
    assert r.scene.num_nodes < 8192
    r.accumulate = True
    for _ in range(24):
        r.raytrace(arch_camera())
    img = r.accum.numpy()
    assert r.frame_count == 25
    p = psnr(img, golden)
    assert p > 26.0, f"arch PSNR vs golden = {p:.1f} dB"
    assert abs(img.mean() - golden.mean()) < 0.03 * golden.mean()
    rgb = r.blit()
    assert rgb.shape == (48, 48, 3) and rgb.dtype == np.uint8
    assert len(r.read_pixels()) == 48 * 48 * 4


def test_unported_features_raise():
    """What the port still leaves to later slices raises (per-pass timing,
    kernel reload, instanced reference scenes); the interactive defaults
    (RenderConfig(), every blit mode), samples_per_frame > 1, blue noise
    and probe / textured scenes do not."""
    r = Renderer((32, 32), RenderConfig(samples_per_frame=4), device="cpu")
    for mode in BlitMode:
        r.set_blit_mode(mode)
    r.upload_noise_texture(np.zeros((4, 4, 4), np.uint8))
    r.use_noise_texture(True)
    for call in (lambda: r.measure_passes(arch_camera()),
                 r.reload_shaders):
        with pytest.raises(NotImplementedError):
            call()
    with numpy_bvh():
        ref = ref_buffers(ref_arch(2_000))
    with pytest.raises(NotImplementedError, match="instanc"):
        from_reference(dataclasses.replace(ref, inst_w2o=jnp.eye(4)[None]),
                       device="cpu")
    bufs = build_scene_buffers(build_arch_scene(2_000, textured=True),
                               device="cpu")
    assert bufs.has_textures
    r.set_resources(bufs)
    r.raytrace(arch_camera())
    assert r.frame_count == 1 and torch.isfinite(r.state.denoised).all()
