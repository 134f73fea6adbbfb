"""Whole frames of the port (loupiote_tpu_torch.trace_paths / Renderer)
against the reference's.

- Exact frame: the same tables and the reference's own uniforms, sort off,
  on arch-90k (past the 16384-node gate, so shadow waves self-sort). A
  t-tie or an ulp at an edge can send a path elsewhere, hence 99.5% of
  pixels within rtol 1e-4 / atol 1e-5 and the mean within 1e-4. The
  inter-bounce sort stays off here: a one-ulp key change moves the slot of
  every later ray, and with it the uniforms each ray draws.
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

from loupiote_tpu.render.integrator import trace_paths as ref_trace_paths
from loupiote_tpu.scene import build_scene_buffers as ref_buffers
from loupiote_tpu.scene.procedural import arch_camera
from loupiote_tpu.scene.procedural import build_arch_scene as ref_arch
from loupiote_tpu_torch import (BlitMode, RenderConfig, Renderer,
                                build_arch_scene, build_scene_buffers,
                                from_reference, trace_paths)
from torch_port_helpers import numpy_bvh, psnr, replay_uniforms

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "arch40k_48x48_24spp.npy")


@pytest.fixture(scope="module")
def arch90k():
    with numpy_bvh():
        ref = ref_buffers(ref_arch(90_000))
    return ref, from_reference(ref, device="cpu")


def test_frame_matches_reference_with_replayed_uniforms(arch90k):
    ref, port = arch90k
    assert port.num_nodes > 16384  # shadow self-sort on
    W, H, B = 128, 8, 3
    key = jr.PRNGKey(5)
    cam = arch_camera()
    frame = jax.jit(lambda bufs, k: ref_trace_paths(
        bufs, jnp.asarray(cam), W, H, k, bounces=B, sort_rays=False)[0])
    ref_img = np.asarray(frame(ref, key))
    img = trace_paths(port, torch.from_numpy(cam), W, H, bounces=B,
                      sort_rays=False,
                      uniforms=replay_uniforms(key, W * H, B))[0].numpy()
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
    """What the port still leaves to later slices raises; the interactive
    defaults (RenderConfig(), every blit mode) do not."""
    with pytest.raises(NotImplementedError, match="spp"):
        Renderer((32, 32), RenderConfig(samples_per_frame=4), device="cpu")
    r = Renderer((32, 32), RenderConfig(), device="cpu")
    for mode in BlitMode:
        r.set_blit_mode(mode)
    for call in (lambda: r.upload_noise_texture(np.zeros((4, 4, 4))),
                 lambda: r.use_noise_texture(True),
                 lambda: r.measure_passes(arch_camera()),
                 r.reload_shaders):
        with pytest.raises(NotImplementedError):
            call()
    bufs = build_scene_buffers(build_arch_scene(2_000), device="cpu")
    for flag in ("has_probe", "has_textures"):
        with pytest.raises(NotImplementedError, match="probe"):
            r.set_resources(dataclasses.replace(bufs, **{flag: True}))
    r.raytrace(arch_camera())  # no scene bound: a no-op
    assert r.frame_count == 1
