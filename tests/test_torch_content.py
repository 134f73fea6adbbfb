"""Scene content of the port (loupiote_tpu_torch): blue noise, the texture
atlas, the HDR probe, their sampling ops, blue-noise planes and spp
batching, against the reference on the same numpy inputs.

Tolerances.
- Host tables (blue noise, atlas, probe CDFs) are byte-equal: the port
  copies the reference's numpy code, and repeats OpenCV's area resize
  (which the reference calls) with its order of sums.
- ``read_hdr``: the reference reads through imageio, which returns 8-bit
  colour where it picks its OpenCV plugin, so the port's numpy reader is
  held bit for bit to the reference's own RGBE decode (``rgbe_to_float``)
  of the file's pixels and to OpenCV's float Radiance decoder.
- ``sample_atlas`` without sRGB and ``blue_noise_uv`` are float32
  arithmetic in the reference's order: within 1 ulp / exact. With sRGB,
  torch's and XLA's ``pow`` differ by ulps: rtol 1e-5.
- The environment: ``atan2`` / ``acos`` differ by ulps, which move the
  bilinear weights of ``eval_env`` by ~width x 1e-7 (radiance within 1e-5
  of the probe's peak) and ``env_pdf``'s cell only where u x width lies
  within 1e-4 of a cell edge; ``sample_env``'s rows and columns are exact
  (``searchsorted`` left = ``torch.searchsorted(right=False)``, ties
  included), its directions within 1e-6.
- spp batching: spp=2 in one wave equals the mean of the two 1-spp frames
  it replaces (rtol 1e-5, atol 1e-6), the property of the reference's
  tests/test_render.py:196-237, on the arch hall.
- The textured golden gate of tests/test_golden_scenes.py: PSNR > 26 dB,
  mean within 6%, the checker visible (red std > 0.05).
"""

import os
from types import SimpleNamespace

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loupiote_tpu.ops.env as ref_env
from loupiote_tpu.ops.texture import sample_atlas as ref_sample_atlas
from loupiote_tpu.render.renderer import blue_noise_uv as ref_blue_noise_uv
from loupiote_tpu.scene import build_probe as ref_build_probe
from loupiote_tpu.scene import pack_atlas as ref_pack_atlas
from loupiote_tpu.scene import rgbe_to_float as ref_rgbe_to_float
from loupiote_tpu.scene.blue_noise import generate_blue_noise as ref_noise
from loupiote_tpu.scene.procedural import \
    _procedural_images as ref_procedural_images
import loupiote_tpu_torch.scene.types as port_types
from loupiote_tpu_torch import (RenderConfig, Renderer, arch_camera,
                                build_arch_scene, build_probe,
                                build_scene_buffers, generate_blue_noise,
                                pack_atlas, read_hdr)
from loupiote_tpu_torch.ops import env
from loupiote_tpu_torch.ops.texture import sample_atlas
from loupiote_tpu_torch.render import integrator
from loupiote_tpu_torch.render.integrator import trace_paths
from loupiote_tpu_torch.render.renderer import blue_noise_uv
from loupiote_tpu_torch.scene.procedural import _procedural_images
from torch_port_helpers import (TEX_CAM, psnr, sky_equirect,
                                textured_quad_scene)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "textured_64x64_32spp.npy")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kw", [{}, {"size": 16, "channels": 2, "seed": 3}],
                         ids=["default", "16x16x2"])
def test_generate_blue_noise_byte_equal(kw):
    a, b = ref_noise(**kw), generate_blue_noise(**kw)
    assert b.dtype == np.uint8 and b.shape == a.shape
    assert a.tobytes() == b.tobytes()


def _odd_images(types_module, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for h, w in ((13, 7), (50, 33), (1, 1), (3, 64), (64, 64), (29, 41)):
        arr = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        out.append(types_module.ImageData.from_array(arr))
    return out


@pytest.mark.parametrize("case", ["procedural", "procedural_layers", "odd",
                                  "empty"])
def test_pack_atlas_byte_equal(case):
    import loupiote_tpu.scene.types as ref_types

    size = {"procedural": 2048, "procedural_layers": 256}.get(case, 64)
    if case.startswith("procedural"):
        ref_imgs, imgs = ref_procedural_images(6), _procedural_images(6)
    elif case == "odd":
        ref_imgs, imgs = _odd_images(ref_types), _odd_images(port_types)
    else:
        ref_imgs, imgs = [], []
    a, b = ref_pack_atlas(ref_imgs, size), pack_atlas(imgs, size)
    for f in ("texture", "blocks"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape and x.dtype == y.dtype, f
        assert x.tobytes() == y.tobytes(), f
    if case == "procedural_layers":
        assert b.layer_count > 1


@pytest.mark.parametrize("shape", [(8, 16), (32, 64), (128, 256), (100, 200),
                                   (64, 300), (1024, 2048)])
def test_build_probe_tables_byte_equal(shape):
    """No resize (<= 64 x 128), integer area scales (the fast path) and
    others (weighted cells), the content frame's 1024 x 2048 sky."""
    rad = sky_equirect(*shape)
    a, b = ref_build_probe(rad), build_probe(rad)
    for f in ("radiance", "cdf_cond", "cdf_marg", "pdf"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.shape == y.shape and x.dtype == y.dtype, f
        assert x.tobytes() == y.tobytes(), f


def _hdr_bytes(rgbe, rle):
    """A Radiance file of (H, W, 4) RGBE pixels, flat or in new-style
    runs (a count byte > 128 repeats the next byte, else literals)."""
    h, w = rgbe.shape[:2]
    out = [b"#?RADIANCE\n# made by a test\nFORMAT=32-bit_rle_rgbe\n"
           b"EXPOSURE=1.0\n\n", b"-Y %d +X %d\n" % (h, w)]
    for y in range(h):
        if not rle:
            out.append(rgbe[y].tobytes())
            continue
        out.append(bytes([2, 2, w >> 8, w & 255]))
        for c in range(4):
            ch = rgbe[y, :, c]
            x = 0
            while x < w:
                n = 1
                while x + n < w and n < 127 and ch[x + n] == ch[x]:
                    n += 1
                if n > 2:
                    out.append(bytes([128 + n, ch[x]]))
                    x += n
                    continue
                start = x
                while x < w and x - start < 128:
                    if x + 2 < w and ch[x] == ch[x + 1] == ch[x + 2]:
                        break
                    x += 1
                out.append(bytes([x - start]) + ch[start:x].tobytes())
    return b"".join(out)


@pytest.mark.parametrize("rle", [False, True], ids=["flat", "rle"])
def test_read_hdr_decodes_flat_and_rle(rle, tmp_path):
    rng = np.random.default_rng(12)
    h, w = 9, 300  # runs longer than 127 and literal runs of 128
    rgbe = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
    rgbe[:, 20:200] = rgbe[:, 20:21]
    rgbe[2:4, :, 3] = 0  # exponent 0: black
    data = _hdr_bytes(rgbe, rle)
    path = tmp_path / "probe.hdr"
    path.write_bytes(data)
    got = read_hdr(data)
    assert got.dtype == np.float32 and got.shape == (h, w, 3)
    assert got.tobytes() == read_hdr(str(path)).tobytes()
    assert got.tobytes() == ref_rgbe_to_float(rgbe).tobytes()
    cv = np.ascontiguousarray(cv2.imread(str(path),
                                         cv2.IMREAD_UNCHANGED)[..., ::-1])
    assert got.tobytes() == cv.tobytes()
    assert (got[2:4] == 0).all()


def _atlas_inputs():
    import loupiote_tpu.scene.types as ref_types

    imgs = ref_procedural_images(6) + _odd_images(ref_types)
    atlas = ref_pack_atlas(imgs, 256)
    rng = np.random.default_rng(21)
    R = 4096
    uv = rng.uniform(-3, 3, (R, 2)).astype(np.float32)
    uv[:64] = np.round(uv[:64])  # block edges and wraps
    tex = rng.integers(-1, len(imgs), R).astype(np.int32)
    return atlas, uv, tex


@pytest.mark.parametrize("srgb", [False, True], ids=["linear", "srgb"])
def test_sample_atlas_matches_reference(srgb):
    atlas, uv, tex = _atlas_inputs()
    assert atlas.texture.shape[0] > 1 and (tex < 0).any()
    ref = np.asarray(ref_sample_atlas(
        SimpleNamespace(atlas=jnp.asarray(atlas.texture),
                        atlas_blocks=jnp.asarray(atlas.blocks)),
        jnp.asarray(tex), jnp.asarray(uv), srgb=srgb))
    got = sample_atlas(SimpleNamespace(atlas=_t(atlas.texture),
                                       atlas_blocks=_t(atlas.blocks)),
                       _t(tex), _t(uv), srgb=srgb).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5 if srgb else 1e-6,
                               atol=1e-6)
    assert (got[tex < 0] == 1.0).all()


def _probe_scenes(shape=(32, 64)):
    p = ref_build_probe(sky_equirect(*shape))
    tables = dict(probe=p.radiance, probe_cdf_cond=p.cdf_cond,
                  probe_cdf_marg=p.cdf_marg, probe_pdf=p.pdf)
    return (SimpleNamespace(**{k: jnp.asarray(v) for k, v in tables.items()}),
            SimpleNamespace(**{k: _t(v) for k, v in tables.items()}), p)


def _dirs(n=4096, seed=22):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:8] = [[0, 0, 1], [-0.0, 0, 1], [0, 1, 0], [0, -1, 0], [-1, 0, 0],
             [1, 0, 0], [-1e-6, 0.3, 0.8], [1e-6, -0.3, 0.8]]  # u = 0 / 1
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("shape", [(32, 64), (128, 256)])
def test_eval_env_and_pdf_match_reference(shape):
    ref_s, port_s, p = _probe_scenes(shape)
    d = _dirs()
    ru, rv = (np.asarray(x) for x in ref_env.dir_to_equirect(jnp.asarray(d)))
    u, v = (x.numpy() for x in env.dir_to_equirect(_t(d)))
    np.testing.assert_allclose(u, ru, atol=1e-6)
    np.testing.assert_allclose(v, rv, atol=1e-6)
    back = env.equirect_to_dir(_t(u), _t(v)).numpy()
    np.testing.assert_allclose(back, np.asarray(ref_env.equirect_to_dir(
        jnp.asarray(u), jnp.asarray(v))), atol=1e-6)
    np.testing.assert_allclose(back, d, atol=1e-5)
    got = env.eval_env(port_s, _t(d)).numpy()
    ref = np.asarray(ref_env.eval_env(ref_s, jnp.asarray(d)))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * p.radiance.max())
    hp, wp = p.pdf.shape
    edge = ((np.abs(u * wp - np.round(u * wp)) < 1e-4)
            | (np.abs(v * hp - np.round(v * hp)) < 1e-4))
    got_p = env.env_pdf(port_s, _t(d)).numpy()
    ref_p = np.asarray(ref_env.env_pdf(ref_s, jnp.asarray(d)))
    assert (got_p == ref_p)[~edge].all() and edge.mean() < 0.01


def test_sample_env_matches_reference():
    ref_s, port_s, p = _probe_scenes((128, 256))
    rng = np.random.default_rng(23)
    R = 8192
    u1, u2 = (rng.random(R).astype(np.float32) for _ in range(2))
    # Ties: uniforms equal to CDF values, and the ends.
    u1[:64] = rng.choice(p.cdf_marg, 64)
    u2[64:128] = p.cdf_cond.reshape(-1)[rng.integers(0, p.cdf_cond.size, 64)]
    u1[128:132] = [0.0, 1.0, np.nextafter(np.float32(1), np.float32(0)),
                   1e-30]
    ref_row = np.clip(np.asarray(jnp.searchsorted(
        jnp.asarray(p.cdf_marg), jnp.asarray(u1), side="left")), 0,
        p.cdf_marg.size - 1)
    row = torch.clamp(torch.searchsorted(port_s.probe_cdf_marg, _t(u1),
                                         right=False), 0,
                      p.cdf_marg.size - 1)
    np.testing.assert_array_equal(row.numpy(), ref_row)
    ref_col = np.asarray(ref_env._bisect_rows(
        jnp.asarray(p.cdf_cond), jnp.asarray(ref_row, jnp.int32),
        jnp.asarray(u2)))
    col = env._bisect_rows(port_s.probe_cdf_cond, row, _t(u2))
    np.testing.assert_array_equal(col.numpy(), ref_col)
    rd, rpdf = ref_env.sample_env(ref_s, jnp.asarray(u1), jnp.asarray(u2))
    d, pdf = env.sample_env(port_s, _t(u1), _t(u2))
    np.testing.assert_array_equal(pdf.numpy(), np.asarray(rpdf))
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), atol=1e-6)


@pytest.mark.parametrize("size", [(64, 40), (200, 70)])
def test_blue_noise_uv_matches_reference(size):
    w, h = size
    raw = np.random.default_rng(24).integers(0, 256, (64, 64, 4), np.uint8)
    tex = (raw[..., :2].astype(np.float32) + 0.5) / 256.0
    for fc in (1, 3, 7, 12345):
        for dim in (0, 1, 5, 8):
            ref = np.asarray(ref_blue_noise_uv(jnp.asarray(tex),
                                               jnp.int32(fc), w, h, dim=dim))
            got = blue_noise_uv(_t(tex), fc, w, h, dim=dim).numpy()
            assert got.dtype == np.float32 and got.shape == (w * h, 2)
            np.testing.assert_array_equal(got, ref)
            assert ((got >= 0) & (got < 1)).all()


@pytest.fixture(scope="module")
def noise():
    raw = generate_blue_noise()
    return raw, torch.from_numpy((raw[..., :2].astype(np.float32) + 0.5)
                                 / 256.0)


@pytest.fixture(scope="module")
def arch8k():
    return build_scene_buffers(build_arch_scene(8_000), device="cpu")


@pytest.mark.parametrize("sort", [False, True], ids=["sort_off", "sort_on"])
def test_spp2_batch_equals_mean_of_single_frames(arch8k, noise, sort,
                                                 monkeypatch):
    """spp=2 in one wave reproduces the mean of its two 1-spp frames under
    blue noise: sample s draws every dimension at frame fc * 2 + s.
    Sort forced on: each slot's noise columns follow it through pid."""
    if sort:
        monkeypatch.setattr(integrator, "SORT_MIN_NODES", 0)
    _, tex = noise
    W, H, fc = 128, 48, 3
    cam = torch.from_numpy(arch_camera())
    g = torch.Generator().manual_seed(7)
    batched, gb2 = trace_paths(arch8k, cam, W, H, g, noise_tex=tex,
                               frame_count=fc, spp=2)
    singles = []
    for s in range(2):
        fcs = fc * 2 + s
        rad, gb1 = trace_paths(
            arch8k, cam, W, H, g, noise_tex=tex, frame_count=fcs,
            jitter=blue_noise_uv(tex, fcs, W, H, dim=0),
            nee_uv=blue_noise_uv(tex, fcs, W, H, dim=1))
        singles.append(rad)
        if s == 0:
            # The G-buffer is sample 0's, at pixel resolution.
            np.testing.assert_array_equal(gb2.depth.numpy(),
                                          gb1.depth.numpy())
            np.testing.assert_array_equal(gb2.albedo.numpy(),
                                          gb1.albedo.numpy())
    want = (singles[0] + singles[1]) / 2
    assert float(want.mean()) > 1e-3
    np.testing.assert_allclose(batched.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_renderer_passes_the_textured_golden_gate():
    """The port's Renderer on the reference's textured quad (a checker
    albedo texture, one quad light) at 64 x 64: 8 frames of 4 samples
    each against the reference's 32-spp golden image."""
    golden = np.load(GOLDEN)
    cfg = RenderConfig(downsample_factor=1.0, denoise=False,
                       bounces_static=2, bounces_moving=2,
                       samples_per_frame=4)
    r = Renderer((64, 64), cfg, seed=2, device="cpu")
    bufs = build_scene_buffers(textured_quad_scene(), device="cpu")
    assert bufs.has_textures and not bufs.has_probe
    r.set_resources(bufs)
    r.accumulate = True
    for _ in range(8):
        r.raytrace(TEX_CAM)
    img = r.accum.numpy()
    assert r.frame_count == 9
    p = psnr(img, golden)
    assert p > 26.0, f"textured PSNR vs golden = {p:.1f} dB"
    assert img[..., 0].std() > 0.05
    assert abs(img.mean() - golden.mean()) < 0.06 * golden.mean()


def test_renderer_blue_noise_and_spp(noise):
    """The Renderer's noise texture: uploaded as (c + 0.5) / 256 of its
    first two channels, kept across resize, used only once switched on;
    a blue-noise frame of samples_per_frame = 2 is the frame trace_paths
    gives for the state's frame count (one light: the pseudo-random light
    choice does not matter)."""
    raw, tex = noise
    r = Renderer((64, 16), RenderConfig(downsample_factor=1.0, denoise=False,
                                        samples_per_frame=2), device="cpu")
    assert (r.state.noise_tex == 0.5).all() and not r.use_noise
    r.upload_noise_texture(raw)
    r.resize((128, 8))
    assert torch.equal(r.state.noise_tex, tex)
    bufs = build_scene_buffers(build_arch_scene(2_000, textured=True),
                               device="cpu")
    r.set_resources(bufs)
    r.use_noise_texture(True)
    r.accumulate = True
    view = arch_camera()
    for fc in (1, 2):
        r.raytrace(view)
        want, _ = trace_paths(bufs, torch.from_numpy(view), 128, 8,
                              torch.Generator().manual_seed(fc),
                              noise_tex=tex, frame_count=fc, spp=2)
        if fc == 1:
            np.testing.assert_allclose(r.accum.reshape(-1, 3).numpy(),
                                       want.numpy(), rtol=1e-6, atol=1e-7)
            first = want
    np.testing.assert_allclose(r.accum.reshape(-1, 3).numpy(),
                               ((first + want) / 2).numpy(), rtol=1e-5,
                               atol=1e-6)
    assert r.frame_count == 3 and float(first.mean()) > 1e-3
