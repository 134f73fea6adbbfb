"""Tile-parallel frames of the port (loupiote_tpu_torch.parallel) against
the reference's (loupiote_tpu.parallel), on the CPU.

- Row slabs: ``generate_rays``, ``blue_noise_uv`` and ``trace_paths`` with
  ``row_offset`` / ``rows`` against the reference's, and a slab equal to
  the matching rows of the whole image.
- ``trace_paths_sharded`` against the reference's (jitted, the mesh
  static, on tests/conftest.py's 8 virtual CPU devices), each shard's
  uniforms replayed from the reference's folded key
  ``fold_in(fold_in(key, ti), si)``: 2x2 (tiled 8-row slabs), 3x1 and 2x1
  (6-row slabs, untiled). The port's meshes list ``torch.device("cpu")``
  once a shard.
- The tile split is exact: with one full-frame jitter the gathered
  G-buffer is bit-equal to the unsharded one; a 1x1 mesh is
  ``trace_paths`` bit for bit. ``make_mesh`` as the reference's.

Tolerances as tests/test_torch_frame.py's: a t-tie or an ulp at an edge
can send a path elsewhere, so 99.5% of pixels within rtol 1e-4 / atol
1e-5 and the image mean within 1e-4.
"""

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from loupiote_tpu.ops.raygen import generate_rays as ref_generate_rays
from loupiote_tpu.parallel import make_mesh as ref_make_mesh
from loupiote_tpu.parallel import trace_paths_sharded as ref_sharded
from loupiote_tpu.render.integrator import trace_paths as ref_trace_paths
from loupiote_tpu.render.renderer import blue_noise_uv as ref_blue_noise_uv
from loupiote_tpu.scene import build_scene_buffers as ref_buffers
from loupiote_tpu.scene.procedural import arch_camera
from loupiote_tpu.scene.procedural import build_arch_scene as ref_arch
from loupiote_tpu_torch import from_reference, generate_blue_noise
from loupiote_tpu_torch.ops.raygen import generate_rays
from loupiote_tpu_torch.parallel import (make_mesh, replicate_scene,
                                         trace_paths_sharded)
from loupiote_tpu_torch.render.integrator import trace_paths
from loupiote_tpu_torch.render.renderer import blue_noise_uv
from torch_port_helpers import numpy_bvh, replay_uniforms, shard_uniforms

CPU = torch.device("cpu")
B = 3
PLANES = ("normal", "depth", "mesh_id", "albedo", "world_pos")


def _t(x):
    return torch.from_numpy(np.array(x))


def cpu_mesh(n_tiles, n_spp):
    return make_mesh(n_tiles, n_spp, devices=[CPU] * (n_tiles * n_spp))


def assert_close(got, ref, mean=True):
    """99.5% of pixels within rtol 1e-4 / atol 1e-5; the mean within
    1e-4 relative (``mean``)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    close = np.isclose(got, ref, rtol=1e-4, atol=1e-5)
    close = close.reshape(close.shape[0] * close.shape[1], -1).all(axis=1)
    assert close.mean() >= 0.995, close.mean()
    if mean:
        assert abs(got.mean() / ref.mean() - 1) < 1e-4


@pytest.fixture(scope="module")
def noise_tex():
    return (generate_blue_noise()[..., :2].astype(np.float32) + 0.5) / 256


@pytest.fixture(scope="module")
def arch20k():
    """Under both node gates (K2/K3 twins, no sort), as the reference's
    sharded trace never turns its sort off."""
    with numpy_bvh():
        ref = ref_buffers(ref_arch(20_000))
    return ref, from_reference(ref, device="cpu")


@pytest.fixture(scope="module")
def arch90k():
    with numpy_bvh():
        ref = ref_buffers(ref_arch(90_000))
    return ref, from_reference(ref, device="cpu")


@pytest.mark.parametrize("row_offset,rows", [(0, 8), (8, 8), (5, 3),
                                             (16, 8), (12, 12)])
def test_slab_rays_match_reference(row_offset, rows):
    """Origins exact, directions within 2 ulp of the reference's (XLA:CPU
    fuses the camera basis sum, as test_torch_shade.py::test_generate_rays
    says); the slab's rays equal those rows of the whole image's."""
    W, H = 128, 24
    cam = arch_camera()
    jitter = np.random.default_rng(7).random((W * H, 2)).astype(np.float32)
    sl = slice(row_offset * W, (row_offset + rows) * W)
    ref_o, ref_d = ref_generate_rays(jnp.asarray(cam), W, H, 0.7853982,
                                     jnp.asarray(jitter[sl]),
                                     row_offset=row_offset, rows=rows)
    o, d = generate_rays(_t(cam), W, H, 0.7853982, _t(jitter[sl]),
                         row_offset=row_offset, rows=rows)
    assert o.shape == d.shape == (rows * W, 3)
    np.testing.assert_array_equal(o.numpy(), np.asarray(ref_o))
    np.testing.assert_array_max_ulp(d.numpy(), np.asarray(ref_d), maxulp=2)
    full_o, full_d = generate_rays(_t(cam), W, H, 0.7853982, _t(jitter))
    assert torch.equal(o, full_o[sl]) and torch.equal(d, full_d[sl])


@pytest.mark.parametrize("row_offset,rows", [(0, 24), (8, 8), (60, 10),
                                             (64, 64)])
def test_slab_blue_noise_matches_reference(noise_tex, row_offset, rows):
    """Exact, as the whole plane is (test_torch_content.py); the slab's
    pairs equal those rows of the whole plane's (64-row texture, so row
    64 wraps to 0)."""
    W, H = 96, 128
    for fc, dim in ((1, 0), (3, 1), (12345, 8)):
        ref = ref_blue_noise_uv(jnp.asarray(noise_tex), jnp.int32(fc), W, H,
                                dim=dim, row_offset=row_offset, rows=rows)
        got = blue_noise_uv(_t(noise_tex), fc, W, H, dim=dim,
                            row_offset=row_offset, rows=rows)
        assert got.shape == (rows * W, 2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        full = blue_noise_uv(_t(noise_tex), fc, W, H, dim=dim)
        assert torch.equal(got, full[row_offset * W:(row_offset + rows) * W])


@pytest.mark.parametrize("case", ["plain", "blue_noise", "spp2_sort_on"])
def test_slab_trace_matches_reference(arch90k, noise_tex, case):
    """Rows 8-15 of a 128x24 frame, as
    test_torch_frame.py::test_frame_matches_reference_with_replayed_uniforms
    traces a whole 128x8 frame: arch-90k (past the sort gate), the
    reference's uniforms of the slab's 1,024 slots replayed."""
    ref, port = arch90k
    W, H, row_offset, rows = 128, 24, 8, 8
    spp = 2 if case.startswith("spp2") else 1
    sort = case == "spp2_sort_on"
    key = jr.PRNGKey(6)
    cam = arch_camera()
    ref_kw, kw = {}, {}
    if case != "plain":
        fc = 3
        ref_kw = dict(noise_tex=jnp.asarray(noise_tex),
                      frame_count=jnp.int32(fc))
        kw = dict(noise_tex=_t(noise_tex), frame_count=fc)
        if spp == 1:
            for d, name in ((0, "jitter"), (1, "nee_uv")):
                ref_kw[name] = ref_blue_noise_uv(
                    ref_kw["noise_tex"], ref_kw["frame_count"], W, H, dim=d,
                    row_offset=row_offset, rows=rows)
                kw[name] = blue_noise_uv(kw["noise_tex"], fc, W, H, dim=d,
                                         row_offset=row_offset, rows=rows)

    @jax.jit
    def frame(bufs, k, extra):
        return ref_trace_paths(bufs, jnp.asarray(cam), W, H, k, bounces=B,
                               sort_rays=sort, spp=spp, row_offset=row_offset,
                               rows=rows, **extra)

    ref_img, ref_gb = frame(ref, key, ref_kw)
    img, gb = trace_paths(port, _t(cam), W, H, bounces=B, sort_rays=sort,
                          spp=spp, row_offset=row_offset, rows=rows,
                          uniforms=replay_uniforms(key, spp * W * rows, B),
                          **kw)
    assert img.shape == (rows * W, 3)
    assert_close(img.numpy(), ref_img)
    assert (img.numpy().sum(axis=1) > 0).mean() > 0.4
    for name in PLANES:
        assert_close(getattr(gb, name).numpy().reshape(rows, W, -1),
                     np.asarray(getattr(ref_gb, name)).reshape(rows, W, -1),
                     mean=False)


@pytest.mark.parametrize("mesh_shape,size", [((2, 2), (128, 16)),
                                             ((3, 1), (128, 24)),
                                             ((2, 1), (128, 12))],
                         ids=["2x2_tiled", "3x1_tiled", "2x1_untiled"])
def test_sharded_trace_matches_reference(arch20k, mesh_shape, size):
    """The image and all five G-buffer planes against the reference's
    sharded trace, every shard's uniforms replayed from its folded key
    (2 bounces: each mesh compiles its own reference program)."""
    ref, port = arch20k
    W, H = size
    n_tiles, n_spp = mesh_shape
    rows = H // n_tiles
    key = jr.PRNGKey(11)
    cam = arch_camera()
    ref_mesh = ref_make_mesh(n_tiles, n_spp)
    ref_img, ref_gb = ref_sharded(ref, jnp.asarray(cam), key, mesh=ref_mesh,
                                  width=W, height=H, bounces=2)
    mesh = cpu_mesh(n_tiles, n_spp)
    img, gb = trace_paths_sharded(
        replicate_scene(port, mesh), _t(cam), mesh=mesh, width=W, height=H,
        bounces=2, uniforms=shard_uniforms(key, mesh_shape, rows * W, 2))
    assert img.shape == (H, W, 3)
    assert_close(img.numpy(), ref_img)
    assert (img.numpy().sum(axis=2) > 0).mean() > 0.4
    for name in PLANES:
        assert gb[name].shape == np.asarray(ref_gb[name]).shape, name
        assert_close(gb[name].numpy().reshape(H, W, -1),
                     np.asarray(ref_gb[name]).reshape(H, W, -1), mean=False)


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_tile_split_gbuffer_is_exact(arch20k, mesh_shape):
    """One full-frame jitter: the gathered G-buffer is bit-equal to the
    unsharded trace's (a pixel's primary ray and its hit do not depend on
    the slab it is traced in)."""
    _, port = arch20k
    W, H = 128, 32
    g = torch.Generator().manual_seed(2)
    jitter = torch.rand(H * W, 2, generator=g)
    nee_uv = torch.rand(H * W, 2, generator=g)
    cam = _t(arch_camera())
    _, whole = trace_paths(port, cam, W, H, torch.Generator().manual_seed(0),
                           bounces=1, jitter=jitter, nee_uv=nee_uv)
    img, gb = trace_paths_sharded(port, cam, (0, 1), mesh=cpu_mesh(
        *mesh_shape), width=W, height=H, bounces=1, jitter=jitter,
        nee_uv=nee_uv)
    assert torch.isfinite(img).all()
    for name in PLANES:
        want = getattr(whole, name)
        assert torch.equal(gb[name].reshape(want.shape), want), name


def test_one_shard_mesh_is_trace_paths(arch20k):
    """A 1x1 mesh with uniforms U is trace_paths with U, bit for bit."""
    _, port = arch20k
    W, H = 128, 16
    cam = _t(arch_camera())
    u = replay_uniforms(jr.PRNGKey(4), W * H, B)
    rad, gb = trace_paths(port, cam, W, H, bounces=B, uniforms=u)
    img, gbs = trace_paths_sharded(port, cam, mesh=cpu_mesh(1, 1), width=W,
                                   height=H, bounces=B, uniforms=[[u]])
    assert torch.equal(img.reshape(-1, 3), rad)
    for name in PLANES:
        want = getattr(gb, name)
        assert torch.equal(gbs[name].reshape(want.shape), want), name


def test_mesh_shapes_and_errors():
    """make_mesh as the reference's (tests/test_parallel.py::
    test_mesh_shapes), a device listed more than once; with no devices
    given and no card it raises (no fallback to the CPU); a height that
    the tiles do not divide raises."""
    m = make_mesh(devices=[CPU] * 8)
    assert m.shape == {"tiles": 8, "spp": 1}
    m2 = make_mesh(n_tiles=4, n_spp=2, devices=[CPU] * 8)
    assert m2.shape == {"tiles": 4, "spp": 2}
    assert m2.devices[3, 1] == CPU and m2.distinct() == [CPU]
    with pytest.raises(ValueError):
        make_mesh(n_tiles=3, n_spp=3, devices=[CPU] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()
    with pytest.raises(ValueError):
        trace_paths_sharded({CPU: None}, torch.eye(4), (0,), mesh=m2,
                            width=8, height=6)
