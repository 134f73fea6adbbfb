"""The port's wavefront stages (raygen, tile order, sort keys, shading,
tonemap) against the reference functions on the same numpy inputs.

Tile order and sort keys are exact; ray directions within 2 ulp.
shade_step gets the same
state, the same hits and the reference's own uniforms (its jax.random
splits replayed), on the arch hall and on a textured hall with props under
an HDR sky (atlas sampling, the environment on a miss, env NEE and the
final gather's probe term); its float outputs agree within rtol 1e-5 /
atol 1e-6 (transcendentals and XLA:CPU's fused multiply-adds differ in
the last bits), its bool outputs exactly. Display bytes agree within
1 LSB.
"""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from loupiote_tpu.ops.intersect import intersect_any as ref_intersect_any
from loupiote_tpu.ops.raygen import generate_rays as ref_generate_rays
from loupiote_tpu.ops.shade import BounceState as RefState
from loupiote_tpu.ops.shade import scene_exit_t as ref_scene_exit_t
from loupiote_tpu.ops.shade import shade_step as ref_shade_step
from loupiote_tpu.ops.sort import ray_sort_key as ref_sort_key
from loupiote_tpu.ops.tonemap import to_display as ref_to_display
from loupiote_tpu.render import integrator as ref_integrator
from loupiote_tpu.scene import build_probe as ref_build_probe
from loupiote_tpu.scene import build_scene_buffers as ref_buffers
from loupiote_tpu.scene.procedural import arch_camera, build_arch_scene
from loupiote_tpu_torch import from_reference
from loupiote_tpu_torch.ops.intersect import Hit
from loupiote_tpu_torch.ops.raygen import generate_rays
from loupiote_tpu_torch.ops.shade import BounceState, scene_exit_t, shade_step
from loupiote_tpu_torch.ops.sort import DEAD_KEY, ray_sort_key, sort_order
from loupiote_tpu_torch.ops.tonemap import to_display
from loupiote_tpu_torch.render import integrator
from torch_port_helpers import numpy_bvh, sky_equirect, step_uniforms

W, H = 128, 8


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def arch8k():
    with numpy_bvh():
        ref = ref_buffers(build_arch_scene(8_000))
    return ref, from_reference(ref, device="cpu")


@pytest.fixture(scope="module")
def content8k():
    """The textured arch-8k hall with 20 props under an HDR sky."""
    with numpy_bvh():
        ref = ref_buffers(build_arch_scene(8_000, textured=True, props=20),
                          probe=ref_build_probe(sky_equirect(64, 128)))
    return ref, from_reference(ref, device="cpu")


@pytest.fixture(scope="module")
def primary():
    """Tile-ordered 128x8 primary rays of the arch camera (numpy)."""
    jitter = np.random.default_rng(3).random((W * H, 2)).astype(np.float32)
    ro, rd = ref_generate_rays(jnp.asarray(arch_camera()), W, H, 0.7853982,
                               jnp.asarray(jitter))
    return (np.asarray(ref_integrator.to_tile_order(ro, W, H)),
            np.asarray(ref_integrator.to_tile_order(rd, W, H)), jitter)


def test_generate_rays(primary):
    """Origins exact; directions within 1 ulp: XLA:CPU fuses the camera
    basis sum into multiply-adds (4% of components differ, by up to 2 ulp);
    the port rounds each product, as numpy does."""
    _, _, jitter = primary
    cam = arch_camera()
    ref_o, ref_d = ref_generate_rays(jnp.asarray(cam), W, H, 0.7853982,
                                     jnp.asarray(jitter))
    o, d = generate_rays(_t(cam), W, H, 0.7853982, _t(jitter))
    np.testing.assert_array_equal(o.numpy(), np.asarray(ref_o))
    np.testing.assert_array_max_ulp(d.numpy(), np.asarray(ref_d), maxulp=2)


def test_tile_order_exact():
    x = np.arange(256 * 16 * 3, dtype=np.float32).reshape(-1, 3)
    tiled = integrator.to_tile_order(_t(x), 256, 16)
    np.testing.assert_array_equal(
        tiled.numpy(), np.asarray(ref_integrator.to_tile_order(x, 256, 16)))
    np.testing.assert_array_equal(
        integrator.from_tile_order(tiled, 256, 16).numpy(), x)


def test_ray_sort_key_exact(arch8k, primary):
    ref, port = arch8k
    ro, rd, _ = primary
    rng = np.random.default_rng(5)
    pos = (ro + rd * rng.random((W * H, 1)).astype(np.float32) * 40)
    dirs = (rng.random((W * H, 3)) - 0.5).astype(np.float32)
    alive = rng.random(W * H) < 0.7
    lo, hi = np.asarray(ref.node_min[0]), np.asarray(ref.node_max[0])
    ref_key = np.asarray(ref_sort_key(jnp.asarray(pos), jnp.asarray(dirs),
                                      jnp.asarray(alive), jnp.asarray(lo),
                                      jnp.asarray(hi)))
    key = ray_sort_key(_t(pos), _t(dirs), _t(alive), port.node_min[0],
                       port.node_max[0])
    assert key.dtype == torch.int64
    np.testing.assert_array_equal(key.numpy(), ref_key.astype(np.int64))
    assert (key.numpy()[~alive] == DEAD_KEY).all()


def test_sort_order_same_permutation():
    """Many equal keys (shared cells, dead rays): the stable order matches
    jnp.argsort's."""
    rng = np.random.default_rng(6)
    key = rng.integers(0, 40, 4096).astype(np.uint32)
    key[rng.random(4096) < 0.3] = np.uint32(0xFFFFFFFF)
    np.testing.assert_array_equal(
        sort_order(_t(key.astype(np.int64))).numpy(),
        np.asarray(jnp.argsort(jnp.asarray(key))))


def _states(ref_state):
    return BounceState(*(_t(x) for x in ref_state))


def _compare(ref_state, state):
    for name, a in zip(RefState._fields, ref_state):
        b = getattr(state, name).numpy()
        if b.dtype == bool:
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)
        else:
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("last, scene", [
    (False, "arch8k"), (True, "arch8k"), (False, "content8k"),
    (True, "content8k")],
    ids=["bounce0", "last", "bounce0-content8k", "last-content8k"])
def test_shade_step_matches_reference(request, primary, last, scene):
    ref, port = request.getfixturevalue(scene)
    assert port.has_probe == port.has_textures == (scene == "content8k")
    ro, rd, _ = primary
    R = W * H
    state = RefState(ro=jnp.asarray(ro), rd=jnp.asarray(rd),
                     throughput=jnp.ones((R, 3)), radiance=jnp.zeros((R, 3)),
                     alive=jnp.ones(R, jnp.bool_), bsdf_pdf=jnp.zeros(R),
                     use_mis=jnp.zeros(R, jnp.bool_))
    key0, key1 = jr.split(jr.PRNGKey(7))
    if last:
        # The state and hits of the next bounce, from the reference.
        hit = ref_intersect_any(ref, state.ro, state.rd, active=state.alive)
        state, _ = ref_shade_step(ref, state, hit, key0)
    hit = ref_intersect_any(ref, state.ro, state.rd, active=state.alive)
    key = key1 if last else key0
    ref_out, _ = ref_shade_step(ref, state, hit, key, last=last,
                                bounce=2 if last else 0)
    u = step_uniforms(key, R)
    out = shade_step(port, _states(state), Hit(*(_t(x) for x in hit[:4])),
                     u_sel=u.u_sel, u1_l=u.u1_l, u2_l=u.u2_l,
                     u_lobe=u.u_lobe, u1=u.u1, u2=u.u2, u1_e=u.u1_e,
                     u2_e=u.u2_e, last=last)
    _compare(ref_out, out)
    assert float(out.radiance.mean()) > 0
    assert out.alive.any() != last


def test_scene_exit_t_matches_reference(arch8k, primary):
    ref, port = arch8k
    ro, rd, _ = primary
    np.testing.assert_allclose(
        scene_exit_t(port, _t(ro), _t(rd)).numpy(),
        np.asarray(ref_scene_exit_t(ref, jnp.asarray(ro), jnp.asarray(rd))),
        rtol=1e-6)


def test_to_display_within_one_lsb():
    rng = np.random.default_rng(8)
    hdr = (rng.random((64, 64, 3)) ** 3 * 8).astype(np.float32)
    for curve in ("aces", "reinhard", "linear"):
        a = to_display(_t(hdr), curve).numpy().astype(int)
        b = np.asarray(ref_to_display(jnp.asarray(hdr), curve)).astype(int)
        assert np.abs(a - b).max() <= 1, curve
