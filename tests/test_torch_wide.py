"""The port's wide traversal (loupiote_tpu_torch/ops/wide.py; on the CPU its
plain twin wide_trace_plain) against the reference Pallas kernel in
interpret mode and the reference SIMT traversal, on the same tables.

Tolerances. tri: equal on every ray whose best t is not tied within 2 ulp
between two triangles. t, u, v: within 2 ulp / 1e-5 of the reference's
Moller-Trumbore evaluated with every product rounded (numpy float32); the
port builds its kernel with --fmad=false to the same end. XLA:CPU contracts
multiply-adds in the reference's own code (its intersect_rays and
intersect_wide differ by up to 6 ulp in t on these rays), so against the
JAX outputs t is held to 1e-5 relative (measured: up to 11 ulp) and u, v
to 5e-5 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loupiote_tpu.scene.types as ref_types
from loupiote_tpu.ops.intersect import intersect_rays
from loupiote_tpu.ops.pallas_wide import intersect_wide as ref_intersect_wide
from loupiote_tpu.ops.raygen import generate_rays as ref_generate_rays
from loupiote_tpu.scene import build_scene_buffers as ref_buffers
from loupiote_tpu.scene.procedural import arch_camera, build_arch_scene
from loupiote_tpu_torch import from_reference
from loupiote_tpu_torch.ops import wide
from torch_port_helpers import (assert_same_hits, numpy_bvh, random_rays,
                                random_tris, soup_scene, t_of)


@pytest.fixture(scope="module")
def soup():
    tris = random_tris()
    with numpy_bvh():
        ref = ref_buffers(soup_scene(ref_types, *tris))
    return ref, from_reference(ref, device="cpu"), tris


def _port_hit(port, ro, rd, tmax=None, active=None):
    def t(x):
        return None if x is None else torch.from_numpy(np.array(x))

    return wide.intersect_wide(port, t(ro), t(rd), tmax=t(tmax),
                               active=t(active))


def _check_closest(ref, ref_hit, port_hit, ro, rd):
    tp = np.asarray(ref.tri_pack)
    ref_tri, tri = np.asarray(ref_hit.tri), port_hit.tri.numpy()
    same = assert_same_hits(tp, ro, rd, ref_tri, tri)
    hit = same & (tri >= 0)
    u, v, t_exact = t_of(tp, ro, rd, tri)
    t = port_hit.t.numpy()
    np.testing.assert_array_max_ulp(t[hit], t_exact[hit], maxulp=2)
    np.testing.assert_allclose(port_hit.u.numpy()[hit], u[hit], atol=1e-5)
    np.testing.assert_allclose(port_hit.v.numpy()[hit], v[hit], atol=1e-5)
    np.testing.assert_allclose(t[same], np.asarray(ref_hit.t)[same],
                               rtol=1e-5)
    np.testing.assert_allclose(port_hit.u.numpy()[same],
                               np.asarray(ref_hit.u)[same], atol=5e-5)
    np.testing.assert_allclose(port_hit.v.numpy()[same],
                               np.asarray(ref_hit.v)[same], atol=5e-5)
    return hit.mean()


def test_closest_matches_pallas_kernel_with_tmax_and_mask(soup):
    ref, port, tris = soup
    ro, rd = random_rays(tris, 1024)
    rng = np.random.default_rng(78)
    tmax = np.where(rng.random(1024) < 0.5, 1e30,
                    rng.random(1024) * 20).astype(np.float32)
    active = rng.random(1024) < 0.8
    ref_hit = ref_intersect_wide(ref, jnp.asarray(ro), jnp.asarray(rd),
                                 tmax=jnp.asarray(tmax),
                                 active=jnp.asarray(active), interpret=True,
                                 sub=8)
    port_hit = _port_hit(port, ro, rd, tmax, active)
    assert (port_hit.tri.numpy()[~active] == -1).all()
    np.testing.assert_array_equal(port_hit.t.numpy()[~active], tmax[~active])
    assert _check_closest(ref, ref_hit, port_hit, ro, rd) > 0.05


def test_closest_matches_simt_oracle(soup):
    ref, port, tris = soup
    ro, rd = random_rays(tris, 1024, seed=79)
    ref_hit = intersect_rays(ref, jnp.asarray(ro), jnp.asarray(rd))
    port_hit = _port_hit(port, ro, rd)
    assert _check_closest(ref, ref_hit, port_hit, ro, rd) > 0.05


@pytest.mark.parametrize("dist", [3.0, 1e30])
def test_anyhit_matches_pallas_kernel(soup, dist):
    ref, port, tris = soup
    ro, rd = random_rays(tris, 1024, seed=80)
    active = np.random.default_rng(81).random(1024) < 0.9
    tmax = np.full(1024, dist, np.float32)
    # occluded_wide's body, at the 1024-ray grid cell the other tests use
    # (one interpret-mode compile instead of one at 8192 rays).
    act = jnp.asarray(active)
    ref_b = np.asarray((ref_intersect_wide(
        ref, jnp.asarray(ro), jnp.asarray(rd), tmax=jnp.asarray(tmax),
        active=act, any_hit=True, interpret=True, sub=8).tri > 0) & act)
    port_b = wide.occluded_wide(port, torch.from_numpy(ro),
                                torch.from_numpy(rd), torch.from_numpy(tmax),
                                active=torch.from_numpy(active)).numpy()
    np.testing.assert_array_equal(port_b, ref_b)
    assert 0 < port_b.mean() < 1


def test_arch8k_primary_rays():
    with numpy_bvh():
        ref = ref_buffers(build_arch_scene(8_000))
    port = from_reference(ref, device="cpu")
    jitter = np.random.default_rng(3).random((32 * 32, 2)).astype(np.float32)
    ro, rd = (np.asarray(x) for x in ref_generate_rays(
        jnp.asarray(arch_camera()), 32, 32, 0.7853982, jnp.asarray(jitter)))
    ref_hit = ref_intersect_wide(ref, jnp.asarray(ro), jnp.asarray(rd),
                                 interpret=True, sub=8)
    port_hit = _port_hit(port, ro, rd)
    assert _check_closest(ref, ref_hit, port_hit, ro, rd) > 0.9


def test_single_triangle_scene_has_synthetic_root():
    v0 = np.array([[-1, -1, 0]], np.float32)
    v1 = np.array([[1, -1, 0]], np.float32)
    v2 = np.array([[0, 1, 0]], np.float32)
    ref = ref_buffers(soup_scene(ref_types, v0, v1, v2))
    port = from_reference(ref, device="cpu")
    ptr = port.trav_rows.view(torch.int32)[0, 6::16]
    assert (ptr == -1).sum() == 7 and int(ptr.max()) == (1 | (1 << 30))
    xs = np.linspace(-1.5, 1.5, 16, dtype=np.float32)
    ro = np.stack([np.repeat(xs, 16), np.tile(xs, 16),
                   np.full(256, 5.0, np.float32)], axis=1)
    rd = np.tile(np.array([[0, 0, -1]], np.float32), (256, 1))
    port_hit = _port_hit(port, ro, rd)
    u, v, t = t_of(np.asarray(ref.tri_pack), ro, rd, np.zeros(256, int))
    inside = (u >= 0) & (v >= 0) & (u + v <= 1)
    assert 0.1 < inside.mean() < 0.5
    np.testing.assert_array_equal(port_hit.tri.numpy(),
                                  np.where(inside, 0, -1))
    far = np.float32(1e30)
    np.testing.assert_array_equal(port_hit.t.numpy(),
                                  np.where(inside, np.float32(5.0), far))


def test_plain_twin_runs_for_cpu_tensors_only(soup, monkeypatch):
    _, port, tris = soup
    ro, rd = random_rays(tris, 64, seed=82)
    calls = []
    real = wide.wide_trace_plain
    monkeypatch.setattr(wide, "wide_trace_plain",
                        lambda *a: calls.append(1) or real(*a))
    _port_hit(port, ro, rd)
    assert calls == [1]
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no traversal"):
        wide.wide_trace(port.trav_rows, meta, meta, None, None, False,
                        port.wide_end, port.wide_stack)


def test_kernel_wrapper_refuses_a_deep_stack(soup):
    _, port, _ = soup
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="stack"):
        wide._launch(port.trav_rows, x, x, x[:, 0], x[:, 0] > 0, False,
                     port.wide_end, wide.STACK_MAX * 2)


def test_step_bound_stops_and_counts_rays(soup):
    """A ray still traversing at the step bound stops and is counted,
    as the kernel's capped counter does."""
    _, port, tris = soup
    ro, rd = random_rays(tris, 256, seed=83)
    wide.reset_counters()
    wide.wide_trace_plain(port.trav_rows, torch.from_numpy(ro),
                          torch.from_numpy(rd), torch.full((256,), 1e30),
                          torch.ones(256, dtype=torch.bool), False, -15,
                          port.wide_stack)
    # wide_end -15 -> a bound of 4 * -15 + 64 = 4 row visits.
    assert 0 < wide.capped_rays("cpu") <= 256
    wide.reset_counters()
    assert wide.capped_rays("cpu") == 0
