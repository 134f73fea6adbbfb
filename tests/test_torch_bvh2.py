"""The port's BVH2 traversal (loupiote_tpu_torch/ops/bvh2.py; on the CPU its
plain twins bvh2_trace_plain and bvh2_occluded_plain) against the
reference's Pallas kernels K2 and K3 in interpret mode, on the same tables.

Tolerances. tri: equal on every ray whose best t is not tied within 2 ulp
between two triangles (the port orders children by each ray's own
direction sign, the reference by a 128-ray sub-packet's majority sign).
Against the unfused Moller-Trumbore in numpy float32, t, u and v are
exact. Against the JAX outputs, t is held to 1e-5 relative and u, v to
5e-5 absolute: XLA:CPU contracts multiply-adds in the reference kernel.
Blocked bits (K3, K2's any-hit mode) are equal.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loupiote_tpu.scene.types as ref_types
from loupiote_tpu.ops.pallas_intersect import (intersect_pallas,
                                               occluded_pallas)
from loupiote_tpu.ops.raygen import generate_rays as ref_generate_rays
from loupiote_tpu.scene import build_scene_buffers as ref_buffers
from loupiote_tpu.scene.procedural import arch_camera, build_arch_scene
import loupiote_tpu_torch.scene.types as port_types
from loupiote_tpu_torch import _build, build_scene_buffers, from_reference
from loupiote_tpu_torch.accel.bvh import bvh_max_depth
from loupiote_tpu_torch.ops import bvh2, intersect, wide
from loupiote_tpu_torch.ops.intersect import T_MIN, moller_trumbore
from torch_port_helpers import (assert_same_hits, nonfinite_rays, numpy_bvh,
                                random_rays, random_tris, soup_scene, t_of)

R = 1024


@pytest.fixture(scope="module")
def soup():
    """The 300-triangle soup of tests/test_pallas_intersect.py."""
    tris = random_tris(seed=1234, n=300)
    with numpy_bvh():
        ref = ref_buffers(soup_scene(ref_types, *tris))
    return ref, from_reference(ref, device="cpu"), tris


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _check_closest(ref, ref_hit, port_hit, ro, rd):
    tp = np.asarray(ref.tri_pack)
    tri = port_hit.tri.numpy()
    same = assert_same_hits(tp, ro, rd, np.asarray(ref_hit.tri), tri)
    hit = same & (tri >= 0)
    u, v, t_exact = t_of(tp, ro, rd, tri)
    np.testing.assert_array_equal(port_hit.t.numpy()[hit], t_exact[hit])
    np.testing.assert_array_equal(port_hit.u.numpy()[hit], u[hit])
    np.testing.assert_array_equal(port_hit.v.numpy()[hit], v[hit])
    np.testing.assert_allclose(port_hit.t.numpy()[same],
                               np.asarray(ref_hit.t)[same], rtol=1e-5)
    np.testing.assert_allclose(port_hit.u.numpy()[same],
                               np.asarray(ref_hit.u)[same], atol=5e-5)
    np.testing.assert_allclose(port_hit.v.numpy()[same],
                               np.asarray(ref_hit.v)[same], atol=5e-5)
    return hit.mean()


def test_closest_matches_pallas_kernel(soup):
    ref, port, tris = soup
    ro, rd = random_rays(tris, R)
    ref_hit = intersect_pallas(ref, jnp.asarray(ro), jnp.asarray(rd),
                               interpret=True, sub=8)
    port_hit = bvh2.intersect_bvh2(port, _t(ro), _t(rd))
    assert _check_closest(ref, ref_hit, port_hit, ro, rd) > 0.05


def test_closest_matches_pallas_kernel_with_tmax_and_mask(soup):
    ref, port, tris = soup
    ro, rd = random_rays(tris, R, seed=78)
    rng = np.random.default_rng(79)
    tmax = np.where(rng.random(R) < 0.5, 1e30,
                    rng.random(R) * 20).astype(np.float32)
    active = rng.random(R) < 0.8
    ref_hit = intersect_pallas(ref, jnp.asarray(ro), jnp.asarray(rd),
                               tmax=jnp.asarray(tmax),
                               active=jnp.asarray(active), interpret=True,
                               sub=8)
    port_hit = bvh2.intersect_bvh2(port, _t(ro), _t(rd), tmax=_t(tmax),
                                   active=_t(active))
    assert (port_hit.tri.numpy()[~active] == -1).all()
    np.testing.assert_array_equal(port_hit.t.numpy()[~active], tmax[~active])
    assert _check_closest(ref, ref_hit, port_hit, ro, rd) > 0.03


@pytest.mark.parametrize("dist", [3.0, 1e30])
def test_anyhit_mode_matches_pallas_kernel(soup, dist):
    ref, port, tris = soup
    ro, rd = random_rays(tris, R, seed=80)
    active = np.random.default_rng(81).random(R) < 0.9
    tmax = np.full(R, dist, np.float32)
    ref_b = np.asarray(intersect_pallas(
        ref, jnp.asarray(ro), jnp.asarray(rd), tmax=jnp.asarray(tmax),
        active=jnp.asarray(active), any_hit=True, interpret=True,
        sub=8).tri) >= 0
    port_b = bvh2.intersect_bvh2(port, _t(ro), _t(rd), tmax=_t(tmax),
                                 active=_t(active), any_hit=True).tri >= 0
    np.testing.assert_array_equal(port_b.numpy(), ref_b)
    assert 0 < ref_b.mean() < 1


@pytest.mark.parametrize("dist", [3.0, 1e30], ids=["bounded", "unbounded"])
def test_occluded_matches_pallas_kernel(soup, dist):
    """The rays of the any-hit test above. (Some seeds aim a ray exactly
    at a triangle's edge, v = 0 unfused; XLA:CPU's contracted products put
    v just below 0 there and the reference misses. The brute-force test
    below holds the port to the unfused formula on such rays.)"""
    ref, port, tris = soup
    ro, rd = random_rays(tris, R, seed=80)
    active = np.random.default_rng(81).random(R) < 0.9
    tmax = np.full(R, dist, np.float32)
    ref_b = np.asarray(occluded_pallas(ref, jnp.asarray(ro), jnp.asarray(rd),
                                       jnp.asarray(tmax),
                                       active=jnp.asarray(active),
                                       interpret=True, sub=8))
    port_b = bvh2.occluded_bvh2(port, _t(ro), _t(rd), _t(tmax),
                                active=_t(active)).numpy()
    np.testing.assert_array_equal(port_b, ref_b)
    assert 0 < port_b.mean() < 1
    assert not port_b[~active].any()


@pytest.mark.parametrize("dist", [3.0, 1e30], ids=["bounded", "unbounded"])
def test_nonfinite_rays_match_pallas_kernels(soup, dist):
    """Rays with +-inf or NaN origin components and +-inf, -0 or tiny
    direction components (lane_gather_bench's edge-case pattern): the
    twins' slab test, like the reference's, returns NaN from a NaN term,
    so K2's closest hits (t, u, v, tri), K2's any-hit mode and K3's
    blocked bits agree with the Pallas kernels' on every ray."""
    ref, port, tris = soup
    ro, rd = (x.numpy() for x in nonfinite_rays(
        *map(torch.from_numpy, random_rays(tris, R, seed=83)), 83))
    bad = ~(np.isfinite(ro).all(1) & np.isfinite(rd).all(1))
    assert 0.3 < bad.mean() < 0.8
    tmax = np.full(R, dist, np.float32)
    ref_hit = intersect_pallas(ref, jnp.asarray(ro), jnp.asarray(rd),
                               tmax=jnp.asarray(tmax), interpret=True, sub=8)
    port_hit = bvh2.intersect_bvh2(port, _t(ro), _t(rd), tmax=_t(tmax))
    same = assert_same_hits(np.asarray(ref.tri_pack), ro, rd,
                            np.asarray(ref_hit.tri), port_hit.tri.numpy())
    for name in ("t", "u", "v"):
        np.testing.assert_allclose(getattr(port_hit, name).numpy()[same],
                                   np.asarray(getattr(ref_hit, name))[same],
                                   rtol=1e-5, atol=5e-5, err_msg=name)
    assert (port_hit.tri.numpy()[~bad] >= 0).any()
    ref_any = np.asarray(intersect_pallas(
        ref, jnp.asarray(ro), jnp.asarray(rd), tmax=jnp.asarray(tmax),
        any_hit=True, interpret=True, sub=8).tri) >= 0
    port_any = bvh2.intersect_bvh2(port, _t(ro), _t(rd), tmax=_t(tmax),
                                   any_hit=True).tri >= 0
    np.testing.assert_array_equal(port_any.numpy(), ref_any)
    ref_b = np.asarray(occluded_pallas(ref, jnp.asarray(ro), jnp.asarray(rd),
                                       jnp.asarray(tmax), interpret=True,
                                       sub=8))
    port_b = bvh2.occluded_bvh2(port, _t(ro), _t(rd), _t(tmax)).numpy()
    np.testing.assert_array_equal(port_b, ref_b)


def test_arch8k_primary_rays():
    with numpy_bvh():
        ref = ref_buffers(build_arch_scene(8_000))
    port = from_reference(ref, device="cpu")
    assert port.num_nodes < intersect._WIDE_MIN_NODES
    jitter = np.random.default_rng(3).random((32 * 32, 2)).astype(np.float32)
    ro, rd = (np.asarray(x) for x in ref_generate_rays(
        jnp.asarray(arch_camera()), 32, 32, 0.7853982, jnp.asarray(jitter)))
    ref_hit = intersect_pallas(ref, jnp.asarray(ro), jnp.asarray(rd),
                               interpret=True, sub=8)
    port_hit = bvh2.intersect_bvh2(port, _t(ro), _t(rd))
    assert _check_closest(ref, ref_hit, port_hit, ro, rd) > 0.9


def test_twins_match_the_unfused_formula_by_brute_force(soup):
    """Closest hits and blocked bits against every triangle tested in
    numpy float32, one product at a time: exact."""
    _, port, tris = soup
    ro, rd = random_rays(tris, 512, seed=84)
    n = 512
    tmax = np.where(np.arange(n) % 2 == 0, 4.0, 1e30).astype(np.float32)
    tp = port.tri_pack.numpy()
    best_t = np.full(n, np.inf, np.float32)
    best_tri = np.full(n, -1)
    blocked = np.zeros(n, bool)
    for k in range(len(tris[0])):
        u, v, t = t_of(tp, ro, rd, np.full(n, k))
        ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > np.float32(1e-4))
        blocked |= ok & (t < tmax)
        better = ok & (t < best_t)
        best_t = np.where(better, t, best_t)
        best_tri = np.where(better, k, best_tri)
    hit = bvh2.intersect_bvh2(port, _t(ro), _t(rd))
    same = assert_same_hits(tp, ro, rd, best_tri, hit.tri.numpy())
    found = best_tri >= 0
    assert (hit.tri.numpy() >= 0).tolist() == found.tolist()
    np.testing.assert_array_equal(hit.t.numpy()[found & same],
                                  best_t[found & same])
    occ = bvh2.occluded_bvh2(port, _t(ro), _t(rd), _t(tmax)).numpy()
    np.testing.assert_array_equal(occ, blocked)
    anyhit = bvh2.intersect_bvh2(port, _t(ro), _t(rd), tmax=_t(tmax),
                                 any_hit=True).tri.numpy() >= 0
    np.testing.assert_array_equal(anyhit, blocked)


def test_dispatch_routes_by_node_count(soup, monkeypatch):
    """Under 8192 BVH2 nodes: K2 for closest-hit waves, K3 for shadow
    waves; at or past it: K1, in both modes."""
    _, port, tris = soup
    ro, rd = (_t(x) for x in random_rays(tris, 64, seed=85))
    dist = torch.full((64,), 5.0)
    calls = []
    for mod, name in ((bvh2, "bvh2_trace_plain"),
                      (bvh2, "bvh2_occluded_plain"),
                      (wide, "wide_trace_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=real, **k:
                            calls.append(_n) or _f(*a, **k))
    intersect.intersect_any(port, ro, rd)
    intersect.occluded(port, ro, rd, dist)
    assert calls == ["bvh2_trace_plain", "bvh2_occluded_plain"]
    calls.clear()
    big = dataclasses.replace(port, num_nodes=intersect._WIDE_MIN_NODES)
    intersect.intersect_any(big, ro, rd)
    intersect.occluded(big, ro, rd, dist)
    assert calls == ["wide_trace_plain", "wide_trace_plain"]


def test_plain_twins_run_for_cpu_tensors_only(soup):
    _, port, _ = soup
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no traversal"):
        bvh2.bvh2_trace(port.node_rows, port.leaf_rows, meta, meta, None,
                        None, False, port.num_nodes, port.stack_depth)
    with pytest.raises(ValueError, match="no traversal"):
        bvh2.bvh2_occluded(port.node_rows, port.leaf_rows, meta, meta, None,
                           None, port.end_index, port.num_nodes)


def test_kernel_wrapper_refuses_a_deep_stack(soup):
    _, port, _ = soup
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="stack"):
        bvh2._launch_trace(port.node_rows, port.leaf_rows, x, x, x[:, 0],
                           x[:, 0] > 0, False, port.num_nodes,
                           bvh2.STACK_MAX * 2)


@pytest.mark.parametrize("any_hit", [False, True])
def test_k2_counts_launches_by_mode(soup, monkeypatch, any_hit):
    """K2's launch site counts each launch under its mode and passes the
    C entry point the ray count, the step bound and the mode. The entry
    point is replaced by a stub that records them."""
    _, port, _ = soup
    calls = []

    def stub(*args):
        calls.append(args[-4:-1])  # n_rays, max_steps, any_hit
        return 0

    monkeypatch.setattr(bvh2._build, "load",
                        lambda name: SimpleNamespace(bvh2_trace=stub))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    x, t0 = torch.zeros((5, 3)), torch.zeros(5)
    _build.reset_counters()
    for _ in range(2):
        t, u, v, tri = bvh2._launch_trace(
            port.node_rows, port.leaf_rows, x, x, t0, t0 > 0, any_hit,
            port.num_nodes, port.stack_depth)
        assert t.shape == u.shape == v.shape == tri.shape == (5,)
    assert calls == [(5, bvh2.max_steps(port.num_nodes), int(any_hit))] * 2
    launches = _build.launches
    assert (launches["bvh2_trace", "closest"],
            launches["bvh2_trace", "anyhit"],
            launches["bvh2_occluded", None]) == ((0, 2, 0) if any_hit
                                                 else (2, 0, 0))
    _build.reset_counters()
    assert not launches


def test_step_bound_stops_and_counts_rays(soup):
    """A ray still traversing at the step bound stops and is counted, in
    both twins, as the kernels' capped counter does."""
    _, port, tris = soup
    ro, rd = (_t(x) for x in random_rays(tris, 256, seed=86))
    t0 = torch.full((256,), 1e30)
    on = torch.ones(256, dtype=torch.bool)
    _build.reset_counters()
    # num_nodes -15 -> a bound of 4 * -15 + 64 = 4 node visits.
    bvh2.bvh2_trace_plain(port.node_rows, port.leaf_rows, ro, rd, t0, on,
                          False, -15, port.stack_depth)
    capped = bvh2.capped_rays("cpu")
    assert 0 < capped <= 256
    bvh2.bvh2_occluded_plain(port.node_rows, port.leaf_rows, ro, rd, t0, on,
                             port.end_index, -15)
    assert capped < bvh2.capped_rays("cpu") <= 512
    _build.reset_counters()
    assert bvh2.capped_rays("cpu") == 0
    stats = {}
    bvh2.bvh2_trace_plain(port.node_rows, port.leaf_rows, ro, rd, t0, on,
                          False, port.num_nodes, port.stack_depth, stats)
    assert bvh2.capped_rays("cpu") == 0
    assert stats["visits"] >= 256 and stats["tri_tests"] > 0


def _k3_kernel_model(port, ro, rd, tmax, active, steps_max):
    """csrc/bvh2_traverse.cu::bvh2_occluded_kernel in torch, warp by warp
    (32 consecutive rays): a lane walks the pre-order until it holds a hit
    leaf, and a warp tests its lanes' leaves only when none of them needs
    another step. Returns (blocked (R,) bool, capped rays, node visits)."""
    R = ro.shape[0]
    W = -(-R // 32) * 32
    pad = W - R
    ro, rd = (torch.cat([x, torch.zeros(pad, 3)]) for x in (ro, rd))
    tmax = torch.cat([tmax, torch.zeros(pad)])
    active = torch.cat([active, torch.zeros(pad, dtype=torch.bool)])
    rows_i = port.node_rows.view(torch.int32)
    inv = [wide._safe_inv(rd[:, a]) for a in range(3)]
    node = torch.where(active, 0, -1).to(torch.int64)
    ln = torch.zeros(W, dtype=torch.int64)
    lrow = torch.zeros(W, dtype=torch.int64)
    steps = torch.zeros(W, dtype=torch.int64)
    blocked = torch.zeros(W, dtype=torch.bool)
    capped = 0
    while bool(((node >= 0) | (ln > 0)).any()):
        need = (node >= 0) & (ln == 0)
        warp_need = need.view(-1, 32).any(1).repeat_interleave(32)
        cap = need & (steps == steps_max)
        capped += int(cap.sum())
        node[cap] = -1
        go = torch.nonzero(need & ~cap).flatten()
        if go.numel():
            n = node[go]
            ints = rows_i[n]
            hit = bvh2._slab(port.node_rows[n], tuple(ro[go, a] for a in range(3)),
                             tuple(x[go] for x in inv), tmax[go])
            steps[go] += 1
            leaf = hit & (ints[:, 6] > 0)
            lrow[go[leaf]] = ints[leaf, 8].to(torch.int64)
            ln[go[leaf]] = ints[leaf, 6].to(torch.int64)
            nxt = torch.where(hit & (ints[:, 6] == 0), n + 1,
                              ints[:, 7].to(torch.int64))
            node[go] = torch.where(nxt < port.end_index, nxt, -1)
        test = torch.nonzero((ln > 0) & ~warp_need).flatten()
        if test.numel():
            ok = bvh2._leaf(port.leaf_rows, lrow[test], ln[test],
                            tuple(ro[test, a] for a in range(3)),
                            tuple(rd[test, a] for a in range(3)),
                            tmax[test])[0].any(dim=1)
            blocked[test[ok]] = True
            node[test[ok]] = -1
            ln[test] = 0
    return blocked[:R], capped, int(steps.sum())


@pytest.mark.parametrize("bound", ["sound", "capped"])
def test_k3_waiting_leaf_rows_keep_the_twins_bits_and_counts(soup, bound):
    """K3's schedule (leaf rows wait for the warp) against
    bvh2_occluded_plain: the blocked bits equal on every ray, and the rays
    stopped by the step bound and the node visits the same, at the real
    bound and at a bound of 4 visits (num_nodes -15) that stops most rays
    (a leaf visited before the bound is tested before the bound stops the
    ray, as in the twin)."""
    _, port, tris = soup
    ro, rd = (_t(x) for x in random_rays(tris, 1000, seed=87))
    rng = np.random.default_rng(88)
    tmax = torch.from_numpy(np.where(rng.random(1000) < 0.5, 3.0, 1e30)
                            .astype(np.float32))
    active = torch.from_numpy(rng.random(1000) < 0.9)
    num_nodes = port.num_nodes if bound == "sound" else -15
    _build.reset_counters()
    stats = {}
    want = bvh2.bvh2_occluded_plain(port.node_rows, port.leaf_rows, ro, rd,
                                    tmax, active, port.end_index, num_nodes,
                                    stats=stats) > 0
    got, capped, visits = _k3_kernel_model(port, ro, rd, tmax, active,
                                           bvh2.max_steps(num_nodes))
    assert torch.equal(got, want)
    assert capped == bvh2.capped_rays("cpu")
    assert visits == stats["visits"]
    if bound == "sound":
        assert capped == 0 and 0 < float(got.float().mean()) < 1
    else:
        assert 100 < capped < int(active.sum())


def test_k3_float4_windows_hold_each_triangle():
    """K3 reads triangle 4g + k of a leaf row from the three float4 words
    at float4 9g + 2k, at offset k: for every count of 1-14 triangles the
    windows hold exactly each triangle's 9 floats and stay in the row's
    128 floats."""
    row = np.arange(128)
    for count in range(1, bvh2.LEAF_CAP + 1):
        seen = []
        for g in range(-(-count // 4)):
            for k in range(4):
                if 4 * g + k < count:
                    q = 9 * g + 2 * k
                    window = row[4 * q:4 * q + 12]
                    assert 4 * q + 12 <= 128
                    tri = 4 * g + k
                    np.testing.assert_array_equal(window[k:k + 9],
                                                  row[9 * tri:9 * tri + 9])
                    seen.append(tri)
        assert seen == list(range(count))


def _dup_soup():
    """The soup with every triangle twice, under two indices: every hit is
    an exact tie, and the winner shows the visit order."""
    tris = tuple(np.concatenate([a, a]) for a in random_tris(seed=1234,
                                                             n=300))
    return build_scene_buffers(soup_scene(port_types, *tris),
                               device="cpu"), tris


def _k2_kernel_model(port, ro, rd, tmax, active, any_hit, steps_max):
    """csrc/bvh2_traverse.cu::bvh2_trace_kernel in torch, warp by warp (32
    consecutive rays): a lane walks near-first with its own stack of
    STACK_MAX entries until it holds a hit leaf (it pops its next node at
    once), and a warp tests its lanes' leaves only when none of them needs
    another step; a leaf folds its triangles in the row's order with a
    strict t < best, as the float4 windows do. Returns (t, u, v, tri,
    capped rays, node visits, most stack entries held)."""
    R = ro.shape[0]
    W = -(-R // 32) * 32
    pad = W - R
    ro, rd = (torch.cat([x, torch.zeros(pad, 3)]) for x in (ro, rd))
    best = torch.cat([tmax, torch.zeros(pad)])
    active = torch.cat([active, torch.zeros(pad, dtype=torch.bool)])
    rows_i = port.node_rows.view(torch.int32)
    inv = [wide._safe_inv(rd[:, a]) for a in range(3)]
    node = torch.where(active, 0, -1).to(torch.int64)
    stack = torch.full((W, bvh2.STACK_MAX), -7, dtype=torch.int64)
    sp = torch.zeros(W, dtype=torch.int64)
    ln, lrow, lfirst, steps = (torch.zeros(W, dtype=torch.int64)
                               for _ in range(4))
    bu, bv = torch.zeros(W), torch.zeros(W)
    btri = torch.full((W,), -1, dtype=torch.int32)
    capped = most = 0
    while bool(((node >= 0) | (ln > 0)).any()):
        need = (node >= 0) & (ln == 0)
        warp_need = need.view(-1, 32).any(1).repeat_interleave(32)
        cap = need & (steps == steps_max)
        capped += int(cap.sum())
        node[cap] = -1
        go = torch.nonzero(need & ~cap).flatten()
        if go.numel():
            n = node[go]
            ints = rows_i[n]
            hit = bvh2._slab(port.node_rows[n],
                             tuple(ro[go, a] for a in range(3)),
                             tuple(x[go] for x in inv), best[go])
            steps[go] += 1
            inner = hit & (ints[:, 6] == 0)
            gi = go[inner]
            if gi.numel():
                axis = ints[inner, 9].to(torch.int64)
                dax = rd[gi].gather(1, axis[:, None])[:, 0]
                left = n[inner] + 1
                right = ints[inner, 8].to(torch.int64)
                pos = dax >= 0.0
                stack[gi, sp[gi]] = torch.where(pos, right, left)
                sp[gi] += 1
                most = max(most, int(sp[gi].max()))
                node[gi] = torch.where(pos, left, right)
            leaf = hit & (ints[:, 6] > 0)
            lrow[go[leaf]] = ints[leaf, 8].to(torch.int64)
            ln[go[leaf]] = ints[leaf, 6].to(torch.int64)
            lfirst[go[leaf]] = ints[leaf, 9].to(torch.int64)
            po = go[~inner]
            has = sp[po] > 0
            sp[po[has]] -= 1
            node[po] = torch.where(has, stack[po, sp[po].clamp_min(0)], -1)
        test = torch.nonzero((ln > 0) & ~warp_need).flatten()
        if test.numel():
            tr = port.leaf_rows[lrow[test], :9 * bvh2.LEAF_CAP].reshape(
                -1, bvh2.LEAF_CAP, 9)
            u, v, t = moller_trumbore(
                tuple(ro[test, a][:, None] for a in range(3)),
                tuple(rd[test, a][:, None] for a in range(3)),
                tuple(tr[:, :, j] for j in range(9)))
            any_ok = torch.zeros(test.numel(), dtype=torch.bool)
            for k in range(bvh2.LEAF_CAP):  # the row's order, strict <
                ok = ((k < ln[test]) & (u[:, k] >= 0.0) & (v[:, k] >= 0.0)
                      & (u[:, k] + v[:, k] <= 1.0) & (t[:, k] > T_MIN)
                      & (t[:, k] < best[test]))
                any_ok |= ok
                sel = test[ok]
                best[sel] = t[ok, k]
                bu[sel] = u[ok, k]
                bv[sel] = v[ok, k]
                btri[sel] = (lfirst[sel] + k).to(torch.int32)
            if any_hit:
                node[test[any_ok]] = -1
            ln[test] = 0
    return (best[:R], bu[:R], bv[:R], btri[:R], capped, int(steps.sum()),
            most)


@pytest.mark.parametrize("bound", ["sound", "capped"])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("name", ["soup", "dup"])
def test_k2_waiting_leaf_rows_keep_the_twins_bits_and_counts(soup, name,
                                                             any_hit, bound):
    """K2's schedule (leaf rows wait for the warp) against
    bvh2_trace_plain: t, u, v and tri bit for bit on every ray, ties
    included (the dup soup has every triangle twice), the rays stopped by
    the step bound and the node visits the same, at the real bound and at
    a bound of 4 visits (num_nodes -15) that stops most rays; the stack
    never holds more entries than the tree's depth."""
    port, tris = (soup[1], soup[2]) if name == "soup" else _dup_soup()
    ro, rd = (_t(x) for x in random_rays(tris, 1000, seed=95))
    rng = np.random.default_rng(96)
    tmax = torch.from_numpy(np.where(rng.random(1000) < 0.5, 8.0, 1e30)
                            .astype(np.float32))
    active = torch.from_numpy(rng.random(1000) < 0.9)
    num_nodes = port.num_nodes if bound == "sound" else -15
    ints = port.node_rows.view(torch.int32)[:port.num_nodes].numpy()
    depth = bvh_max_depth(ints[:, 6], ints[:, 7])
    _build.reset_counters()
    stats = {}
    want = bvh2.bvh2_trace_plain(port.node_rows, port.leaf_rows, ro, rd,
                                 tmax, active, any_hit, num_nodes,
                                 port.stack_depth, stats=stats)
    *got, capped, visits, most = _k2_kernel_model(
        port, ro, rd, tmax, active, any_hit, bvh2.max_steps(num_nodes))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert capped == bvh2.capped_rays("cpu")
    assert visits == stats["visits"]
    assert most <= depth <= bvh2.STACK_MAX
    hits = want[3] >= 0
    if bound == "sound":
        assert capped == 0 and 0.02 < float(hits.float().mean()) < 1
        if name == "dup" and not any_hit:  # the first copy of a tie wins
            n = tris[0].shape[0] // 2
            assert (want[3][hits] < n).any()
    else:
        assert 100 < capped < int(active.sum())


def test_k2_float4_windows_fold_each_triangle_in_order(soup):
    """K2 reads triangle 4g + k of a leaf row from the three float4 words
    at float4 9g + 2k, at offset k, and folds them in the row's order: on
    every leaf row of the soup the windows give each triangle's 9 floats,
    ids first + 0 .. first + count - 1 in that order."""
    _, port, _ = soup
    ints = port.node_rows.view(torch.int32)[:port.num_nodes]
    leaves = torch.nonzero(ints[:, 6] > 0).flatten()
    words = port.leaf_rows.reshape(port.leaf_rows.shape[0], 32, 4)
    for nd in leaves.tolist():
        count, lrow, first = (int(ints[nd, c]) for c in (6, 8, 9))
        n = min(count, bvh2.LEAF_CAP)
        ids = []
        for g in range(-(-n // 4)):
            for k in range(4):
                if 4 * g + k < n:
                    q = 9 * g + 2 * k
                    window = words[lrow, q:q + 3].reshape(-1)
                    tri = 4 * g + k
                    want = port.leaf_rows[lrow, 9 * tri:9 * tri + 9]
                    assert torch.equal(window[k:k + 9], want)
                    ids.append(first + tri)
        assert ids == list(range(first, first + n))
