"""The port's treelet traversal end to end
(loupiote_tpu_torch/treelet/pipeline.py, on the CPU through the plain
twins) against the reference's (experiments/treelet/pipeline.py, Pallas
kernels in interpret mode), and a frame traced through it.

Tolerances. tri: equal on every ray whose best t is not tied within 2 ulp
between two triangles; t within 1e-5 relative where tri is the same
(XLA:CPU contracts the reference's multiply-adds). Any-hit: blocked bits
equal. Frame: the standard of tests/test_torch_frame.py, 99.5% of pixels
within rtol 1e-4 / atol 1e-5 and the mean within 1e-3, against the same
frame traced without treelets.
"""

import os
import sys

import numpy as np
import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import jax.numpy as jnp  # noqa: E402

import loupiote_tpu.scene.types as ref_types  # noqa: E402
from experiments.treelet.pipeline import \
    treelet_intersect as ref_treelet_intersect  # noqa: E402
from loupiote_tpu.scene import build_scene_buffers as ref_buffers  # noqa: E402
from loupiote_tpu_torch import (_build, arch_camera,  # noqa: E402
                                build_arch_scene, build_scene_buffers,
                                from_reference, trace_paths)
from loupiote_tpu_torch._build import DeviceCounter, full_device  # noqa: E402
from loupiote_tpu_torch.ops import bvh2  # noqa: E402
from loupiote_tpu_torch.ops.intersect import intersect_any  # noqa: E402
from loupiote_tpu_torch.render.integrator import draw_uniforms  # noqa: E402
from loupiote_tpu_torch.treelet import lane_top, pipeline  # noqa: E402
from loupiote_tpu_torch.treelet.pipeline import (treelet_intersect,  # noqa: E402
                                                 treelet_occluded)
from torch_port_helpers import (assert_same_hits, numpy_bvh,  # noqa: E402
                                random_tris, soup_scene)

R = 1024


@pytest.fixture(scope="module")
def scene():
    """The 2,500-triangle soup of experiments/treelet/tests/test_treelet.py
    with treelet tables (reference build, numpy BVH), carried to the port
    by from_reference; and 1,024 rays with tmax and an active mask."""
    tris = random_tris(seed=42, n=2500, spread=8.0)
    with numpy_bvh():
        ref = ref_buffers(soup_scene(ref_types, *tris), treelets=True)
    rng = np.random.default_rng(7)
    ro = ((rng.random((R, 3)) - 0.5) * 10).astype(np.float32)
    rd = (rng.random((R, 3)) - 0.5).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    active = rng.random(R) > 0.1
    tmax = np.where(rng.random(R) > 0.5, 6.0, 1e30).astype(np.float32)
    return ref, from_reference(ref, device="cpu"), (ro, rd, tmax, active)


_ref_cache = {}


def _reference(scene, monkeypatch, binning, any_hit):
    key = (binning, any_hit)
    if key not in _ref_cache:
        ref, _, (ro, rd, tmax, active) = scene
        monkeypatch.setenv("LOUPIOTE_REGROUP", binning)
        hit = ref_treelet_intersect(ref, jnp.asarray(ro), jnp.asarray(rd),
                                    tmax=jnp.asarray(tmax),
                                    active=jnp.asarray(active),
                                    any_hit=any_hit, interpret=True)
        _ref_cache[key] = (np.asarray(hit.t), np.asarray(hit.tri))
    return _ref_cache[key]


def _port(port, rays, any_hit, regroup):
    ro, rd, tmax, active = (torch.from_numpy(x) for x in rays)
    hit = treelet_intersect(port, ro, rd, tmax=tmax, active=active,
                            any_hit=any_hit, regroup=regroup)
    return hit.t.numpy(), hit.tri.numpy()


def _check(ref, rays, want, got, any_hit):
    (wt, wtri), (gt, gtri) = want, got
    active = rays[3]
    assert (gtri[~active] == -1).all()
    if any_hit:
        np.testing.assert_array_equal(gtri >= 0, wtri >= 0)
        return
    same = assert_same_hits(np.asarray(ref.tri_pack), rays[0], rays[1],
                            wtri, gtri)
    assert same.mean() > 0.999
    np.testing.assert_allclose(gt[same], wt[same], rtol=1e-5)
    assert (gtri >= 0).sum() > 100


@pytest.mark.parametrize("binning", ["xla", "count"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_treelet_intersect_matches_reference(scene, monkeypatch, binning,
                                             any_hit):
    """Both of the port's binnings against the reference under each
    LOUPIOTE_REGROUP, in closest-hit and any-hit mode."""
    ref, port, rays = scene
    want = _reference(scene, monkeypatch, binning, any_hit)
    for regroup in ("count", "sort"):
        _check(ref, rays, want, _port(port, rays, any_hit, regroup), any_hit)


def test_starved_budget_falls_back_and_matches(scene, monkeypatch):
    """PAIR_BUDGET = 1 sends rays through the fallback (here K2's twin: the
    soup is under 8,192 BVH2 nodes); the hits still match."""
    ref, port, rays = scene
    want = _reference(scene, monkeypatch, "xla", False)
    monkeypatch.setattr(lane_top, "PAIR_BUDGET", 1)
    _build.reset_counters()
    for regroup in ("count", "sort"):
        _check(ref, rays, want, _port(port, rays, False, regroup), False)
    assert pipeline.fallback_rays("cpu") > 50


def test_device_counter_names_one_counter_per_card(monkeypatch):
    """Kernels add to the counter of a tensor's device ("cuda:0"); callers
    read it by "cuda": both must name one counter."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert full_device("cuda") == full_device("cuda:0") \
        == torch.device("cuda", 0)
    assert full_device("cpu") == torch.device("cpu")
    c = DeviceCounter(torch.int64)
    c.tensor(torch.device("cpu")).add_(3)
    assert c.read("cpu") == 3
    c.reset()
    assert c.read("cpu") == 0


def test_dispatch_and_occluded(scene):
    """intersect_any takes the treelet traversal on a treelet scene;
    treelet_occluded agrees with the non-treelet occluded query; empty and
    all-inactive waves work."""
    _, port, (ro, rd, tmax, active) = scene
    ro, rd, tmax, active = (torch.from_numpy(x)
                            for x in (ro, rd, tmax, active))
    a = intersect_any(port, ro, rd, tmax=tmax, active=active)
    b = treelet_intersect(port, ro, rd, tmax=tmax, active=active)
    assert torch.equal(a.tri, b.tri) and torch.equal(a.t, b.t)
    plain = bvh2.intersect_bvh2(port, ro, rd, tmax=tmax, active=active)
    assert torch.equal(a.tri >= 0, plain.tri >= 0)
    dist = torch.full((R,), 5.0)
    blocked = treelet_occluded(port, ro, rd, dist, active=active)
    want = bvh2.occluded_bvh2(port, ro, rd, dist * (1.0 - 1e-3),
                              active=active)
    assert torch.equal(blocked, want) and blocked.any()
    none = treelet_intersect(port, ro, rd, active=torch.zeros(R, dtype=bool))
    assert (none.tri == -1).all() and (none.t == 1e30).all()
    empty = treelet_intersect(port, ro[:0], rd[:0])
    assert empty.tri.shape == (0,)


def test_frame_with_treelets_matches_frame_without():
    """A 64x32 arch-8k frame through the treelet traversal against the same
    frame (same uniforms) through the non-treelet dispatch."""
    scene = build_arch_scene(8_000)
    plain = build_scene_buffers(scene, device="cpu", use_native=False)
    tree = build_scene_buffers(scene, device="cpu", use_native=False,
                               treelets=True)
    assert tree.treelet is not None and plain.treelet is None
    W, H, B = 64, 32, 3
    uni = draw_uniforms(W * H, B, torch.Generator().manual_seed(3), "cpu")
    cam = torch.from_numpy(arch_camera())
    imgs = [trace_paths(s, cam, W, H, bounces=B, sort_rays=False,
                        uniforms=uni)[0].numpy() for s in (plain, tree)]
    close = np.isclose(imgs[1], imgs[0], rtol=1e-4, atol=1e-5).all(axis=1)
    assert close.mean() >= 0.995, close.mean()
    assert abs(imgs[1].mean() / imgs[0].mean() - 1) < 1e-3
    assert (imgs[1].sum(axis=1) > 0).mean() > 0.4


def _two_scatter_combine(R, pair_ray, pt, ptri_local, pair_on, pair_sid,
                         sub_tri_base, t0):
    """The port's combine before E7 took it in, as it stood: per ray the
    least t by an amin scatter_reduce, then among the pairs at that t the
    largest global triangle id by an amax scatter_reduce."""
    from loupiote_tpu_torch.ops.intersect import T_FAR

    pr = pair_ray.to(torch.int64)
    hit_ok = (ptri_local >= 0) & (pair_on > 0)
    pt = torch.where(hit_ok, pt, T_FAR)
    tmin = torch.full((R,), T_FAR, dtype=torch.float32)
    tmin = tmin.scatter_reduce(0, pr, pt, "amin")
    ptri = torch.where(hit_ok,
                       sub_tri_base[pair_sid.to(torch.int64)] + ptri_local,
                       -1)
    cand = hit_ok & (pt <= tmin[pr])
    tri = torch.full((R,), -1, dtype=torch.int32)
    tri = tri.scatter_reduce(0, pr, torch.where(cand, ptri, -1), "amax")
    return torch.where(tri >= 0, tmin, t0), tri


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packed_combine_matches_two_scatter_reduces(seed):
    """pack_hits + an int64 amin + unpack_hits (the per-ray epilogue's
    combine) against the two scatter_reduces, on random pairs whose t are
    drawn from four values, so most rays tie across their pairs."""
    from loupiote_tpu_torch.treelet.lane_bottom import (NO_HIT, TILE,
                                                        pack_hits,
                                                        unpack_hits)

    rng = np.random.default_rng(seed)
    Rn, S, tiles = 400, 12, 3
    P = tiles * TILE
    sid_blocks = torch.from_numpy(rng.integers(0, S, tiles).astype(np.int32))
    pair_sid = torch.repeat_interleave(sid_blocks, TILE)
    base = torch.from_numpy(np.concatenate(
        [np.cumsum(rng.integers(50, 300, S)), [0]]).astype(np.int32))
    pair_ray = torch.from_numpy(rng.integers(0, Rn, P).astype(np.int32))
    pair_on = torch.from_numpy((rng.random(P) < 0.85).astype(np.int32))
    pt = torch.from_numpy(rng.choice(
        np.float32([0.5, 1.25, 1.25, 7.0]), P).astype(np.float32))
    local = torch.from_numpy(np.where(rng.random(P) < 0.3, -1,
                                      rng.integers(0, 40, P)).astype(np.int32))
    t0 = torch.from_numpy(np.where(rng.random(Rn) < 0.5, 1e30, 9.0)
                          .astype(np.float32))
    want = _two_scatter_combine(Rn, pair_ray, pt, local, pair_on, pair_sid,
                                base, t0)
    ok = (local >= 0) & (pair_on > 0)
    key = torch.where(ok, pack_hits(pt, base[pair_sid.long()] + local),
                      NO_HIT)
    hit = torch.full((Rn,), NO_HIT, dtype=torch.int64).scatter_reduce(
        0, pair_ray.long(), key, "amin")
    t, tri = unpack_hits(hit, t0)
    assert torch.equal(t.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(tri, want[1])
    # Ties: rays with two hit pairs at their least t and different ids.
    at_min = ok & (pt == t[pair_ray.long()])
    n_at = torch.zeros(Rn, dtype=torch.int64).index_add_(
        0, pair_ray.long(), at_min.long())
    assert int((n_at >= 2).sum()) > 50
    assert (tri >= 0).float().mean() > 0.5


def _old_phase2_combine(td, ro, rd, t0, pair_ray, pair_on, sid_blocks, *,
                        any_hit, mark=None):
    """The phase 2 chain before E7 took in the combine: gather each pair's
    ray, the per-pair walk, the two scatter_reduces."""
    from loupiote_tpu_torch.treelet.lane_bottom import TILE, lane_bottom_trace

    pr = pair_ray.to(torch.int64)
    pt, local = lane_bottom_trace(sid_blocks, td.sub_fields,
                                  ro[pr].contiguous(), rd[pr].contiguous(),
                                  t0[pr].contiguous(), pair_on.contiguous(),
                                  any_hit=any_hit)
    return _two_scatter_combine(ro.shape[0], pair_ray, pt, local, pair_on,
                                torch.repeat_interleave(sid_blocks, TILE),
                                td.sub_tri_base, t0)


@pytest.mark.parametrize("regroup", ["count", "sort"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_per_ray_epilogue_matches_the_old_chain(scene, monkeypatch, regroup,
                                                any_hit):
    """Binning and phase 2 with the per-ray plain version
    (lane_bottom_rays_plain, then unpack_hits) against the chain it
    replaces, bit for bit, under both binnings and in both modes."""
    _, port, (ro, rd, tmax, active) = scene
    ro, rd, t0, act = (torch.from_numpy(x) for x in (ro, rd, tmax, active))
    td = port.treelet
    pairs = lane_top.lane_top_pairs(td.top_fields, ro, rd, t0, act,
                                    td.num_top, td.num_subtrees)
    args = (td, ro, rd, t0, *pairs)
    got = pipeline._bin_and_walk(*args, any_hit=any_hit, regroup=regroup)
    monkeypatch.setattr(pipeline, "_phase2_combine", _old_phase2_combine)
    want = pipeline._bin_and_walk(*args, any_hit=any_hit, regroup=regroup)
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert (got[1] >= 0).sum() > 100


def test_pipeline_takes_the_compacting_epilogue_on_the_card_only(
        scene, monkeypatch):
    """treelet_intersect asks E6 for pairs (lane_top_pairs): on CPU tensors
    that runs the compacting epilogue's plain version; where lane_top sees
    a card's tensor (on_card patched to say so) it launches the compacting
    epilogue, and the per-ray one on neither. The hits are the same."""
    _, port, rays = scene
    ro, rd, tmax, active = (torch.from_numpy(x) for x in rays)
    calls = []
    plain = lane_top.lane_top_pairs_plain
    monkeypatch.setattr(lane_top, "_launch",
                        lambda *a: calls.append("per_ray"))
    monkeypatch.setattr(lane_top, "lane_top_pairs_plain",
                        lambda *a: calls.append("plain") or plain(*a))
    monkeypatch.setattr(lane_top, "_launch_pairs",
                        lambda *a: calls.append("pairs") or plain(*a))
    want = treelet_intersect(port, ro, rd, tmax=tmax, active=active)
    assert calls == ["plain"]
    calls.clear()
    monkeypatch.setattr(lane_top, "on_card", lambda x: True)
    got = treelet_intersect(port, ro, rd, tmax=tmax, active=active)
    assert calls == ["pairs"]
    assert torch.equal(got.tri, want.tri) and torch.equal(got.t, want.t)
    assert (got.tri >= 0).sum() > 100
