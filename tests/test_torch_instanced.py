"""Two-level instancing in the port (loupiote_tpu_torch/scene/instanced.py)
against the reference's (loupiote_tpu/scene/instanced.py), on the same
numpy scenes: the scenes of tests/test_instanced.py (four translated
instances of one mesh, the K <= 12 unroll; 200 instances of two meshes,
the candidate-gather TLAS; 20 overlapping instances with one candidate
wave, the drain) and 13 rotated and scaled props (mesh groups of 9, 2 and 2).

- Tables: both packages' builds byte-equal, every BLAS included (numpy
  BVH builder on both sides).
- Hits: tri and inst equal on every ray but where two hits tie in t, t
  within 1e-5 relative (the reference's XLA:CPU code contracts
  multiply-adds; ROADMAP, "Traversal"), u and v within 1e-3 (the gate of
  tests/test_instanced.py's u, v test; a grazing ray's barycentrics move
  by 1e-4 with an ulp of its object-space ray); any-hit blocked bits
  equal on every ray.
- The chunking of the TLAS selection changes no bit of the result.
- Whole frames: tests/test_torch_instanced_frame.py.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loupiote_tpu.scene.types as ref_types
import loupiote_tpu_torch.scene.types as port_types
from loupiote_tpu.ops.intersect import intersect_any as ref_intersect
from loupiote_tpu.ops.intersect import occluded as ref_occluded
from loupiote_tpu.scene.instanced import \
    build_instanced_buffers as ref_build_instanced
from loupiote_tpu.scene.instanced import update_instance as ref_update
from loupiote_tpu_torch import (Renderer, RenderConfig, build_scene_buffers,
                                from_reference, spans, trace_paths)
from loupiote_tpu_torch.ops.intersect import (intersect_any, occluded,
                                              path_libraries)
from loupiote_tpu_torch.scene import instanced
from loupiote_tpu_torch.scene.instanced import (build_instanced_buffers,
                                                update_instance)
from torch_port_helpers import numpy_bvh

TABLES = ("trav_rows", "node_rows", "leaf_rows", "tri_pack", "tri_shade",
          "mat_pack", "light_origin", "light_emission", "node_min",
          "node_max", "atlas", "atlas_blocks")
INSTANCE_TABLES = ("inst_w2o", "inst_nmat", "inst_mat_id", "inst_tri_base",
                   "inst_aabb_lo", "inst_aabb_hi")


def _mesh(types, rng, n, spread):
    """tests/test_instanced.py's random mesh."""
    base = (rng.random((n, 3), dtype=np.float32) - 0.5) * spread
    p1 = base + (rng.random((n, 3), dtype=np.float32) - 0.5) * 0.4
    p2 = base + (rng.random((n, 3), dtype=np.float32) - 0.5) * 0.4
    positions = np.concatenate([base, p1, p2]).astype(np.float32)
    indices = np.arange(3 * n, dtype=np.int32).reshape(3, n).T.reshape(-1)
    return types.Mesh(positions=positions, normals=None, texcoords=None,
                      indices=indices)


def _xlate(x, y, z):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [x, y, z]
    return m


def _props(rng):
    """A rotation about y, a uniform scale in 0.6-1.4 (the hall's props)
    and a translation."""
    s = 0.6 + 0.8 * rng.random()
    a = rng.random() * 2 * np.pi
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]], np.float32) * s
    m[:3, 3] = (rng.random(3) - 0.5) * 12
    return m


def _scene(types, name):
    """One of the test scenes, built the same in either package."""
    scene = types.Scene.default()
    if name == "unroll4":
        scene.meshes.append(_mesh(types, np.random.default_rng(42), 400, 2.0))
        for off in ((-3, 0, 0), (3, 0, 0), (0, 3, 0), (0, -3, 0)):
            scene.instances.append(types.Instance(0, _xlate(*off), 0))
    elif name == "cand200":
        rng = np.random.default_rng(2026)
        for _ in range(2):
            scene.meshes.append(_mesh(types, rng, 60, 1.2))
        for k in range(200):
            off = (rng.random(3) - 0.5) * 40
            scene.instances.append(types.Instance(k % 2, _xlate(*off), 0))
    elif name == "drain20":
        rng = np.random.default_rng(7)
        scene.meshes.append(_mesh(types, rng, 40, 1.5))
        for _ in range(20):
            off = (rng.random(3) - 0.5) * 2.0
            scene.instances.append(types.Instance(0, _xlate(*off), 0))
    else:  # props13: rotated, scaled, two materials; mesh groups of 9
        # (candidate waves), 2 and 2 (each behind its box cull)
        rng = np.random.default_rng(9)
        scene.materials.append(types.Material(
            color=np.array([0.2, 0.5, 0.9, 1.0], np.float32)))
        for _ in range(3):
            scene.meshes.append(_mesh(types, rng, 50, 1.0))
        for k in range(13):
            scene.instances.append(types.Instance(
                0 if k < 9 else 1 + k % 2, _props(rng), k % 2))
    return scene


SCENES = ("unroll4", "cand200", "drain20", "props13")


@pytest.fixture(scope="module")
def builds():
    """{name: (reference buffers, port buffers)}, numpy BVH builder on both
    sides."""
    out = {}
    for name in SCENES:
        with numpy_bvh():
            ref = ref_build_instanced(_scene(ref_types, name))
        port = build_instanced_buffers(_scene(port_types, name),
                                       device="cpu", use_native=False)
        out[name] = (ref, port)
    return out


def _rays(name, R=512):
    """Random rays; for the candidate scenes 70% aimed at an instance's
    box centre, so most rays cross boxes."""
    rng = np.random.default_rng(sum(map(ord, name)))
    spread = {"unroll4": 14, "cand200": 50, "drain20": 8, "props13": 16}
    ro = ((rng.random((R, 3)) - 0.5) * spread[name]).astype(np.float32)
    rd = (rng.random((R, 3)) - 0.5).astype(np.float32)
    if name in ("cand200", "props13"):
        K = 200 if name == "cand200" else 13
        scene = _scene(port_types, name)
        tgt = np.stack([scene.instances[k].model_to_world[:3, 3]
                        for k in rng.integers(0, K, R)])
        aim = rng.random(R) < 0.7
        rd[aim] = (tgt[aim] - ro[aim]).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


def _both(name, builds, fn_ref, fn_port):
    ref, port = builds[name]
    ro, rd = _rays(name)
    return (fn_ref(ref, jnp.asarray(ro), jnp.asarray(rd)),
            fn_port(port, torch.from_numpy(ro), torch.from_numpy(rd)))


DIST = {"unroll4": 8.0, "cand200": 6.0}


@pytest.fixture(scope="module")
def ref_hits(builds):
    """The reference's closest hits and shadow answers (segments of
    DIST[name]) on the rays of the unroll and candidate scenes, traced
    once: the reference's candidate path on the CPU compiles each wave's
    traversal anew, about 1.6 s each, so props13 is held to its closest
    hits only and drain20 to both with one wave, in
    test_forced_drain_matches_reference."""
    out = {}
    for name in ("unroll4", "cand200", "props13"):
        ref, _ = builds[name]
        ro, rd = (jnp.asarray(x) for x in _rays(name))
        out[name] = (ref_intersect(ref, ro, rd), None if name not in DIST
                     else np.asarray(ref_occluded(ref, ro, rd, jnp.full(
                         ro.shape[0], DIST[name], jnp.float32))))
    return out


def assert_hits_match(ref_hit, hit):
    """tri and inst equal but where both hit at one t (a tie), t within
    1e-5 relative, u and v within 1e-3 where the triangle is the same."""
    rt, pt = np.asarray(ref_hit.tri), hit.tri.numpy()
    ri, pi = np.asarray(ref_hit.inst), hit.inst.numpy()
    r_t, p_t = np.asarray(ref_hit.t), hit.t.numpy()
    same = (rt == pt) & (ri == pi)
    tie = (~same & (rt >= 0) & (pt >= 0)
           & np.isclose(r_t, p_t, rtol=1e-6, atol=0))
    assert (same | tie).all(), f"{(~(same | tie)).sum()} untied mismatches"
    assert ((pi >= 0) == (pt >= 0)).all()
    hits = rt >= 0
    np.testing.assert_allclose(p_t[hits], r_t[hits], rtol=1e-5, atol=0)
    both = same & hits
    np.testing.assert_allclose(hit.u.numpy()[both],
                               np.asarray(ref_hit.u)[both], atol=1e-3)
    np.testing.assert_allclose(hit.v.numpy()[both],
                               np.asarray(ref_hit.v)[both], atol=1e-3)
    return hits.mean()


@pytest.mark.parametrize("name", SCENES)
def test_build_matches_reference(builds, name):
    """The port's two-level build is the reference's, byte for byte: the
    shell's tables with the instances' world bounds in row 0, the BLASes'
    object-space triangles end to end, every instance table and every
    BLAS; from_reference carries the reference's across unchanged."""
    ref, port = builds[name]
    for got in (port, from_reference(ref, device="cpu")):
        for f in TABLES + INSTANCE_TABLES:
            a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        assert got.inst_mesh == tuple(ref.inst_mesh)
        # The instance loop's plan and device tables, over its own BLASes.
        assert got.tlas.groups == port.tlas.groups
        assert torch.equal(got.tlas.rows, port.tlas.rows)
        assert got.tlas.blas is got.blas
        assert got.num_tris == ref.num_tris and got.num_nodes == ref.num_nodes
        assert len(got.blas) == len(ref.blas)
        for rb, pb in zip(ref.blas, got.blas):
            for f in TABLES:
                a, b = np.asarray(getattr(rb, f)), getattr(pb, f).numpy()
                assert a.tobytes() == b.tobytes(), f
            assert (pb.num_nodes, pb.wide_end, pb.num_tris) == (
                rb.num_nodes, rb.wide_end, rb.num_tris)
    st = port.stats()
    assert st["instances"] == len(ref.inst_mesh)
    assert st["unique_meshes"] == len(ref.blas) and st["blas_bytes"] > 0


@pytest.mark.parametrize("name", ("unroll4", "cand200", "props13"))
def test_intersect_matches_reference(builds, ref_hits, name):
    """Closest hits through intersect_any: the unroll (unroll4), the
    candidate waves (cand200; props13 with rotated, scaled instances and
    unnormalised object-space directions)."""
    ro, rd = (torch.from_numpy(x) for x in _rays(name))
    hit = intersect_any(builds[name][1], ro, rd)
    assert assert_hits_match(ref_hits[name][0], hit) > 0.02


@pytest.mark.parametrize("name", ("unroll4", "cand200"))
def test_occluded_and_any_hit_match_reference(builds, ref_hits, name):
    """occluded (the any-hit instance loop) gives the reference's blocked
    bits on every ray, and intersect_any(any_hit=True) blocks the same
    rays."""
    ro, rd = (torch.from_numpy(x) for x in _rays(name))
    port = builds[name][1]
    dist = torch.full((ro.shape[0],), DIST[name])
    got = occluded(port, ro, rd, dist)
    assert (ref_hits[name][1] == got.numpy()).all() and got.any()
    any_hit = intersect_any(port, ro, rd, tmax=dist * (1.0 - 1e-3),
                            any_hit=True)
    assert torch.equal(any_hit.tri >= 0, got)


def test_forced_drain_matches_reference(builds, monkeypatch):
    """One candidate wave on 20 overlapping boxes: most rays' hits come
    from the drain, closest-hit and any-hit."""
    monkeypatch.setenv("LOUPIOTE_TLAS_C", "1")
    monkeypatch.setattr(instanced, "TLAS_C", 1)
    with spans.recording() as rec:
        ref_hit, hit = _both("drain20", builds, ref_intersect, intersect_any)
    assert_hits_match(ref_hit, hit)
    assert rec.counts[("tlas", "drain")] > 1
    dist = np.full(512, 4.0, np.float32)
    a, b = _both("drain20", builds,
                 lambda s, o, d: ref_occluded(s, o, d, jnp.asarray(dist)),
                 lambda s, o, d: occluded(s, o, d, torch.from_numpy(dist)))
    assert (np.asarray(a) == b.numpy()).all()


@pytest.mark.parametrize("name, C", [("cand200", 12), ("drain20", 1)])
def test_selection_chunks_change_no_bit(builds, name, C, monkeypatch):
    """The selection in chunks of 7 rays (the last one short) gives the
    same bits as in one chunk, through the candidate waves and the
    drain."""
    _, port = builds[name]
    ro, rd = (torch.from_numpy(x) for x in _rays(name))
    monkeypatch.setattr(instanced, "TLAS_C", C)
    outs = []
    for elems in (instanced.TLAS_CHUNK_ELEMS, 7 * 200):
        monkeypatch.setattr(instanced, "TLAS_CHUNK_ELEMS", elems)
        outs.append((intersect_any(port, ro, rd),
                     intersect_any(port, ro, rd, tmax=torch.full(
                         (len(ro),), 5.0), any_hit=True)))
    for a, b in zip(*outs):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_uv_in_the_winning_instances_object_space():
    """A unit triangle translated +5 x: the hit at world (5.25, 0.25, 0)
    has object-space barycentrics (0.25, 0.25) (tests/test_instanced.py);
    and u, v match the flattened build's on the four-instance scene."""
    scene = port_types.Scene.default()
    scene.meshes.append(port_types.Mesh(
        positions=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
        normals=np.array([[0, 0, 1]] * 3, np.float32),
        texcoords=np.array([[0, 0], [1, 0], [0, 1]], np.float32),
        indices=np.array([0, 1, 2], np.int32)))
    scene.instances.append(port_types.Instance(0, _xlate(5, 0, 0), 0))
    bufs = build_instanced_buffers(scene, device="cpu")
    hit = intersect_any(bufs, torch.tensor([[5.25, 0.25, 3.0]]),
                        torch.tensor([[0.0, 0.0, -1.0]]))
    assert int(hit.tri[0]) == 0 and int(hit.inst[0]) == 0
    assert abs(float(hit.u[0]) - 0.25) < 1e-6
    assert abs(float(hit.v[0]) - 0.25) < 1e-6

    scene = _scene(port_types, "unroll4")
    flat = build_scene_buffers(scene, device="cpu", use_native=False)
    inst = build_instanced_buffers(scene, device="cpu", use_native=False)
    ro, rd = (torch.from_numpy(x) for x in _rays("unroll4"))
    want, got = intersect_any(flat, ro, rd), intersect_any(inst, ro, rd)
    hits = want.tri >= 0
    assert torch.equal(hits, got.tri >= 0) and hits.any()
    assert torch.allclose(got.u[hits], want.u[hits], atol=1e-3)
    assert torch.allclose(got.v[hits], want.v[hits], atol=1e-3)


def test_update_instance_rebuilds_nothing(builds):
    """Moving the most-hit instance keeps the BLAS tuple and every BLAS
    tensor (the same storage), gives the reference's moved tables and
    the hits of a fresh build with the instance moved, and the moved
    instance's box follows it (no ray reports it once it is 500 away);
    four instances of one mesh take well under the flattened build's
    bytes."""
    for name in ("unroll4", "cand200"):
        ref, port = builds[name]
        ro, rd = _rays(name)
        before = intersect_any(port, torch.from_numpy(ro),
                               torch.from_numpy(rd))
        k = int(torch.mode(before.inst[before.inst >= 0]).values)
        where = _xlate(500.0, 0.0, 0.0)
        ptrs = [getattr(b, f).data_ptr() for b in port.blas for f in TABLES]
        moved = update_instance(port, k, where)
        assert moved.blas is port.blas
        assert ptrs == [getattr(b, f).data_ptr()
                        for b in moved.blas for f in TABLES]
        ref_moved = ref_update(ref, k, where)
        for f in INSTANCE_TABLES + ("node_min", "node_max"):
            a, b = np.asarray(getattr(ref_moved, f)), getattr(moved, f)
            assert a.tobytes() == b.numpy().tobytes(), f
        hit = intersect_any(moved, torch.from_numpy(ro), torch.from_numpy(rd))
        assert not (hit.inst == k).any()
        # The same hits as a fresh build with the instance moved.
        scene = _scene(port_types, name)
        scene.instances[k].model_to_world = where
        fresh = build_instanced_buffers(scene, device="cpu", use_native=False)
        want = intersect_any(fresh, torch.from_numpy(ro),
                             torch.from_numpy(rd))
        for a, b in zip(hit, want):
            assert torch.equal(a, b)
    scene = _scene(port_types, "unroll4")
    flat = build_scene_buffers(scene, device="cpu", use_native=False)
    assert builds["unroll4"][1].nbytes() < 0.55 * flat.nbytes()


def test_path_libraries_are_the_blases():
    """reload_shaders and chip_smoke.py build what the BLASes launch: the
    two-level kernel's source, which walks the small ones as K2 does, and
    K1's past 8,192 BVH2 nodes, each once."""
    def blas(nodes):
        return SimpleNamespace(num_nodes=nodes, treelet=None)

    scene = SimpleNamespace(inst_w2o=object(), treelet=None, num_nodes=1,
                            blas=(blas(9), blas(50_000), blas(25)))
    assert path_libraries(scene) == ["tlas_traverse", "wide_traverse"]


def test_renderer_takes_instanced_buffers(builds):
    """Renderer.set_resources on instanced buffers: frames render, the
    G-buffer's mesh ids are instance ids (from the hit, not the BLAS's
    own tables), and to() carries every BLAS."""
    _, port = builds["props13"]
    bufs = dataclasses.replace(port)
    r = Renderer((32, 32), RenderConfig(downsample_factor=1.0, denoise=False),
                 device="cpu")
    r.set_resources(bufs)
    cam = np.eye(4, dtype=np.float32)
    cam[:3, 3] = [0, 2, 14]
    cam[:3, 2] = [0, 0, -1]
    r.accumulate = True
    for _ in range(2):
        r.raytrace(cam)
    assert torch.isfinite(r.accum).all()
    _, gb = trace_paths(bufs, torch.from_numpy(cam), 32, 32,
                        torch.Generator().manual_seed(1), bounces=1)
    ids = gb.mesh_id[gb.mesh_id >= 0]
    assert ids.numel() and 0 < int(ids.max()) < 13
    moved = bufs.to("cpu")
    assert len(moved.blas) == 3 and moved.inst_mesh == bufs.inst_mesh
