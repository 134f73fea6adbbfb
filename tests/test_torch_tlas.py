"""The instance loop's plan and ``csrc/tlas_traverse.cu``'s order of work,
on the CPU (the kernel itself runs on the card only: ``chip_smoke.py``'s
TLAS phase holds it bit for bit to the plain loop there).

- The plan: the split of an instance table into groups (the unroll, the
  visits behind box culls of meshes with at most two instances, the
  candidate groups) and of the groups into runs by the kernel their BLASes
  take (a K2 run broken at a K1 BLAS).
- The tables: built at upload beside the BLASes, built again by ``to``
  (``tests/test_torch_instanced.py``: by ``from_reference``), kept by
  ``update_instance`` but for the group boxes.
- The kernel's order: ``kernel_model`` repeats the kernel's per-ray steps
  (the union box, the stable insertion of the C nearest, the waves, the
  pending test and the drain that walks boxes in (entry t, id) order)
  vectorised over rays, with the twin's own box arithmetic and BLAS
  traversals; it gives the plain loop's t, tri and inst bit for bit in
  both modes, on non-finite rays too, with the drain forced.
- On CPU tensors the plain loop runs, counted ``("tlas_path", "plain")``.
"""

import numpy as np
import pytest
import torch

from loupiote_tpu_torch import spans
from loupiote_tpu_torch.ops import intersect
from loupiote_tpu_torch.ops.intersect import T_FAR, intersect_any, occluded
from loupiote_tpu_torch.scene import instanced, types
from loupiote_tpu_torch.scene.instanced import (CANDIDATE, UNROLL, VISIT,
                                                build_instanced_buffers,
                                                plan_groups, plan_runs,
                                                update_instance)
from torch_port_helpers import nonfinite_rays

# csrc/tlas_traverse.cu: kCMax, the insertion network's width.
C_MAX = instanced.TLAS_C_MAX


def _mesh(rng, n, spread):
    base = (rng.random((n, 3), dtype=np.float32) - 0.5) * spread
    p1 = base + (rng.random((n, 3), dtype=np.float32) - 0.5) * 0.4
    p2 = base + (rng.random((n, 3), dtype=np.float32) - 0.5) * 0.4
    positions = np.concatenate([base, p1, p2]).astype(np.float32)
    indices = np.arange(3 * n, dtype=np.int32).reshape(3, n).T.reshape(-1)
    return types.Mesh(positions=positions, normals=None, texcoords=None,
                      indices=indices)


def _xform(rng, spread, rotate):
    m = np.eye(4, dtype=np.float32)
    if rotate:
        s = 0.6 + 0.8 * rng.random()
        a = rng.random() * 2 * np.pi
        m[:3, :3] = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                              [-np.sin(a), 0, np.cos(a)]], np.float32) * s
    m[:3, 3] = (rng.random(3) - 0.5) * spread
    return m


def _scene(name):
    """``mixed``: a shell-like mesh once, 24 overlapping instances of one
    mesh (a candidate group that drains at small C), 2 of another (box
    culls) and 9 rotated, scaled props (a second candidate group), in
    an interleaved instance order; ``unroll``: 5 instances of 3 meshes."""
    rng = np.random.default_rng(2207)
    scene = types.Scene.default()
    if name == "unroll":
        for _ in range(3):
            scene.meshes.append(_mesh(rng, 40, 1.5))
        for k in range(5):
            scene.instances.append(types.Instance(
                k % 3, _xform(rng, 6.0, k % 2 == 1), 0))
        return scene
    for n, spread in ((300, 14.0), (40, 1.5), (30, 1.0), (50, 1.0)):
        scene.meshes.append(_mesh(rng, n, spread))
    plan = [0] + [1] * 24 + [2] * 2 + [3] * 9
    for k in rng.permutation(len(plan)):
        mesh = plan[k]
        spread = {0: 0.0, 1: 2.5, 2: 8.0, 3: 12.0}[mesh]
        scene.instances.append(types.Instance(
            mesh, _xform(rng, spread, mesh == 3), 0))
    return scene


@pytest.fixture(scope="module")
def builds():
    return {name: build_instanced_buffers(_scene(name), device="cpu",
                                          use_native=False)
            for name in ("mixed", "unroll")}


def _rays(R=384, seed=5, nonfinite=False):
    rng = np.random.default_rng(seed)
    ro = ((rng.random((R, 3)) - 0.5) * 16).astype(np.float32)
    tgt = ((rng.random((R, 3)) - 0.5) * 4).astype(np.float32)
    rd = tgt - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro, rd = torch.from_numpy(ro), torch.from_numpy(rd.astype(np.float32))
    if nonfinite:
        ro, rd = nonfinite_rays(ro, rd, seed)
    return ro, rd


# -- the plan -----------------------------------------------------------------

def test_plan_groups_unroll_visits_and_candidates():
    assert plan_groups((2, 0, 2, 1)) == (
        (UNROLL, (0,), 2), (UNROLL, (1,), 0), (UNROLL, (2,), 2),
        (UNROLL, (3,), 1))
    mesh = (3, 0, 1, 1, 0, 2) + (1,) * 5 + (3, 2)
    assert len(mesh) > instanced.TLAS_UNROLL_MAX
    assert plan_groups(mesh) == (
        (VISIT, (1, 4), 0), (CANDIDATE, (2, 3, 6, 7, 8, 9, 10), 1),
        (VISIT, (5, 12), 2), (VISIT, (0, 11), 3))


def test_plan_runs_break_at_a_k1_blas():
    groups = tuple((VISIT, (g,), s) for g, s in enumerate((0, 1, 2, 3, 4)))
    assert plan_runs(groups, [True] * 5) == [(0, 5, True)]
    assert plan_runs(groups, [True, True, False, True, True]) == [
        (0, 2, True), (2, 3, False), (3, 5, True)]
    assert plan_runs(groups, [False, False, True, False, True]) == [
        (0, 2, False), (2, 3, True), (3, 4, False), (4, 5, True)]


def test_mixed_scene_runs_follow_the_dispatch(builds, monkeypatch):
    bufs = builds["mixed"]
    kinds = [g[0] for g in bufs.tlas.groups]
    assert kinds == [VISIT, CANDIDATE, VISIT, CANDIDATE]
    on = [intersect.uses_bvh2(b) for b in bufs.blas]
    assert plan_runs(bufs.tlas.groups, on) == [(0, 4, True)]
    # Past the shell's node count only the shell takes K1: it breaks the
    # run at its group (slot 0, first).
    monkeypatch.setattr(intersect, "_WIDE_MIN_NODES",
                        max(b.num_nodes for b in bufs.blas[1:]) + 1)
    on = [intersect.uses_bvh2(b) for b in bufs.blas]
    assert on == [False, True, True, True]
    assert plan_runs(bufs.tlas.groups, on) == [(0, 1, False), (1, 4, True)]


# -- the tables ---------------------------------------------------------------

def _rows_of(bufs):
    t = bufs.tlas
    out = []
    for kind, idx, slot in t.groups:
        first = len([k for g in out for k in g[1]])
        out.append((kind, idx, slot, first))
    return [(kind, first, len(idx), slot) for kind, idx, slot, first in out]


def test_tables_built_at_upload(builds):
    for bufs in builds.values():
        t = bufs.tlas
        assert t.groups == plan_groups(bufs.inst_mesh)
        assert t.rows.tolist() == [list(r) for r in _rows_of(bufs)]
        assert t.ids.tolist() == [k for _, idx, _ in t.groups for k in idx]
        assert t.blas is bufs.blas
        assert t.blas_ptrs.tolist() == [
            [b.node_rows.data_ptr(), b.leaf_rows.data_ptr()]
            for b in bufs.blas]
        assert t.blas_steps.tolist() == [4 * b.num_nodes + 64
                                         for b in bufs.blas]
        for g, (_, idx, _) in enumerate(t.groups):
            i = torch.tensor(idx)
            assert torch.equal(t.lo[g], bufs.inst_aabb_lo[i].amin(0))
            assert torch.equal(t.hi[g], bufs.inst_aabb_hi[i].amax(0))
        for d in (t.rows, t.ids, t.lo, t.hi, t.blas_ptrs, t.blas_steps):
            assert d.device == bufs.device


def test_tables_follow_to_and_update_instance(builds):
    bufs = builds["mixed"]
    moved = bufs.to("cpu")
    assert moved.tlas.blas is moved.blas
    assert moved.tlas.blas_ptrs.tolist() == [
        [b.node_rows.data_ptr(), b.leaf_rows.data_ptr()]
        for b in moved.blas]
    assert moved.tlas.groups == bufs.tlas.groups
    # update_instance keeps the plan and its device tables, and moves only
    # the union box of the moved instance's group.
    k = bufs.tlas.groups[1][1][3]
    where = np.eye(4, dtype=np.float32)
    where[:3, 3] = [40.0, 0.0, 0.0]
    up = update_instance(bufs, k, where)
    t, u = bufs.tlas, up.tlas
    for f in ("groups", "rows", "ids", "blas", "blas_ptrs", "blas_steps"):
        assert getattr(u, f) is getattr(t, f), f
    assert torch.equal(u.lo[[0, 2, 3]], t.lo[[0, 2, 3]])
    assert float(u.hi[1, 0]) == float(up.inst_aabb_hi[k, 0]) > 39.0
    ro, rd = _rays()
    a = intersect_any(up, ro, rd)
    fresh_scene = _scene("mixed")
    fresh_scene.instances[k].model_to_world = where
    b = intersect_any(build_instanced_buffers(fresh_scene, device="cpu",
                                              use_native=False), ro, rd)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# -- the kernel's order of work -----------------------------------------------

def kernel_model(bufs, ro, rd, tmax, any_hit, C):
    """``csrc/tlas_traverse.cu::run_lane`` vectorised over rays: the same
    steps in the same order, each ray's BLAS walks batched a step at a
    time through the dispatch (every ray a lane of its own). Returns
    (best_t, best_tri, best_inst)."""
    R = ro.shape[0]
    best_t = (torch.full((R,), T_FAR) if tmax is None else tmax.clone())
    best_tri = torch.full((R,), -1, dtype=torch.int32)
    best_inst = torch.full((R,), -1, dtype=torch.int32)
    inf = torch.tensor(float("inf"))
    inv = instanced._safe_inv(rd)
    lo_all, hi_all = bufs.inst_aabb_lo, bufs.inst_aabb_hi

    def blocked():
        return (best_tri >= 0) if any_hit else torch.zeros(R, dtype=bool)

    def visit(k, lane, slot):
        nonlocal best_t, best_tri, best_inst
        ro_o, rd_o = instanced._to_object(bufs.inst_w2o[k], ro, rd)
        hit = intersect_any(bufs.blas[slot], ro_o, rd_o, tmax=best_t,
                            active=lane, any_hit=any_hit)
        win = lane & (hit.tri >= 0)
        if not any_hit:
            best_t = torch.where(win, hit.t, best_t)
        best_tri = torch.where(win, hit.tri + bufs.inst_tri_base[k],
                               best_tri)
        best_inst = torch.where(win, k.to(torch.int32), best_inst)

    for g, (kind, idx, slot) in enumerate(bufs.tlas.groups):
        ids = torch.tensor(idx)
        count = len(idx)
        live = ~blocked()
        if kind != CANDIDATE:
            for s in range(count):
                k = ids[s].expand(R)
                lane = live & ~blocked()
                if kind == VISIT:
                    lane = lane & instanced._ray_box_overlap(
                        ro, rd, lo_all[ids[s]], hi_all[ids[s]], best_t)
                visit(k, lane, slot)
            continue
        lim0 = best_t.clone()
        live = live & instanced._ray_box_overlap(ro, rd, bufs.tlas.lo[g],
                                                 bufs.tlas.hi[g], lim0)
        Cg = min(C, count)
        top_t = torch.full((R, C_MAX), float("inf"))
        top_j = torch.zeros((R, C_MAX), dtype=torch.int64)
        tn_all = instanced._chunk_tnear(ro, inv, lim0, lo_all[ids],
                                        hi_all[ids])
        n_ov = torch.isfinite(tn_all).sum(1)
        for j in range(count):
            tn = tn_all[:, j]
            for c in range(C_MAX - 1, -1, -1):
                if c >= Cg:
                    continue
                past = top_t[:, c] > tn
                if c > 0:
                    shift = past & (top_t[:, c - 1] > tn)
                    put = past & ~shift
                    top_t[:, c] = torch.where(shift, top_t[:, c - 1],
                                              torch.where(put, tn,
                                                          top_t[:, c]))
                    top_j[:, c] = torch.where(shift, top_j[:, c - 1],
                                              torch.where(put, j,
                                                          top_j[:, c]))
                else:
                    top_t[:, c] = torch.where(past, tn, top_t[:, c])
                    top_j[:, c] = torch.where(past, j, top_j[:, c])
        for s in range(Cg):
            sel = top_t[:, s]
            lane = (live & ~blocked() & torch.isfinite(sel)
                    & (sel < best_t))
            visit(ids[top_j[:, s]], lane, slot)
        if Cg >= count:
            continue
        last_t, last = top_t[:, Cg - 1].clone(), top_j[:, Cg - 1].clone()
        drain = (live & ~blocked() & (n_ov > Cg) & (last_t < best_t)
                 & (top_t[:, 0] != -inf))
        jj = torch.arange(count)[None, :]
        while bool(drain.any()):
            tn = instanced._chunk_tnear(ro, inv, best_t, lo_all[ids],
                                        hi_all[ids])
            after = (tn > last_t[:, None]) | ((tn == last_t[:, None])
                                              & (jj > last[:, None]))
            cand = torch.where(torch.isfinite(tn) & after, tn, inf)
            nj = torch.argmin(cand, dim=1)  # the first minimum: lowest j
            nt = cand.gather(1, nj[:, None])[:, 0]
            drain = drain & torch.isfinite(nt) & (nt < best_t)
            last_t = torch.where(drain, nt, last_t)
            last = torch.where(drain, nj, last)
            visit(ids[nj], drain, slot)
            drain = drain & ~blocked()
    return best_t, best_tri, best_inst


@pytest.mark.parametrize("name, C, nonfinite", [
    ("mixed", 12, False), ("mixed", 2, False), ("mixed", 1, False),
    ("mixed", 2, True), ("unroll", 12, False)])
@pytest.mark.parametrize("any_hit", [False, True])
def test_kernel_order_equals_the_plain_loop(builds, name, C, nonfinite,
                                            any_hit, monkeypatch):
    """The kernel's per-ray order of waves and drain gives the plain
    loop's t, tri and inst bit for bit; at C = 1 and 2 the plain loop's
    drain runs (counted), and the model drains rays one by one."""
    monkeypatch.setattr(instanced, "TLAS_C", C)
    bufs = builds[name]
    ro, rd = _rays(nonfinite=nonfinite)
    tmax = torch.full((ro.shape[0],), 9.0) if any_hit else None
    with spans.recording() as rec:
        plain = intersect_any(bufs, ro, rd, tmax=tmax, any_hit=any_hit)
    model = kernel_model(bufs, ro, rd, tmax, any_hit, C)
    for got, want in zip(model, plain[:2] + (plain.inst,)):
        assert torch.equal(got, want)
    assert (plain.tri >= 0).float().mean() > 0.02
    assert rec.counts[("tlas_path", "plain")] == 1
    assert ("tlas_path", "cuda") not in rec.counts
    if name == "mixed" and C == 1 and not any_hit:
        assert rec.counts.get(("tlas", "drain"), 0) > 0


def test_occluded_counts_the_plain_path(builds):
    bufs = builds["mixed"]
    ro, rd = _rays()
    with spans.recording() as rec:
        occluded(bufs, ro, rd, torch.full((ro.shape[0],), 6.0))
        intersect_any(bufs, ro, rd)
    assert rec.counts[("tlas_path", "plain")] == 2
    assert not [k for k in rec.counts if k[0] == "blas_walks"]
