"""The port's treelet traversal pieces (loupiote_tpu_torch/treelet/; on the
CPU the plain twins of E5, E6 and E7) against the reference
(experiments/treelet/), whose Pallas kernels run in interpret mode.

Tolerances. Tables, E6 (pend, npend), E5 and the regroups: exactly equal
(E5 and the regroups on the positions inside key regions, where the
reference leaves junk and the port zeros). E7: tri_local equal except
where two triangles lie within 2 ulp along the ray (a t-tie), t within
1e-5 relative: XLA:CPU contracts the reference's multiply-adds, so its t
may differ from the port's separately rounded products by a few ulp.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import jax.numpy as jnp  # noqa: E402

import loupiote_tpu.scene.types as ref_types  # noqa: E402
import loupiote_tpu_torch.scene.types as port_types  # noqa: E402
from experiments.treelet.build import build_treelets as ref_treelets  # noqa: E402
from experiments.treelet.lane_bottom import \
    lane_bottom_trace as ref_lane_bottom  # noqa: E402
from experiments.treelet.lane_top import TopTables  # noqa: E402
from experiments.treelet.lane_top import lane_top_trace as ref_lane_top  # noqa: E402
from experiments.treelet import pipeline as ref_pipeline  # noqa: E402
from experiments.treelet.regroup import block_regroup as ref_block  # noqa: E402
from experiments.treelet.regroup import counting_regroup as ref_counting  # noqa: E402
from experiments.treelet.regroup import scatter_runs as ref_scatter  # noqa: E402
from loupiote_tpu.accel.bvh import build_bvh as ref_build_bvh  # noqa: E402
from loupiote_tpu.scene import build_scene_buffers as ref_buffers  # noqa: E402
from loupiote_tpu.scene.procedural import build_arch_scene as ref_arch  # noqa: E402
from loupiote_tpu_torch import build_arch_scene as port_arch  # noqa: E402
from loupiote_tpu_torch import build_scene_buffers, from_reference  # noqa: E402
from loupiote_tpu_torch.accel.bvh import build_bvh  # noqa: E402
from loupiote_tpu_torch.treelet import build as tb  # noqa: E402
from loupiote_tpu_torch.treelet import lane_bottom, lane_top, regroup  # noqa: E402
from loupiote_tpu_torch.treelet.lane_top import compact_pairs  # noqa: E402
from torch_port_helpers import (assert_same_hits, nonfinite_rays,  # noqa: E402
                                numpy_bvh, random_rays, random_tris,
                                soup_scene)


@pytest.fixture(scope="module")
def soup():
    """A 900-triangle soup cut at cap=96 (many subtrees): the same BVH on
    both sides (numpy builders), and each side's treelet tables."""
    tris = random_tris(seed=21, n=900, spread=10.0, size=1.0)
    ref_bvh = ref_build_bvh(*tris, use_native=False)
    bvh = build_bvh(*tris, use_native=False)
    o = bvh.tri_order
    p0, p1, p2 = (t[o] for t in tris)
    tri9 = np.concatenate([p0, p1 - p0, p2 - p0], axis=1).astype(np.float32)
    return (tris, tri9, ref_treelets(ref_bvh, tri9, cap=96),
            tb.build_treelets(bvh, tri9, cap=96))


def _tables_equal(ref, port, dump_tile: bool):
    """ref: a TreeletTables or TreeletDevice of the reference; port: the
    port's counterpart (numpy or torch fields)."""
    for f in ("top_fields", "sub_fields", "sub_tri_base"):
        a = np.asarray(getattr(ref, f))
        b = getattr(port, f)
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert a.tobytes() == b.tobytes(), f
    for f in ("num_top", "num_subtrees") + (("top_tiles",) if dump_tile
                                            else ()):
        assert int(getattr(ref, f)) == int(getattr(port, f)), f


def test_build_treelets_byte_equal_soup_cap96(soup):
    _, _, ref, port = soup
    assert port.num_subtrees > 8 and (port.sub_entries <= 96).all()
    _tables_equal(ref, port, dump_tile=False)
    assert (ref.sub_entries == port.sub_entries).all()
    # The top table's frontier ids name every subtree once.
    pend = port.top_fields[7].reshape(-1).view(np.int32)[:port.num_top]
    assert sorted(pend[pend >= 0].tolist()) == list(range(port.num_subtrees))


@pytest.mark.parametrize("name", ["soup2500", "arch8k"])
def test_scene_buffers_treelets_match_reference(name):
    """build_scene_buffers(treelets=True) at the default cap, and
    from_reference, give the reference's TreeletDevice byte for byte (the
    dump tile S included)."""
    if name == "arch8k":
        ref_scene, port_scene = ref_arch(8_000), port_arch(8_000)
    else:
        tris = random_tris(seed=8, n=2500, spread=8.0)
        ref_scene = soup_scene(ref_types, *tris)
        port_scene = soup_scene(port_types, *tris)
    with numpy_bvh():
        ref = ref_buffers(ref_scene, treelets=True)
    port = build_scene_buffers(port_scene, device="cpu", use_native=False,
                               treelets=True)
    for p in (port.treelet, from_reference(ref, device="cpu").treelet):
        _tables_equal(ref.treelet, p, dump_tile=True)
        assert p.sub_fields.shape[1] == p.num_subtrees + 1
    st = port.stats()
    assert st["subtrees"] == port.treelet.num_subtrees
    assert st["top_entries"] == port.treelet.num_top
    assert st["treelet_bytes"] == port.treelet.nbytes()
    assert build_scene_buffers(port_scene, device="cpu",
                               use_native=False).treelet is None
    # .to() carries the tables.
    moved = port.to("cpu").treelet
    assert moved.num_subtrees == port.treelet.num_subtrees
    assert torch.equal(moved.sub_fields.view(torch.int32),
                       port.treelet.sub_fields.view(torch.int32))


def _rays(tris, R, seed):
    ro, rd = random_rays(tris, R, seed=seed)
    rng = np.random.default_rng(seed + 1)
    tmax = np.where(rng.random(R) > 0.5, 6.0, 1e30).astype(np.float32)
    active = rng.random(R) > 0.1
    return ro, rd, tmax, active


def _top_walk(ref_tables, port_tables, ro, rd, tmax, active):
    tt = TopTables(fields=ref_tables.top_fields, num_top=ref_tables.num_top,
                   tiles=ref_tables.top_tiles)
    rp, rn = ref_lane_top(tt, jnp.asarray(ro), jnp.asarray(rd),
                          tmax=jnp.asarray(tmax), active=jnp.asarray(active),
                          interpret=True)
    pp, pn = lane_top.lane_top_plain(
        torch.from_numpy(port_tables.top_fields), torch.from_numpy(ro),
        torch.from_numpy(rd), torch.from_numpy(tmax),
        torch.from_numpy(active), port_tables.num_top)
    return (np.asarray(rp), np.asarray(rn)), (pp.numpy(), pn.numpy())


@pytest.mark.parametrize("cap, edge", [(96, False), (24, False), (96, True)],
                         ids=["96", "24", "96-nonfinite"])
def test_lane_top_matches_reference_exactly(soup, cap, edge):
    """E6's twin on the soup's top table; cap 24 starves the pending lists
    so that lanes reach PEND_CAP. ``edge``: the rays of nonfinite_rays
    (+-inf / NaN origins, +-inf / -0 / +-1e-30 directions), where the
    twin's min / max return NaN as the reference's do."""
    tris, tri9, ref_t, port_t = soup
    if cap != 96:
        bvh = build_bvh(*tris, use_native=False)
        ref_t = ref_treelets(ref_build_bvh(*tris, use_native=False), tri9,
                             cap=cap)
        port_t = tb.build_treelets(bvh, tri9, cap=cap)
    lane_top.reset_counters()
    ro, rd, tmax, active = _rays(tris, 2048, seed=3)
    if edge:
        ro, rd = (x.numpy() for x in nonfinite_rays(
            torch.from_numpy(ro), torch.from_numpy(rd), 31))
    (rp, rn), (pp, pn) = _top_walk(ref_t, port_t, ro, rd, tmax, active)
    np.testing.assert_array_equal(pn, rn)
    np.testing.assert_array_equal(pp, rp)
    assert (pn[~active] == 0).all() and (pn > 0).mean() > (0.2 if edge
                                                           else 0.3)
    if edge:
        bad = ~(np.isfinite(ro).all(1) & np.isfinite(rd).all(1))
        assert 0.3 < bad.mean() < 0.8 and (pn[bad & active] > 0).any()
    if cap != 96:
        assert (pn == tb.PEND_CAP).sum() > 10
    assert lane_top.capped_rays("cpu") == 0


def _pend_lists(R, S, seed):
    """Random pending lists as E6 leaves them: a quarter of the rays at
    npend == PEND_CAP, the others in [0, 4), ids in [0, S) below npend and
    -1 past it, and an active mask (inactive rays have npend 0)."""
    rng = np.random.default_rng(seed)
    act = rng.random(R) > 0.15
    npend = np.where(rng.random(R) < 0.25, tb.PEND_CAP,
                     rng.integers(0, 4, R)).astype(np.int32)
    npend[~act] = 0
    ids = rng.integers(0, S, (R, tb.PEND_CAP)).astype(np.int32)
    pend = np.where(np.arange(tb.PEND_CAP)[None, :] < npend[:, None], ids,
                    -1).astype(np.int32)
    return pend, npend, act


def _compacting_kernel_model(pend, npend, act, S, budget):
    """The compacting epilogue as csrc/treelet_traverse.cu runs it, in
    numpy: tiles of TILE_RAYS rays in ticket order, each tile's pair count
    added to the prefix of the tiles before it (the look-back), then each
    ray writes its own slots (its pairs, or the dump key and ray 0 where it
    falls back) and the slots from the total on get the dump key and 0."""
    R = pend.shape[0]
    T = lane_top.TILE_RAYS
    pad = budget * R
    key = np.full(pad, -7, np.int64)  # every slot must be written once
    ray_of = np.full(pad, -7, np.int64)
    fallback = np.zeros(R, bool)
    prefix = 0
    for tile in range(-(-R // T)):
        rays = np.arange(tile * T, min((tile + 1) * T, R))
        n = np.where(act[rays], npend[rays], 0).astype(np.int64)
        base = prefix + np.cumsum(n) - n
        prefix += int(n.sum())
        for r, b, c in zip(rays, base, n):
            fb = bool(act[r]) and (b + c > pad or c >= tb.PEND_CAP)
            fallback[r] = fb
            for k in range(c):
                if b + k < pad:
                    assert key[b + k] == -7
                    key[b + k] = S if fb else pend[r, k]
                    ray_of[b + k] = 0 if fb else r
    tail = np.arange(pad) >= prefix
    assert (key[tail] == -7).all()
    key[tail], ray_of[tail] = S, 0
    assert (key != -7).all() and (ray_of != -7).all()
    return key.astype(np.int32), ray_of.astype(np.int32), fallback


@pytest.mark.parametrize("budget", [4, 2, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_compact_pairs_matches_reference_and_kernel_model(monkeypatch, budget,
                                                          seed):
    """The plain compaction (lane_top.compact_pairs, the compacting
    epilogue's plain version) against the reference's _compact_pairs and
    against a model of the kernel's tiled scan, bit for bit: rays at
    npend == PEND_CAP fall back, and a PAIR_BUDGET below the default makes
    the budget fallback fire (the rays past it, and the active rays after
    them with no pairs)."""
    R, S = 1000, 37
    pend, npend, act = _pend_lists(R, S, seed)
    monkeypatch.setattr(lane_top, "PAIR_BUDGET", budget)
    monkeypatch.setattr(ref_pipeline, "PAIR_BUDGET", budget)
    got = lane_top.compact_pairs(torch.from_numpy(pend),
                                 torch.from_numpy(npend),
                                 torch.from_numpy(act), S=S)
    want = [np.asarray(x) for x in ref_pipeline._compact_pairs(
        jnp.asarray(pend), jnp.asarray(npend), jnp.asarray(act), S=S)]
    model = _compacting_kernel_model(pend, npend, act, S, budget)
    for g, w, m in zip(got, want, model):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(g.numpy(), m)
    fb = got[2].numpy()
    at_cap = act & (npend == tb.PEND_CAP)
    assert fb[at_cap].all() and at_cap.sum() > 100
    over_budget = fb & ~at_cap
    assert over_budget.any() == (budget < 4)
    assert (got[0].numpy() < S).sum() == np.where(act & ~fb, npend, 0).sum()


def test_lane_top_pairs_on_the_cpu_is_top_walk_then_compaction(soup):
    """E6's compacting entry point on CPU tensors: lane_top_plain, then
    compact_pairs; a tensor on another device raises."""
    tris, _, _, port_t = soup
    ro, rd, tmax, active = (torch.from_numpy(x)
                            for x in _rays(tris, 2048, seed=9))
    top = torch.from_numpy(port_t.top_fields)
    S = port_t.num_subtrees
    pend, npend = lane_top.lane_top_trace(top, ro, rd, tmax, active,
                                          port_t.num_top)
    want = compact_pairs(pend, npend, active, S=S)
    got = lane_top.lane_top_pairs(top, ro, rd, tmax, active, port_t.num_top,
                                  S)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[0].shape == (lane_top.PAIR_BUDGET * 2048,)
    assert (got[0] < S).sum() > 500
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no traversal"):
        lane_top.lane_top_pairs(top, meta, meta, meta[:, 0], None,
                                port_t.num_top, S)


@pytest.mark.parametrize("epilogue", ["per_ray", "pairs"])
def test_lane_top_counts_launches_by_epilogue(monkeypatch, epilogue):
    """E6's launch sites count each launch under its own epilogue, so a run
    can tell which one a path launched. The C entry points are replaced by
    stubs that record their names and step bound; the compacting one gets
    a zeroed scan state of one word a TILE_RAYS tile and a ticket."""
    calls = []

    def stub(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    monkeypatch.setattr(lane_top._build, "load", lambda name: SimpleNamespace(
        lane_top=stub("lane_top"), lane_top_pairs=stub("lane_top_pairs")))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    R = 100
    top = torch.zeros((8, 1024), dtype=torch.float32)
    ray = torch.zeros((R, 3), dtype=torch.float32)
    t0 = torch.zeros(R, dtype=torch.float32)
    act = torch.ones(R, dtype=torch.bool)
    lane_top.reset_counters()
    for _ in range(3):
        if epilogue == "per_ray":
            pend, npend = lane_top._launch(top, ray, ray, t0, act, 5)
            assert pend.shape == (R, tb.PEND_CAP) and npend.shape == (R,)
        else:
            key, ray_of, fb = lane_top._launch_pairs(top, ray, ray, t0, act,
                                                     5, 9)
            assert key.shape == ray_of.shape == (lane_top.PAIR_BUDGET * R,)
            assert fb.shape == (R,) and fb.dtype == torch.bool
    assert lane_top.launches == {k: 3 * (k == epilogue)
                                 for k in lane_top.launches}
    name = "lane_top" if epilogue == "per_ray" else "lane_top_pairs"
    assert [c[0] for c in calls] == [name] * 3
    assert all(lane_top.max_steps(5) in c[1] for c in calls)
    lane_top.reset_counters()
    assert not any(lane_top.launches.values())
    with pytest.raises(ValueError, match="top_fields"):
        lane_top._launch(top[:, :1000].contiguous(), ray, ray, t0, act, 5)


def _pair_blocks(soup_tables, tris, n_blocks=8, seed=5):
    """A few 1024-pair blocks of the port's phase-2 layout (E6 + regroup on
    the CPU): (sid_blocks, pair ro, rd, tmax, on) as numpy arrays."""
    ro, rd, tmax, active = _rays(tris, 2048, seed=seed)
    t = {k: torch.from_numpy(v) for k, v in
         (("ro", ro), ("rd", rd), ("tmax", tmax), ("active", active))}
    pend, npend = lane_top.lane_top_plain(
        torch.from_numpy(soup_tables.top_fields), t["ro"], t["rd"],
        t["tmax"], t["active"], soup_tables.num_top)
    key, ray_of, _ = compact_pairs(pend, npend, t["active"],
                                    S=soup_tables.num_subtrees)
    ray, sid, on = regroup.block_regroup(key, ray_of,
                                         soup_tables.num_subtrees,
                                         slab_log=10)
    blocks = torch.nonzero(on.reshape(-1, tb.TILE).any(1)).flatten()
    blocks = blocks[torch.linspace(0, len(blocks) - 1, n_blocks).long()]
    sel = (blocks[:, None] * tb.TILE + torch.arange(tb.TILE)).reshape(-1)
    pr = ray[sel].long()
    return (sid[blocks].numpy(), ro[pr.numpy()], rd[pr.numpy()],
            tmax[pr.numpy()], on[sel].numpy())


@pytest.mark.parametrize("any_hit, edge", [(False, False), (True, False),
                                           (False, True), (True, True)],
                         ids=["False", "True", "False-nonfinite",
                              "True-nonfinite"])
def test_lane_bottom_matches_reference(soup, any_hit, edge):
    """``edge``: the pairs' rays get nonfinite_rays' edge cases after the
    layout, so E7's slab tests see NaN terms; t NaN-equal and tri equal
    on those pairs."""
    tris, tri9, _, port_t = soup
    sid, pro, prd, pt0, on = _pair_blocks(port_t, tris)
    if edge:
        pro, prd = (x.numpy() for x in nonfinite_rays(
            torch.from_numpy(pro), torch.from_numpy(prd), 33))
    sub = np.concatenate([port_t.sub_fields,
                          tb._empty_tile_like(port_t.sub_fields)], axis=1)
    rt, rtri = ref_lane_bottom(jnp.asarray(sid), jnp.asarray(sub),
                               jnp.asarray(pro), jnp.asarray(prd),
                               jnp.asarray(pt0), jnp.asarray(on),
                               any_hit=any_hit, interpret=True)
    lane_bottom.reset_counters()
    stats = {}
    pt, ptri = lane_bottom.lane_bottom_plain(
        torch.from_numpy(sid), torch.from_numpy(sub), torch.from_numpy(pro),
        torch.from_numpy(prd), torch.from_numpy(pt0), torch.from_numpy(on),
        any_hit, stats=stats)
    rt, rtri, pt, ptri = (np.asarray(rt), np.asarray(rtri), pt.numpy(),
                          ptri.numpy())
    assert lane_bottom.capped_pairs("cpu") == 0
    assert stats["box_tests"] > 0 and stats["tri_tests"] > 0
    assert ((ptri >= 0).sum() > (50 if edge else 100)
            and (ptri[on == 0] == -1).all())
    base = np.repeat(port_t.sub_tri_base[sid], tb.TILE)
    g_ref = np.where(rtri >= 0, base + rtri, -1)
    g_port = np.where(ptri >= 0, base + ptri, -1)
    if edge:
        bad = ~(np.isfinite(pro).all(1) & np.isfinite(prd).all(1))
        assert 0.3 < bad[on != 0].mean() < 0.8
        np.testing.assert_array_equal(ptri[bad], rtri[bad])
        assert np.array_equal(pt[bad], rt[bad], equal_nan=True)
    same = assert_same_hits(tri9, pro, prd, g_ref, g_port)
    assert same.mean() > 0.999
    np.testing.assert_allclose(pt[same], rt[same], rtol=1e-5)


@pytest.mark.parametrize("any_hit", [False, True])
def test_lane_bottom_rays_combines_per_ray_on_the_cpu_only(soup, any_hit):
    """E7's per-ray entry point on CPU tensors runs its plain version: per
    ray, the least t over its pairs' walks and, at that t, the largest
    global triangle id (checked here by a numpy loop over the pairs). A
    tensor on another device raises instead of falling back."""
    tris, _, _, port_t = soup
    ro, rd, tmax, active = (torch.from_numpy(x)
                            for x in _rays(tris, 2048, seed=6))
    top = torch.from_numpy(port_t.top_fields)
    sub = torch.from_numpy(np.concatenate(
        [port_t.sub_fields, tb._empty_tile_like(port_t.sub_fields)], axis=1))
    base = torch.from_numpy(np.concatenate([port_t.sub_tri_base, [0]])
                            .astype(np.int32))
    pend, npend = lane_top.lane_top_plain(top, ro, rd, tmax, active,
                                          port_t.num_top)
    key, ray_of, _ = compact_pairs(pend, npend, active,
                                    S=port_t.num_subtrees)
    pray, sid, on = regroup.block_regroup(key, ray_of, port_t.num_subtrees,
                                          slab_log=10)
    hit = lane_bottom.lane_bottom_rays(sid, sub, base, pray, on, ro, rd,
                                       tmax, any_hit)
    t, tri = lane_bottom.unpack_hits(hit, tmax)
    pr = pray.long()
    pt, local = lane_bottom.lane_bottom_trace(sid, sub, ro[pr], rd[pr],
                                              tmax[pr], on, any_hit)
    gid = base[sid.long()].repeat_interleave(tb.TILE) + local
    want_t, want_tri = tmax.numpy().copy(), np.full(2048, -1, np.int32)
    for p in np.nonzero(((local >= 0) & (on > 0)).numpy())[0]:
        r, tp, g = int(pr[p]), pt[p].item(), int(gid[p])
        if want_tri[r] < 0 or tp < want_t[r] or (tp == want_t[r]
                                                 and g > want_tri[r]):
            want_t[r], want_tri[r] = tp, g
    np.testing.assert_array_equal(t.numpy(), want_t)
    np.testing.assert_array_equal(tri.numpy(), want_tri)
    assert (tri >= 0).sum() > 100
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no traversal"):
        lane_bottom.lane_bottom_rays(sid, sub, base, pray, on, meta, meta,
                                     meta[:, 0], any_hit)


@pytest.mark.parametrize("per_ray", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_lane_bottom_counts_launches_by_epilogue(monkeypatch, per_ray,
                                                 any_hit):
    """E7's launch site counts each launch under its own (epilogue, mode)
    key, so a run can tell which epilogue a path launched. The C entry
    point is replaced by a stub that records its epilogue and mode flags;
    ``reset_counters`` zeroes every key."""
    calls = []

    def stub(*args):
        calls.append(args[-4:-1])  # max_steps, any_hit, per_ray
        return 0

    monkeypatch.setattr(lane_bottom._build, "load",
                        lambda name: SimpleNamespace(lane_bottom=stub))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    sid = torch.zeros(1, dtype=torch.int32)
    sub = torch.zeros((11, 2 * tb.TILE), dtype=torch.float32)
    ray = torch.zeros((tb.TILE, 3), dtype=torch.float32)
    lane_bottom.reset_counters()
    for _ in range(2):
        lane_bottom._call(sid, sub, (None, ray, ray, ray[:, 0], sid, None),
                          (None, None, None), any_hit, per_ray)
    key = ("per_ray" if per_ray else "per_pair",
           "anyhit" if any_hit else "closest")
    assert lane_bottom.launches == {k: 2 * (k == key)
                                    for k in lane_bottom.launches}
    assert calls == [(lane_bottom.MAX_STEPS, int(any_hit), int(per_ray))] * 2
    lane_bottom.reset_counters()
    assert not any(lane_bottom.launches.values())


def _slab_runs(seed, G=3, slab=1024, K=9):
    """Sorted slab rows and their run tables from the port's glue."""
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.integers(0, K + 1, G * slab).astype(np.int32))
    pay = torch.from_numpy(rng.integers(0, 1 << 20, G * slab)
                           .astype(np.int32))
    mat, c_log = regroup.sort_pairs(keys, pay, slab_log=10)
    pay3, C, src = regroup._slab_counts(mat, K, c_log)
    H = C.sum(0, dtype=torch.int32)
    starts = torch.cat([torch.zeros(1, dtype=torch.int32),
                        torch.cumsum(H + regroup.CHUNK, 0,
                                     dtype=torch.int32)[:-1]])
    nruns, pos, cell_base = regroup._run_lists(C, starts)
    return (pay3, nruns, regroup._compact(src, pos),
            regroup._compact(cell_base, pos), regroup._compact(C, pos),
            starts, H)


def test_scatter_runs_matches_reference_inside_regions():
    pay3, nruns, src, dst, lens, starts, H = _slab_runs(seed=4)
    G = pay3.shape[0]
    out_rows = G * 1024 + 10 * regroup.CHUNK
    # The reference's source rows carry a CHUNK-element junk pad.
    data2 = torch.cat([pay3, torch.zeros((G, regroup.CHUNK),
                                         dtype=torch.int32)], 1)
    ref = np.asarray(ref_scatter(*(jnp.asarray(x.numpy()) for x in
                                   (data2, nruns, src, dst, lens)),
                                 out_rows=out_rows, interpret=True))
    regroup.reset_counters()
    out = regroup.scatter_runs(data2, nruns, src, dst, lens, out_rows).numpy()
    # CPU tensors: the twin, no launch of either entry
    assert not any(regroup.launches.values())
    inside = np.zeros(out_rows, bool)
    for s, h in zip(starts.tolist(), H.tolist()):
        inside[s:s + h] = True
    assert inside.sum() == int(H.sum()) > 0
    np.testing.assert_array_equal(out[inside], ref[inside])
    assert (out[~inside] == 0).all()
    # The port takes the source rows without the pad too.
    np.testing.assert_array_equal(
        regroup.scatter_runs(pay3, nruns, src, dst, lens, out_rows).numpy(),
        out)


def _regions(starts, counts):
    starts, counts = np.asarray(starts), np.asarray(counts)
    return [slice(s, s + c) for s, c in zip(starts, counts)]


@pytest.mark.parametrize("R,K,seed", [(3000, 37, 1), (1024, 5, 2),
                                      (5000, 300, 3)])
def test_counting_regroup_matches_reference(R, K, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, K, R).astype(np.int32)
    payload = np.arange(R, dtype=np.int32)
    ro, rs, rc = ref_counting(jnp.asarray(keys), jnp.asarray(payload), K,
                              slab_log=10, interpret=True)
    po, ps, pc = regroup.counting_regroup(torch.from_numpy(keys),
                                          torch.from_numpy(payload), K,
                                          slab_log=10)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    assert po.shape[0] == np.asarray(ro).shape[0]
    ro, po = np.asarray(ro), po.numpy()
    for k, sl in enumerate(_regions(rs, rc)):
        np.testing.assert_array_equal(po[sl], ro[sl])
        assert sorted(po[sl].tolist()) == np.nonzero(keys == k)[0].tolist()


@pytest.mark.parametrize("R,K,seed", [(3000, 37, 1), (2048, 5, 2)])
def test_block_regroup_matches_reference(R, K, seed):
    """Keys in [0, K] (K is the pipeline's dump key, dropped)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, K + 1, R).astype(np.int32)
    ray = rng.integers(0, R, R).astype(np.int32)
    r_ray, r_sid, r_on = (np.asarray(x) for x in ref_block(
        jnp.asarray(keys), jnp.asarray(ray), K, slab_log=10,
        interpret=True))
    p_ray, p_sid, p_on = (x.numpy() for x in regroup.block_regroup(
        torch.from_numpy(keys), torch.from_numpy(ray), K, slab_log=10))
    np.testing.assert_array_equal(p_sid, r_sid)
    np.testing.assert_array_equal(p_on, r_on)
    on = p_on > 0
    np.testing.assert_array_equal(p_ray[on], r_ray[on])
    assert on.sum() == (keys < K).sum()
    # Each block is one subtree; its pairs are exactly that key's pairs.
    sid_of = np.repeat(p_sid, 1024)
    for k in range(K):
        got = sorted(p_ray[on & (sid_of == k)].tolist())
        assert got == sorted(ray[keys == k].tolist())


# E5's path entry: (R, K) with keys in [0, K] (K: the dump key, dropped),
# slabs of 2^10. "spans": every key spans all five slabs, R not a multiple
# of the slab; "empty": one slab, most of its 300 keys empty; "exact": R a
# multiple of the slab.
E5_CASES = {"spans": (5000, 5, 11), "empty": (1000, 300, 12),
            "exact": (2048, 37, 13)}


def _e5_input(case):
    R, K, seed = E5_CASES[case]
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, K + 1, R).astype(np.int32)
    if case == "empty":
        keys = np.where(keys % 7 == 0, keys, K).astype(np.int32)
    ray = rng.integers(0, R, R).astype(np.int32)
    mat, c_log = regroup.sort_pairs(torch.from_numpy(keys),
                                    torch.from_numpy(ray), slab_log=10)
    return keys, ray, mat, c_log, R, K


def _e5_model(mat, c_log, R, K, tile=1024, chunk=regroup.CHUNK):
    """csrc/regroup.cu::regroup_blocks in numpy, pass by pass: (1) a key's
    run in each slab by two binary searches and its exclusive prefix over
    slabs, (2) the tile-aligned regions, their starts and sid_blocks, (3)
    four slots a thread: the slab of the first by a binary search over the
    prefixes, a step to the next slab where a run ends inside the four."""
    mat = mat.numpy()
    G = mat.shape[1] >> c_log
    keys, rays = mat[0].reshape(G, -1), mat[1].reshape(G, -1)
    first = np.zeros((G, K), np.int64)
    pre = np.zeros((G, K), np.int64)
    counts = np.zeros(K, np.int64)
    for k in range(K):  # 1. one block a key, one thread a slab
        lo = np.array([np.searchsorted(keys[g], k, "left") for g in range(G)])
        c = np.array([np.searchsorted(keys[g], k + 1, "left")
                      for g in range(G)]) - lo
        first[:, k], pre[:, k], counts[k] = lo, np.cumsum(c) - c, c.sum()
    region = (counts + chunk + tile - 1) // tile * tile  # 2. one block
    starts = np.cumsum(region) - region
    B = regroup.out_rows_of(R, K, tile, chunk) // tile
    sid = np.full(B, K - 1, np.int32)
    for k in range(K):
        sid[starts[k] // tile:(starts[k] + region[k]) // tile] = k
    ray_out = np.zeros(B * tile, np.int32)
    on = np.zeros(B * tile, np.int32)
    for s in range(0, B * tile, 4):  # 3. four slots a thread
        k = sid[s // tile]
        o, h = s - starts[k], counts[k]
        if o >= h:
            continue
        g = int(np.nonzero(pre[:, k] <= o)[0].max())
        for j in range(4):
            if o + j < h:
                while g + 1 < G and o + j >= pre[g + 1, k]:
                    g += 1
                ray_out[s + j] = np.clip(
                    rays[g, first[g, k] + o + j - pre[g, k]], 0, R - 1)
                on[s + j] = 1
    return ray_out, sid, on


@pytest.mark.parametrize("case", sorted(E5_CASES))
def test_regroup_blocks_plain_is_the_composition_and_the_reference(case):
    """E5's path entry on the CPU (its plain version) is bit-equal to
    block_runs + scatter_runs_plain + block_layout, and to the reference's
    block_regroup (interpret mode) on sid_blocks, on and the rays of every
    live slot; every live pair lands once, in a block of its key."""
    keys, ray, mat, c_log, R, K = _e5_input(case)
    regroup.reset_counters()
    got = regroup.regroup_blocks(mat, c_log, R, K)
    assert not any(regroup.launches.values()) and regroup.cuda_launched == 0
    args, (starts, counts) = regroup.block_runs(mat, c_log, R, K)
    want = regroup.block_layout(regroup.scatter_runs_plain(*args), starts,
                                counts, R)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)
    r_ray, r_sid, r_on = (np.asarray(x) for x in ref_block(
        jnp.asarray(keys), jnp.asarray(ray), K, slab_log=10,
        interpret=True))
    p_ray, p_sid, p_on = (x.numpy() for x in got)
    np.testing.assert_array_equal(p_sid, r_sid)
    np.testing.assert_array_equal(p_on, r_on)
    on = p_on > 0
    np.testing.assert_array_equal(p_ray[on], r_ray[on])
    assert (p_ray[~on] == 0).all()
    assert on.sum() == (keys < K).sum()
    sid_of = np.repeat(p_sid, 1024)
    for k in range(K):
        assert sorted(p_ray[on & (sid_of == k)].tolist()) == \
            sorted(ray[keys == k].tolist())
    if case == "spans":
        G = mat.shape[1] >> c_log
        assert G == 5 and R % (1 << c_log)
    if case == "empty":
        assert (counts == 0).sum() > K // 2


@pytest.mark.parametrize("case", sorted(E5_CASES))
def test_regroup_blocks_three_pass_model(case):
    """The kernel's three passes, modelled in numpy, give the plain
    version's (ray_out, sid_blocks, on) bit for bit."""
    _, _, mat, c_log, R, K = _e5_input(case)
    want = regroup.regroup_blocks_plain(mat, c_log, R, K)
    for a, b in zip(_e5_model(mat, c_log, R, K), want):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("entry", ["runs", "blocks"])
def test_e5_counts_launches_by_entry(monkeypatch, entry):
    """E5's launch sites count each call under its own entry, and the path
    entry adds the CUDA launches its C entry point reports (three). The C
    entry points are replaced by stubs that record their sizes."""
    calls = []

    def runs(*args):
        calls.append(("runs", args[6:10]))
        return 0

    def blocks(*args):
        calls.append(("blocks", args[8:15]))
        args[-1]._obj.value = 3
        return 0

    monkeypatch.setattr(regroup._build, "load", lambda name: SimpleNamespace(
        scatter_runs=runs, regroup_blocks=blocks))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=0))
    _, _, mat, c_log, R, K = _e5_input("spans")
    regroup.reset_counters()
    for _ in range(2):
        if entry == "runs":
            z = torch.zeros((3, 4), dtype=torch.int32)
            out = regroup._launch(z, z[:, 0].contiguous(), z, z, z, 50)
            assert out.shape == (50,)
        else:
            ray_out, sid, on = regroup._launch_blocks(mat, c_log, R, K, 1024,
                                                      regroup.CHUNK)
            B = regroup.out_rows_of(R, K) // 1024
            assert ray_out.shape == on.shape == (B * 1024,)
            assert sid.shape == (B,)
    assert regroup.launches == {k: 2 * (k == entry) for k in regroup.launches}
    assert regroup.cuda_launched == (6 if entry == "blocks" else 0)
    G = mat.shape[1] >> c_log
    assert calls == [(entry, (3, 4, 4, 50) if entry == "runs" else
                      (G, K, c_log, 1024, regroup.CHUNK,
                       regroup.out_rows_of(R, K) // 1024, R))] * 2
    regroup.reset_counters()
    assert not any(regroup.launches.values()) and regroup.cuda_launched == 0
    with pytest.raises(ValueError, match="tile"):
        regroup._launch_blocks(mat, c_log, R, K, 1022, regroup.CHUNK)
