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
from loupiote_tpu_torch import _build, from_reference
from loupiote_tpu_torch.ops import wide
from torch_port_helpers import (assert_same_hits, nonfinite_rays, numpy_bvh,
                                random_rays, random_tris, soup_scene, t_of)


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


def test_nonfinite_rays_match_pallas_kernel(soup):
    """Rays with +-inf or NaN origin components and +-inf, -0 or tiny
    direction components (lane_gather_bench's edge-case pattern): the
    twin's slab test, like the reference's, returns NaN from a NaN term
    (torch.minimum / maximum, as jnp's), so tri, t and the blocked bits
    agree with the Pallas kernel's on every ray, finite or not."""
    ref, port, tris = soup
    ro, rd = (x.numpy() for x in nonfinite_rays(
        *map(torch.from_numpy, random_rays(tris, 1024, seed=82)), 82))
    bad = ~(np.isfinite(ro).all(1) & np.isfinite(rd).all(1))
    assert 0.3 < bad.mean() < 0.8
    ref_hit = ref_intersect_wide(ref, jnp.asarray(ro), jnp.asarray(rd),
                                 interpret=True, sub=8)
    port_hit = _port_hit(port, ro, rd)
    same = assert_same_hits(np.asarray(ref.tri_pack), ro, rd,
                            np.asarray(ref_hit.tri), port_hit.tri.numpy())
    np.testing.assert_allclose(port_hit.t.numpy()[same],
                               np.asarray(ref_hit.t)[same], rtol=1e-5)
    assert (port_hit.tri.numpy()[~bad] >= 0).mean() > 0.05
    tmax = np.full(1024, 1e30, np.float32)
    ref_b = np.asarray(ref_intersect_wide(
        ref, jnp.asarray(ro), jnp.asarray(rd), tmax=jnp.asarray(tmax),
        any_hit=True, interpret=True, sub=8).tri > 0)
    port_b = wide.occluded_wide(port, torch.from_numpy(ro),
                                torch.from_numpy(rd),
                                torch.from_numpy(tmax)).numpy()
    np.testing.assert_array_equal(port_b, ref_b)


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


def _chain_table(depth):
    """A wide table of ``depth`` internal rows in a chain (slot 0 of each
    points to the next) over one leaf row."""
    rows = np.zeros((depth + 1, 128), np.float32)
    ptr = rows.view(np.int32)
    ptr[:, 6::16] = -1
    for r in range(depth):
        ptr[r, 6] = r + 1 if r + 1 < depth else depth | wide.LEAF_TAG
    return torch.from_numpy(rows)


def test_kernel_wrapper_refuses_a_deep_stack(soup):
    """K1 holds DEPTH_MAX per-level stack entries: a deeper table raises
    before anything is launched; one at the limit passes the check."""
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="stack"):
        wide._launch(_chain_table(wide.DEPTH_MAX + 1), x, x, x[:, 0],
                     x[:, 0] > 0, False, 0, 16)
    assert wide.kernel_depth(_chain_table(wide.DEPTH_MAX)) == wide.DEPTH_MAX


@pytest.mark.parametrize("bad", ["cycle", "out of the table"])
def test_table_depth_refuses_a_malformed_table(bad):
    """The depth walk follows pointers from outside the kernel: a cycle
    or a pointer past the last row raises instead of looping or reading
    past the table."""
    table = _chain_table(4)
    ptr = table.view(torch.int32)
    ptr[3, 6] = 1 if bad == "cycle" else 99
    with pytest.raises(ValueError, match="cycle" if bad == "cycle"
                       else "leaves the table"):
        wide.table_depth(table)


def test_kernel_wrapper_refuses_a_table_of_2_24_rows():
    """A stack entry holds a row index in 24 bits."""
    x = torch.zeros((4, 3))
    big = torch.empty((wide.ROWS_MAX, 128), device="meta")
    with pytest.raises(ValueError, match="rows"):
        wide._launch(big, x, x, x[:, 0], x[:, 0] > 0, False, 0, 16)


def _depth_by_parents(trav_rows):
    """Internal ancestors of the deepest leaf, from a parent map: another
    way to the depth than table_depth's breadth-first levels."""
    ptr = trav_rows.view(torch.int32)[:, 6::16].numpy()
    parent, leaves, todo = {0: None}, [], [0]
    while todo:
        r = todo.pop()
        for c in ptr[r]:
            if c == -1:
                continue
            if c & wide.LEAF_TAG:
                leaves.append(r)
            else:
                parent[int(c)] = r
                todo.append(int(c))
    best = 0
    for r in leaves:
        n = 0
        while r is not None:
            n, r = n + 1, parent[r]
        best = max(best, n)
    return best


def _dup_soup():
    """The random soup with every triangle twice, under two indices: every
    hit is an exact tie, and the winner shows the visit order."""
    import loupiote_tpu_torch.scene.types as port_types
    from loupiote_tpu_torch import build_scene_buffers

    v0, v1, v2 = random_tris(n=300)
    tris = tuple(np.concatenate([a, a]) for a in (v0, v1, v2))
    return build_scene_buffers(soup_scene(port_types, *tris),
                               device="cpu"), tris


def _arch8k():
    with numpy_bvh():
        return from_reference(ref_buffers(build_arch_scene(8_000)),
                              device="cpu")


@pytest.mark.parametrize("name", ["soup", "arch8k", "single", "dup"])
def test_table_depth_on_in_repo_scenes(soup, name):
    """The kernel's stack depth from trav_rows: equal to a parent-map
    count, within DEPTH_MAX, cached per table and recomputed after an
    in-place write."""
    if name == "soup":
        table = soup[1].trav_rows
    elif name == "arch8k":
        table = _arch8k().trav_rows
    elif name == "single":
        v = [np.array([p], np.float32) for p in
             ([-1, -1, 0], [1, -1, 0], [0, 1, 0])]
        table = from_reference(ref_buffers(soup_scene(ref_types, *v)),
                               device="cpu").trav_rows
    else:
        table = _dup_soup()[0].trav_rows
    table = table.clone()  # written in place below
    depth = wide.kernel_depth(table)
    assert depth == _depth_by_parents(table)
    assert 1 <= depth <= wide.DEPTH_MAX
    assert (1 if name == "single" else 2) <= depth
    assert wide.table_depth(table) == depth  # from the cache
    table.view(torch.int32)[0, 6::16] = -1   # the root loses its children
    assert wide.table_depth(table) == 1


def _per_level_walk(trav_rows, ro, rd, tmax, active, any_hit, wide_end):
    """A model of K1's per-level stack, vectorised over rays: an entry is
    (parent row << 8 | mask of its waiting hit children by priority); a
    pop takes the mask's lowest bit and re-reads that child's pointer.
    Returns (t, tri, most entries any ray held)."""
    from loupiote_tpu_torch.ops.intersect import T_MIN, moller_trumbore

    R = ro.shape[0]
    rows_i = trav_rows.view(torch.int32)
    t_best, tri = tmax.clone(), torch.full((R,), -1, dtype=torch.int32)
    blocked = torch.zeros(R, dtype=torch.bool)
    inv = [wide._safe_inv(rd[:, a]) for a in range(3)]
    octant = ((rd[:, 0] < 0).long() | ((rd[:, 1] < 0).long() << 1)
              | ((rd[:, 2] < 0).long() << 2))
    stack = torch.zeros((R, wide.DEPTH_MAX + 1), dtype=torch.int64)
    sp = torch.zeros(R, dtype=torch.int64)
    cur = torch.zeros(R, dtype=torch.int64)
    slots, k14 = torch.arange(8), torch.arange(14)
    live = torch.nonzero(active).flatten()
    most = 0
    for _ in range(wide.max_steps(wide_end)):
        if live.numel() == 0:
            break
        c = cur[live]
        leaf = (c & wide.LEAF_TAG) != 0
        row = c & wide.LEAF_MASK
        nxt = torch.full_like(c, -1)
        if bool(leaf.any()):
            li, lrow = live[leaf], row[leaf]
            tr = trav_rows[lrow, :126].reshape(-1, 14, 9)
            fc = rows_i[lrow, 126]
            u, v, t = moller_trumbore(
                tuple(ro[li, a, None] for a in range(3)),
                tuple(rd[li, a, None] for a in range(3)),
                tuple(tr[:, :, j] for j in range(9)))
            ok = ((k14[None] < (fc & 15)[:, None]) & (u >= 0) & (v >= 0)
                  & (u + v <= 1) & (t > T_MIN) & (t < t_best[li, None]))
            if any_hit:
                blocked[li] = ok.any(1)
            else:
                for k in range(14):  # in slot order, strict <
                    upd = ok[:, k] & (t[:, k] < t_best[li])
                    t_best[li] = torch.where(upd, t[:, k], t_best[li])
                    tri[li] = torch.where(upd, (fc >> 4) + k, tri[li])
        inner = ~leaf
        if bool(inner.any()):
            ni, nrow = live[inner], row[inner]
            box = trav_rows[nrow].reshape(-1, 8, 16)
            ptr = rows_i[nrow].reshape(-1, 8, 16)[:, :, 6]
            t1 = [(box[:, :, a] - ro[ni, a, None]) * inv[a][ni, None]
                  for a in range(3)]
            t2 = [(box[:, :, a + 3] - ro[ni, a, None]) * inv[a][ni, None]
                  for a in range(3)]
            tn = torch.stack([torch.minimum(a, b) for a, b in zip(t1, t2)]
                             ).amax(0)
            tf = torch.stack([torch.maximum(a, b) for a, b in zip(t1, t2)]
                             ).amin(0)
            bound = (tmax if any_hit else t_best)[ni, None]
            hit = (ptr != -1) & (tf >= tn.clamp_min(0.0)) & (tn < bound)
            hit_p = hit.gather(1, slots[None] ^ octant[ni, None])
            mask = (hit_p.long() << slots[None]).sum(1)
            first = (mask & -mask)
            p = torch.log2(first.clamp_min(1).double()).long()
            near = ptr.gather(1, (p ^ octant[ni])[:, None])[:, 0]
            rest = mask & (mask - 1)
            push = rest > 0
            stack[ni[push], sp[ni[push]]] = (nrow[push] << 8) | rest[push]
            sp[ni[push]] += 1
            nxt[inner] = torch.where(mask > 0, near.long(), -1)
        most = max(most, int(sp.max()))
        descend = nxt >= 0
        pop = ~descend & (sp[live] > 0)
        if any_hit:
            descend &= ~blocked[live]
            pop &= ~blocked[live]
        pi = live[pop]
        e = stack[pi, sp[pi] - 1]
        m = e & 255
        p = torch.log2((m & -m).double()).long()
        rest = m & (m - 1)
        stack[pi, sp[pi] - 1] = (e & ~255) | rest
        sp[pi] -= (rest == 0).long()
        cur[pi] = rows_i[e >> 8, 16 * (p ^ octant[pi]) + 6].long()
        cur[live[descend]] = nxt[descend]
        live = live[descend | pop]
    if any_hit:
        return t_best, blocked.to(torch.int32), most
    return t_best, tri, most


@pytest.mark.parametrize("name", ["soup", "arch8k", "dup"])
def test_per_level_stack_visits_in_the_twins_order(soup, name):
    """The redesigned K1's stack (one entry a level) gives wide_trace_plain's
    hits bit for bit, ties included, in both modes, and never holds more
    entries than table_depth."""
    if name == "soup":
        port, tris = soup[1], soup[2]
        ro, rd = random_rays(tris, 512, seed=91)
    elif name == "dup":
        port, tris = _dup_soup()
        ro, rd = random_rays(tris, 512, seed=92)
    else:
        port = _arch8k()
        jitter = np.random.default_rng(5).random((24 * 24, 2)).astype(
            np.float32)
        ro, rd = (np.array(x) for x in ref_generate_rays(
            jnp.asarray(arch_camera()), 24, 24, 0.7853982,
            jnp.asarray(jitter)))
    ro, rd = torch.from_numpy(ro), torch.from_numpy(rd)
    R = ro.shape[0]
    active = torch.from_numpy(np.random.default_rng(93).random(R) < 0.9)
    for any_hit, tmax in ((False, torch.full((R,), 1e30)),
                          (True, torch.full((R,), 6.0))):
        want = wide.wide_trace_plain(port.trav_rows, ro, rd, tmax, active,
                                     any_hit, port.wide_end, port.wide_stack)
        t, tri, most = _per_level_walk(port.trav_rows, ro, rd, tmax, active,
                                       any_hit, port.wide_end)
        assert torch.equal(t.view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(tri, want[1])
        assert most <= wide.table_depth(port.trav_rows)
        if not any_hit:
            assert (tri >= 0).float().mean() > 0.05
            if name == "dup":  # winners from both copies: order matters
                n = tris[0].shape[0] // 2
                assert (tri[tri >= 0] >= n).any()
                assert (tri[tri >= 0] < n).any()


def test_step_bound_stops_and_counts_rays(soup):
    """A ray still traversing at the step bound stops and is counted,
    as the kernel's capped counter does."""
    _, port, tris = soup
    ro, rd = random_rays(tris, 256, seed=83)
    _build.reset_counters()
    wide.wide_trace_plain(port.trav_rows, torch.from_numpy(ro),
                          torch.from_numpy(rd), torch.full((256,), 1e30),
                          torch.ones(256, dtype=torch.bool), False, -15,
                          port.wide_stack)
    # wide_end -15 -> a bound of 4 * -15 + 64 = 4 row visits.
    assert 0 < wide.capped_rays("cpu") <= 256
    _build.reset_counters()
    assert wide.capped_rays("cpu") == 0
