"""Two-level instancing: one BLAS per unique mesh, instance transforms on
top (counterpart of ``loupiote_tpu/scene/instanced.py``).

Moving an instance swaps its transform row and rebuilds no BVH
(``update_instance``), and N instances of a mesh share one BLAS. The
instance loop is planned once at upload (``TlasTables``): its groups in
visit order, each with its kind, instance ids and BLAS slot, on the host
and on the device. A call of the loop runs the groups in maximal runs by
the kernel ``ops/intersect.py``'s dispatch picks for their BLASes (K1 past
8,192 BVH2 nodes, else K2): on CUDA tensors a run of K2 groups is one
launch of ``csrc/tlas_traverse.cu`` (the box culls, the candidate
selection and waves, the drain and the BLAS walks, one thread a ray, no
host sync), and a run of K1 groups runs the plain loop, one K1 launch a
traversal; on CPU tensors every run runs the plain loop
(``_groups_plain``), the kernel's twin, which walks each BLAS through the
dispatch's kernels on object-space rays with a per-ray ``tmax`` carried
from the instances visited before. ``intersect_instanced_plain`` runs the
twin on any device, for the card's checks.

Execution shapes, as the reference's (its ``LOUPIOTE_TLAS=scan`` debug
mode is not ported):
  - at most ``TLAS_UNROLL_MAX`` instances: one traversal per instance, in
    instance order, with no box cull;
  - more: mesh groups in mesh-slot order. A group of at most two
    instances visits each one behind a cull by its world box; a larger
    group takes the candidate-gather TLAS: each ray's ``TLAS_C`` nearest
    overlapping instance boxes of the group, then ``TLAS_C`` waves in
    which every ray traverses its own candidate (its world-to-object
    matrix gathered per ray), then an exact drain for the rays that
    overlap more boxes than that. The drain runs the same kernels (the
    reference's drain avoided its Pallas kernels only because a Pallas
    call inside a loop crashed XLA:TPU).

Spans and counts (``spans.py``): each call of the instance loop is a
``tlas`` span (inside ``intersect{N}``, or ``shadow`` through
``occluded_instanced``) and counts ``("tlas_path", "cuda" | "plain")``;
the kernel adds its ray-by-BLAS walks into the device count
``("blas_walks", "k2")``. In the plain loop each BLAS traversal is a
``blas`` span, so that the loop's own work and its traversals time apart,
counted ``("tlas", "visit" | "wave" | "drain")`` by traversal kind and
``("blas", "k1" | "k2")`` by the kernel the dispatch picks, and the
copies of a candidate group that wait for the device's queue are ``sync``
sites: ``tlas_ids`` (its instance ids uploaded), ``tlas_gather`` (the
rays near the group), ``tlas_pending`` (whether any ray needs the drain)
and ``tlas_drain`` (whether a drain wave found a box).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import _build, spans
from .buffers import SceneBuffers, build_scene_buffers
from .hdr import Probe
from .types import INVALID_INDEX, Instance, Scene

# At most this many instances: a plain unroll over them (no box cull).
TLAS_UNROLL_MAX = 12
# Candidate waves of a mesh group (the reference's LOUPIOTE_TLAS_C
# default; a test may patch it, as the reference's test sets its knob).
TLAS_C = 12
# Rays x boxes of one selection chunk. The chunking bounds memory only and
# changes no result: at the 1080p frame (2,073,600 rays x 100 boxes) one
# chunk holds the whole wave.
TLAS_CHUNK_ELEMS = 1 << 28
# The most candidate waves a group takes on the card
# (csrc/tlas_traverse.cu: kCMax).
TLAS_C_MAX = 16

# Group kinds of the plan: an instance visited with no cull (the unroll),
# instances visited behind their box culls, a candidate-gather group.
UNROLL, VISIT, CANDIDATE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class TlasTables:
    """The instance loop's plan, built once at upload: its groups in visit
    order on the host, ``(kind, instance ids, BLAS slot)``, and the tables
    ``csrc/tlas_traverse.cu`` reads on the device. ``update_instance``
    replaces the union boxes only."""

    groups: tuple
    rows: torch.Tensor  # (G, 4) int32: kind, first id, count, BLAS slot
    ids: torch.Tensor  # (K,) int32 instance ids, group after group
    lo: torch.Tensor  # (G, 3) each group's union of its instance boxes
    hi: torch.Tensor  # (G, 3)
    blas: tuple  # the BLASes whose tables blas_ptrs points into
    blas_ptrs: torch.Tensor  # (S, 2) int64 node_rows, leaf_rows pointers
    blas_steps: torch.Tensor  # (S,) int32 K2's step bound a BLAS


def plan_groups(inst_mesh) -> tuple:
    """The instance loop's groups, ``(kind, instance ids, slot)`` in visit
    order: at most ``TLAS_UNROLL_MAX`` instances, each one an ``UNROLL``
    group in instance order; more, one group a mesh slot in slot order,
    ``VISIT`` for at most two instances and ``CANDIDATE`` past that."""
    if len(inst_mesh) <= TLAS_UNROLL_MAX:
        return tuple((UNROLL, (k,), int(s)) for k, s in enumerate(inst_mesh))
    slots = np.asarray(inst_mesh)
    out = []
    for slot in sorted(set(inst_mesh)):
        idx = tuple(int(k) for k in np.nonzero(slots == slot)[0])
        out.append((VISIT if len(idx) <= 2 else CANDIDATE, idx, int(slot)))
    return tuple(out)


def plan_runs(groups, on_bvh2) -> list:
    """Maximal runs ``(first, stop, on_bvh2)`` of consecutive groups whose
    BLASes (``on_bvh2[slot]``) all take K2, or all take K1."""
    runs: list = []
    for g, (_, _, slot) in enumerate(groups):
        on = bool(on_bvh2[slot])
        if runs and runs[-1][2] == on:
            runs[-1] = (runs[-1][0], g + 1, on)
        else:
            runs.append((g, g + 1, on))
    return runs


def _group_boxes(groups, aabb_lo: np.ndarray, aabb_hi: np.ndarray):
    """(G, 3) unions of each group's instance boxes (min and max are exact,
    so they equal the plain loop's ``amin`` / ``amax``)."""
    lo = np.stack([aabb_lo[list(idx)].min(0) for _, idx, _ in groups])
    hi = np.stack([aabb_hi[list(idx)].max(0) for _, idx, _ in groups])
    return lo.astype(np.float32), hi.astype(np.float32)


def tlas_tables(blas: tuple, inst_mesh: tuple, aabb_lo: np.ndarray,
                aabb_hi: np.ndarray) -> TlasTables:
    """Plan the instance loop and upload its tables beside the BLASes."""
    from ..ops.bvh2 import max_steps

    groups = plan_groups(inst_mesh)
    rows, ids = [], []
    for kind, idx, slot in groups:
        rows.append((kind, len(ids), len(idx), slot))
        ids.extend(idx)
    lo, hi = _group_boxes(groups, aabb_lo, aabb_hi)
    for b in blas:
        for t in (b.node_rows, b.leaf_rows):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError("a BLAS table is not contiguous float32")
    dev = blas[0].node_rows.device

    def up(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    return TlasTables(
        groups=groups, rows=up(rows, torch.int32), ids=up(ids, torch.int32),
        lo=up(lo, torch.float32), hi=up(hi, torch.float32), blas=blas,
        blas_ptrs=up([(b.node_rows.data_ptr(), b.leaf_rows.data_ptr())
                      for b in blas], torch.int64),
        blas_steps=up([max_steps(b.num_nodes) for b in blas], torch.int32))


def build_instanced_buffers(scene: Scene, probe: Optional[Probe] = None,
                            atlas_size: int = 2048, device="cuda",
                            use_native: bool = True) -> SceneBuffers:
    """Two-level upload: one BLAS per unique mesh, and the instance table.

    The returned buffers' ``blas`` holds each mesh's traversal tables
    (object space, built without treelets); their ``tri_shade`` and
    ``tri_pack`` are the BLASes' object-space triangle tables end to end,
    so a hit's global triangle is ``inst_tri_base[instance]`` plus its
    BLAS-local id. Materials, lights, the atlas and the probe come from a
    geometry-less build of the scene. A scene without instances gets the
    flattened build.
    """
    build = dict(device=device, use_native=use_native)
    if not scene.instances:
        return build_scene_buffers(scene, probe=probe, atlas_size=atlas_size,
                                   **build)
    used_meshes = sorted({inst.mesh_index for inst in scene.instances})
    mesh_slot = {m: i for i, m in enumerate(used_meshes)}

    blas = []
    for m in used_meshes:
        sub = Scene.default()
        sub.materials = list(scene.materials) or sub.materials
        sub.meshes = [scene.meshes[m]]
        sub.instances = [Instance(0, np.eye(4, dtype=np.float32), 0)]
        sub.lights, sub.images = [], []
        blas.append(build_scene_buffers(sub, treelets=False, **build))

    shell = Scene.default()
    shell.materials = list(scene.materials)
    shell.lights = list(scene.lights)
    shell.images = list(scene.images)
    shell.meshes, shell.instances = [], []
    base = build_scene_buffers(shell, probe=probe, atlas_size=atlas_size,
                               **build)

    total = sum(b.num_tris for b in blas)
    mesh_tri_base = np.cumsum([0] + [b.num_tris for b in blas])[:-1]
    Tp = max(((total + 127) // 128) * 128, 128)

    def stacked(name):
        rows = torch.cat([getattr(b, name)[:b.num_tris] for b in blas])
        return torch.cat([rows, rows.new_zeros(Tp - total, rows.shape[1])])

    tri_shade = stacked("tri_shade")
    tri_pack = stacked("tri_pack")
    tri_pack[total:, 0:3] = 1e30

    K = len(scene.instances)
    w2o = np.zeros((K, 4, 4), np.float32)
    nmat = np.zeros((K, 3, 3), np.float32)
    mat_id = np.zeros(K, np.int32)
    tri_base = np.zeros(K, np.int32)
    aabb_lo = np.zeros((K, 3), np.float32)
    aabb_hi = np.zeros((K, 3), np.float32)
    roots = [_root_box(b) for b in blas]
    inst_mesh = []
    for k, inst in enumerate(scene.instances):
        s = mesh_slot[inst.mesh_index]
        inst_mesh.append(s)
        m = np.asarray(inst.model_to_world, np.float32)
        w2o[k] = np.linalg.inv(m)
        nmat[k] = np.linalg.inv(m[:3, :3]).T
        mid = inst.material_index
        if mid == int(INVALID_INDEX) or mid >= len(scene.materials):
            mid = 0
        mat_id[k] = mid
        tri_base[k] = mesh_tri_base[s]
        aabb_lo[k], aabb_hi[k] = _world_aabb(roots[s], m)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # The instances' world bounds feed the ray-sort keys and scene_exit_t
    # through node_min[0] / node_max[0] of the shell's tables.
    node_min, node_max = _bounds_rows(base, aabb_lo, aabb_hi)
    blas = tuple(blas)
    return dataclasses.replace(
        base, tri_shade=tri_shade, tri_pack=tri_pack, node_min=node_min,
        node_max=node_max, blas=blas, inst_w2o=dev(w2o),
        inst_nmat=dev(nmat), inst_mat_id=dev(mat_id),
        inst_tri_base=dev(tri_base), inst_mesh=tuple(inst_mesh),
        inst_aabb_lo=dev(aabb_lo), inst_aabb_hi=dev(aabb_hi),
        num_tris=int(total),
        tlas=tlas_tables(blas, tuple(inst_mesh), aabb_lo, aabb_hi))


def _root_box(blas: SceneBuffers):
    """A BLAS's object-space root box, (lo, hi) as numpy."""
    return blas.node_min[0].cpu().numpy(), blas.node_max[0].cpu().numpy()


def _world_aabb(root, m: np.ndarray):
    """World-space AABB of a mesh's object-space root box under ``m``."""
    bmin, bmax = root
    pts = np.array([[x, y, z] for x in (bmin[0], bmax[0])
                    for y in (bmin[1], bmax[1])
                    for z in (bmin[2], bmax[2])], np.float32)
    w = pts @ m[:3, :3].T + m[:3, 3]
    return w.min(0), w.max(0)


def _bounds_rows(bufs: SceneBuffers, aabb_lo: np.ndarray,
                 aabb_hi: np.ndarray):
    """node_min / node_max with row 0 the union of the instance boxes."""
    node_min, node_max = bufs.node_min.clone(), bufs.node_max.clone()
    node_min[0] = torch.from_numpy(aabb_lo.min(0))
    node_max[0] = torch.from_numpy(aabb_hi.max(0))
    return node_min, node_max


def update_instance(bufs: SceneBuffers, k: int,
                    model_to_world: np.ndarray) -> SceneBuffers:
    """Move instance ``k``: new transform rows, cull box, group union box
    and world bounds; no BVH rebuild and no geometry upload (the BLAS
    tuple is the same object, its tensors untouched, and the loop's plan
    and its device group tables are kept)."""
    m = np.asarray(model_to_world, np.float32)
    w2o, nmat = bufs.inst_w2o.clone(), bufs.inst_nmat.clone()
    w2o[k] = torch.from_numpy(np.linalg.inv(m))
    nmat[k] = torch.from_numpy(np.linalg.inv(m[:3, :3]).T.copy())
    aabb_lo = bufs.inst_aabb_lo.cpu().numpy().copy()
    aabb_hi = bufs.inst_aabb_hi.cpu().numpy().copy()
    aabb_lo[k], aabb_hi[k] = _world_aabb(
        _root_box(bufs.blas[bufs.inst_mesh[k]]), m)
    node_min, node_max = _bounds_rows(bufs, aabb_lo, aabb_hi)
    dev = bufs.device
    lo, hi = _group_boxes(bufs.tlas.groups, aabb_lo, aabb_hi)
    tlas = dataclasses.replace(bufs.tlas, lo=torch.from_numpy(lo).to(dev),
                               hi=torch.from_numpy(hi).to(dev))
    return dataclasses.replace(
        bufs, inst_w2o=w2o, inst_nmat=nmat,
        inst_aabb_lo=torch.from_numpy(aabb_lo).to(dev),
        inst_aabb_hi=torch.from_numpy(aabb_hi).to(dev),
        node_min=node_min, node_max=node_max, tlas=tlas)


# -- Traversal ----------------------------------------------------------------

def _safe_inv(rd):
    """1 / rd with components of |rd| <= 1e-20 replaced by +1e-20 (the
    reference's substitution: a tiny negative component turns positive)."""
    return 1.0 / torch.where(rd.abs() > 1e-20, rd, 1e-20)


def _to_object(m, ro, rd):
    """Rays through per-ray (R, 4, 4) or shared (4, 4) world-to-object
    matrices; the direction stays unnormalised, so t stays the world
    ray's parameter. Five device ops a call: a wave's transform is on the
    host's launch path 168 times a 1080p frame."""
    r = m[..., :3, :3]
    ro_o = (r * ro[:, None, :]).sum(-1) + m[..., :3, 3]
    rd_o = (r * rd[:, None, :]).sum(-1)
    return ro_o, rd_o


def _ray_box_overlap(ro, rd, lo, hi, t1):
    """(R,) bool: ray slab-overlaps [lo, hi] within (0, t1] (world space)."""
    from ..ops.intersect import T_MIN

    inv = _safe_inv(rd)
    ta = (lo[None, :] - ro) * inv
    tb = (hi[None, :] - ro) * inv
    tnear = torch.minimum(ta, tb).amax(dim=1)
    tfar = torch.maximum(ta, tb).amin(dim=1)
    return (tfar >= torch.clamp_min(tnear, T_MIN)) & (tnear <= t1)


def _chunk_tnear(ro_c, inv_c, lim_c, lo, hi):
    """(n, K) entry t of each overlapping box, +inf where the ray misses
    it; one axis at a time, so only (n, K) tensors are live."""
    from ..ops.intersect import T_MIN

    tn = tf = None
    for a in range(3):
        ta = (lo[None, :, a] - ro_c[:, a:a + 1]) * inv_c[:, a:a + 1]
        tb = (hi[None, :, a] - ro_c[:, a:a + 1]) * inv_c[:, a:a + 1]
        lo_t, hi_t = torch.minimum(ta, tb), torch.maximum(ta, tb)
        del ta, tb
        tn = lo_t if tn is None else torch.maximum(tn, lo_t)
        tf = hi_t if tf is None else torch.minimum(tf, hi_t)
    ov = (tf >= torch.clamp_min(tn, T_MIN)) & (tn <= lim_c[:, None])
    return torch.where(ov, tn, torch.inf)


def _chunked(ro, rd, lim, K, fn, *extra):
    """``fn(ro_c, inv_c, lim_c, *extra_c)`` over chunks of rays, at most
    ``TLAS_CHUNK_ELEMS`` rays x boxes each; outputs concatenated."""
    R = ro.shape[0]
    inv = _safe_inv(rd)
    ch = max(min(TLAS_CHUNK_ELEMS // max(K, 1), R), 1)
    outs = [fn(ro[i:i + ch], inv[i:i + ch], lim[i:i + ch],
               *(x[i:i + ch] for x in extra)) for i in range(0, R, ch)]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def _select_topc(ro, rd, lim, lo, hi, C):
    """Each ray's C nearest overlapping boxes: (ids (R, C) int64, tnear
    (R, C), +inf past the overlaps, n_overlap (R,)). A stable sort keeps
    the lower box id first on equal entry t, as ``lax.top_k`` does."""
    K = lo.shape[0]

    def fn(ro_c, inv_c, lim_c):
        tn = _chunk_tnear(ro_c, inv_c, lim_c, lo, hi)
        vals, order = torch.sort(tn, dim=1, stable=True)
        return order[:, :C], vals[:, :C], torch.isfinite(tn).sum(1)

    return _chunked(ro, rd, lim, K, fn)


def _select_next(ro, rd, lim, lo, hi, processed):
    """Each ray's nearest overlapping box not yet processed: (id, tnear,
    valid). ``processed``: (R, K) bool."""
    K = lo.shape[0]

    def fn(ro_c, inv_c, lim_c, proc_c):
        tn = torch.where(proc_c, torch.inf,
                         _chunk_tnear(ro_c, inv_c, lim_c, lo, hi))
        nid = torch.argmin(tn, dim=1)  # the first minimum, as jnp.argmin
        ntn = torch.gather(tn, 1, nid[:, None])[:, 0]
        return nid, ntn, torch.isfinite(ntn)

    return _chunked(ro, rd, lim, K, fn, processed)


def _set_bits(processed, ids, on):
    """Mark box ``ids`` (R,) processed where ``on``."""
    rows = torch.arange(processed.shape[0], device=processed.device)
    processed[rows, ids] |= on
    return processed


def _traverse(blas, ro, rd, tmax, active, any_hit):
    """One BLAS traversal under a ``blas`` span, counted by the kernel
    that ``ops/intersect.py``'s dispatch picks for the BLAS."""
    from ..ops.intersect import intersect_any, uses_bvh2

    spans.count("blas", "k2" if uses_bvh2(blas) else "k1")
    with spans.span("blas"):
        return intersect_any(blas, ro, rd, tmax=tmax, active=active,
                             any_hit=any_hit)


def _candidate_group(bufs, slot, idx, carry, ro, rd, act, any_hit):
    """Traverse one mesh group (instance ids ``idx``) by candidate waves.
    ``carry`` = (best_t, best_tri, best_inst); in any-hit mode best_t
    stays the caller's tmax and best_tri >= 0 marks a blocked ray."""
    blas = bufs.blas[slot]
    Ks = len(idx)
    C = min(max(int(TLAS_C), 1), Ks)
    with spans.sync("tlas_ids"):  # a blocking copy to the device
        gids = torch.as_tensor(np.asarray(idx, np.int64), device=ro.device)
    lo, hi = bufs.inst_aabb_lo[gids], bufs.inst_aabb_hi[gids]
    w2o_tbl = bufs.inst_w2o[gids]
    tri_base = bufs.inst_tri_base[int(idx[0])]  # one mesh: one base

    # Only a ray that reaches the group's union box can overlap one of
    # its boxes (the slab test is monotone in the box, rounding
    # included), and a blocked any-hit ray changes no more: the group
    # runs on the others alone, gathered here and scattered back at the
    # end (one host sync). A group no ray comes near launches nothing.
    lim0 = torch.where(act, carry[0], -torch.inf)
    near = _ray_box_overlap(ro, rd, lo.amin(0), hi.amax(0), lim0)
    if any_hit:
        near = near & (carry[1] < 0)
    with spans.sync("tlas_gather"):
        sub = torch.nonzero(near).flatten()
    if sub.numel() == 0:
        return carry
    full = carry
    carry = tuple(x[sub] for x in carry)
    ro, rd, act, lim0 = ro[sub], rd[sub], act[sub], lim0[sub]
    ids, tns, n_ov = _select_topc(ro, rd, lim0, lo, hi, C)

    def scatter(carry):
        out = tuple(x.clone() for x in full)
        for x, y in zip(out, carry):
            x[sub] = y
        return out

    def wave(carry, sel_id, sel_tn):
        best_t, best_tri, best_inst = carry
        lane = act & torch.isfinite(sel_tn) & (sel_tn < best_t)
        if any_hit:
            lane = lane & (best_tri < 0)
        ro_o, rd_o = _to_object(w2o_tbl[sel_id], ro, rd)
        hit = _traverse(blas, ro_o, rd_o, best_t, lane, any_hit)
        win = hit.tri >= 0
        if not any_hit:
            win = win & (hit.t < best_t)
            best_t = torch.where(win, hit.t, best_t)
        best_tri = torch.where(win, hit.tri + tri_base, best_tri)
        best_inst = torch.where(win, gids[sel_id].to(torch.int32),
                                best_inst)
        return best_t, best_tri, best_inst

    for c in range(C):
        spans.count("tlas", "wave")
        carry = wave(carry, ids[:, c], tns[:, c])
    if C >= Ks:
        return scatter(carry)

    # The exact drain for rays that overlap more than C boxes. A box not
    # yet processed can matter only while its entry t beats the carried
    # limit (closest-hit: best_t; any-hit: tmax, while not blocked).
    best_t, best_tri, best_inst = carry
    pend = act & (n_ov > C) & (tns[:, C - 1] < best_t)
    if any_hit:
        pend = pend & (best_tri < 0)
    with spans.sync("tlas_pending"):
        pending = bool(pend.any())
    if not pending:
        return scatter(carry)
    processed = torch.zeros((ro.shape[0], Ks), dtype=torch.bool,
                            device=ro.device)
    for c in range(C):
        processed = _set_bits(processed, ids[:, c],
                              torch.isfinite(tns[:, c]))
    while True:
        lim = torch.where(act, best_t, -torch.inf)
        if any_hit:
            lim = torch.where(best_tri < 0, lim, -torch.inf)
        nid, ntn, valid = _select_next(ro, rd, lim, lo, hi, processed)
        processed = _set_bits(processed, nid, valid)
        spans.count("tlas", "drain")
        best_t, best_tri, best_inst = wave(
            (best_t, best_tri, best_inst), torch.where(valid, nid, 0),
            torch.where(valid, ntn, torch.inf))
        with spans.sync("tlas_drain"):
            more = bool(valid.any())
        if not more:
            return scatter((best_t, best_tri, best_inst))


def intersect_instanced(bufs: SceneBuffers, ro, rd, tmax=None, active=None,
                        any_hit: bool = False):
    """The instance loop, under a ``tlas`` span: per instance (or per
    candidate wave), rays to object space and the mesh's kernel, the
    running best t bounding each later traversal. A later instance wins
    only with a strictly nearer hit, so the first visited keeps a tie.
    u, v are replayed once, in the object space of each ray's winning
    instance (0 in any-hit mode, where only ``tri >= 0`` carries
    meaning). On CUDA tensors each run of K2 groups is one launch of
    ``csrc/tlas_traverse.cu``, which also returns the winners' u, v where
    it is the whole loop (the same bits as the replay); on CPU tensors
    the plain loop runs."""
    with spans.span("tlas"):
        return _instance_loop(bufs, ro, rd, tmax, active, any_hit,
                              _build.on_card(ro))


def intersect_instanced_plain(bufs: SceneBuffers, ro, rd, tmax=None,
                              active=None, any_hit: bool = False):
    """``intersect_instanced`` through the plain loop on any device: the
    kernel's twin, which on CUDA tensors launches a BLAS kernel a
    traversal."""
    with spans.span("tlas"):
        return _instance_loop(bufs, ro, rd, tmax, active, any_hit, False)


def _instance_loop(bufs, ro, rd, tmax, active, any_hit, kernel):
    from ..ops.intersect import T_FAR, Hit, recompute_uv, uses_bvh2

    R = ro.shape[0]
    dev = ro.device
    best_t = (torch.full((R,), T_FAR, dtype=torch.float32, device=dev)
              if tmax is None else tmax.to(torch.float32))
    best_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_inst = torch.full((R,), -1, dtype=torch.int32, device=dev)
    act = (torch.ones(R, dtype=torch.bool, device=dev) if active is None
           else active)
    spans.count("tlas_path", "cuda" if kernel else "plain")
    groups = bufs.tlas.groups
    runs = plan_runs(groups, [uses_bvh2(b) for b in bufs.blas])
    # A closest-hit loop that is one launch takes the kernel's u, v.
    with_uv = kernel and not any_hit and len(runs) == 1 and runs[0][2]
    carry = (best_t, best_tri, best_inst)
    for g0, g1, on_bvh2 in runs:
        if kernel and on_bvh2:
            carry = _launch(bufs, g0, g1, carry, ro, rd, act, any_hit,
                            with_uv)
        else:
            carry = _groups_plain(bufs, groups[g0:g1], carry, ro, rd, act,
                                  any_hit)
    if with_uv:
        return Hit(*carry[:2], *carry[3:], inst=carry[2])
    best_t, best_tri, best_inst = carry
    if any_hit:
        zero = torch.zeros_like(best_t)
        return Hit(best_t, best_tri, zero, zero, inst=best_inst)
    ro_w, rd_w = _to_object(bufs.inst_w2o[best_inst.clamp_min(0).long()],
                            ro, rd)
    u, v = recompute_uv(bufs, ro_w, rd_w, best_tri)
    return Hit(best_t, best_tri, u, v, inst=best_inst)


def _groups_plain(bufs, groups, carry, ro, rd, act, any_hit):
    """The plain loop over ``groups`` from ``carry`` = (best_t, best_tri,
    best_inst): the twin of ``csrc/tlas_traverse.cu``, a BLAS traversal
    through ``ops/intersect.py``'s dispatch at a time."""

    def visit(carry, k, cull):
        best_t, best_tri, best_inst = carry
        lane = act
        if cull:
            lane = lane & _ray_box_overlap(ro, rd, bufs.inst_aabb_lo[k],
                                           bufs.inst_aabb_hi[k], best_t)
        if any_hit:
            lane = lane & (best_tri < 0)
        ro_o, rd_o = _to_object(bufs.inst_w2o[k], ro, rd)
        spans.count("tlas", "visit")
        hit = _traverse(bufs.blas[bufs.inst_mesh[k]], ro_o, rd_o, best_t,
                        lane, any_hit)
        win = hit.tri >= 0
        if not any_hit:
            win = win & (hit.t < best_t)
            best_t = torch.where(win, hit.t, best_t)
        best_tri = torch.where(win, hit.tri + bufs.inst_tri_base[k],
                               best_tri)
        best_inst = torch.where(win, k, best_inst)
        return best_t, best_tri, best_inst

    for kind, idx, slot in groups:
        if kind == CANDIDATE:
            carry = _candidate_group(bufs, slot, idx, carry, ro, rd, act,
                                     any_hit)
        else:
            for k in idx:
                carry = visit(carry, k, cull=kind == VISIT)
    return carry


def _launch(bufs, g0, g1, carry, ro, rd, act, any_hit, with_uv=False):
    """``csrc/tlas_traverse.cu`` over groups [g0, g1) of ``bufs.tlas``, all
    on K2: the carry out (best_t, best_tri, best_inst), new tensors, and
    with ``with_uv`` the u, v of this launch's hits after it."""
    from ..ops import bvh2

    tables = bufs.tlas
    if tables.blas is not bufs.blas:
        raise ValueError("the TLAS tables were built for other BLASes")
    c_max = max(int(TLAS_C), 1)
    if c_max > TLAS_C_MAX:
        raise ValueError(f"TLAS_C {c_max}: the kernel keeps at most "
                         f"{TLAS_C_MAX} candidates a ray")
    for _, _, slot in tables.groups[g0:g1]:
        if bufs.blas[slot].stack_depth > bvh2.STACK_MAX:
            raise ValueError(f"BLAS {slot} needs a traversal stack of "
                             f"{bufs.blas[slot].stack_depth} entries; the "
                             f"kernel holds {bvh2.STACK_MAX}")
    dev = ro.device
    R = ro.shape[0]
    K = len(bufs.inst_mesh)
    G, S = len(tables.groups), len(bufs.blas)
    ro, rd, act = ro.contiguous(), rd.contiguous(), act.contiguous()
    t_in, tri_in, inst_in = (x.contiguous() for x in carry)
    _build.check_args(dev, (("ro", ro, torch.float32, (R, 3)),
                     ("rd", rd, torch.float32, (R, 3)),
                     ("active", act, torch.bool, (R,)),
                     ("best_t", t_in, torch.float32, (R,)),
                     ("best_tri", tri_in, torch.int32, (R,)),
                     ("best_inst", inst_in, torch.int32, (R,)),
                     ("rows", tables.rows, torch.int32, (G, 4)),
                     ("ids", tables.ids, torch.int32, (K,)),
                     ("lo", tables.lo, torch.float32, (G, 3)),
                     ("hi", tables.hi, torch.float32, (G, 3)),
                     ("blas_ptrs", tables.blas_ptrs, torch.int64, (S, 2)),
                     ("blas_steps", tables.blas_steps, torch.int32, (S,)),
                     ("inst_w2o", bufs.inst_w2o, torch.float32, (K, 4, 4)),
                     ("inst_aabb_lo", bufs.inst_aabb_lo, torch.float32,
                      (K, 3)),
                     ("inst_aabb_hi", bufs.inst_aabb_hi, torch.float32,
                      (K, 3)),
                     ("inst_tri_base", bufs.inst_tri_base, torch.int32,
                      (K,))))
    out = (torch.empty(R, dtype=torch.float32, device=dev),
           torch.empty(R, dtype=torch.int32, device=dev),
           torch.empty(R, dtype=torch.int32, device=dev))
    if with_uv:
        out += (torch.empty(R, dtype=torch.float32, device=dev),
                torch.empty(R, dtype=torch.float32, device=dev))
    walks = spans.device_count("blas_walks", "k2", dev)
    _build.launch("tlas_traverse", "tlas_trace", "23p5is", ro, rd, act, t_in,
                  tri_in, inst_in, *out[:3],
                  *(out[3:] if with_uv else (None, None)), tables.rows,
                  tables.ids, tables.lo, tables.hi, tables.blas_ptrs,
                  tables.blas_steps, bufs.inst_w2o, bufs.inst_aabb_lo,
                  bufs.inst_aabb_hi, bufs.inst_tri_base,
                  bvh2._capped.tensor(dev), walks, R, g0, g1, c_max,
                  int(any_hit))
    return out


def occluded_instanced(bufs: SceneBuffers, ro, rd, dist,
                       active=None) -> torch.Tensor:
    """(R,) bool: segment [T_MIN, dist) blocked, through the instance loop
    in any-hit mode (K3 does not run on instanced scenes)."""
    hit = intersect_instanced(bufs, ro, rd, tmax=dist * (1.0 - 1e-3),
                              active=active, any_hit=True)
    out = hit.tri >= 0
    if active is not None:
        out = out & active
    return out
