"""Two-level scenes in the reference: a frozen copy of the port's
``loupiote_tpu_torch/scene/instanced.py`` (one BLAS a mesh, the instance
table, the instance loop with its candidate-gather TLAS) over the
reference's own tables and twins.

A configuration asks for it with ``render.instancing: true``. The tables
are worked out again from the benchmark's scene: each BLAS is the mesh in
object space, built by the reference's frozen C++ builder
(``bvh_builder.cpp``, without treelets, as the port builds them); each
BLAS is walked by the twin of the kernel the port picks for it
(``bvh2.py``'s K2 twin under ``WIDE_MIN_NODES`` BVH2 nodes, else the wide
twin of ``trace.py``), in both modes. The instances are visited in the
port's order, and a later instance wins only with a strictly nearer hit:
both decide which of two triangles at one ``t`` a ray hits.

Execution shapes, as the port's:
  - at most ``TLAS_UNROLL_MAX`` instances: one traversal an instance, in
    instance order, with no box cull;
  - more: mesh groups in mesh-slot order. A group of at most two
    instances visits each behind a cull by its world box; a larger group
    takes each ray's ``TLAS_C`` nearest overlapping boxes (a stable sort
    of entry t: the lower id first on a tie), ``TLAS_C`` waves in which
    every ray traverses its own candidate, then an exact drain for rays
    that overlap more boxes than that.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .bvh2 import WIDE_MIN_NODES, bvh2_rows, bvh2_trace_plain
from .probe import Probe
from .scene_types import INVALID_INDEX, Instance, Scene
from .tables import Tables, build_geometry, build_tables
from .trace import (T_FAR, T_MIN, Hit, intersect_wide, ray_args,
                    recompute_uv)

TLAS_UNROLL_MAX = 12
TLAS_C = 12
# Rays x boxes of one selection chunk: bounds memory only, changes no
# result.
TLAS_CHUNK_ELEMS = 1 << 28


@dataclass
class Blas:
    """One mesh's traversal tables, in object space, on one device."""

    trav_rows: torch.Tensor  # the wide table
    node_rows: torch.Tensor  # BVH2 rows (bvh2.py)
    leaf_rows: torch.Tensor
    tri_pack: torch.Tensor  # (Tp, 9)
    tri_shade: torch.Tensor  # (Tp, 20)
    root_min: np.ndarray  # (3,) the BVH2's root box
    root_max: np.ndarray
    wide_end: int
    wide_stack: int
    num_nodes: int
    stack_depth: int
    num_tris: int


def build_blas(mesh, device) -> Blas:
    """The BLAS of ``mesh``: the mesh alone under the identity, material
    0, as the port builds it."""
    sub = Scene(meshes=[mesh],
                instances=[Instance(0, np.eye(4, dtype=np.float32), 0)])
    geo = build_geometry(sub)
    node_rows, leaf_rows, stack_depth = bvh2_rows(geo.bvh, geo.tri9)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Blas(trav_rows=dev(geo.trav_rows), node_rows=dev(node_rows),
                leaf_rows=dev(leaf_rows), tri_pack=dev(geo.tri_pack),
                tri_shade=dev(geo.tri_shade),
                root_min=geo.bvh.node_min[0].copy(),
                root_max=geo.bvh.node_max[0].copy(),
                wide_end=geo.wide_end, wide_stack=geo.wide_stack,
                num_nodes=geo.bvh.num_nodes, stack_depth=stack_depth,
                num_tris=geo.num_tris)


def _world_aabb(bmin, bmax, m: np.ndarray):
    """World-space AABB of an object-space box under ``m``."""
    pts = np.array([[x, y, z] for x in (bmin[0], bmax[0])
                    for y in (bmin[1], bmax[1])
                    for z in (bmin[2], bmax[2])], np.float32)
    w = pts @ m[:3, :3].T + m[:3, 3]
    return w.min(0), w.max(0)


def build_instanced_tables(scene: Scene, probe: Optional[Probe] = None,
                           atlas_size: int = 2048, device="cuda") -> Tables:
    """Two-level tables of ``scene`` (its lights as given): one BLAS per
    mesh an instance uses, the instance table, and the materials, lights,
    atlas and probe of a geometry-less shell. A scene without instances
    gets the flattened tables."""
    if not scene.instances:
        return build_tables(scene, probe=probe, atlas_size=atlas_size,
                            device=device)
    used = sorted({inst.mesh_index for inst in scene.instances})
    mesh_slot = {m: i for i, m in enumerate(used)}
    blas = [build_blas(scene.meshes[m], device) for m in used]
    shell = Scene(materials=list(scene.materials), meshes=[], instances=[],
                  lights=list(scene.lights), images=list(scene.images))
    base = build_tables(shell, probe=probe, atlas_size=atlas_size,
                        device=device)

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
        aabb_lo[k], aabb_hi[k] = _world_aabb(blas[s].root_min,
                                             blas[s].root_max, m)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # The instances' world bounds: the sort keys' and scene_exit_t's box.
    node_min, node_max = base.node_min.clone(), base.node_max.clone()
    node_min[0] = torch.from_numpy(aabb_lo.min(0))
    node_max[0] = torch.from_numpy(aabb_hi.max(0))
    return dataclasses.replace(
        base, tri_shade=tri_shade, tri_pack=tri_pack, node_min=node_min,
        node_max=node_max, blas=tuple(blas), inst_w2o=dev(w2o),
        inst_nmat=dev(nmat), inst_mat_id=dev(mat_id),
        inst_tri_base=dev(tri_base), inst_mesh=tuple(inst_mesh),
        inst_aabb_lo=dev(aabb_lo), inst_aabb_hi=dev(aabb_hi),
        num_tris=int(total))


# -- Traversal ----------------------------------------------------------------

def blas_intersect(blas: Blas, ro, rd, tmax=None, active=None,
                   any_hit: bool = False) -> Hit:
    """One BLAS through the twin of the kernel the port picks for it: K2
    (u, v tracked by the traversal) under ``WIDE_MIN_NODES`` BVH2 nodes,
    else K1 (u, v recomputed)."""
    if blas.num_nodes >= WIDE_MIN_NODES:
        return intersect_wide(blas, ro, rd, tmax=tmax, active=active,
                              any_hit=any_hit)
    ro, rd, t0, act = ray_args(ro, rd, tmax, active)
    t, u, v, tri = bvh2_trace_plain(blas.node_rows, blas.leaf_rows, ro, rd,
                                    t0, act, any_hit, blas.num_nodes,
                                    blas.stack_depth)
    if active is not None:
        tri = torch.where(active, tri, -1)
    return Hit(t, tri, u, v)


def _safe_inv(rd):
    """1 / rd with components of |rd| <= 1e-20 replaced by +1e-20 (the
    port's TLAS substitution: a tiny negative component turns positive)."""
    return 1.0 / torch.where(rd.abs() > 1e-20, rd, 1e-20)


def _to_object(m, ro, rd):
    """Rays through per-ray (R, 4, 4) or shared (4, 4) world-to-object
    matrices; the direction stays unnormalised, so t stays the world
    ray's parameter."""
    r = m[..., :3, :3]
    ro_o = (r * ro[:, None, :]).sum(-1) + m[..., :3, 3]
    rd_o = (r * rd[:, None, :]).sum(-1)
    return ro_o, rd_o


def _ray_box_overlap(ro, rd, lo, hi, t1):
    """(R,) bool: ray slab-overlaps [lo, hi] within (0, t1]."""
    inv = _safe_inv(rd)
    ta = (lo[None, :] - ro) * inv
    tb = (hi[None, :] - ro) * inv
    tnear = torch.minimum(ta, tb).amax(dim=1)
    tfar = torch.maximum(ta, tb).amin(dim=1)
    return (tfar >= torch.clamp_min(tnear, T_MIN)) & (tnear <= t1)


def _chunk_tnear(ro_c, inv_c, lim_c, lo, hi):
    """(n, K) entry t of each overlapping box, +inf where the ray misses
    it."""
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
    (R, C), +inf past the overlaps, n_overlap (R,)); a stable sort keeps
    the lower box id first on equal entry t."""
    K = lo.shape[0]

    def fn(ro_c, inv_c, lim_c):
        tn = _chunk_tnear(ro_c, inv_c, lim_c, lo, hi)
        vals, order = torch.sort(tn, dim=1, stable=True)
        return order[:, :C], vals[:, :C], torch.isfinite(tn).sum(1)

    return _chunked(ro, rd, lim, K, fn)


def _select_next(ro, rd, lim, lo, hi, processed):
    """Each ray's nearest overlapping box not yet processed: (id, tnear,
    valid)."""
    K = lo.shape[0]

    def fn(ro_c, inv_c, lim_c, proc_c):
        tn = torch.where(proc_c, torch.inf,
                         _chunk_tnear(ro_c, inv_c, lim_c, lo, hi))
        nid = torch.argmin(tn, dim=1)  # the first minimum
        ntn = torch.gather(tn, 1, nid[:, None])[:, 0]
        return nid, ntn, torch.isfinite(ntn)

    return _chunked(ro, rd, lim, K, fn, processed)


def _set_bits(processed, ids, on):
    rows = torch.arange(processed.shape[0], device=processed.device)
    processed[rows, ids] |= on
    return processed


def _candidate_group(tables, slot, idx, carry, ro, rd, act, any_hit):
    """One mesh group (instance ids ``idx``) by candidate waves, on the
    rays that reach the group's union box (and, any-hit, are not yet
    blocked); ``carry`` = (best_t, best_tri, best_inst)."""
    blas = tables.blas[slot]
    Ks = len(idx)
    C = min(max(int(TLAS_C), 1), Ks)
    gids = torch.as_tensor(np.asarray(idx, np.int64), device=ro.device)
    lo, hi = tables.inst_aabb_lo[gids], tables.inst_aabb_hi[gids]
    w2o_tbl = tables.inst_w2o[gids]
    tri_base = tables.inst_tri_base[int(idx[0])]

    lim0 = torch.where(act, carry[0], -torch.inf)
    near = _ray_box_overlap(ro, rd, lo.amin(0), hi.amax(0), lim0)
    if any_hit:
        near = near & (carry[1] < 0)
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
        hit = blas_intersect(blas, ro_o, rd_o, tmax=best_t, active=lane,
                             any_hit=any_hit)
        win = hit.tri >= 0
        if not any_hit:
            win = win & (hit.t < best_t)
            best_t = torch.where(win, hit.t, best_t)
        best_tri = torch.where(win, hit.tri + tri_base, best_tri)
        best_inst = torch.where(win, gids[sel_id].to(torch.int32),
                                best_inst)
        return best_t, best_tri, best_inst

    for c in range(C):
        carry = wave(carry, ids[:, c], tns[:, c])
    if C >= Ks:
        return scatter(carry)

    # The exact drain for rays that overlap more than C boxes.
    best_t, best_tri, best_inst = carry
    pend = act & (n_ov > C) & (tns[:, C - 1] < best_t)
    if any_hit:
        pend = pend & (best_tri < 0)
    if not bool(pend.any()):
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
        best_t, best_tri, best_inst = wave(
            (best_t, best_tri, best_inst), torch.where(valid, nid, 0),
            torch.where(valid, ntn, torch.inf))
        if not bool(valid.any()):
            return scatter((best_t, best_tri, best_inst))


def intersect_instanced(tables: Tables, ro, rd, tmax=None, active=None,
                        any_hit: bool = False) -> Hit:
    """The instance loop: rays to object space and each mesh's twin, the
    running best t bounding each later traversal; a later instance wins
    only with a strictly nearer hit. u, v are replayed once, in the
    object space of each ray's winning instance (0 in any-hit mode, where
    only ``tri >= 0`` carries meaning)."""
    R = ro.shape[0]
    dev = ro.device
    best_t = (torch.full((R,), T_FAR, dtype=torch.float32, device=dev)
              if tmax is None else tmax.to(torch.float32))
    best_tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_inst = torch.full((R,), -1, dtype=torch.int32, device=dev)
    act = (torch.ones(R, dtype=torch.bool, device=dev) if active is None
           else active)
    K = len(tables.inst_mesh)

    def visit(carry, k, cull):
        best_t, best_tri, best_inst = carry
        lane = act
        if cull:
            lane = lane & _ray_box_overlap(ro, rd, tables.inst_aabb_lo[k],
                                           tables.inst_aabb_hi[k], best_t)
        if any_hit:
            lane = lane & (best_tri < 0)
        ro_o, rd_o = _to_object(tables.inst_w2o[k], ro, rd)
        hit = blas_intersect(tables.blas[tables.inst_mesh[k]], ro_o, rd_o,
                             tmax=best_t, active=lane, any_hit=any_hit)
        win = hit.tri >= 0
        if not any_hit:
            win = win & (hit.t < best_t)
            best_t = torch.where(win, hit.t, best_t)
        best_tri = torch.where(win, hit.tri + tables.inst_tri_base[k],
                               best_tri)
        best_inst = torch.where(win, k, best_inst)
        return best_t, best_tri, best_inst

    carry = (best_t, best_tri, best_inst)
    if K <= TLAS_UNROLL_MAX:
        for k in range(K):
            carry = visit(carry, k, cull=False)
    else:
        slots = np.asarray(tables.inst_mesh)
        for slot in sorted(set(tables.inst_mesh)):
            idx = np.nonzero(slots == slot)[0]
            if len(idx) <= 2:
                for k in idx:
                    carry = visit(carry, int(k), cull=True)
            else:
                carry = _candidate_group(tables, slot, idx, carry, ro, rd,
                                         act, any_hit)
    best_t, best_tri, best_inst = carry
    if any_hit:
        zero = torch.zeros_like(best_t)
        return Hit(best_t, best_tri, zero, zero, inst=best_inst)
    ro_w, rd_w = _to_object(tables.inst_w2o[best_inst.clamp_min(0).long()],
                            ro, rd)
    u, v = recompute_uv(tables, ro_w, rd_w, best_tri)
    return Hit(best_t, best_tri, u, v, inst=best_inst)


def occluded_instanced(tables: Tables, ro, rd, dist,
                       active=None) -> torch.Tensor:
    """(R,) bool: segment [T_MIN, dist) blocked, through the instance loop
    in any-hit mode."""
    hit = intersect_instanced(tables, ro, rd, tmax=dist * (1.0 - 1e-3),
                              active=active, any_hit=True)
    out = hit.tri >= 0
    if active is not None:
        out = out & active
    return out
