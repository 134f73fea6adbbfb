"""Wide-BVH traversal: kernel K1 (``csrc/wide_traverse.cu``) and its plain
torch twin.

Counterpart of ``loupiote_tpu/ops/pallas_wide.py`` (``intersect_wide``,
``occluded_wide``). ``wide_trace`` launches the CUDA kernel for CUDA
tensors and runs ``wide_trace_plain`` for CPU tensors; there is no
fallback from one to the other. Both visit rows in the same order
(nearest hit child next, the others later in ``slot ^ octant(ray
direction)`` order), so they return the same hits. The twin keeps one
stack entry per waiting child; the kernel one per level (the parent row
and the mask of its waiting children), so it needs the table's depth,
which ``table_depth`` computes on the host.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from .. import _build
from .._build import check_args, on_card
from ..accel.wide import LEAF_MASK, LEAF_TAG
from .intersect import T_MIN, Hit, moller_trumbore, ray_args, recompute_uv

DEPTH_MAX = 32  # csrc/wide_traverse.cu: kDepthMax
ROWS_MAX = 1 << 24  # a stack entry holds a row index in 24 bits

# Rays stopped by the step bound, per device.
_capped = _build.kernel_counter("wide_traverse.capped")


def capped_rays(device) -> int:
    """Rays that reached the step bound ``4 * wide_end + 64`` on ``device``
    since the last ``_build.reset_counters()``; 0 on a well-formed
    table."""
    return _capped.read(device)


def max_steps(wide_end: int) -> int:
    """The reference kernel's step bound (row visits per ray)."""
    return 4 * int(wide_end) + 64


def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(d.abs() > 1e-20, d,
                             torch.where(d >= 0, 1e-20, -1e-20))


def wide_trace_plain(trav_rows: torch.Tensor, ro: torch.Tensor,
                     rd: torch.Tensor, tmax: torch.Tensor,
                     active: torch.Tensor, any_hit: bool, wide_end: int,
                     wide_stack: int, stats: dict | None = None):
    """Plain torch traversal of the wide table, vectorised over rays.

    Each live ray visits one row per step: a leaf row runs the 14-triangle
    Moller-Trumbore test; an internal row box-tests its 8 children, makes
    the nearest hit child the next row and pushes the others far-to-near
    onto the ray's own stack (R, wide_stack). Returns ``(t, tri)``:
    closest-hit gives the nearest hit's t (``tmax`` on a miss) and triangle
    (-1 on a miss); any-hit gives ``tmax`` and 1 where blocked, else 0.

    ``stats``: when a dict, receives ``box_tests`` (8 per internal row
    visit) and ``tri_tests`` (triangles tested) summed over the rays, the
    work count that bounds the kernel's operations.
    """
    dev = ro.device
    R = ro.shape[0]
    rows_i = trav_rows.view(torch.int32)
    t_best = tmax.clone()
    tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    blocked = torch.zeros(R, dtype=torch.bool, device=dev)
    ox, oy, oz = ro[:, 0], ro[:, 1], ro[:, 2]
    dx, dy, dz = rd[:, 0], rd[:, 1], rd[:, 2]
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    octant = ((dx < 0).to(torch.int64) | ((dy < 0).to(torch.int64) << 1)
              | ((dz < 0).to(torch.int64) << 2))
    # Column wide_stack is a dump slot for the scatter of unpushed children.
    stack = torch.zeros((R, wide_stack + 1), dtype=torch.int32, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    cur = torch.zeros(R, dtype=torch.int32, device=dev)
    slots = torch.arange(8, device=dev)
    k14 = torch.arange(14, device=dev)
    live = torch.nonzero(active).flatten()
    box_tests = tri_tests = 0
    for _ in range(max_steps(wide_end)):
        if live.numel() == 0:
            break
        c = cur[live]
        leaf = (c & LEAF_TAG) != 0
        row = (c & LEAF_MASK).to(torch.int64)
        nxt = torch.full_like(c, -1)
        box_tests += 8 * int((~leaf).sum())

        # Leaf rows: Moller-Trumbore against up to 14 triangles.
        if bool(leaf.any()):
            li, lrow = live[leaf], row[leaf]
            tr = trav_rows[lrow, :126].reshape(-1, 14, 9)
            fc = rows_i[lrow, 126]
            first, count = fc >> 4, fc & 15
            tri_tests += int(count.sum())
            o = (ox[li, None], oy[li, None], oz[li, None])
            d = (dx[li, None], dy[li, None], dz[li, None])
            u, v, t = moller_trumbore(o, d, tuple(tr[:, :, j]
                                                  for j in range(9)))
            ok = ((k14[None, :] < count[:, None]) & (u >= 0.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (t > T_MIN)
                  & (t < t_best[li, None]))
            if any_hit:
                blocked[li] = ok.any(dim=1)
            else:
                cand = torch.where(ok, t, float("inf"))
                k = torch.argmin(cand, dim=1)  # first minimum: earlier tri
                ct = cand.gather(1, k[:, None])[:, 0]
                upd = ct < t_best[li]
                t_best[li] = torch.where(upd, ct, t_best[li])
                tri[li] = torch.where(upd, (first + k).to(torch.int32),
                                      tri[li])

        # Internal rows: box-test 8 children, descend nearest, push rest.
        inner = ~leaf
        if bool(inner.any()):
            ni, nrow = live[inner], row[inner]
            box = trav_rows[nrow].reshape(-1, 8, 16)
            ptr = rows_i[nrow].reshape(-1, 8, 16)[:, :, 6]
            o = (ox[ni, None], oy[ni, None], oz[ni, None])
            inv = (ix[ni, None], iy[ni, None], iz[ni, None])
            t1 = [(box[:, :, a] - o[a]) * inv[a] for a in range(3)]
            t2 = [(box[:, :, a + 3] - o[a]) * inv[a] for a in range(3)]
            tn = torch.maximum(torch.maximum(torch.minimum(t1[0], t2[0]),
                                             torch.minimum(t1[1], t2[1])),
                               torch.minimum(t1[2], t2[2]))
            tf = torch.minimum(torch.minimum(torch.maximum(t1[0], t2[0]),
                                             torch.maximum(t1[1], t2[1])),
                               torch.maximum(t1[2], t2[2]))
            bound = (tmax if any_hit else t_best)[ni, None]
            hit = ((ptr != -1) & (tf >= torch.clamp_min(tn, 0.0))
                   & (tn < bound))
            # Reorder children by priority p: child (p ^ octant).
            by_p = slots[None, :] ^ octant[ni, None]
            hit_p = hit.gather(1, by_p)
            ptr_p = ptr.gather(1, by_p)
            nh = hit_p.sum(dim=1)
            rank = torch.cumsum(hit_p.to(torch.int64), dim=1) - 1
            pos = sp[ni, None] + (nh[:, None] - 1 - rank)
            push = hit_p & (rank >= 1)
            stack[ni[:, None], torch.where(push, pos, wide_stack)] = ptr_p
            nearest = torch.where(hit_p & (rank == 0), ptr_p, -1).amax(dim=1)
            sp[ni] += torch.clamp_min(nh - 1, 0)
            nxt[inner] = nearest.to(torch.int32)

        # Next row: the nearest hit child, else the stack top, else done.
        descend = nxt >= 0
        can_pop = ~descend & (sp[live] > 0)
        if any_hit:
            finished = blocked[live]
            descend &= ~finished
            can_pop &= ~finished
        pi = live[can_pop]
        sp[pi] -= 1
        cur[pi] = stack[pi, sp[pi]]
        cur[live[descend]] = nxt[descend]
        live = live[descend | can_pop]
    else:
        if live.numel():
            _capped.tensor(dev).add_(live.numel())
    if stats is not None:
        stats["box_tests"] = box_tests
        stats["tri_tests"] = tri_tests
    if any_hit:
        return t_best, blocked.to(torch.int32)
    return t_best, tri


_depths: dict = {}  # id(trav_rows) -> (its version, its depth)


def table_depth(trav_rows: torch.Tensor) -> int:
    """Internal rows on the longest root-to-leaf path of a (rows, 128)
    wide table, from its child pointers (lanes 6::16; only internal rows
    are read): the most entries the kernel's per-level stack holds.
    Computed on the host once per table, and again after the table is
    written in place. Raises on a pointer out of the table or a cycle."""
    key = id(trav_rows)
    known = _depths.get(key)
    if known is not None and known[0] == trav_rows._version:
        return known[1]
    ptr = trav_rows.view(torch.int32)[:, 6::16].cpu().numpy()
    n = ptr.shape[0]
    level = np.zeros(1, np.int64)
    depth = 0
    while level.size:
        depth += 1
        if depth > n:
            raise ValueError("trav_rows: the child pointers form a cycle")
        ch = ptr[level].reshape(-1).astype(np.int64)
        ch = ch[(ch != -1) & ((ch & LEAF_TAG) == 0)]
        if ch.size and (ch.min() < 0 or ch.max() >= n):
            raise ValueError("trav_rows: a child pointer leaves the table")
        level = np.unique(ch)
    if known is None:
        weakref.finalize(trav_rows, _depths.pop, key, None)
    _depths[key] = (trav_rows._version, depth)
    return depth


def kernel_depth(trav_rows: torch.Tensor) -> int:
    """The depth K1 runs with; raises for a table it cannot hold: 2^24
    rows or more, or a depth beyond ``DEPTH_MAX``."""
    if trav_rows.dim() != 2 or trav_rows.shape[1] != 128:
        raise ValueError("trav_rows: need shape (rows, 128)")
    if trav_rows.shape[0] >= ROWS_MAX:
        raise ValueError(f"trav_rows has {trav_rows.shape[0]} rows; the "
                         f"kernel's stack entries hold row indices below "
                         f"{ROWS_MAX}")
    depth = table_depth(trav_rows)
    if depth > DEPTH_MAX:
        raise ValueError(f"scene needs a traversal stack of {depth} levels; "
                         f"the kernel holds {DEPTH_MAX}")
    return depth


def _launch(trav_rows, ro, rd, tmax, active, any_hit, wide_end, wide_stack):
    """K1 on CUDA tensors. ``wide_stack`` sizes the twin's per-child
    stack; the kernel's per-level stack is sized by ``kernel_depth``."""
    dev = ro.device
    R = ro.shape[0]
    depth = kernel_depth(trav_rows)
    check_args(dev, (("trav_rows", trav_rows, torch.float32, None),
                     ("ro", ro, torch.float32, (R, 3)),
                     ("rd", rd, torch.float32, (R, 3)),
                     ("tmax", tmax, torch.float32, (R,)),
                     ("active", active, torch.bool, (R,))))
    t = torch.empty(R, dtype=torch.float32, device=dev)
    tri = torch.empty(R, dtype=torch.int32, device=dev)
    _build.launch("wide_traverse", "wide_traverse", "8p4is", trav_rows, ro,
                  rd, tmax, active, t, tri, _capped.tensor(dev), R,
                  max_steps(wide_end), depth, int(any_hit),
                  mode="anyhit" if any_hit else "closest")
    return t, tri


def wide_trace(trav_rows, ro, rd, tmax, active, any_hit: bool,
               wide_end: int, wide_stack: int):
    """K1 on CUDA tensors, the plain version on CPU tensors."""
    fn = _launch if on_card(ro) else wide_trace_plain
    return fn(trav_rows, ro, rd, tmax, active, any_hit, wide_end, wide_stack)


def intersect_wide(scene, ro, rd, tmax=None, active=None,
                   any_hit: bool = False) -> Hit:
    """Hit record from the wide traversal (``pallas_wide.intersect_wide``).

    A miss returns ``(tmax or T_FAR, -1)``; inactive rays return tri -1;
    u, v of the winning triangle come from ``recompute_uv``.
    """
    ro, rd, t0, act = ray_args(ro, rd, tmax, active)
    t, tri = wide_trace(scene.trav_rows, ro, rd, t0, act, any_hit,
                        scene.wide_end, scene.wide_stack)
    if any_hit:
        tri = torch.where(tri > 0, tri, -1)
        u = v = torch.zeros_like(t)
    else:
        u, v = recompute_uv(scene, ro, rd, tri)
    if active is not None:
        tri = torch.where(active, tri, -1)
    return Hit(t, tri, u, v)


def occluded_wide(scene, ro, rd, tmax, active=None) -> torch.Tensor:
    """(R,) bool: segment [T_MIN, tmax) blocked (any-hit mode)."""
    out = intersect_wide(scene, ro, rd, tmax=tmax, active=active,
                         any_hit=True).tri > 0
    if active is not None:
        out = out & active
    return out
