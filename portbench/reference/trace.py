"""Ray queries of the reference: a frozen copy of the plain twin of the
port's wide traversal (``loupiote_tpu_torch/ops/wide.py::wide_trace_plain``)
with ``ops/intersect.py``'s Moller-Trumbore, ``recompute_uv`` and shadow
query, over the reference's own wide table (``tables.py``).

Every closest-hit and any-hit wave of a flattened scene takes this path,
whatever dispatch the program makes: the nearest hit and the blocked bit
do not depend on the tree, so the answers are the kernel's up to ties
between triangles at one ``t``. A two-level scene's waves take the
instance loop of ``instanced.py``, which walks each BLAS with the twin of
the kernel the port picks for it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .wide_table import LEAF_MASK, LEAF_TAG

T_MIN = 1e-4
T_FAR = 1e30


class Hit(NamedTuple):
    """Per-ray intersection record."""

    t: torch.Tensor  # (R,) float32, tmax or T_FAR on a miss
    tri: torch.Tensor  # (R,) int32, -1 on a miss
    u: torch.Tensor  # (R,) float32 barycentric
    v: torch.Tensor  # (R,) float32 barycentric
    # (R,) int32 instance of the hit, -1 on a miss: instanced scenes only.
    inst: Optional[torch.Tensor] = None


def moller_trumbore(o, d, tri9):
    """Moller-Trumbore on broadcastable component tensors.

    ``o``, ``d``: (x, y, z) of the ray; ``tri9``: (p0x, p0y, p0z, e1x, ...,
    e2z). Every product is taken in the reference's order. Returns
    (u, v, t); t is 0 for a degenerate triangle (|det| <= 1e-12).
    """
    ox, oy, oz = o
    dx, dy, dz = d
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tri9
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    return u, v, t


def recompute_uv(scene, ro, rd, tri):
    """Barycentrics of the winning triangle, recomputed once per ray (the
    traversal tracks only t and the triangle); 0 on a miss."""
    trow = scene.tri_pack[torch.clamp_min(tri, 0).to(torch.int64)]
    u, v, _ = moller_trumbore((ro[:, 0], ro[:, 1], ro[:, 2]),
                              (rd[:, 0], rd[:, 1], rd[:, 2]),
                              tuple(trow[:, j] for j in range(9)))
    miss = tri < 0
    return torch.where(miss, 0.0, u), torch.where(miss, 0.0, v)


def max_steps(wide_end: int) -> int:
    """The step bound (row visits per ray)."""
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
    if stats is not None:
        stats["box_tests"] = box_tests
        stats["tri_tests"] = tri_tests
    if any_hit:
        return t_best, blocked.to(torch.int32)
    return t_best, tri


def ray_args(ro, rd, tmax, active):
    R = ro.shape[0]
    dev = ro.device
    t0 = (torch.full((R,), T_FAR, dtype=torch.float32, device=dev)
          if tmax is None else tmax.contiguous())
    act = (torch.ones(R, dtype=torch.bool, device=dev) if active is None
           else active.contiguous())
    return ro.contiguous(), rd.contiguous(), t0, act


def intersect_any(scene, ro, rd, tmax=None, active=None,
                  any_hit: bool = False) -> Hit:
    """Hit record of a wave: a two-level scene's (``Tables.blas`` set)
    from the instance loop of ``instanced.py``, any other's from the
    wide traversal."""
    if scene.blas is not None:
        from .instanced import intersect_instanced

        return intersect_instanced(scene, ro, rd, tmax=tmax, active=active,
                                   any_hit=any_hit)
    return intersect_wide(scene, ro, rd, tmax=tmax, active=active,
                          any_hit=any_hit)


def intersect_wide(scene, ro, rd, tmax=None, active=None,
                   any_hit: bool = False) -> Hit:
    """Hit record of the wide traversal: a miss returns ``(tmax or T_FAR,
    -1)``; inactive rays return tri -1; u, v from ``recompute_uv``."""
    ro, rd, t0, act = ray_args(ro, rd, tmax, active)
    t, tri = wide_trace_plain(scene.trav_rows, ro, rd, t0, act, any_hit,
                              scene.wide_end, scene.wide_stack)
    if any_hit:
        tri = torch.where(tri > 0, tri, -1)
        u = v = torch.zeros_like(t)
    else:
        u, v = recompute_uv(scene, ro, rd, tri)
    if active is not None:
        tri = torch.where(active, tri, -1)
    return Hit(t, tri, u, v)


def occluded(scene, ro, rd, dist, active=None) -> torch.Tensor:
    """Shadow query: True where the segment [T_MIN, dist) is blocked."""
    if scene.blas is not None:
        from .instanced import occluded_instanced

        return occluded_instanced(scene, ro, rd, dist, active=active)
    tmax = dist * (1.0 - 1e-3)
    out = intersect_wide(scene, ro, rd, tmax=tmax, active=active,
                         any_hit=True).tri > 0
    if active is not None:
        out = out & active
    return out
