"""The BVH2 traversal of the reference: a frozen copy of the plain twin of
the port's kernel K2 (``loupiote_tpu_torch/ops/bvh2.py::bvh2_trace_plain``,
closest-hit and any-hit) and of the BVH2 row tables it walks
(``scene/buffers.py``: ``node_rows``, ``leaf_rows``, the stack depth).

The port sends a two-level scene's BLAS of under ``WIDE_MIN_NODES`` BVH2
nodes to K2 in both modes; its visit order (the near child by the ray's
direction along the split axis, a per-ray stack) decides which of two
triangles at one ``t`` wins, so the reference walks the same tree in the
same order.
"""

from __future__ import annotations

import numpy as np
import torch

from .bvh import LEAF_MAX, FlatBVH
from .scene_types import pad_rows
from .tables import _ceil_to
from .trace import T_MIN, _safe_inv, max_steps, moller_trumbore

# The port's dispatch (ops/intersect.py::_WIDE_MIN_NODES): a table of
# fewer BVH2 nodes goes to K2, a larger one to K1.
WIDE_MIN_NODES = 8192
LEAF_CAP = 14


def bvh_max_depth(count: np.ndarray, miss: np.ndarray) -> int:
    """Max tree depth (root = 0) of a threaded pre-order BVH: internal
    node ``j``'s descendants are the index interval ``(j, miss[j])``."""
    n = count.shape[0]
    internal = np.nonzero(count == 0)[0]
    delta = np.zeros(n + 1, np.int64)
    np.add.at(delta, internal + 1, 1)
    np.add.at(delta, miss[internal].astype(np.int64), -1)
    depth = np.cumsum(delta)[:n]
    return int(depth.max()) if n else 0


def bvh2_rows(bvh: FlatBVH, tri9: np.ndarray):
    """``(node_rows (Np, 16), leaf_rows (L, 128), stack_depth)`` as the
    port lays them out: node rows [min(3), max(3), count, miss, right |
    leaf row, axis | first triangle, 0 x 6] with the ints bitcast, padded
    with empty boxes; one leaf row of up to 14 triangles [p0, e1, e2] a
    leaf, empty slots at p0 = 1e30."""
    def i32col(v):
        return v.astype(np.int32).view(np.float32)[:, None]

    N = bvh.num_nodes
    is_leaf = bvh.count > 0
    leaf_ids = np.nonzero(is_leaf)[0]
    leaf_rows = np.zeros((max(len(leaf_ids), 1), 128), np.float32)
    for li, nd in enumerate(leaf_ids):
        f, c = int(bvh.first[nd]), min(int(bvh.count[nd]), LEAF_MAX)
        leaf_rows[li, :9 * c] = tri9[f:f + c].reshape(-1)
        for k in range(c, LEAF_MAX):
            leaf_rows[li, 9 * k:9 * k + 3] = 1e30
    slot8 = np.where(is_leaf, np.cumsum(is_leaf) - 1, bvh.right)
    slot9 = np.where(is_leaf, bvh.first, bvh.axis)
    node_rows = np.concatenate([
        bvh.node_min, bvh.node_max, i32col(bvh.count), i32col(bvh.miss),
        i32col(slot8), i32col(slot9), np.zeros((N, 6), np.float32),
    ], axis=1).astype(np.float32)
    node_rows = pad_rows(node_rows, _ceil_to(N), 0.0)
    node_rows[N:, 0:3] = 1e30
    node_rows[N:, 3:6] = -1e30
    stack_depth = 64
    while stack_depth < bvh_max_depth(bvh.count, bvh.miss) + 2:
        stack_depth *= 2
    return node_rows, leaf_rows, stack_depth


def _slab(rows, o, inv, bound):
    t1 = [(rows[:, a] - o[a]) * inv[a] for a in range(3)]
    t2 = [(rows[:, a + 3] - o[a]) * inv[a] for a in range(3)]
    tn = torch.maximum(torch.maximum(torch.minimum(t1[0], t2[0]),
                                     torch.minimum(t1[1], t2[1])),
                       torch.minimum(t1[2], t2[2]))
    tf = torch.minimum(torch.minimum(torch.maximum(t1[0], t2[0]),
                                     torch.maximum(t1[1], t2[1])),
                       torch.maximum(t1[2], t2[2]))
    return (tf >= torch.clamp_min(tn, 0.0)) & (tn < bound)


def _leaf(leaf_rows, lrow, count, o, d, bound):
    tr = leaf_rows[lrow, :9 * LEAF_CAP].reshape(-1, LEAF_CAP, 9)
    u, v, t = moller_trumbore(tuple(x[:, None] for x in o),
                              tuple(x[:, None] for x in d),
                              tuple(tr[:, :, j] for j in range(9)))
    k = torch.arange(LEAF_CAP, device=lrow.device)
    ok = ((k[None, :] < count[:, None]) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > T_MIN) & (t < bound[:, None]))
    return ok, u, v, t


def bvh2_trace_plain(node_rows, leaf_rows, ro, rd, tmax, active,
                     any_hit: bool, num_nodes: int, stack_depth: int):
    """Plain torch K2, vectorised over rays: each live ray visits one node
    a step; a hit leaf keeps the first of its nearest triangles (strict
    ``<``), a hit internal node pushes the far child and descends to the
    near one (the left child where the ray's direction along the split
    axis is >= 0), anything else pops. Any-hit rays stop at their first
    confirmed hit. Returns ``(t, u, v, tri)``: ``tmax`` and -1 on a
    miss."""
    dev = ro.device
    R = ro.shape[0]
    rows_i = node_rows.view(torch.int32)
    t_best = tmax.clone()
    u_best = torch.zeros(R, dtype=torch.float32, device=dev)
    v_best = torch.zeros(R, dtype=torch.float32, device=dev)
    tri = torch.full((R,), -1, dtype=torch.int32, device=dev)
    o = (ro[:, 0], ro[:, 1], ro[:, 2])
    d = (rd[:, 0], rd[:, 1], rd[:, 2])
    inv = tuple(_safe_inv(x) for x in d)
    stack = torch.zeros((R, stack_depth), dtype=torch.int32, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    node = torch.zeros(R, dtype=torch.int64, device=dev)
    live = torch.nonzero(active).flatten()
    for _ in range(max_steps(num_nodes)):
        if live.numel() == 0:
            break
        n = node[live]
        rows = node_rows[n]
        ints = rows_i[n]
        count, slot8, slot9 = ints[:, 6], ints[:, 8], ints[:, 9]
        ol = tuple(x[live] for x in o)
        dl = tuple(x[live] for x in d)
        hit = _slab(rows, ol, tuple(x[live] for x in inv), t_best[live])
        leaf = hit & (count > 0)
        inner = hit & (count == 0)
        done = torch.zeros_like(hit)

        if bool(leaf.any()):
            li = live[leaf]
            ok, u, v, t = _leaf(leaf_rows, slot8[leaf].to(torch.int64),
                                count[leaf], tuple(x[leaf] for x in ol),
                                tuple(x[leaf] for x in dl), t_best[li])
            cand = torch.where(ok, t, float("inf"))
            k = torch.argmin(cand, dim=1, keepdim=True)  # first minimum
            upd = ok.any(dim=1)
            t_best[li] = torch.where(upd, cand.gather(1, k)[:, 0], t_best[li])
            u_best[li] = torch.where(upd, u.gather(1, k)[:, 0], u_best[li])
            v_best[li] = torch.where(upd, v.gather(1, k)[:, 0], v_best[li])
            tri[li] = torch.where(upd, (slot9[leaf] + k[:, 0]).to(torch.int32),
                                  tri[li])
            if any_hit:
                done[leaf] = upd

        if bool(inner.any()):
            ni = live[inner]
            axis = slot9[inner]
            dax = torch.where(axis == 0, dl[0][inner],
                              torch.where(axis == 1, dl[1][inner],
                                          dl[2][inner]))
            left = n[inner] + 1
            right = slot8[inner].to(torch.int64)
            pos = dax >= 0.0
            stack[ni, sp[ni]] = torch.where(pos, right, left).to(torch.int32)
            sp[ni] += 1
            node[ni] = torch.where(pos, left, right)

        pop = ~inner & ~done
        pi = live[pop]
        has = sp[pi] > 0
        pi = pi[has]
        sp[pi] -= 1
        node[pi] = stack[pi, sp[pi]].to(torch.int64)
        keep = inner.clone()
        keep[pop] = has
        live = live[keep]
    return t_best, u_best, v_best, tri
