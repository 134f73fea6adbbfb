"""BVH2 -> 8-wide table collapse: a frozen copy of the port's
``loupiote_tpu_torch/accel/wide.py``.

8 children per internal row, one row per leaf, the SAH DP collapse.

Unified row table layout (``trav_rows``: (W + L, 128) float32):
  - rows [0, W): internal nodes. Child c in lanes [16c, 16c+16):
      [min.x, min.y, min.z, max.x, max.y, max.z, ptr, pad...]
    ``ptr`` (bitcast int32) is the child's row index; a leaf child carries
    the ``LEAF_TAG`` bit; -1 marks an empty slot. Lane 127 = kind tag 0.
  - rows [W, W+L): leaf rows: 14 triangles x [p0, e1, e2] in lanes
    [0, 126), lane 126 = (global_first << 4 | count) bitcast int32,
    lane 127 = kind tag 1.
Row 0 is always internal: a one-leaf scene gets a synthetic root.
Children sit at octant-coded slots, so a traversal that visits slot
``c ^ octant(ray direction)`` in ascending order goes roughly near-to-far.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bvh import FlatBVH

WIDTH = 8
LEAF_ROW_CAP = 14  # triangles per leaf row (9 floats each, 126 lanes)
LEAF_TAG = 1 << 30  # child-pointer tag: target row is a leaf
LEAF_MASK = LEAF_TAG - 1

# DP collapse cost constants: expected row visits per random ray ~ sum of
# child-box areas; an internal and a leaf visit cost about the same.
C_NODE = 1.0
C_LEAF = 0.9


@dataclass
class WideBVH:
    trav_rows: np.ndarray  # (rows, 128) float32 unified row table
    stack_need: int  # max stack entries any traversal order can require
    end_index: int  # first row PAST the table
    leaf_row_max: int = LEAF_ROW_CAP  # max triangles in any ONE leaf row


def _dp_clusters(bvh: FlatBVH):
    """SAH-optimal collapse: a DP over the BVH2 chooses, per node, whether
    its subtree becomes a merged leaf row (<= 14 triangles), a wide row, or
    is inlined into an ancestor row's child slots, minimizing
    sum over rows of area(row root) * C_row.

    Returns (wide_children, wide_of, leaf_nodes, leaf_row_of, tris,
    firstmin); leaf_nodes entries are subtree ROOTS.
    """
    width = WIDTH
    N = bvh.num_nodes
    count = bvh.count
    right = bvh.right
    is_leaf = count > 0
    INF = np.float64(1e30)

    tris = np.zeros(N, np.int64)
    firstmin = np.zeros(N, np.int64)
    area = np.empty(N, np.float64)
    d = np.maximum(bvh.node_max - bvh.node_min, 0.0)
    area[:] = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    for n in range(N - 1, -1, -1):
        if is_leaf[n]:
            tris[n] = count[n]
            firstmin[n] = bvh.first[n]
        else:
            r = int(right[n])
            tris[n] = tris[n + 1] + tris[r]
            firstmin[n] = min(firstmin[n + 1], firstmin[r])

    # C[n, i]: min cost of giving subtree n <= i child slots of an ancestor
    # row; split2[n, s]: best split of s slots between n's two children;
    # kind1[n]: 0 = leaf row, 1 = wide row, for the 1-slot choice.
    C = np.full((N, width + 1), INF)
    split2 = np.zeros((N, width + 1), np.int8)
    kind1 = np.zeros(N, np.int8)
    dist_stop = np.zeros((N, width + 1), bool)

    for n in range(N - 1, -1, -1):
        if is_leaf[n]:
            C[n, 1:] = area[n] * C_LEAF
            kind1[n] = 0
            dist_stop[n, :] = True
            continue
        l, r = n + 1, int(right[n])
        c2 = np.full(width + 1, INF)
        for s in range(2, width + 1):
            best, ba = INF, 1
            for a in range(1, s):
                v = C[l, a] + C[r, s - a]
                if v < best:
                    best, ba = v, a
            c2[s] = best
            split2[n, s] = ba
        row_cost = area[n] * C_NODE + c2[width]
        leaf_cost = (area[n] * C_LEAF if tris[n] <= LEAF_ROW_CAP else INF)
        if leaf_cost <= row_cost:
            C[n, 1] = leaf_cost
            kind1[n] = 0
        else:
            C[n, 1] = row_cost
            kind1[n] = 1
        dist_stop[n, 1] = True
        for s in range(2, width + 1):
            if C[n, 1] <= c2[s]:
                C[n, s] = C[n, 1]
                dist_stop[n, s] = True
            else:
                C[n, s] = c2[s]

    wide_children: list[list[int]] = []
    wide_of: dict[int, int] = {}
    leaf_nodes: list[int] = []
    leaf_row_of: dict[int, int] = {}

    def frontier(n: int, s: int, out: list[int]):
        st = [(n, s)]
        while st:
            m, i = st.pop()
            if dist_stop[m, i]:
                out.append(m)
            else:
                a = int(split2[m, i])
                # Left pushed last -> popped first: pre-order member order.
                st.append((int(right[m]), i - a))
                st.append((m + 1, a))
        return out

    def add_member(m: int):
        if kind1[m] == 0:
            if m not in leaf_row_of:
                leaf_row_of[m] = len(leaf_nodes)
                leaf_nodes.append(m)
        else:
            emit_row(m)

    def emit_row(n: int):
        wide_of[n] = len(wide_children)
        mem = frontier(n, width, [])
        wide_children.append(mem)
        for m in mem:
            add_member(m)

    if is_leaf[0] or tris[0] <= LEAF_ROW_CAP:
        # Tiny scene: one leaf row under a synthetic root wide node.
        wide_children.append([0])
        leaf_row_of[0] = 0
        leaf_nodes.append(0)
        kind1[0] = 0
    else:
        emit_row(0)
    return wide_children, wide_of, leaf_nodes, leaf_row_of, tris, firstmin


def _octant_slots(bvh: FlatBVH, mem: list[int]):
    """Assign each cluster member to a direction-coded slot.

    Slot s is a 3-bit octant code: bit a = 1 iff the member's box center is
    on the positive side of the members' mean center along axis a;
    collisions resolve greedily (largest offset first, best-aligned free
    slot). Returns a list of length 8: member id or None per slot.
    """
    centers = (bvh.node_min[mem] + bvh.node_max[mem]) * 0.5  # (k, 3)
    off = centers - centers.mean(axis=0, keepdims=True)
    o_ids = np.arange(8)
    d = np.stack([(o_ids >> a) & 1 for a in range(3)], axis=1) * 2.0 - 1.0
    align = off @ d.T  # (k, 8): alignment of member with each octant
    order = np.argsort(-np.linalg.norm(off, axis=1), kind="stable")
    slot_of: list = [None] * WIDTH
    free = np.ones(WIDTH, bool)
    for i in order:
        s = int(np.argmax(np.where(free, align[i], -np.inf)))
        slot_of[s] = mem[i]
        free[s] = False
    return slot_of


def collapse_wide(bvh: FlatBVH, tri9: np.ndarray) -> WideBVH:
    """Collapse a threaded BVH2 into the unified wide row table.

    ``tri9``: (T, 9) float32 [p0, e1, e2] per triangle in BVH leaf order.
    """
    (wide_children, wide_of, leaf_nodes, leaf_row_of, tris,
     firstmin) = _dp_clusters(bvh)
    W = len(wide_children)
    L = len(leaf_nodes)
    rows = np.zeros((W + L, 128), np.float32)

    def _i32(x):
        return np.float32(np.int32(x).view(np.float32))

    for w, mem in enumerate(wide_children):
        slot_of = _octant_slots(bvh, mem)
        for c in range(WIDTH):
            b = 16 * c
            m = slot_of[c]
            if m is not None:
                rows[w, b:b + 3] = bvh.node_min[m]
                rows[w, b + 3:b + 6] = bvh.node_max[m]
                ptr = ((W + leaf_row_of[m]) | LEAF_TAG
                       if m in leaf_row_of else wide_of[m])
                rows[w, b + 6] = _i32(ptr)
            else:
                rows[w, b:b + 3] = 1e30
                rows[w, b + 3:b + 6] = -1e30
                rows[w, b + 6] = _i32(-1)
        rows[w, 127] = _i32(0)

    # Leaf rows: a merged subtree covers one contiguous triangle range.
    for li, n2 in enumerate(leaf_nodes):
        f, c = int(firstmin[n2]), int(tris[n2])
        assert c <= LEAF_ROW_CAP
        r = W + li
        block = tri9[f:f + c].reshape(-1)
        rows[r, :block.size] = block
        for k in range(c, LEAF_ROW_CAP):
            rows[r, 9 * k:9 * k + 3] = 1e30  # degenerate: never hits
        rows[r, 126] = _i32((f << 4) | c)
        rows[r, 127] = _i32(1)

    # Worst-case stack need: pushing (k-1) children then descending.
    # Wide nodes are in pre-order, so children have larger ids.
    need = np.zeros(max(W, 1), np.int64)
    for w in range(W - 1, -1, -1):
        mem = wide_children[w]
        child_need = max((int(need[wide_of[m]]) for m in mem if m in wide_of),
                         default=0)
        need[w] = (len(mem) - 1) + max(child_need, 1)
    stack_need = int(need[0]) + 2 if W else 2

    leaf_row_max = max((min(int(tris[n2]), LEAF_ROW_CAP)
                        for n2 in leaf_nodes), default=1)
    return WideBVH(trav_rows=rows, stack_need=stack_need, end_index=W + L,
                   leaf_row_max=leaf_row_max)
