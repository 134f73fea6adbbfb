"""Treelet partition of the BVH2 for the two-phase per-lane traversal
(counterpart of ``experiments/treelet/build.py`` and of the device bundle
of ``experiments/treelet/pipeline.py``).

Phase 1 (``treelet/lane_top.py``, kernel E6): every ray walks the threaded
TOP region of the BVH2 and collects the ids of the subtrees whose root
boxes it enters. Phase 2 (``treelet/lane_bottom.py``, kernel E7): the
(ray, subtree) pairs are grouped by subtree and every pair walks its
subtree (node boxes and triangles) on its own.

The partition cuts the BVH2 into bottom subtrees of at most ``ENTRY_CAP``
entries (one per node, one per triangle), each one 1024-entry tile per
field. Subtree entry layout (float32 tables, ints bitcast):

  f0..f5  node: box min/max     tri: p0.xyz, e1.xyz
  f6..f8  node: unused          tri: e2.xyz
  f9      link: hit_id | miss_id << 10 | is_tri << 20 | local_tri << 21
          (10-bit entry ids, END = 1023; a triangle entry stores its next
          id in both link slots; local_tri is the subtree-local triangle
          ordinal, global id = sub_tri_base[s] + local_tri)
  f10     tri: global triangle id; node: -1 (host side only)

A ``link`` word with local_tri >= 1020 sets every exponent bit of the
float, so it is a NaN or Inf pattern: it is only ever read back with
``.view(torch.int32)`` (``__float_as_int`` in the kernels), never passed
through float arithmetic.

The top table (8 fields x ``TILE``-padded entries): box min/max, then
``link`` = hit_id | miss_id << 12 (``ID_MASK`` = out-of-top hit / END
miss) and ``pend`` = the subtree id a frontier entry enqueues (-1 for
in-top entries). Numpy only; copied from the reference because every
module of the reference package imports jax.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..accel.bvh import FlatBVH

ENTRY_CAP = 1023  # entries per subtree (id 1023 = END sentinel)
SUB_END = 1023
TOP_ID_BITS = 12  # phase-1 table ids
F_LINK = 9
F_AUX = 10
NUM_FIELDS = 11

# experiments/treelet/lane_top.py: tables are (8, 128) tiles of 1024
# entries; top ids take 12 bits; each ray keeps up to 8 pending subtrees.
SUB, SUBP = 8, 128
TILE = SUB * SUBP
ID_MASK = (1 << TOP_ID_BITS) - 1  # also the out-of-top / END sentinel
PEND_CAP = 8


@dataclass
class TreeletTables:
    # Phase-1 top table: (8, T, 8, 128) f32; pend entries hold subtree ids.
    top_fields: np.ndarray
    num_top: int
    top_tiles: int
    # Phase-2 subtree tables: (NUM_FIELDS, S, 8, 128) f32.
    sub_fields: np.ndarray
    num_subtrees: int
    sub_entries: np.ndarray  # (S,) int32 entries used by each subtree
    # Global triangle id of each subtree's local ordinal 0.
    sub_tri_base: np.ndarray = None  # (S,) int32


def _subtree_sizes(bvh: FlatBVH):
    """entries(n) = nodes + triangles in the subtree rooted at n."""
    N = bvh.num_nodes
    is_leaf = bvh.count > 0
    sizes = np.zeros(N, np.int64)
    for n in range(N - 1, -1, -1):
        if is_leaf[n]:
            sizes[n] = 1 + int(bvh.count[n])
        else:
            sizes[n] = 1 + sizes[n + 1] + sizes[int(bvh.right[n])]
    return sizes


def build_treelet_tables(bvh: FlatBVH, cap: int = ENTRY_CAP) -> TreeletTables:
    N = bvh.num_nodes
    is_leaf = bvh.count > 0
    sizes = _subtree_sizes(bvh)

    # Cut: the highest nodes whose whole subtree fits one tile. A tiny
    # scene's root is itself the one subtree, and the top table is then a
    # single frontier entry pointing at it.
    cut_roots: list[int] = []
    in_top = np.zeros(N, bool)
    stack = [0]
    while stack:
        n = stack.pop()
        if sizes[n] <= cap:
            cut_roots.append(n)
            continue
        in_top[n] = True
        stack.append(int(bvh.right[n]))
        stack.append(n + 1)

    subtree_of = {r: i for i, r in enumerate(cut_roots)}
    S = len(cut_roots)

    # Phase-1 top table (frontier = cut roots).
    top_ids = [int(i) for i in np.nonzero(in_top)[0]]
    order = top_ids + cut_roots
    K = len(order)
    assert K < ID_MASK, f"top region too large: {K}"
    remap = {n: i for i, n in enumerate(order)}

    def rid(t: int) -> int:
        return remap.get(t, ID_MASK) if t < N else ID_MASK

    minx = np.empty(K, np.float32)
    miny = np.empty(K, np.float32)
    minz = np.empty(K, np.float32)
    maxx = np.empty(K, np.float32)
    maxy = np.empty(K, np.float32)
    maxz = np.empty(K, np.float32)
    link = np.zeros(K, np.int32)
    pend = np.full(K, -1, np.int32)
    for i, n2 in enumerate(order):
        minx[i], miny[i], minz[i] = bvh.node_min[n2]
        maxx[i], maxy[i], maxz[i] = bvh.node_max[n2]
        miss_id = rid(int(bvh.miss[n2]))
        if in_top[n2]:
            hit_id = rid(n2 + 1)
            assert hit_id != ID_MASK
        else:  # frontier: enqueue the subtree, continue at the miss link
            hit_id = ID_MASK
            pend[i] = subtree_of[n2]
        link[i] = np.int32(hit_id | (miss_id << TOP_ID_BITS))

    T = max(1, -(-K // TILE))
    top = np.zeros((8, T * TILE), np.float32)
    for fi, arr in enumerate((minx, miny, minz, maxx, maxy, maxz)):
        top[fi, :K] = arr
        top[fi, K:] = 1e30 if fi < 3 else -1e30
    top[6, :K] = link.view(np.float32)
    top[6, K:] = np.int32(ID_MASK | (ID_MASK << TOP_ID_BITS)).view(np.float32)
    top[7, :K] = pend.view(np.float32)
    top[7, K:] = np.float32(np.int32(-1).view(np.float32))

    # Phase-2 subtree tables. Defaults: empty boxes never hit, links ->
    # END, aux -1.
    fields = np.zeros((NUM_FIELDS, S, TILE), np.float32)
    fields[0:3, :, :] = 1e30
    fields[3:6, :, :] = -1e30
    fields[F_LINK, :, :] = np.float32(np.int32(
        SUB_END | (SUB_END << 10)).view(np.float32))
    fields[F_AUX, :, :] = np.float32(np.int32(-1).view(np.float32))
    entries_used = np.zeros(S, np.int32)
    tri_bases = np.zeros(S, np.int32)

    for si, root in enumerate(cut_roots):
        # First pass: entry ids in DFS order (a leaf's triangles follow
        # it); second pass: fields with hit/miss ids.
        ids: dict[int, int] = {}
        tri_base: dict[int, int] = {}
        cnt = 0
        st = [root]
        dfs: list[int] = []
        while st:
            n = st.pop()
            dfs.append(n)
            ids[n] = cnt
            cnt += 1
            if is_leaf[n]:
                tri_base[n] = cnt
                cnt += int(bvh.count[n])
            else:
                st.append(int(bvh.right[n]))
                st.append(n + 1)
        # cnt <= cap < SUB_END: entry ids never collide with END.
        assert cnt <= cap, f"subtree {si} has {cnt} entries"
        entries_used[si] = cnt

        # A miss link either stays inside the subtree or leaves it for
        # good (threaded DFS), so a target outside it is END.
        def eid(t: int) -> int:
            return ids.get(t, SUB_END) if t < N else SUB_END

        # A DFS subtree's triangles are one contiguous global range (the
        # BVH orders triangles leaf by leaf in DFS order), so one base per
        # subtree recovers the global id from the local ordinal.
        base = min((int(bvh.first[n]) for n in dfs if is_leaf[n]),
                   default=0)
        tri_bases[si] = base
        local_ord = 0

        f = fields[:, si, :]
        for n in dfs:
            e = ids[n]
            miss_e = eid(int(bvh.miss[n]))
            hit_e = tri_base[n] if is_leaf[n] else ids[n + 1]
            f[0:3, e] = bvh.node_min[n]
            f[3:6, e] = bvh.node_max[n]
            f[F_LINK, e] = np.int32(hit_e | (miss_e << 10)).view(np.float32)
            f[F_AUX, e] = np.int32(-1).view(np.float32)
            if is_leaf[n]:
                first, count = int(bvh.first[n]), int(bvh.count[n])
                assert first - base == local_ord, "non-contiguous subtree"
                for k in range(count):
                    te = tri_base[n] + k
                    nxt = te + 1 if k + 1 < count else miss_e
                    f[F_LINK, te] = np.int32(
                        nxt | (nxt << 10) | (1 << 20)
                        | (local_ord << 21)).view(np.float32)
                    f[F_AUX, te] = np.int32(first + k).view(np.float32)
                    local_ord += 1

    return TreeletTables(
        top_fields=top.reshape(8, T, SUB, SUBP),
        num_top=K,
        top_tiles=T,
        sub_fields=fields.reshape(NUM_FIELDS, S, SUB, SUBP),
        num_subtrees=S,
        sub_entries=entries_used,
        sub_tri_base=tri_bases,
    )


def fill_triangles(tables: TreeletTables, tri9: np.ndarray) -> None:
    """Fill the triangle entries' geometry (p0, e1, e2) from the BVH-ordered
    (T, 9) triangle array, in place."""
    S = tables.num_subtrees
    f = tables.sub_fields.reshape(NUM_FIELDS, S, -1)
    link = f[F_LINK].view(np.int32)
    aux = f[F_AUX].view(np.int32)
    si, ei = np.nonzero((link >> 20) & 1)
    gt = aux[si, ei]
    for c in range(9):
        f[c, si, ei] = tri9[gt, c]


def build_treelets(bvh: FlatBVH, tri9: np.ndarray,
                   cap: int = ENTRY_CAP) -> TreeletTables:
    t = build_treelet_tables(bvh, cap=cap)
    fill_triangles(t, tri9)
    return t


@dataclass
class TreeletDevice:
    """The treelet tables on one device (``SceneBuffers.treelet``)."""

    top_fields: torch.Tensor  # (8, T, 8, 128) f32
    sub_fields: torch.Tensor  # (NUM_FIELDS, S + 1, 8, 128) f32, tile S empty
    sub_tri_base: torch.Tensor  # (S + 1,) int32
    num_top: int = 0
    top_tiles: int = 1
    num_subtrees: int = 0

    @property
    def device(self) -> torch.device:
        return self.top_fields.device

    def to(self, device) -> "TreeletDevice":
        return dataclasses.replace(self, **{
            name: getattr(self, name).to(device)
            for name in ("top_fields", "sub_fields", "sub_tri_base")})

    def nbytes(self) -> int:
        return sum(x.numel() * x.element_size() for x in
                   (self.top_fields, self.sub_fields, self.sub_tri_base))


def build_treelet_device(bvh: FlatBVH, tri9: np.ndarray,
                         device="cuda") -> TreeletDevice:
    t = build_treelets(bvh, tri9)
    # Tile S: an all-empty dump subtree for padding blocks (boxes never
    # hit, links -> END).
    sub = np.concatenate([t.sub_fields, _empty_tile_like(t.sub_fields)],
                         axis=1)
    base = np.concatenate([t.sub_tri_base, np.zeros(1, np.int32)])
    return TreeletDevice(
        top_fields=torch.from_numpy(t.top_fields).to(device),
        sub_fields=torch.from_numpy(sub).to(device),
        sub_tri_base=torch.from_numpy(base).to(device),
        num_top=t.num_top,
        top_tiles=t.top_tiles,
        num_subtrees=t.num_subtrees,
    )


def _empty_tile_like(sub_fields: np.ndarray) -> np.ndarray:
    F = sub_fields.shape[0]
    tile = np.zeros((F, 1) + sub_fields.shape[2:], np.float32)
    tile[0:3] = 1e30
    tile[3:6] = -1e30
    tile[9] = np.float32(np.int32(SUB_END | (SUB_END << 10))
                         .view(np.float32))
    tile[10] = np.float32(np.int32(-1).view(np.float32))
    return tile
