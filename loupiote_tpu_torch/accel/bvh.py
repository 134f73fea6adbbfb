"""Binned-SAH BVH2 builder with a threaded pre-order layout.

Copy of ``loupiote_tpu/accel/bvh.py`` (the numpy builder is the verified
reference implementation). Layout: internal node ``n``'s left child is
``n + 1`` and ``miss[n]`` jumps over its subtree; ``right[n]`` is the
right child. ``accel/wide.py`` collapses this tree into the 8-wide table
the traversal kernel reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Max triangles per leaf: one 128-float leaf row holds 14 x 9 floats.
LEAF_MAX = 14
SAH_BINS = 16


class AccelBuild(ValueError):
    """The BVH cannot be built from the given triangles."""


@dataclass
class FlatBVH:
    """Flat threaded BVH arrays (all leading dim = node count N).

    ``first``: leaf -> first triangle in the *reordered* triangle array;
               internal -> left child index (== self + 1).
    ``count``: 0 for internal nodes, triangle count for leaves.
    ``miss``:  skip link; ``len(nodes)`` terminates traversal.
    ``tri_order``: permutation applied to input triangles.
    """

    node_min: np.ndarray  # (N, 3) float32
    node_max: np.ndarray  # (N, 3) float32
    first: np.ndarray  # (N,) int32
    count: np.ndarray  # (N,) int32
    miss: np.ndarray  # (N,) int32
    right: np.ndarray  # (N,) int32 right child (-1 for leaves)
    axis: np.ndarray  # (N,) int32 split axis (-1 for leaves)
    tri_order: np.ndarray  # (T,) int32

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


def build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
              leaf_max: int = LEAF_MAX, use_native: bool = True) -> FlatBVH:
    """Build a binned-SAH BVH2 over triangles (v0, v1, v2): (T, 3) float32.

    ``use_native``: build with the C++ builder (accel/native.py), which
    also runs the insertion optimizer, so its tree differs from the numpy
    builder's. It raises if the builder cannot be compiled or loaded.
    """
    T = v0.shape[0]
    if T == 0:
        raise AccelBuild("cannot build a BVH over zero triangles")
    if not (np.isfinite(v0).all() and np.isfinite(v1).all()
            and np.isfinite(v2).all()):
        raise AccelBuild("non-finite vertex positions in BVH input")
    if use_native:
        from .native import build_bvh_native

        return build_bvh_native(v0, v1, v2, leaf_max)
    tri_min = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tri_max = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroid = ((tri_min + tri_max) * 0.5).astype(np.float32)

    # Node storage, grown geometrically.
    cap = max(2 * T, 64)
    n_min = np.empty((cap, 3), np.float32)
    n_max = np.empty((cap, 3), np.float32)
    n_first = np.empty(cap, np.int32)
    n_count = np.empty(cap, np.int32)
    out_n = 0

    def ensure(extra):
        nonlocal cap, n_min, n_max, n_first, n_count, split_axis
        if out_n + extra <= cap:
            return
        cap = max(cap * 2, out_n + extra)
        n_min = np.resize(n_min, (cap, 3))
        n_max = np.resize(n_max, (cap, 3))
        n_first = np.resize(n_first, cap)
        n_count = np.resize(n_count, cap)
        split_axis = np.resize(split_axis, cap)

    # Explicit DFS stack: (lo, hi, slot_to_patch or -1). Emitting in
    # pre-order makes left child == parent + 1 by construction.
    right_patch = {}
    split_axis = np.full(cap, -1, np.int32)
    stack = [(0, T, -1)]
    out_order = np.empty(T, dtype=np.int64)
    out_pos = 0
    work = np.arange(T, dtype=np.int64)

    while stack:
        lo, hi, patch_slot = stack.pop()
        ensure(1)
        me = out_n
        out_n += 1
        if patch_slot >= 0:
            right_patch[patch_slot] = me

        idx = work[lo:hi].copy()  # copy: partition writes below alias `work`
        bmin = tri_min[idx].min(axis=0)
        bmax = tri_max[idx].max(axis=0)
        n_min[me] = bmin
        n_max[me] = bmax

        count = hi - lo
        if count <= leaf_max:
            n_first[me] = out_pos
            n_count[me] = count
            split_axis[me] = -1
            out_order[out_pos:out_pos + count] = idx
            out_pos += count
            continue

        split = _binned_sah_split(centroid[idx], tri_min[idx], tri_max[idx])
        if split is None:
            # Degenerate spatial distribution: median split on largest axis.
            axis = int(np.argmax(bmax - bmin))
            key = np.argsort(centroid[idx, axis], kind="stable")
            mid = count // 2
            work[lo:hi] = idx[key]
        else:
            axis, mask = split
            mid = int(mask.sum())
            if mid == 0 or mid == count:
                key = np.argsort(centroid[idx, axis], kind="stable")
                mid = count // 2
                work[lo:hi] = idx[key]
            else:
                work[lo:lo + mid] = idx[mask]
                work[lo + mid:hi] = idx[~mask]

        split_axis[me] = axis
        n_count[me] = 0
        n_first[me] = me + 1  # left child, by pre-order construction
        # Push right first so left pops first; the right child's index is
        # patched once the left subtree is emitted.
        stack.append((lo + mid, hi, me))
        stack.append((lo, lo + mid, -1))

    node_min = n_min[:out_n].copy()
    node_max = n_max[:out_n].copy()
    first = n_first[:out_n].copy()
    count = n_count[:out_n].copy()

    # Miss links from the right-child table, by a pre-order walk.
    miss = np.full(out_n, out_n, dtype=np.int32)
    right = np.full(out_n, -1, dtype=np.int32)
    for parent, r in right_patch.items():
        right[parent] = r
    walk = [(0, out_n)]  # (node, miss_value)
    while walk:
        node, m = walk.pop()
        miss[node] = m
        if count[node] == 0:
            left, r = node + 1, right[node]
            walk.append((left, r))
            walk.append((r, m))

    return FlatBVH(
        node_min=node_min,
        node_max=node_max,
        first=first.astype(np.int32),
        count=count.astype(np.int32),
        miss=miss,
        right=right,
        axis=split_axis[:out_n].copy(),
        tri_order=out_order.astype(np.int32),
    )


def _binned_sah_split(cent, tmin, tmax, bins: int = SAH_BINS):
    """Return (axis, left_mask) for the best binned-SAH split, or None."""
    best = None
    best_cost = np.inf
    cb_min = cent.min(axis=0)
    cb_max = cent.max(axis=0)
    extent = cb_max - cb_min

    for axis in range(3):
        if extent[axis] <= 1e-12:
            continue
        scale = bins / (extent[axis] + 1e-30)
        b = np.clip(((cent[:, axis] - cb_min[axis]) * scale).astype(np.int32),
                    0, bins - 1)
        counts = np.bincount(b, minlength=bins)
        bb_min = np.full((bins, 3), np.inf, np.float32)
        bb_max = np.full((bins, 3), -np.inf, np.float32)
        np.minimum.at(bb_min, b, tmin)
        np.maximum.at(bb_max, b, tmax)

        # Sweep: left-to-right and right-to-left cumulative surface areas.
        lmin = np.minimum.accumulate(bb_min, axis=0)
        lmax = np.maximum.accumulate(bb_max, axis=0)
        rmin = np.minimum.accumulate(bb_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bb_max[::-1], axis=0)[::-1]
        lcnt = np.cumsum(counts)
        rcnt = np.cumsum(counts[::-1])[::-1]

        def area(mn, mx):
            d = np.maximum(mx - mn, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        # Split after bin i: left = bins[..i], right = bins[i+1..].
        la = area(lmin, lmax)[:-1]
        ra = area(rmin, rmax)[1:]
        cl = lcnt[:-1]
        cr = rcnt[1:]
        valid = (cl > 0) & (cr > 0)
        if not valid.any():
            continue
        cost = np.where(valid, 1.0 + la * cl + ra * cr, np.inf)
        i = int(np.argmin(cost))
        if cost[i] < best_cost:
            best_cost = cost[i]
            best = (axis, b <= i)
    return best


def bvh_max_depth(count: np.ndarray, miss: np.ndarray) -> int:
    """Max tree depth (root = 0) of a threaded pre-order BVH.

    Internal node ``j``'s descendants are exactly the index interval
    ``(j, miss[j])``, so a node's depth is the number of such intervals
    containing it: one difference-array sweep.
    """
    n = count.shape[0]
    internal = np.nonzero(count == 0)[0]
    delta = np.zeros(n + 1, np.int64)
    np.add.at(delta, internal + 1, 1)
    np.add.at(delta, miss[internal].astype(np.int64), -1)
    depth = np.cumsum(delta)[:n]
    return int(depth.max()) if n else 0
