"""BVH2 traversal: kernels K2 (closest-hit / any-hit) and K3 (stackless
any-hit) in ``csrc/bvh2_traverse.cu``, each with its plain torch twin.

Counterpart of ``loupiote_tpu/ops/pallas_intersect.py``
(``intersect_pallas``, ``occluded_pallas``). ``bvh2_trace`` and
``bvh2_occluded`` launch the CUDA kernels for CUDA tensors and run
``bvh2_trace_plain`` / ``bvh2_occluded_plain`` for CPU tensors; there is
no fallback from one to the other. A kernel and its twin visit nodes in
the same order with the same arithmetic, so they return the same bits.

Tables (``scene/buffers.py``): ``node_rows`` (N, 16) holds min.xyz,
max.xyz, then bitcast ints count, miss, right-or-leaf-row and
axis-or-first-triangle; ``leaf_rows`` (L, 128) holds up to 14 triangles
of [p0, e1, e2]. K2 descends to the child nearer along the split axis by
the ray's own direction sign and keeps the other on a per-ray stack; K3
walks the pre-order with the ``miss`` links and no stack.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import check_args, on_card
from .intersect import T_MIN, Hit, moller_trumbore, ray_args
from .wide import _safe_inv

STACK_MAX = 128  # csrc/bvh2_traverse.cu: kStackMax
LEAF_CAP = 14

# Rays stopped by the step bound, per device (K2, K3 and the two-level
# kernel's K2 walks).
_capped = _build.kernel_counter("bvh2_traverse.capped")


def capped_rays(device) -> int:
    """Rays that reached the step bound ``4 * num_nodes + 64`` on
    ``device`` since the last ``_build.reset_counters()``; 0 on a sound
    tree."""
    return _capped.read(device)


def max_steps(num_nodes: int) -> int:
    """The reference kernels' step bound (node visits per ray)."""
    return 4 * int(num_nodes) + 64


def _slab(rows, o, inv, bound):
    """Slab test of each ray against its own row's box: the reference's
    products and min/max order. Returns the (R,) hit mask."""
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
    """Moller-Trumbore of each ray against its own leaf row's first
    ``count`` triangles. Returns (ok (M,14), u, v, t); slots at or past
    ``count`` are masked before their 1e30 padding can matter."""
    tr = leaf_rows[lrow, :9 * LEAF_CAP].reshape(-1, LEAF_CAP, 9)
    u, v, t = moller_trumbore(tuple(x[:, None] for x in o),
                              tuple(x[:, None] for x in d),
                              tuple(tr[:, :, j] for j in range(9)))
    k = torch.arange(LEAF_CAP, device=lrow.device)
    ok = ((k[None, :] < count[:, None]) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > T_MIN) & (t < bound[:, None]))
    return ok, u, v, t


def bvh2_trace_plain(node_rows, leaf_rows, ro, rd, tmax, active,
                     any_hit: bool, num_nodes: int, stack_depth: int,
                     stats: dict | None = None):
    """Plain torch K2, vectorised over rays.

    Each live ray visits one node per step. A hit leaf runs
    Moller-Trumbore on its triangles and keeps the first of the nearest
    (strict ``<``); a hit internal node pushes the far child onto the
    ray's own stack (R, stack_depth) and descends to the near one (the
    left child where the ray's direction along the split axis is >= 0);
    anything else pops. Any-hit rays stop at their first confirmed hit.
    Returns ``(t, u, v, tri)``: ``tmax`` and -1 on a miss.

    ``stats``: when a dict, receives ``visits`` (node visits) and
    ``tri_tests`` (triangles tested) summed over the rays, the work
    count that bounds the kernel's operations.
    """
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
    visits = tri_tests = 0
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
        visits += live.numel()

        if bool(leaf.any()):
            li = live[leaf]
            ok, u, v, t = _leaf(leaf_rows, slot8[leaf].to(torch.int64),
                                count[leaf], tuple(x[leaf] for x in ol),
                                tuple(x[leaf] for x in dl), t_best[li])
            tri_tests += int(count[leaf].sum())
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

        # Internal hit: push the far child, descend to the near one.
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

        # Anything else pops; an empty stack ends the ray.
        pop = ~inner & ~done
        pi = live[pop]
        has = sp[pi] > 0
        pi = pi[has]
        sp[pi] -= 1
        node[pi] = stack[pi, sp[pi]].to(torch.int64)
        keep = inner.clone()
        keep[pop] = has
        live = live[keep]
    else:
        if live.numel():
            _capped.tensor(dev).add_(live.numel())
    if stats is not None:
        stats["visits"] = visits
        stats["tri_tests"] = tri_tests
    return t_best, u_best, v_best, tri


def bvh2_occluded_plain(node_rows, leaf_rows, ro, rd, tmax, active,
                        end_index: int, num_nodes: int,
                        stats: dict | None = None) -> torch.Tensor:
    """Plain torch K3: (R,) int32, 1 where [T_MIN, tmax) is blocked.

    Stackless: each step goes to ``node + 1`` after a hit internal node,
    else to the node's ``miss`` link; a ray ends when it is blocked or
    the next node is at or past ``end_index``. ``stats`` as in
    ``bvh2_trace_plain``.
    """
    dev = ro.device
    R = ro.shape[0]
    rows_i = node_rows.view(torch.int32)
    blocked = torch.zeros(R, dtype=torch.int32, device=dev)
    o = (ro[:, 0], ro[:, 1], ro[:, 2])
    d = (rd[:, 0], rd[:, 1], rd[:, 2])
    inv = tuple(_safe_inv(x) for x in d)
    node = torch.zeros(R, dtype=torch.int64, device=dev)
    live = torch.nonzero(active).flatten()
    visits = tri_tests = 0
    for _ in range(max_steps(num_nodes)):
        if live.numel() == 0:
            break
        n = node[live]
        rows = node_rows[n]
        ints = rows_i[n]
        count, miss, slot8 = ints[:, 6], ints[:, 7], ints[:, 8]
        ol = tuple(x[live] for x in o)
        dl = tuple(x[live] for x in d)
        hit = _slab(rows, ol, tuple(x[live] for x in inv), tmax[live])
        leaf = hit & (count > 0)
        visits += live.numel()
        stop = torch.zeros_like(hit)
        if bool(leaf.any()):
            ok = _leaf(leaf_rows, slot8[leaf].to(torch.int64), count[leaf],
                       tuple(x[leaf] for x in ol), tuple(x[leaf] for x in dl),
                       tmax[live[leaf]])[0]
            tri_tests += int(count[leaf].sum())
            stop[leaf] = ok.any(dim=1)
            blocked[live[stop]] = 1
        nxt = torch.where(hit & (count == 0), n + 1, miss.to(torch.int64))
        keep = ~stop & (nxt < end_index)
        live = live[keep]
        node[live] = nxt[keep]
    else:
        if live.numel():
            _capped.tensor(dev).add_(live.numel())
    if stats is not None:
        stats["visits"] = visits
        stats["tri_tests"] = tri_tests
    return blocked


def _check(dev, R, node_rows, leaf_rows, ro, rd, tmax, active):
    check_args(dev, (("node_rows", node_rows, torch.float32, None),
                     ("leaf_rows", leaf_rows, torch.float32, None),
                     ("ro", ro, torch.float32, (R, 3)),
                     ("rd", rd, torch.float32, (R, 3)),
                     ("tmax", tmax, torch.float32, (R,)),
                     ("active", active, torch.bool, (R,))))
    if node_rows.dim() != 2 or node_rows.shape[1] != 16:
        raise ValueError("node_rows: need shape (nodes, 16)")
    if leaf_rows.dim() != 2 or leaf_rows.shape[1] != 128:
        raise ValueError("leaf_rows: need shape (leaves, 128)")


def _launch_trace(node_rows, leaf_rows, ro, rd, tmax, active, any_hit,
                  num_nodes, stack_depth):
    dev = ro.device
    R = ro.shape[0]
    if stack_depth > STACK_MAX:
        raise ValueError(f"scene needs a traversal stack of {stack_depth} "
                         f"entries; the kernel holds {STACK_MAX}")
    _check(dev, R, node_rows, leaf_rows, ro, rd, tmax, active)
    out = [torch.empty(R, dtype=torch.float32, device=dev) for _ in range(3)]
    tri = torch.empty(R, dtype=torch.int32, device=dev)
    _build.launch("bvh2_traverse", "bvh2_trace", "11p3is", node_rows,
                  leaf_rows, ro, rd, tmax, active, *out, tri,
                  _capped.tensor(dev), R, max_steps(num_nodes), int(any_hit),
                  mode="anyhit" if any_hit else "closest")
    return (*out, tri)


def _launch_occluded(node_rows, leaf_rows, ro, rd, tmax, active, end_index,
                     num_nodes):
    dev = ro.device
    R = ro.shape[0]
    _check(dev, R, node_rows, leaf_rows, ro, rd, tmax, active)
    blocked = torch.empty(R, dtype=torch.int32, device=dev)
    _build.launch("bvh2_traverse", "bvh2_occluded", "8p3is", node_rows,
                  leaf_rows, ro, rd, tmax, active, blocked,
                  _capped.tensor(dev), R, max_steps(num_nodes),
                  int(end_index))
    return blocked


def bvh2_trace(node_rows, leaf_rows, ro, rd, tmax, active, any_hit: bool,
               num_nodes: int, stack_depth: int):
    """K2 on CUDA tensors, its plain twin on CPU tensors."""
    fn = _launch_trace if on_card(ro) else bvh2_trace_plain
    return fn(node_rows, leaf_rows, ro, rd, tmax, active, any_hit, num_nodes,
              stack_depth)


def bvh2_occluded(node_rows, leaf_rows, ro, rd, tmax, active,
                  end_index: int, num_nodes: int) -> torch.Tensor:
    """K3 on CUDA tensors, its plain twin on CPU tensors."""
    fn = _launch_occluded if on_card(ro) else bvh2_occluded_plain
    return fn(node_rows, leaf_rows, ro, rd, tmax, active, end_index,
              num_nodes)


def intersect_bvh2(scene, ro, rd, tmax=None, active=None,
                   any_hit: bool = False) -> Hit:
    """Hit record from K2 (``pallas_intersect.intersect_pallas``).

    A miss returns ``(tmax or T_FAR, -1, 0, 0)``; inactive rays return
    tri -1. u, v are tracked by the traversal itself. In any-hit mode
    only ``tri >= 0`` carries meaning.
    """
    ro, rd, t0, act = ray_args(ro, rd, tmax, active)
    t, u, v, tri = bvh2_trace(scene.node_rows, scene.leaf_rows, ro, rd, t0,
                              act, any_hit, scene.num_nodes,
                              scene.stack_depth)
    if active is not None:
        tri = torch.where(active, tri, -1)
    return Hit(t, tri, u, v)


def occluded_bvh2(scene, ro, rd, tmax, active=None) -> torch.Tensor:
    """(R,) bool from K3 (``pallas_intersect.occluded_pallas``): segment
    [T_MIN, tmax) blocked."""
    ro, rd, t0, act = ray_args(ro, rd, tmax, active)
    out = bvh2_occluded(scene.node_rows, scene.leaf_rows, ro, rd, t0, act,
                        scene.end_index, scene.num_nodes) > 0
    if active is not None:
        out = out & active
    return out
