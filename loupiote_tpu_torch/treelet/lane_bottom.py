"""Phase 2 of the treelet traversal: kernel E7 (``csrc/treelet_traverse.cu``,
``lane_bottom``) and its plain torch twins.

Counterpart of ``experiments/treelet/lane_bottom.py`` (``lane_bottom_trace``,
the Pallas ``_lane_bottom_kernel``) and of the per-ray combine of
``experiments/treelet/pipeline.py``. Pairs come in tiles of ``TILE``; all
pairs of tile b walk subtree ``sid[b]``. Each pair walks the threaded
subtree from entry 0: a node entry's box test against the pair's best t
goes to ``hit_id`` or ``miss_id``; a triangle entry runs Moller-Trumbore
(accepted when T_MIN < t < best t, |det| > 1e-12, u, v >= 0, u + v <= 1)
and records its subtree-local ordinal. In any-hit mode the first accepted
triangle ends the walk. Step bound 2048; pairs that reach it are counted.

Two entry points share the kernel: ``lane_bottom_trace`` returns each
pair's (t, tri_local), the reference's contract; ``lane_bottom_rays``
returns one packed word a ray, the least t over its pairs and, among
equal t, the largest global triangle id (``pack_hits``; the kernel's
64-bit atomicMin), which ``unpack_hits`` turns into (t, tri).
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import check_args, on_card
from ..ops.intersect import T_MIN, moller_trumbore
from ..ops.wide import _safe_inv
from .build import SUB_END, TILE

MAX_STEPS = 2048
WALK_FIELDS = 10  # f0..f9; f10 (the global id) is host-side only
NO_HIT = (1 << 63) - 1  # a ray's packed word before any pair hits

# Pairs stopped by the step bound, per device.
_capped = _build.kernel_counter("lane_bottom.capped")


def capped_pairs(device) -> int:
    """Pairs that reached the step bound on ``device`` since the last
    ``_build.reset_counters()``."""
    return _capped.read(device)


def lane_bottom_plain(sid_blocks, sub_fields, ro, rd, tmax, active,
                      any_hit: bool, stats: dict | None = None):
    """Plain torch walk of each pair's subtree, vectorised over the live
    pairs. Returns ``(t (P,) f32, tri_local (P,) int32, -1 on a miss)``.
    ``stats``: receives ``box_tests`` (node entries visited) and
    ``tri_tests`` (triangle entries visited)."""
    dev = ro.device
    P = ro.shape[0]
    tab = sub_fields[:WALK_FIELDS].reshape(WALK_FIELDS, -1)
    link_all = tab[9].view(torch.int32)
    base = torch.repeat_interleave(sid_blocks.to(torch.int64) * TILE, TILE)
    cur = torch.zeros(P, dtype=torch.int64, device=dev)
    best_t = tmax.clone()
    best_tri = torch.full((P,), -1, dtype=torch.int32, device=dev)
    inv = [_safe_inv(rd[:, a]) for a in range(3)]
    live = torch.nonzero(active > 0).flatten()
    box_tests = tri_tests = 0
    for _ in range(MAX_STEPS):
        if live.numel() == 0:
            break
        e = base[live] + cur[live]
        link = link_all[e]
        hit_id = link & 1023
        miss_id = (link >> 10) & 1023
        is_tri = ((link >> 20) & 1) > 0
        nxt = miss_id.clone()

        # Node entries: slab test against the pair's best t.
        node = ~is_tri
        if bool(node.any()):
            ni, ne = live[node], e[node]
            box_tests += ni.numel()
            t1 = [(tab[a, ne] - ro[ni, a]) * inv[a][ni] for a in range(3)]
            t2 = [(tab[a + 3, ne] - ro[ni, a]) * inv[a][ni] for a in range(3)]
            tn = torch.maximum(torch.maximum(torch.minimum(t1[0], t2[0]),
                                             torch.minimum(t1[1], t2[1])),
                               torch.minimum(t1[2], t2[2]))
            tf = torch.minimum(torch.minimum(torch.maximum(t1[0], t2[0]),
                                             torch.maximum(t1[1], t2[1])),
                               torch.maximum(t1[2], t2[2]))
            go = (tf >= torch.clamp_min(tn, 0.0)) & (tn < best_t[ni])
            nxt[node] = torch.where(go, hit_id[node], miss_id[node])

        # Triangle entries: Moller-Trumbore on f0..f8 = p0, e1, e2.
        ended = torch.zeros_like(is_tri)
        if bool(is_tri.any()):
            ti, te = live[is_tri], e[is_tri]
            tri_tests += ti.numel()
            u, v, t = moller_trumbore(
                tuple(ro[ti, a] for a in range(3)),
                tuple(rd[ti, a] for a in range(3)),
                tuple(tab[j, te] for j in range(9)))
            # t is 0 where |det| <= 1e-12 (inv_det 0), so t > T_MIN also
            # carries the determinant test.
            ok = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
                  & (t < best_t[ti]))
            best_t[ti[ok]] = t[ok]
            best_tri[ti[ok]] = (link[is_tri][ok] >> 21) & 1023
            if any_hit:
                ended[is_tri] = ok
        nxt = torch.where(ended, SUB_END, nxt)
        cur[live] = nxt.to(torch.int64)
        live = live[nxt != SUB_END]
    else:
        if live.numel():
            _capped.tensor(dev).add_(live.numel())
    if stats is not None:
        stats["box_tests"] = box_tests
        stats["tri_tests"] = tri_tests
    return best_t, best_tri


def pack_hits(t: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """int64 words ``float_bits(t) << 32 | 0x7FFFFFFF - tri`` of hits with
    t > 0 and global ids tri >= 0: the least word is the least t and,
    among equal t, the largest id (the reference's combine rule)."""
    return ((t.view(torch.int32).to(torch.int64) << 32)
            | (0x7FFFFFFF - tri.to(torch.int64)))


def unpack_hits(hit: torch.Tensor, t0: torch.Tensor):
    """(t, tri) of packed words; ``NO_HIT`` gives (t0, -1)."""
    miss = hit == NO_HIT
    t = (hit >> 32).to(torch.int32).view(torch.float32)
    tri = (0x7FFFFFFF - (hit & 0xFFFFFFFF)).to(torch.int32)
    return torch.where(miss, t0, t), torch.where(miss, -1, tri)


def lane_bottom_rays_plain(sid_blocks, sub_fields, sub_tri_base, pair_ray,
                           pair_on, ro, rd, t0, any_hit: bool,
                           stats: dict | None = None):
    """Plain version of the per-ray epilogue: gather each pair's ray,
    ``lane_bottom_plain``, then one packed word a ray by an int64
    ``scatter_reduce`` amin (exact, in any order). Returns (R,) int64."""
    pr = pair_ray.to(torch.int64)
    pt, ptri = lane_bottom_plain(sid_blocks, sub_fields, ro[pr].contiguous(),
                                 rd[pr].contiguous(), t0[pr].contiguous(),
                                 pair_on, any_hit, stats)
    base = torch.repeat_interleave(sub_tri_base[sid_blocks.to(torch.int64)],
                                   TILE)
    key = torch.where((ptri >= 0) & (pair_on > 0), pack_hits(pt, base + ptri),
                      NO_HIT)
    hit = torch.full((ro.shape[0],), NO_HIT, dtype=torch.int64,
                     device=ro.device)
    return hit.scatter_reduce(0, pr, key, "amin")


def _call(sid_blocks, sub_fields, ray_args, outs, any_hit: bool,
          per_ray: bool):
    """Launch the C entry point ``lane_bottom`` on checked CUDA tensors.
    ``ray_args``: (pair_ray or None, ro, rd, tmax, active, tri_base or
    None); ``outs``: (t, tri, hit), None where the epilogue has none."""
    dev = sid_blocks.device
    tab = sub_fields.reshape(sub_fields.shape[0], -1)
    if tab.data_ptr() % 16:
        raise ValueError("sub_fields: need a 16-byte aligned table")
    _build.launch("treelet_traverse", "lane_bottom", "p2ipi10p3is",
                  sid_blocks, sid_blocks.shape[0], tab.shape[1] // TILE - 1,
                  tab, tab.shape[1], *ray_args, *outs, _capped.tensor(dev),
                  MAX_STEPS, int(any_hit), int(per_ray),
                  mode=("per_ray" if per_ray else "per_pair",
                        "anyhit" if any_hit else "closest"))


def _launch(sid_blocks, sub_fields, ro, rd, tmax, active, any_hit: bool):
    dev = ro.device
    P = ro.shape[0]
    if P % TILE:
        raise ValueError(f"lane_bottom: {P} pairs is not a multiple of "
                         f"{TILE}")
    tab = sub_fields.reshape(sub_fields.shape[0], -1)
    check_args(dev, (("sid_blocks", sid_blocks, torch.int32, (P // TILE,)),
                     ("sub_fields", tab, torch.float32, None),
                     ("ro", ro, torch.float32, (P, 3)),
                     ("rd", rd, torch.float32, (P, 3)),
                     ("tmax", tmax, torch.float32, (P,)),
                     ("active", active, torch.int32, (P,))))
    if tab.shape[0] < WALK_FIELDS or tab.shape[1] % TILE:
        raise ValueError("sub_fields: need shape (>= 10, S + 1, 8, 128)")
    t = torch.empty(P, dtype=torch.float32, device=dev)
    tri = torch.empty(P, dtype=torch.int32, device=dev)
    _call(sid_blocks, sub_fields, (None, ro, rd, tmax, active, None),
          (t, tri, None), any_hit, per_ray=False)
    return t, tri


def _launch_rays(sid_blocks, sub_fields, sub_tri_base, pair_ray, pair_on, ro,
                 rd, t0, any_hit: bool):
    dev = ro.device
    P = pair_ray.shape[0]
    R = ro.shape[0]
    if P % TILE:
        raise ValueError(f"lane_bottom: {P} pairs is not a multiple of "
                         f"{TILE}")
    tab = sub_fields.reshape(sub_fields.shape[0], -1)
    check_args(dev, (("sid_blocks", sid_blocks, torch.int32, (P // TILE,)),
                     ("sub_fields", tab, torch.float32, None),
                     ("sub_tri_base", sub_tri_base, torch.int32,
                      (tab.shape[1] // TILE,)),
                     ("pair_ray", pair_ray, torch.int32, (P,)),
                     ("pair_on", pair_on, torch.int32, (P,)),
                     ("ro", ro, torch.float32, (R, 3)),
                     ("rd", rd, torch.float32, (R, 3)),
                     ("t0", t0, torch.float32, (R,))))
    if tab.shape[0] < WALK_FIELDS or tab.shape[1] % TILE:
        raise ValueError("sub_fields: need shape (>= 10, S + 1, 8, 128)")
    hit = torch.full((R,), NO_HIT, dtype=torch.int64, device=dev)
    _call(sid_blocks, sub_fields,
          (pair_ray, ro, rd, t0, pair_on, sub_tri_base), (None, None, hit),
          any_hit, per_ray=True)
    return hit


def lane_bottom_rays(sid_blocks, sub_fields, sub_tri_base, pair_ray,
                     pair_on, ro, rd, t0, any_hit: bool = False):
    """E7 with the per-ray epilogue on CUDA tensors, the plain version on
    CPU tensors.

    ``sid_blocks`` (P / TILE,) int32 subtree per tile; ``sub_fields``
    (NUM_FIELDS, S + 1, 8, 128) f32; ``sub_tri_base`` (S + 1,) int32;
    ``pair_ray``, ``pair_on`` (P,) int32, the ray of each pair slot and its
    validity; ``ro``, ``rd`` (R, 3), ``t0`` (R,) ray data. Returns (R,)
    int64 packed words (``unpack_hits``).
    """
    fn = _launch_rays if on_card(ro) else lane_bottom_rays_plain
    return fn(sid_blocks, sub_fields, sub_tri_base, pair_ray, pair_on, ro,
              rd, t0, any_hit)


def lane_bottom_trace(sid_blocks, sub_fields, ro, rd, tmax, active,
                      any_hit: bool = False):
    """E7 with the per-pair epilogue on CUDA tensors, the plain twin on CPU
    tensors.

    ``sid_blocks`` (P / TILE,) int32 subtree per block; ``sub_fields``
    (NUM_FIELDS, S + 1, 8, 128) f32; ``ro``, ``rd`` (P, 3) pair-ordered ray
    data; ``tmax`` (P,) per-pair bound; ``active`` (P,) int32 pair
    validity. Returns ``(t, tri_local)``; add the subtree's triangle base
    to tri_local for the global id.
    """
    fn = _launch if on_card(ro) else lane_bottom_plain
    return fn(sid_blocks, sub_fields, ro, rd, tmax, active, any_hit)
