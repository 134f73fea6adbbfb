"""The treelet traversal (counterpart of ``experiments/treelet/pipeline.py``).

  phase 1  lane_top.py (E6)     every ray walks the threaded top of the
                                BVH2 and collects the ids of the subtrees
                                whose root boxes it enters (<= PEND_CAP);
                                its compacting epilogue lays the (subtree,
                                ray) pairs out in PAIR_BUDGET * R slots and
                                flags the rays that fall back;
  binning  regroup="count"      (subtree, ray) pairs are grouped by subtree
                                into 1024-pair single-subtree blocks: slab
                                sort (K4), then E5's path entry
                                (regroup_blocks: each key's runs, the
                                regions, the placement; on the CPU its
                                plain version, searchsorted, run lists and
                                the run scatter); regroup="sort" does it with
                                one stable torch.sort, a rank within runs
                                and a padded scatter (the reference's
                                ``xla`` binning);
  phase 2  lane_bottom.py (E7)  every pair walks its subtree and folds
                                its hit into its ray's packed word: the
                                least t over the ray's pairs, the largest
                                global id among equal t;
  combine                       the words unpacked to (t, tri); rays
                                whose pending list filled or whose pairs
                                did not fit the budget are traced again by
                                the port's non-treelet dispatch.

The reference picked its binning with ``LOUPIOTE_REGROUP`` and defaulted
to ``xla`` because its counting regroup could not compile under Mosaic
(dynamic slice offsets must be tile-aligned). Here it is the ``regroup``
argument, and ``count``, the binning with kernels, is the default.
"""

from __future__ import annotations

import torch

from ..ops.bvh2 import bvh2_trace
from ..ops.intersect import DeviceCounter, Hit, _bvh2, ray_args, recompute_uv
from ..ops.wide import wide_trace
from .build import TILE
from .lane_bottom import lane_bottom_rays, unpack_hits
from .lane_top import lane_top_pairs
from .regroup import _no_mark, block_regroup

# The csrc/ libraries this traversal loads beside its fallback's: E6 and
# E7, K4 and E5 (the "count" binning).
LIBRARIES = ("treelet_traverse", "slab_sort", "regroup")

_fallback = DeviceCounter(torch.int64)  # fallback rays, per device


def fallback_rays(device) -> int:
    """Rays traced again by the non-treelet dispatch on ``device`` since
    the last ``reset_counters()``."""
    return _fallback.read(device)


def reset_counters() -> None:
    _fallback.reset()


def _bin_pairs_sort(key, ray_of, fallback, *, R: int, S: int):
    """The sort binning: sort pairs by subtree, rank within runs, scatter
    into TILE-padded single-subtree blocks. Returns (pair_ray, pair_sid,
    pair_on, fallback)."""
    dev = key.device
    P_pad = key.shape[0]
    key_s, order = torch.sort(key, stable=True)
    ray_s = ray_of[order]
    ar = torch.arange(P_pad, device=dev)
    first = torch.ones(P_pad, dtype=torch.bool, device=dev)
    first[1:] = key_s[1:] != key_s[:-1]
    run_start = torch.where(first, ar, 0)
    rank = ar - torch.cummax(run_start, 0).values
    counts = torch.bincount(key_s.to(torch.int64), minlength=S + 1)
    padded = -(-counts[:S] // TILE) * TILE
    base = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(padded, 0)])
    # Destination slot; dump-key pairs and pad overflow land at P_pad.
    ks = key_s.to(torch.int64)
    dest = torch.where(ks < S, base[torch.clamp_max(ks, S - 1)] + rank,
                       P_pad)
    dest = torch.clamp_max(dest, P_pad)
    # Padding can push the padded total past P_pad; those rays fall back.
    over_pad = (dest >= P_pad) & (ks < S)
    fallback = fallback.clone()
    fallback[ray_s[over_pad].to(torch.int64)] = True
    pair_ray = torch.zeros(P_pad + 1, dtype=torch.int32, device=dev)
    pair_ray[dest] = ray_s
    pair_sid = torch.full((P_pad + 1,), S, dtype=torch.int32, device=dev)
    pair_sid[dest] = torch.clamp_max(key_s, S)
    pair_on = torch.zeros(P_pad + 1, dtype=torch.int32, device=dev)
    pair_on[dest] = (ks < S).to(torch.int32)
    return pair_ray[:P_pad], pair_sid[:P_pad], pair_on[:P_pad], fallback


def _phase2_combine(td, ro, rd, t0, pair_ray, pair_on, sid_blocks, *,
                    any_hit: bool, mark=_no_mark):
    """Per-pair subtree walks and, per ray, the least t over its pairs and,
    among pairs at that t, the largest global triangle id: E7 with its
    per-ray epilogue (one packed word a ray), then the unpacking. Returns
    (t, tri)."""
    mark("binning")
    hit = lane_bottom_rays(sid_blocks, td.sub_fields, td.sub_tri_base,
                           pair_ray, pair_on.contiguous(), ro, rd, t0,
                           any_hit=any_hit)
    mark("E7")
    out = unpack_hits(hit, t0)
    mark("combine")
    return out


def _bin_and_walk(td, ro, rd, t0, key, ray_of, fallback, *, any_hit: bool,
                  regroup: str, mark=_no_mark):
    """Binning and phase 2 of the pairs that E6's compacting epilogue laid
    out. Returns (t, tri, fallback)."""
    R = ro.shape[0]
    S = td.num_subtrees
    if regroup == "count":
        # Regions are tile-aligned over PAIR_BUDGET * R pairs with room to
        # spare, so no further fallback arises here.
        pair_ray, sid_blocks, pair_on = block_regroup(key, ray_of, S,
                                                      tile=TILE, mark=mark)
    elif regroup == "sort":
        pair_ray, pair_sid, pair_on, fallback = _bin_pairs_sort(
            key, ray_of, fallback, R=R, S=S)
        # Whole blocks for phase 2: pad with idle pairs of the dump tile.
        pad = -pair_ray.shape[0] % TILE
        if pad:
            pair_ray = torch.nn.functional.pad(pair_ray, (0, pad))
            pair_sid = torch.nn.functional.pad(pair_sid, (0, pad), value=S)
            pair_on = torch.nn.functional.pad(pair_on, (0, pad))
        sid_blocks = pair_sid[::TILE].contiguous()
    else:
        raise ValueError(f"regroup must be 'count' or 'sort', got "
                         f"{regroup!r}")
    t, tri = _phase2_combine(td, ro, rd, t0, pair_ray, pair_on, sid_blocks,
                             any_hit=any_hit, mark=mark)
    return t, tri, fallback


def _fallback_trace(scene, ro, rd, t0, act, any_hit: bool):
    """(t, tri) of the port's non-treelet traversal, without u, v: K2 on
    scenes below 8,192 BVH2 nodes, K1 from there on; any-hit tri is -1
    where nothing blocks."""
    if _bvh2(scene):
        t, _, _, tri = bvh2_trace(scene.node_rows, scene.leaf_rows, ro, rd,
                                  t0, act, any_hit, scene.num_nodes,
                                  scene.stack_depth)
        return t, tri
    t, tri = wide_trace(scene.trav_rows, ro, rd, t0, act, any_hit,
                        scene.wide_end, scene.wide_stack)
    return t, (torch.where(tri > 0, tri, -1) if any_hit else tri)


def treelet_intersect(scene, ro, rd, tmax=None, active=None,
                      any_hit: bool = False, regroup: str = "count",
                      mark=_no_mark) -> Hit:
    """Hit record from the treelet traversal; needs ``scene.treelet``.

    Rays whose pending list filled or whose pairs did not fit the budget
    are traced again through the port's non-treelet dispatch with
    ``active=fallback``: K1 on scenes of 8,192 BVH2 nodes or more, K2
    below. They are counted (``fallback_rays``). ``mark(stage)`` is
    called as each stage ends ("E6", "binning", "K4", "E5", "E7",
    "combine", "fallback"), for a caller that times them.
    """
    td = scene.treelet
    ro, rd, t0, act = ray_args(ro, rd, tmax, active)
    if ro.shape[0] == 0:
        empty = torch.zeros(0, dtype=torch.float32, device=ro.device)
        return Hit(empty, torch.zeros(0, dtype=torch.int32,
                                      device=ro.device), empty, empty)
    key, ray_of, fallback = lane_top_pairs(td.top_fields, ro, rd, t0, act,
                                           td.num_top, td.num_subtrees)
    mark("E6")
    t, tri, fallback = _bin_and_walk(td, ro, rd, t0, key, ray_of, fallback,
                                     any_hit=any_hit, regroup=regroup,
                                     mark=mark)
    fb_act = fallback & act
    _fallback.tensor(ro.device).add_(fb_act.sum())
    fb_t, fb_tri = _fallback_trace(scene, ro, rd, t0, fb_act, any_hit)
    t = torch.where(fb_act, fb_t, t)
    tri = torch.where(fb_act, fb_tri, tri)
    # u, v once for the final hits (the walks track only t and tri).
    u, v = recompute_uv(scene, ro, rd, tri)
    mark("fallback")
    return Hit(t, tri, u, v)


def treelet_occluded(scene, ro, rd, dist, active=None,
                     regroup: str = "count") -> torch.Tensor:
    """(R,) bool: segment [T_MIN, dist) blocked, by the treelet traversal
    in any-hit mode."""
    tmax = dist * (1.0 - 1e-3)
    out = treelet_intersect(scene, ro, rd, tmax=tmax, active=active,
                            any_hit=True, regroup=regroup).tri != -1
    if active is not None:
        out = out & active
    return out
