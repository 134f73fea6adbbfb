"""Phase 1 of the treelet traversal: kernel E6 (``csrc/treelet_traverse.cu``,
``lane_top``) and its plain torch twin.

Counterpart of ``experiments/treelet/lane_top.py`` (``lane_top_trace``,
the Pallas ``_lane_top_kernel``). Each ray walks the threaded top table
from entry 0: a box hit descends to ``hit_id``, else the walk continues
at ``miss_id``; a hit frontier entry appends its subtree id to the ray's
pending list (at most ``PEND_CAP``) and continues at its miss link; a
frontier hit with every slot full parks the ray at END, its walk
incomplete (the pipeline sends such rays, ``npend == PEND_CAP``, down the
fallback). Inactive rays return ``npend = 0``. The step bound is
``4 * num_top + 64``; rays that reach it are counted.

The kernel has two epilogues. Per ray (``lane_top_trace``, the
reference's contract): ``pend`` and ``npend``. Compacting
(``lane_top_pairs``, what the pipeline runs): the (subtree, ray) pairs
laid out in ``PAIR_BUDGET * R`` slots by an exclusive scan over the rays,
with the rays that fall back flagged; its plain version is
``lane_top_plain`` followed by ``compact_pairs``.
"""

from __future__ import annotations

import torch

from .. import _build
from .._build import check_args, on_card
from ..ops.wide import _safe_inv
from .build import ID_MASK, PEND_CAP, TOP_ID_BITS

# Pair-budget factor: the pair array holds PAIR_BUDGET * R slots; rays
# whose pairs do not fit fall back to the non-treelet traversal.
PAIR_BUDGET = 4
# Rays a block takes at a time (csrc/treelet_traverse.cu: kTopThreads); the
# compacting epilogue keeps one scan word a tile of this many rays.
TILE_RAYS = 256

# Rays stopped by the step bound, per device.
_capped = _build.kernel_counter("lane_top.capped")


def capped_rays(device) -> int:
    """Rays that reached the step bound on ``device`` since the last
    ``_build.reset_counters()``."""
    return _capped.read(device)


def max_steps(num_top: int) -> int:
    """The reference kernel's step bound."""
    return 4 * int(num_top) + 64


def lane_top_plain(top_fields, ro, rd, tmax, active, num_top: int,
                   stats: dict | None = None):
    """Plain torch walk of the top table, vectorised over the live rays.
    Returns ``(pend (R, PEND_CAP) int32 subtree ids, -1 empty; npend (R,)
    int32)``. ``stats``: receives ``box_tests``, the entries visited."""
    dev = ro.device
    R = ro.shape[0]
    tab = top_fields.reshape(8, -1)
    tab_i = tab.view(torch.int32)
    pend = torch.full((R, PEND_CAP), -1, dtype=torch.int32, device=dev)
    npend = torch.zeros(R, dtype=torch.int32, device=dev)
    cur = torch.zeros(R, dtype=torch.int64, device=dev)
    inv = [_safe_inv(rd[:, a]) for a in range(3)]
    live = torch.nonzero(active).flatten()
    box_tests = 0
    for _ in range(max_steps(num_top)):
        if live.numel() == 0:
            break
        c = cur[live]
        box_tests += live.numel()
        t1 = [(tab[a, c] - ro[live, a]) * inv[a][live] for a in range(3)]
        t2 = [(tab[a + 3, c] - ro[live, a]) * inv[a][live] for a in range(3)]
        tn = torch.maximum(torch.maximum(torch.minimum(t1[0], t2[0]),
                                         torch.minimum(t1[1], t2[1])),
                           torch.minimum(t1[2], t2[2]))
        tf = torch.minimum(torch.minimum(torch.maximum(t1[0], t2[0]),
                                         torch.maximum(t1[1], t2[1])),
                           torch.maximum(t1[2], t2[2]))
        link = tab_i[6, c]
        pe = tab_i[7, c]
        hit = (tf >= torch.clamp_min(tn, 0.0)) & (tn < tmax[live])
        hit_id = link & ID_MASK
        miss_id = (link >> TOP_ID_BITS) & ID_MASK
        np_ = npend[live]
        frontier = hit & (pe >= 0)
        enq = frontier & (np_ < PEND_CAP)
        pend[live[enq], np_[enq].to(torch.int64)] = pe[enq]
        npend[live[enq]] += 1
        nxt = torch.where(hit & (hit_id != ID_MASK), hit_id, miss_id)
        nxt = torch.where(frontier & (np_ >= PEND_CAP), ID_MASK, nxt)
        cur[live] = nxt.to(torch.int64)
        live = live[nxt != ID_MASK]
    else:
        if live.numel():
            _capped.tensor(dev).add_(live.numel())
    if stats is not None:
        stats["box_tests"] = box_tests
    return pend, npend


def compact_pairs(pend, npend, act, *, S: int):
    """Plain version of the compacting epilogue's layout: the (ray,
    subtree) pairs in ``PAIR_BUDGET * R`` slots by a per-ray exclusive
    scan of the pending counts. Returns (key (P_pad,) int32, the dump key
    ``S`` in every slot without a pair; ray_of (P_pad,) int32, 0 there;
    fallback (R,) bool)."""
    R = pend.shape[0]
    dev = pend.device
    P_pad = PAIR_BUDGET * R
    np_eff = torch.where(act, torch.clamp_max(npend, PEND_CAP), 0).to(
        torch.int64)
    ray_base = torch.cumsum(np_eff, 0) - np_eff
    # npend == PEND_CAP may be an incomplete walk, even where nothing was
    # dropped: such rays fall back, as do rays past the budget.
    fallback = ((ray_base + np_eff > P_pad) | (npend >= PEND_CAP)) & act
    keep = act & ~fallback
    slot = torch.arange(PEND_CAP, device=dev)[None, :]
    valid = (slot < np_eff[:, None]) & (pend >= 0) & keep[:, None]
    # Slot P_pad is a dump for every invalid entry; it is sliced off.
    dest = torch.where(valid, ray_base[:, None] + slot, P_pad).reshape(-1)
    key = torch.full((P_pad + 1,), S, dtype=torch.int32, device=dev)
    key[dest] = torch.where(valid, pend, S).reshape(-1)
    ray_of = torch.zeros(P_pad + 1, dtype=torch.int32, device=dev)
    ray_of[dest] = torch.arange(R, dtype=torch.int32, device=dev)[
        :, None].expand(R, PEND_CAP).reshape(-1)
    return key[:P_pad], ray_of[:P_pad], fallback


def lane_top_pairs_plain(top_fields, ro, rd, tmax, active, num_top: int,
                         S: int):
    """Plain version of the compacting epilogue: ``lane_top_plain``, then
    ``compact_pairs``."""
    pend, npend = lane_top_plain(top_fields, ro, rd, tmax, active, num_top)
    return compact_pairs(pend, npend, active, S=S)


def _check(top_fields, ro, rd, tmax, active):
    dev = ro.device
    R = ro.shape[0]
    tab = top_fields.reshape(8, -1)
    check_args(dev, (("top_fields", tab, torch.float32, None),
                     ("ro", ro, torch.float32, (R, 3)),
                     ("rd", rd, torch.float32, (R, 3)),
                     ("tmax", tmax, torch.float32, (R,)),
                     ("active", active, torch.bool, (R,))))
    if tab.shape[1] % 1024 or tab.shape[1] > 1 << TOP_ID_BITS:
        raise ValueError("top_fields: need (8, tiles * 1024) with at most "
                         f"{1 << TOP_ID_BITS} entries")
    if PAIR_BUDGET * R >= 1 << 31:
        raise ValueError(f"lane_top: {R} rays need {PAIR_BUDGET * R} pair "
                         "slots, past int32")
    return dev, R, tab


def _launch(top_fields, ro, rd, tmax, active, num_top: int):
    dev, R, tab = _check(top_fields, ro, rd, tmax, active)
    pend = torch.empty((R, PEND_CAP), dtype=torch.int32, device=dev)
    npend = torch.empty(R, dtype=torch.int32, device=dev)
    _build.launch("treelet_traverse", "lane_top", "pi7p2is", tab,
                  tab.shape[1], ro, rd, tmax, active, pend, npend,
                  _capped.tensor(dev), R, max_steps(num_top))
    return pend, npend


def _launch_pairs(top_fields, ro, rd, tmax, active, num_top: int, S: int):
    dev, R, tab = _check(top_fields, ro, rd, tmax, active)
    P_pad = PAIR_BUDGET * R
    key = torch.empty(P_pad, dtype=torch.int32, device=dev)
    ray_of = torch.empty(P_pad, dtype=torch.int32, device=dev)
    fallback = torch.empty(R, dtype=torch.bool, device=dev)
    # One scan word a tile of TILE_RAYS rays, then the tile ticket: zero
    # at every launch.
    state = torch.zeros(-(-R // TILE_RAYS) + 1, dtype=torch.int64,
                        device=dev)
    _build.launch("treelet_traverse", "lane_top_pairs", "pi9p4is", tab,
                  tab.shape[1], ro, rd, tmax, active, key, ray_of, fallback,
                  state, _capped.tensor(dev), R, max_steps(num_top), int(S),
                  P_pad)
    return key, ray_of, fallback


def lane_top_trace(top_fields, ro, rd, tmax, active, num_top: int):
    """E6 with the per-ray epilogue on CUDA tensors, the plain twin on CPU
    tensors. Returns (pend (R, PEND_CAP) int32, npend (R,) int32)."""
    fn = _launch if on_card(ro) else lane_top_plain
    return fn(top_fields, ro, rd, tmax, active, num_top)


def lane_top_pairs(top_fields, ro, rd, tmax, active, num_top: int, S: int):
    """E6 with the compacting epilogue on CUDA tensors, its plain version
    on CPU tensors. Returns (key, ray_of, fallback) as ``compact_pairs``
    does, for ``S`` subtrees (the dump key)."""
    fn = _launch_pairs if on_card(ro) else lane_top_pairs_plain
    return fn(top_fields, ro, rd, tmax, active, num_top, S)
