"""Exact group-by-key regroup: slab sort (K4) + the scatter (E5, kernels in
``csrc/regroup.cu``), and their plain torch twins.

Counterpart of ``experiments/treelet/regroup.py`` (``scatter_runs``,
``counting_regroup``, ``block_regroup``). Pipeline for keys in [0, K):

  1. ``ops/slab_sort.py`` sorts each 2**16-key slab by key (K4).
  2. Per-slab per-key counts C[g, k] (a searchsorted on the sorted slabs);
     the global histogram H; per-key output regions; per-(slab, key)
     destination bases by an exclusive scan over slabs.
  3. The copy of each slab's key runs to their bases.

E5 has two entries. ``scatter_runs`` is the TPU kernel's function (step
3 on run lists that torch glue builds: ``block_runs``), used by
``counting_regroup``. ``regroup_blocks`` is the treelet path's whole
binning after K4 (steps 2 and 3 and ``block_regroup``'s block layout) in
three launches and no torch glue; its plain version,
``regroup_blocks_plain``, is the composition ``block_runs`` +
``scatter_runs_plain`` + ``block_layout``.

Neither copies past a run's end. The TPU kernel copies 256-element chunks
and lets the last chunk of a run spill up to 255 junk elements past its
end, which is safe there only because grid cells run in order, so a later
cell overwrites the spill. Blocks of a GPU grid run concurrently, and a
spill would race with another slab's copy. The output equals the
reference's inside every key region (``starts[k] .. starts[k] +
counts[k]``); outside them the reference leaves junk and the port zeros.
The region layout (with the reference's spill gaps) is kept, so
``starts`` and the block layout are the reference's.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._build import check_args, on_card
from ..ops.slab_sort import pack, sort_matrix

CHUNK = 256  # the reference's copy granule; also its per-key gap size


def scatter_runs_plain(data2, nruns, src, dst, lens, out_rows: int):
    """Plain torch twin of E5: ``out`` (out_rows,) int32, zero except the
    runs; run r < nruns[g] of slab g copies ``data2[g, src : src + len]``
    to ``out[dst : dst + len]``."""
    G, SP = data2.shape
    MAXR = src.shape[1]
    dev = data2.device
    out = torch.zeros(out_rows, dtype=torch.int32, device=dev)
    valid = (torch.arange(MAXR, device=dev)[None, :] < nruns[:, None])
    ln = torch.where(valid, lens, 0).reshape(-1).to(torch.int64)
    total = int(ln.sum())
    if total == 0:
        return out
    run = torch.repeat_interleave(torch.arange(G * MAXR, device=dev), ln)
    first = torch.cumsum(ln, 0) - ln
    off = torch.arange(total, device=dev) - first[run]
    g = run // MAXR
    s = src.reshape(-1).to(torch.int64)[run] + off
    d = dst.reshape(-1).to(torch.int64)[run] + off
    out[d] = data2.reshape(-1)[g * SP + s]
    return out


def _launch(data2, nruns, src, dst, lens, out_rows: int):
    G, SP = data2.shape
    MAXR = src.shape[1]
    dev = data2.device
    check_args(dev, (("data2", data2, torch.int32, None),
                     ("nruns", nruns, torch.int32, (G,)),
                     ("src", src, torch.int32, (G, MAXR)),
                     ("dst", dst, torch.int32, (G, MAXR)),
                     ("lens", lens, torch.int32, (G, MAXR))))
    out = torch.zeros(out_rows, dtype=torch.int32, device=dev)
    _build.launch("regroup", "scatter_runs", "6p4is", data2, nruns, src, dst,
                  lens, out, G, SP, MAXR, out_rows)
    return out


def scatter_runs(data2, nruns, src, dst, lens, out_rows: int):
    """E5 on CUDA tensors, the plain twin on CPU tensors. ``data2`` (G, SP)
    int32 slab rows; ``nruns`` (G,), ``src``/``dst``/``lens`` (G, MAXR)
    int32 (entries past nruns[g] ignored). Destinations must be disjoint
    and inside ``out_rows``."""
    fn = _launch if on_card(data2) else scatter_runs_plain
    return fn(data2, nruns, src, dst, lens, out_rows)


def _slab_counts(mat, K: int, c_log: int):
    """From K4's sorted (2, Rp) matrix (``ops/slab_sort.pack``: keys, then
    the payload): the payload's slab rows (G, slab), per-slab per-key
    counts C (G, K) and the run sources (G, K) inside each slab."""
    G, slab = mat.shape[1] >> c_log, 1 << c_log
    keys = mat[0].view(G, slab)
    # The tail slab's I32_MAX pads sort last and fall outside [0, K), so
    # searchsorted drops them from every bucket.
    edges = torch.arange(K + 1, dtype=torch.int32, device=mat.device)
    ss = torch.searchsorted(keys, edges.expand(G, K + 1).contiguous())
    C = (ss[:, 1:] - ss[:, :-1]).to(torch.int32)
    return mat[1].view(G, slab), C, ss[:, :-1].to(torch.int32)


def sort_pairs(key, payload, slab_log: int = 16):
    """K4 on the (2, Rp) matrix of (R,) int32 keys and payload; returns the
    sorted matrix and its c_log."""
    mat, c_log = pack(key, [payload], slab_log)
    return sort_matrix(mat, c_log), c_log


def _run_lists(C, starts):
    """Compacted per-slab run lists: nruns (G,) and, for ``_compact``, each
    run's column and the (G, K) destination bases (an exclusive scan over
    slabs from the key's region start). MAXR = K; the scatter kernel reads
    the first nruns[g] entries of row g."""
    G, K = C.shape
    dev = C.device
    cell_base = starts[None, :] + torch.cat(
        [torch.zeros((1, K), dtype=torch.int32, device=dev),
         torch.cumsum(C, 0, dtype=torch.int32)[:-1]], 0)
    present = C > 0
    nruns = present.sum(1, dtype=torch.int32)
    pos = torch.cumsum(present, 1) - 1
    pos = torch.where(present, pos, K)  # parked in column K, then dropped
    return nruns, pos, cell_base


def _compact(values, pos):
    G, K = values.shape
    out = torch.zeros((G, K + 1), dtype=torch.int32, device=values.device)
    out.scatter_(1, pos, values)
    return out[:, :K].contiguous()


def counting_regroup(key, payload, n_keys: int, slab_log: int = 16,
                     chunk: int = CHUNK):
    """Group ``payload`` (R,) int32 by ``key`` (R,) int32 in [0, n_keys).

    Returns (out, starts, counts): key k's payloads (grouped, not stably
    sorted) are ``out[starts[k] : starts[k] + counts[k]]``; the positions
    between regions are 0.
    """
    K = int(n_keys)
    dev = key.device
    mat, c_log = sort_pairs(key, payload, slab_log)
    pay3, C, src_all = _slab_counts(mat, K, c_log)
    H = C.sum(0, dtype=torch.int32)
    region = H + chunk
    starts = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(region, 0, dtype=torch.int32)[:-1]])
    nruns, pos, cell_base = _run_lists(C, starts)
    out_rows = mat.shape[1] + (K + 1) * chunk
    out = scatter_runs(pay3, nruns, _compact(src_all, pos),
                       _compact(cell_base, pos), _compact(C, pos), out_rows)
    return out, starts, H


def out_rows_of(R: int, n_keys: int, tile: int = 1024,
                chunk: int = CHUNK) -> int:
    """``block_regroup``'s static output size: sum(region) <= R +
    n_keys * (tile + chunk), plus a tile, in whole tiles."""
    return -(-(R + int(n_keys) * (tile + chunk) + tile) // tile) * tile


def block_runs(mat, c_log: int, R: int, n_keys: int, tile: int = 1024,
               chunk: int = CHUNK):
    """The glue between K4 and E5 of ``block_regroup``: from the sorted
    (key, ray) matrix of R pairs, E5's arguments ``(data2, nruns, src, dst,
    lens, out_rows)`` and the key regions ``(starts, counts)``. Regions are
    tile-aligned with the reference's >= ``chunk`` gap."""
    K = int(n_keys)
    dev = mat.device
    pay3, C, src_all = _slab_counts(mat, K, c_log)
    H = C.sum(0, dtype=torch.int32)
    region = (-(-(H + chunk) // tile) * tile).to(torch.int32)
    starts = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(region, 0, dtype=torch.int32)[:-1]])
    nruns, pos, cell_base = _run_lists(C, starts)
    # Static capacity: sum(region) <= R + K*(tile + chunk) <= out_rows.
    out_rows = out_rows_of(R, K, tile, chunk)
    args = (pay3, nruns, _compact(src_all, pos), _compact(cell_base, pos),
            _compact(C, pos), out_rows)
    return args, (starts, H)


def block_layout(out, starts, counts, R: int, tile: int = 1024):
    """The glue after E5 of ``block_regroup``: (ray_out, sid_blocks, on)
    from the scattered rays and the key regions."""
    K = starts.shape[0]
    dev = out.device
    B = out.shape[0] // tile
    block_start = torch.arange(B, dtype=torch.int32, device=dev) * tile
    sid_blocks = torch.clamp(
        torch.searchsorted(starts, block_start, right=True) - 1,
        0, K - 1).to(torch.int32)
    slot = torch.arange(out.shape[0], dtype=torch.int32, device=dev)
    sid_of_slot = torch.repeat_interleave(sid_blocks.to(torch.int64), tile)
    on = (slot - starts[sid_of_slot] < counts[sid_of_slot]).to(torch.int32)
    ray_out = torch.clamp(out, 0, max(R - 1, 0))
    return ray_out, sid_blocks, on


def _no_mark(stage: str) -> None:
    pass


def regroup_blocks_plain(mat, c_log: int, R: int, n_keys: int,
                         tile: int = 1024, chunk: int = CHUNK,
                         mark=_no_mark):
    """Plain twin of E5's path entry: ``block_runs``, ``scatter_runs_plain``
    and ``block_layout``. ``mark("binning")`` is called where the glue
    before the copy ends."""
    args, (starts, counts) = block_runs(mat, c_log, R, n_keys, tile, chunk)
    mark("binning")
    out = scatter_runs_plain(*args)
    return block_layout(out, starts, counts, R, tile)


def _launch_blocks(mat, c_log: int, R: int, n_keys: int, tile: int,
                   chunk: int, mark=_no_mark):
    K = int(n_keys)
    dev = mat.device
    G = mat.shape[-1] >> c_log
    check_args(dev, (("mat", mat, torch.int32, (2, G << c_log)),))
    if G <= 0 or K <= 0 or tile <= 0 or tile % 4:
        raise ValueError("regroup_blocks: need a slab of keys, n_keys > 0 "
                         "and a tile of a multiple of 4 slots")
    out_rows = out_rows_of(R, K, tile, chunk)
    B = out_rows // tile
    scratch = torch.empty(2 * (G + 1) * K, dtype=torch.int32, device=dev)
    first, pre, counts, starts = torch.split(scratch,
                                             [G * K, G * K, K, K])
    sid_blocks = torch.empty(B, dtype=torch.int32, device=dev)
    ray_out = torch.empty(out_rows, dtype=torch.int32, device=dev)
    on = torch.empty(out_rows, dtype=torch.int32, device=dev)
    mark("binning")
    made = ctypes.c_int(0)
    _build.launch("regroup", "regroup_blocks", "8p7isn", mat, first, pre,
                  counts, starts, sid_blocks, ray_out, on, G, K, c_log, tile,
                  chunk, B, R, ctypes.byref(made))
    _build.launches["regroup_blocks", "cuda_launches"] += made.value
    return ray_out, sid_blocks, on


def regroup_blocks(mat, c_log: int, R: int, n_keys: int, tile: int = 1024,
                   chunk: int = CHUNK, mark=_no_mark):
    """E5's path entry on a CUDA matrix, its plain twin on a CPU one: from
    K4's sorted (2, G << c_log) matrix of R (key, ray) pairs,
    ``block_regroup``'s (ray_out, sid_blocks, on). ``mark("binning")`` is
    called where the work before the kernels (on the card: allocation
    only) ends."""
    fn = _launch_blocks if on_card(mat) else regroup_blocks_plain
    return fn(mat, c_log, R, n_keys, tile, chunk, mark=mark)


def block_regroup(key, ray, n_keys: int, tile: int = 1024,
                  chunk: int = CHUNK, slab_log: int = 16, mark=_no_mark):
    """Group (key, ray) pairs into single-key blocks of ``tile`` pairs, the
    phase-2 layout: K4, then E5's path entry (``regroup_blocks``). Keys >=
    n_keys (the pipeline's dump key) are dropped. Every block holds pairs
    of one key; padding lanes carry on = 0. Returns (ray_out (B*tile,),
    sid_blocks (B,), on (B*tile,)) int32 with
    B = ceil((R + n_keys*(tile + chunk) + tile) / tile).

    ``mark(stage)`` is called as each stage ends ("K4", "binning", "E5"),
    for a caller that times them.
    """
    mat, c_log = sort_pairs(key, ray, slab_log)
    mark("K4")
    out = regroup_blocks(mat, c_log, key.shape[0], n_keys, tile, chunk,
                         mark=mark)
    mark("E5")
    return out
