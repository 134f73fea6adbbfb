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
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..ops.intersect import DeviceCounter, check_args, on_card
from ..ops.wide import _safe_inv
from .build import ID_MASK, PEND_CAP, TOP_ID_BITS

# Launches of E6 on the card; chip_smoke.py zeroes it before the main path
# and reads it after.
launches = 0

_capped = DeviceCounter()  # rays stopped by the step bound, per device


def capped_rays(device) -> int:
    """Rays that reached the step bound on ``device`` since the last
    ``reset_counters()``."""
    return _capped.read(device)


def reset_counters() -> None:
    global launches
    launches = 0
    _capped.reset()


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


def _launch(top_fields, ro, rd, tmax, active, num_top: int):
    dev = ro.device
    R = ro.shape[0]
    tab = top_fields.reshape(8, -1)
    check_args(dev, (("top_fields", tab, torch.float32, None),
                     ("ro", ro, torch.float32, (R, 3)),
                     ("rd", rd, torch.float32, (R, 3)),
                     ("tmax", tmax, torch.float32, (R,)),
                     ("active", active, torch.bool, (R,))))
    lib = _build.load("treelet_traverse")
    fn = lib.lane_top
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    pend = torch.empty((R, PEND_CAP), dtype=torch.int32, device=dev)
    npend = torch.empty(R, dtype=torch.int32, device=dev)
    err = fn(tab.data_ptr(), tab.shape[1], ro.data_ptr(), rd.data_ptr(),
             tmax.data_ptr(), active.data_ptr(), pend.data_ptr(),
             npend.data_ptr(), _capped.tensor(dev).data_ptr(), R,
             max_steps(num_top), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lane_top launch failed: CUDA error {err}")
    global launches
    launches += 1
    return pend, npend


def lane_top_trace(top_fields, ro, rd, tmax, active, num_top: int):
    """E6 on CUDA tensors, the plain twin on CPU tensors."""
    fn = _launch if on_card(ro) else lane_top_plain
    return fn(top_fields, ro, rd, tmax, active, num_top)
