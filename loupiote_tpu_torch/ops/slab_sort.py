"""Slab-local bitonic sort carrying payload columns: kernel K4
(``csrc/slab_sort.cu``) and its plain torch twin.

Counterpart of ``loupiote_tpu/ops/slab_sort.py`` (``slab_sort``, the
Pallas ``_slab_kernel``). The keys are sorted ascending within each slab
of ``2**c_log`` keys, ``c_log = min(slab_log, max(bit_length(R - 1), 10))``,
by the reference's network: stages ``k = 1..c_log``, within each
``j = k-1..0``; partner ``i ^ (1 << j)``; ascending where bit ``k`` of the
in-slab index is clear; strict compares, so equal keys never swap; every
payload column follows the key's swap. Kernel, twin and reference apply
the same network, so keys and the payload order among equal keys agree
bit for bit. The tail slab is padded with ``I32_MAX`` keys.

Keys: int32, or uint32 values held in int64 (``ops/sort.py``), mapped to
int32 order by subtracting 2**31 (the reference's sign-bit flip).
Payload columns: int32, float32 (bitcast) and bool (through int32, back
with ``!= 0``); up to ``MAX_PAYLOAD`` of them.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .intersect import on_card

I32_MAX = 2**31 - 1
MAX_PAYLOAD = 4  # csrc/slab_sort.cu: kMaxPayload
CHUNK_LOG = 12  # csrc/slab_sort.cu: stages with d < 4096 run in shared memory

# Sorts launched on the card (each issues csrc/slab_sort.cu's sequence of
# CUDA launches). chip_smoke.py zeroes it before the main path and reads it
# after.
launches = 0


def reset_counters() -> None:
    global launches
    launches = 0


def slab_log_of(n: int, slab_log: int = 16) -> int:
    """The slab's log2 size for ``n`` keys, as the reference computes it."""
    return min(slab_log, max((n - 1).bit_length(), 10))


def cuda_launches(c_log: int) -> int:
    """CUDA launches one sort issues: one shared-memory launch for the
    stages k <= CHUNK_LOG, then for each k > CHUNK_LOG one global pass per
    d >= 2**CHUNK_LOG and one shared-memory launch for the rest."""
    cl = min(CHUNK_LOG, c_log)
    return 1 + sum(k - cl + 1 for k in range(cl + 1, c_log + 1))


def _stages(c_log: int):
    for k in range(1, c_log + 1):
        for j in range(k - 1, -1, -1):
            yield k, j


def slab_sort_plain(mat: torch.Tensor, c_log: int) -> torch.Tensor:
    """The network on a (1 + n_payload, Rp) int32 matrix (row 0 the keys,
    Rp a multiple of the slab), in place; vectorised over all pairs of a
    stage. Returns ``mat``."""
    rows, n = mat.shape
    for k, j in _stages(c_log):
        d = 1 << j
        v = mat.view(rows, n // (2 * d), 2, d)
        lo, hi = v[:, :, 0, :].clone(), v[:, :, 1, :].clone()
        # Pair block a holds in-slab indices with bit k = bit (k - j - 1)
        # of a; at k == c_log the whole slab ascends.
        if k == c_log:
            asc = torch.ones((n // (2 * d), 1), dtype=torch.bool,
                             device=mat.device)
        else:
            a = torch.arange(n // (2 * d), device=mat.device)[:, None]
            asc = ((a >> (k - j - 1)) & 1) == 0
        swap = torch.where(asc, hi[0] < lo[0], lo[0] < hi[0])
        v[:, :, 0, :] = torch.where(swap, hi, lo)
        v[:, :, 1, :] = torch.where(swap, lo, hi)
    return mat


def _launch(mat: torch.Tensor, c_log: int) -> torch.Tensor:
    rows, n = mat.shape
    if rows - 1 > MAX_PAYLOAD:
        raise ValueError(f"slab_sort carries at most {MAX_PAYLOAD} payload "
                         f"columns, got {rows - 1}")
    if mat.dtype != torch.int32 or not mat.is_contiguous():
        raise ValueError("slab_sort: need a contiguous int32 matrix")
    lib = _build.load("slab_sort")
    fn = lib.slab_sort
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    err = fn(mat.data_ptr(), rows - 1, n, c_log,
             torch.cuda.current_stream(mat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"slab_sort launch failed: CUDA error {err}")
    global launches
    launches += 1
    return mat


def pack(key: torch.Tensor, payload: list, slab_log: int = 16):
    """The (1 + len(payload), Rp) int32 matrix the network sorts, and its
    c_log: the keys in int32 order padded with I32_MAX, each payload column
    as int32 bits padded with 0."""
    R = key.shape[0]
    dev = key.device
    c_log = slab_log_of(R, slab_log)
    slab = 1 << c_log
    Rp = -(-R // slab) * slab
    if key.dtype == torch.int64:  # uint32 values
        k32 = (key - 2**31).to(torch.int32)
    elif key.dtype == torch.int32:
        k32 = key
    else:
        raise ValueError(f"slab_sort: keys must be int32 or uint32 values "
                         f"in int64, got {key.dtype}")
    mat = torch.zeros((1 + len(payload), Rp), dtype=torch.int32, device=dev)
    mat[0, R:] = I32_MAX
    mat[0, :R] = k32
    for i, col in enumerate(payload):
        if col.shape != (R,) or col.device != dev:
            raise ValueError("slab_sort: payload columns must be (R,) on "
                             "the key's device")
        if col.dtype == torch.bool or col.dtype == torch.int32:
            mat[1 + i, :R] = col.to(torch.int32)
        elif col.dtype == torch.float32:
            mat[1 + i, :R] = col.view(torch.int32)
        else:
            raise ValueError(f"slab_sort: payload dtype {col.dtype}")
    return mat, c_log


def unpack(mat: torch.Tensor, key: torch.Tensor, payload: list):
    """The sorted matrix back as (key, [columns]) in the input dtypes."""
    R = key.shape[0]
    ks = mat[0, :R]
    ks = ks.to(torch.int64) + 2**31 if key.dtype == torch.int64 else ks.clone()
    out = []
    for i, col in enumerate(payload):
        flat = mat[1 + i, :R]
        if col.dtype == torch.int32:
            out.append(flat.clone())
        elif col.dtype == torch.bool:
            out.append(flat != 0)
        else:
            out.append(flat.clone().view(torch.float32))
    return ks, out


def sort_matrix(mat: torch.Tensor, c_log: int) -> torch.Tensor:
    """K4 on a CUDA matrix, the plain twin on a CPU matrix; in place."""
    if mat.shape[1]:
        (_launch if on_card(mat) else slab_sort_plain)(mat, c_log)
    return mat


def slab_sort(key: torch.Tensor, payload: list, slab_log: int = 16):
    """Sort ``key`` (R,) ascending within each slab, applying the same
    permutation to every (R,) column of ``payload``. Returns
    ``(key_sorted, [payload_sorted...])`` in the original dtypes. K4 on
    CUDA tensors, the plain twin on CPU tensors."""
    mat, c_log = pack(key, payload, slab_log)
    return unpack(sort_matrix(mat, c_log), key, payload)
