"""Slab-local bitonic sort carrying payload columns: kernel K4
(``csrc/slab_sort.cu``), its launch plan and its plain torch twin.

Counterpart of ``loupiote_tpu/ops/slab_sort.py`` (``slab_sort``, the
Pallas ``_slab_kernel``). The keys are sorted ascending within each slab
of ``2**c_log`` keys, ``c_log = min(slab_log, max(bit_length(R - 1), 10))``,
by the reference's network: stages ``k = 1..c_log``, within each
``j = k-1..0``; partner ``i ^ (1 << j)``; ascending where bit ``k`` of the
in-slab index is clear; strict compares, so equal keys never swap; every
payload column follows the key's swap. Kernel, twin and reference apply
the same network, so keys and the payload order among equal keys agree
bit for bit. The tail slab is padded with ``I32_MAX`` keys.

Only the schedule is the card's own. ``launch_plan`` cuts the network
into CUDA launches, and the kernel runs that plan as given: a thread-block
cluster holds ``2**span_log`` keys (every row) in its blocks' shared
memory, so a slab of up to that size is sorted in one launch and one
round trip through device memory, as the TPU kernel sorts a slab in VMEM;
the stages of a larger slab whose partner lies beyond a cluster run as
passes over device memory, up to ``global_stages`` stages a pass.

Keys: int32, or uint32 values held in int64 (``ops/sort.py``), mapped to
int32 order by subtracting 2**31 (the reference's sign-bit flip).
Payload columns: int32, float32 (bitcast) and bool (through int32, back
with ``!= 0``); up to ``MAX_PAYLOAD`` of them.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._build import on_card

I32_MAX = 2**31 - 1
MAX_PAYLOAD = 4  # csrc/slab_sort.cu: kMaxPayload
# The H100's limits that size the plan (csrc/slab_sort.cu: kSmemBytes,
# kClusterLog): the shared memory one block may use (227 KB), and 8 blocks,
# the largest portable cluster. A cluster holds 8 blocks' worth of keys.
SMEM_BYTES = 232_448
CLUSTER_LOG = 3
# Data registers a thread of a global pass may hold (half of the 255 a
# thread may use; csrc/slab_sort.cu: global_stages).
PASS_REGISTERS = 128


def slab_log_of(n: int, slab_log: int = 16) -> int:
    """The slab's log2 size for ``n`` keys, as the reference computes it."""
    return min(slab_log, max((n - 1).bit_length(), 10))


def block_log_max(n_payload: int) -> int:
    """The most keys one block holds, log2: the largest power of two whose
    ``(1 + n_payload)`` int32 rows fit ``SMEM_BYTES``."""
    return (SMEM_BYTES // (4 * (1 + n_payload))).bit_length() - 1


def global_stages(n_payload: int) -> int:
    """Stages one pass over device memory applies in registers, at most:
    each thread holds ``2**m`` keys and their payloads, at most
    ``PASS_REGISTERS`` values (6 at one payload, 4 at four)."""
    return (PASS_REGISTERS // (1 + n_payload)).bit_length() - 1


def span_log_of(n_payload: int) -> int:
    """Keys one cluster holds on chip, log2: 2**17 at one or two payload
    rows, 2**16 at three or four."""
    return block_log_max(n_payload) + CLUSTER_LOG


def launch_plan(c_log: int, n_payload: int, span_log: int | None = None):
    """The ordered CUDA launches of one sort of slabs of ``2**c_log`` keys.

    ``("cluster", k_lo, k_hi, j_top)``: one cluster launch for the stages
    ``k = k_lo..k_hi``, ``j = min(k - 1, j_top)..0``, every partner within
    the cluster's ``2**span`` keys (``span = min(span_log, c_log)``).
    ``("global", k, j_hi, j_lo)``: one pass over device memory for the
    stages ``j = j_hi..j_lo`` of level ``k``, at most ``global_stages`` of
    them, each with ``d = 2**j >= 2**span``. Applied in order, the steps
    run the network's stages in its order, each once."""
    if not 0 <= n_payload <= MAX_PAYLOAD:
        raise ValueError(f"slab_sort carries at most {MAX_PAYLOAD} payload "
                         f"columns, got {n_payload}")
    span = min(c_log, span_log_of(n_payload) if span_log is None
               else span_log)
    plan = [("cluster", 1, span, span - 1)]
    for k in range(span + 1, c_log + 1):
        j = k - 1
        while j >= span:
            lo = max(span, j - global_stages(n_payload) + 1)
            plan.append(("global", k, j, lo))
            j = lo - 1
        plan.append(("cluster", k, k, span - 1))
    return plan


def cuda_launches(c_log: int, n_payload: int) -> int:
    """CUDA launches one sort makes: one a step of its plan."""
    return len(launch_plan(c_log, n_payload))


def plain_stage(mat: torch.Tensor, c_log: int, k: int, j: int) -> None:
    """Stage (k, j) of the network on a (1 + n_payload, Rp) int32 matrix,
    in place; vectorised over all pairs of the stage."""
    rows, n = mat.shape
    d = 1 << j
    v = mat.view(rows, n // (2 * d), 2, d)
    lo, hi = v[:, :, 0, :].clone(), v[:, :, 1, :].clone()
    # Pair block a holds in-slab indices with bit k = bit (k - j - 1) of a;
    # at k == c_log the whole slab ascends.
    if k == c_log:
        asc = torch.ones((n // (2 * d), 1), dtype=torch.bool,
                         device=mat.device)
    else:
        a = torch.arange(n // (2 * d), device=mat.device)[:, None]
        asc = ((a >> (k - j - 1)) & 1) == 0
    swap = torch.where(asc, hi[0] < lo[0], lo[0] < hi[0])
    v[:, :, 0, :] = torch.where(swap, hi, lo)
    v[:, :, 1, :] = torch.where(swap, lo, hi)


def slab_sort_plain(mat: torch.Tensor, c_log: int) -> torch.Tensor:
    """The network on a (1 + n_payload, Rp) int32 matrix (row 0 the keys,
    Rp a multiple of the slab), in place; vectorised over all pairs of a
    stage. Returns ``mat``."""
    for k in range(1, c_log + 1):
        for j in range(k - 1, -1, -1):
            plain_stage(mat, c_log, k, j)
    return mat


def _shape(c_log: int, n_payload: int):
    """(span, b): keys a cluster and a block hold, log2. A cluster has as
    many blocks as it may (8 blocks of 2**13 keys measured faster than 4 of
    2**14 at the treelet shape), each of at least 2**10 keys (32 lanes of
    32 registers) and at most what its shared memory holds."""
    span = min(c_log, span_log_of(n_payload))
    return span, min(block_log_max(n_payload),
                     max(span - CLUSTER_LOG, min(span, 10)))


def max_active_clusters(c_log: int, n_payload: int) -> int:
    """``cudaOccupancyMaxActiveClusters`` for the cluster launch of a sort
    of ``2**c_log``-key slabs on the current card."""
    out = ctypes.c_int(0)
    _build.call("slab_sort", "slab_sort_max_clusters", "3in", n_payload,
                *_shape(c_log, n_payload), ctypes.byref(out),
                what="slab_sort occupancy query")
    return out.value


def _run_plan(mat: torch.Tensor, c_log: int, plan) -> None:
    """Launch the steps of ``plan`` on a CUDA matrix, in place, through the
    C entry point, counted with the CUDA launches it made. Raises on a
    refused launch."""
    rows, n = mat.shape
    if mat.dtype != torch.int32 or not mat.is_contiguous():
        raise ValueError("slab_sort: need a contiguous int32 matrix")
    if mat.data_ptr() % 16:
        raise ValueError("slab_sort: the matrix must be 16-byte aligned")
    codes = [x for step in plan
             for x in ((0 if step[0] == "cluster" else 1), *step[1:])]
    made = ctypes.c_int(0)
    _build.launch("slab_sort", "slab_sort", "pi q 3i n i s n", mat, rows - 1,
                  n, c_log, *_shape(c_log, rows - 1),
                  (ctypes.c_int * len(codes))(*codes), len(plan),
                  ctypes.byref(made))
    _build.launches["slab_sort", "cuda_launches"] += made.value


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
    """K4 on a CUDA matrix (its launch plan), the plain twin on a CPU
    matrix; in place."""
    if not mat.shape[1]:
        return mat
    if on_card(mat):
        _run_plan(mat, c_log, launch_plan(c_log, mat.shape[0] - 1))
    else:
        slab_sort_plain(mat, c_log)
    return mat


def slab_sort(key: torch.Tensor, payload: list, slab_log: int = 16):
    """Sort ``key`` (R,) ascending within each slab, applying the same
    permutation to every (R,) column of ``payload``. Returns
    ``(key_sorted, [payload_sorted...])`` in the original dtypes. K4 on
    CUDA tensors, the plain twin on CPU tensors."""
    mat, c_log = pack(key, payload, slab_log)
    return unpack(sort_matrix(mat, c_log), key, payload)
