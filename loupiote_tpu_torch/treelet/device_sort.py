"""E4: the global bitonic sort of int32 (key, payload) pairs (counterpart of
``experiments/treelet/device_sort.py``: ``device_sort``, the Pallas
``_chunk_sort_kernel``, ``_cross_kernel`` and ``_descent_kernel``).

The reference's network is K4's network with one slab spanning the padded
array: its chunk sort, cross stages and descents are the same stages, and
the direction of a pair is global bit ``k`` of its index in both. So
``device_sort`` runs ``ops/slab_sort.py`` on one slab of ``2**n_log`` keys
(K4, ``csrc/slab_sort.cu``, on CUDA tensors; its plain twin on CPU
tensors), and keys and payload agree bit for bit with the reference. K4's
``launch_plan`` schedules the slab: cluster launches for the stages whose
partner lies within a cluster's keys, passes over device memory of up to
``global_stages`` stages for the rest (13 launches at 2**23 keys). The
reference's ``chunk_log`` and ``interpret`` sized its TPU VMEM chunk and
change no result; they are not ported.

The reference measured this network slower than XLA's sort on a TPU and
kept ``lax.sort`` in production; the port's treelet path does not call it
either. ``experiments/device_sort_bench.py`` times it against
``torch.sort``.
"""

from __future__ import annotations

import torch

from ..ops import slab_sort as ss

I32_MAX = ss.I32_MAX


def device_sort(keys: torch.Tensor, vals: torch.Tensor | None = None):
    """Ascending sort of int32 ``keys`` (R,) with an optional int32 payload
    ``vals`` (zeros when None). Keys must be below ``I32_MAX``, the padding
    sentinel. Not stable. Returns ``(sorted keys, permuted vals)``."""
    if keys.dtype != torch.int32:
        raise ValueError(f"device_sort: keys must be int32, got {keys.dtype}")
    if vals is None:
        vals = torch.zeros_like(keys)
    if vals.dtype != torch.int32:
        raise ValueError(f"device_sort: vals must be int32, got {vals.dtype}")
    # A slab_log above any array's: one slab of 2**max(bit_length(n - 1),
    # 10) keys, padded with I32_MAX as the reference pads.
    mat, c_log = ss.pack(keys, [vals], slab_log=64)
    ks, (vs,) = ss.unpack(ss.sort_matrix(mat, c_log), keys, [vals])
    return ks, vs
