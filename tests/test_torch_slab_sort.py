"""The port's slab sort (loupiote_tpu_torch/ops/slab_sort.py; on the CPU its
plain twin slab_sort_plain) against the reference Pallas kernel
(loupiote_tpu/ops/slab_sort.py) in interpret mode.

Tolerance: none. Kernel, twin and reference apply the same compare-exchange
network with strict compares, so keys and every payload column, including
the payload order among equal keys, are exactly equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import jax.numpy as jnp  # noqa: E402

from loupiote_tpu.ops.slab_sort import slab_sort as ref_slab_sort  # noqa: E402
from loupiote_tpu_torch.ops import slab_sort as port  # noqa: E402
from loupiote_tpu_torch.ops.sort import DEAD_KEY  # noqa: E402


def _inputs(case):
    """The three inputs of tests/test_slab_sort.py: (keys, payload columns)
    as numpy arrays."""
    if case == "unique_tail":
        rng = np.random.default_rng(1)
        R = 3000  # not a multiple of the slab: exercises the tail padding
        keys = rng.permutation(R).astype(np.int32)
        return keys, [rng.random(R).astype(np.float32),
                      rng.integers(0, 1 << 30, R).astype(np.int32)]
    if case == "duplicates":
        rng = np.random.default_rng(2)
        R = 2048
        return (rng.integers(0, 7, R).astype(np.int32),
                [np.arange(R, dtype=np.int32)])
    rng = np.random.default_rng(3)
    R = 1024
    keys = rng.integers(0, 1 << 30, R).astype(np.uint32)
    dead = rng.random(R) < 0.3
    keys[dead] = np.uint32(DEAD_KEY)
    return keys, [~dead]


def _port_args(keys, cols):
    k = torch.from_numpy(keys.astype(np.int64) if keys.dtype == np.uint32
                         else keys)
    return k, [torch.from_numpy(c) for c in cols]


@pytest.mark.parametrize("case", ["unique_tail", "duplicates", "uint32_dead"])
def test_slab_sort_matches_reference_exactly(case):
    keys, cols = _inputs(case)
    ref_k, ref_cols = ref_slab_sort(jnp.asarray(keys),
                                    [jnp.asarray(c) for c in cols],
                                    slab_log=10, interpret=True)
    k, out = port.slab_sort(*_port_args(keys, cols), slab_log=10)
    ref_k = np.asarray(ref_k)
    if keys.dtype == np.uint32:
        assert k.dtype == torch.int64
        np.testing.assert_array_equal(k.numpy(), ref_k.astype(np.int64))
    else:
        assert k.dtype == torch.int32
        np.testing.assert_array_equal(k.numpy(), ref_k)
    for c, o, r in zip(cols, out, ref_cols):
        r = np.asarray(r)
        assert o.numpy().dtype == c.dtype == r.dtype
        assert o.numpy().tobytes() == r.tobytes()


def test_slab_sort_sorts_each_slab_and_keeps_pairs():
    """Ascending within every slab, the (key, payload) multiset of each
    slab kept; equal keys are grouped, not stably ordered."""
    rng = np.random.default_rng(9)
    R, slab = 5000, 1024
    keys = rng.integers(0, 40, R).astype(np.int32)
    pay = np.arange(R, dtype=np.int32)
    k, (p,) = port.slab_sort(torch.from_numpy(keys), [torch.from_numpy(pay)],
                             slab_log=10)
    k, p = k.numpy(), p.numpy()
    for s in range(0, R, slab):
        e = min(s + slab, R)
        assert (np.diff(k[s:e]) >= 0).all()
        assert sorted(zip(keys[s:e], pay[s:e])) == sorted(zip(k[s:e], p[s:e]))


def test_slab_size_and_launch_count():
    """The slab follows the reference (2**16, or less for short inputs, at
    least 2**10); the kernel's launches per sort follow from it."""
    assert port.slab_log_of(8_294_400) == 16
    assert port.slab_log_of(3000, slab_log=10) == 10
    assert port.slab_log_of(100) == 10
    assert port.slab_log_of(40_000) == 16
    assert port.cuda_launches(16) == 15
    assert port.cuda_launches(12) == 1
    assert port.cuda_launches(10) == 1


def test_slab_sort_empty_and_bad_inputs():
    k, (p,) = port.slab_sort(torch.zeros(0, dtype=torch.int32),
                             [torch.zeros(0, dtype=torch.float32)])
    assert k.shape == (0,) and p.shape == (0,) and p.dtype == torch.float32
    with pytest.raises(ValueError):
        port.slab_sort(torch.zeros(4, dtype=torch.float32), [])
    with pytest.raises(ValueError):
        port.slab_sort(torch.zeros(4, dtype=torch.int32),
                       [torch.zeros(4, dtype=torch.float64)])
