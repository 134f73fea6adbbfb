"""The port's global bitonic sort (loupiote_tpu_torch/treelet/device_sort.py:
K4's network over one slab spanning the padded array; on the CPU its plain
twin slab_sort_plain) against the reference Pallas sort
(experiments/treelet/device_sort.py) in interpret mode, at the sizes of the
reference's own tests.

Tolerance: none. Both apply the same compare-exchange network with strict
compares, so keys and payload, the payload order among equal keys
included, are bit-equal, whatever the reference's chunk size.
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

from experiments.treelet.device_sort import (  # noqa: E402
    device_sort as ref_sort)
from loupiote_tpu_torch.experiments import device_sort_bench  # noqa: E402
from loupiote_tpu_torch.ops import slab_sort as ss  # noqa: E402
from loupiote_tpu_torch.treelet.device_sort import device_sort  # noqa: E402


def _check(keys, vals, chunk_log):
    rk, rv = ref_sort(jnp.asarray(keys),
                      None if vals is None else jnp.asarray(vals),
                      chunk_log=chunk_log, interpret=True)
    k, v = device_sort(torch.from_numpy(keys),
                       None if vals is None else torch.from_numpy(vals))
    assert k.dtype == v.dtype == torch.int32
    assert k.numpy().tobytes() == np.asarray(rk).tobytes()
    assert v.numpy().tobytes() == np.asarray(rv).tobytes()
    np.testing.assert_array_equal(k.numpy(), np.sort(keys))
    return k.numpy(), v.numpy()


@pytest.mark.parametrize("n,chunk_log", [
    (1024, 10),   # one chunk, exact power of two
    (4096, 10),   # cross-chunk merges
    (700, 10),    # padding
    (5000, 10),   # padding and several chunks
    (16384, 11),  # deeper merge
])
def test_device_sort_matches_reference(n, chunk_log):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 1 << 30, n, dtype=np.int32)
    vals = np.arange(n, dtype=np.int32)
    k, v = _check(keys, vals, chunk_log)
    np.testing.assert_array_equal(keys[v], k)  # payload rides with its key


def test_device_sort_duplicate_keys():
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 50, 3000, dtype=np.int32)
    k, v = _check(keys, np.arange(3000, dtype=np.int32), 10)
    assert sorted(v.tolist()) == list(range(3000))
    np.testing.assert_array_equal(keys[v], k)


def test_device_sort_keys_only():
    rng = np.random.default_rng(3)
    keys = rng.integers(-(1 << 20), 1 << 20, 2048).astype(np.int32)
    _, v = _check(keys, None, 10)
    assert not v.any()


def test_device_sort_sizes_and_inputs():
    """One slab of 2**max(bit_length(n - 1), 10) keys; the wave-scale bench
    sorts 2**23 keys in 13 CUDA launches; empty input and bad dtypes."""
    for n, c_log in ((1, 10), (1024, 10), (1025, 11), (700, 10)):
        mat, c = ss.pack(torch.zeros(n, dtype=torch.int32),
                         [torch.zeros(n, dtype=torch.int32)], slab_log=64)
        assert c == c_log and mat.shape == (2, 1 << c_log)
    assert ss.slab_log_of(8_388_608, 64) == 23
    assert ss.cuda_launches(23, 1) == 13
    keys_np, keys, vals = device_sort_bench.inputs(5000, "cpu")
    k, v = device_sort(keys, vals)
    np.testing.assert_array_equal(k.numpy(), np.sort(keys_np))
    lk, lv = device_sort_bench.library_sort(keys, vals)
    assert torch.equal(lk, k) and torch.equal(keys[lv.long()], lk)
    k, v = device_sort(torch.zeros(0, dtype=torch.int32))
    assert k.shape == v.shape == (0,)
    with pytest.raises(ValueError):
        device_sort(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        device_sort(torch.zeros(4, dtype=torch.int32),
                    torch.zeros(4, dtype=torch.float32))
