"""The port's slab sort (loupiote_tpu_torch/ops/slab_sort.py; on the CPU its
plain twin slab_sort_plain) against the reference Pallas kernel
(loupiote_tpu/ops/slab_sort.py) in interpret mode.

Tolerance: none. Kernel, twin and reference apply the same compare-exchange
network with strict compares, so keys and every payload column, including
the payload order among equal keys, are exactly equal. The launch plan the
kernel runs is checked here too: it covers the network's stages in order,
and replayed stage by stage it equals the reference.
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
    least 2**10); the kernel's launches per sort follow from it and the
    payload count: one cluster launch whenever the slab fits a cluster."""
    assert port.slab_log_of(8_294_400) == 16
    assert port.slab_log_of(3000, slab_log=10) == 10
    assert port.slab_log_of(100) == 10
    assert port.slab_log_of(40_000) == 16
    assert [port.span_log_of(p) for p in range(5)] == [18, 17, 17, 16, 16]
    # Clusters of 8 blocks where shared memory allows: 8 x 2^13 keys for
    # the treelet path, 8 x 2^14 for E4.
    assert port._shape(16, 1) == (16, 13)
    assert port._shape(23, 1) == (17, 14)
    assert port._shape(10, 1) == (10, 10)
    # Keys only: 8 x 2^15 keys; four payloads: 8 x 2^13 keys.
    assert port._shape(20, 0) == (18, 15)
    assert port._shape(20, 4) == (16, 13)
    assert port.cuda_launches(16, 1) == 1
    assert port.cuda_launches(16, 4) == 1
    assert port.cuda_launches(12, 1) == 1
    assert port.cuda_launches(10, 1) == 1
    assert [port.global_stages(p) for p in range(5)] == [7, 6, 5, 5, 4]
    assert port.cuda_launches(17, 4) == 3
    assert port.cuda_launches(20, 2) == 7
    assert port.cuda_launches(23, 1) == 13


def _flatten(plan):
    """The (k, j) stages a launch plan applies, in its order."""
    for step in plan:
        if step[0] == "cluster":
            _, k_lo, k_hi, j_top = step
            for k in range(k_lo, k_hi + 1):
                for j in range(min(k - 1, j_top), -1, -1):
                    yield k, j
        else:
            _, k, j_hi, j_lo = step
            for j in range(j_hi, j_lo - 1, -1):
                yield k, j


@pytest.mark.parametrize("span_log", [None, 10, 12])
@pytest.mark.parametrize("n_payload", [0, 1, 4])
@pytest.mark.parametrize("c_log", [10, 12, 16, 17, 20, 23])
def test_launch_plan_covers_the_network(c_log, n_payload, span_log):
    """The plan's steps apply the network's stages in its order, each once;
    a cluster step's partners lie within 2**span keys, a global pass holds
    at most global_stages stages, each with d >= 2**span."""
    plan = port.launch_plan(c_log, n_payload, span_log)
    network = [(k, j) for k in range(1, c_log + 1)
               for j in range(k - 1, -1, -1)]
    assert list(_flatten(plan)) == network
    span = min(c_log, port.span_log_of(n_payload) if span_log is None
               else span_log)
    assert plan[0] == ("cluster", 1, span, span - 1)
    for step in plan:
        if step[0] == "cluster":
            _, k_lo, k_hi, j_top = step
            assert 1 <= k_lo <= k_hi <= c_log and 0 <= j_top < span
        else:
            assert step[0] == "global"
            _, k, j_hi, j_lo = step
            assert span <= j_lo <= j_hi < k <= c_log
            assert j_hi - j_lo + 1 <= port.global_stages(n_payload)
    if span_log is None:
        assert port.cuda_launches(c_log, n_payload) == len(plan)


@pytest.mark.parametrize("R,n_payload,slab_log", [
    (8192, 1, 13), (12_000, 2, 14), (16_384, 0, 14)])
def test_plan_replay_matches_reference(R, n_payload, slab_log):
    """A plan with a 2**10-key span, so that global passes and cluster
    tails both occur, replayed step by step with the twin's stage function,
    equals the reference kernel byte for byte, the order of ties
    included."""
    rng = np.random.default_rng(R)
    keys = rng.integers(0, 40, R).astype(np.int32)
    cols = [rng.integers(-(1 << 31), (1 << 31) - 1, R).astype(np.int32)
            for _ in range(n_payload)]
    ref_k, ref_cols = ref_slab_sort(jnp.asarray(keys),
                                    [jnp.asarray(c) for c in cols],
                                    slab_log=slab_log, interpret=True)
    key, tcols = _port_args(keys, cols)
    mat, c_log = port.pack(key, tcols, slab_log)
    assert c_log == slab_log
    plan = port.launch_plan(c_log, n_payload, span_log=10)
    assert [s[0] for s in plan].count("global") >= 3
    assert any(s[2] > s[3] for s in plan if s[0] == "global")
    assert ("cluster", c_log, c_log, 9) in plan
    for step in plan:
        for k, j in _flatten([step]):
            port.plain_stage(mat, c_log, k, j)
    k, out = port.unpack(mat, key, tcols)
    assert k.numpy().tobytes() == np.asarray(ref_k).tobytes()
    for o, r in zip(out, ref_cols):
        assert o.numpy().tobytes() == np.asarray(r).tobytes()


def test_slab_sort_empty_and_bad_inputs():
    k, (p,) = port.slab_sort(torch.zeros(0, dtype=torch.int32),
                             [torch.zeros(0, dtype=torch.float32)])
    assert k.shape == (0,) and p.shape == (0,) and p.dtype == torch.float32
    with pytest.raises(ValueError):
        port.slab_sort(torch.zeros(4, dtype=torch.float32), [])
    with pytest.raises(ValueError):
        port.slab_sort(torch.zeros(4, dtype=torch.int32),
                       [torch.zeros(4, dtype=torch.float64)])
