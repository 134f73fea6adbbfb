"""The port's probe kernels E1-E3 (loupiote_tpu_torch/experiments/; on the
CPU their plain twins) against the reference's Pallas kernels run in TPU
interpret mode, unmodified, on the same inputs.

E1 (kernel_probe): build_arch_scene(2_000), two (8, 128) blocks of the
sorted diffuse wave of a 128x16 image of the arch camera, all five
variants (nofetch bounded at 100 steps in both). The reference probe
predates the LEAF_TAG bit on leaf pointers (fault R7), so it runs on the
table with the tag cleared and the port on the table as built.
Tolerances: tri equal except where two triangles tie within 2 ulp along
the ray; t within 1e-5 relative and u, v within 1e-5 absolute of the
reference, whose XLA:CPU code contracts multiply-adds; the port's t
within 2 ulp and u, v within 1e-5 of the unfused Moller-Trumbore in
numpy float32 (as in test_torch_wide.py).

E2 (lane_gather_bench): exact in practice, held to 1e-6 relative. E3
(r3_probes): within 1e-6 relative and at least 99% of the elements
bit-equal. XLA:CPU contracts the reference's ``x + acc * c`` into a fused
multiply-add where the port (and its kernel, built with --fmad=false)
rounds twice: measured, 1 ulp on 1 of 1,024 elements of seggather after
12 steps, none elsewhere; mxu's dot may also sum in another order.
"""

import os
import sys

import numpy as np
import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
# kernel_probe.py imports measure_traversal as a top-level module.
_EXP = os.path.join(_ROOT, "experiments")
if _EXP not in sys.path:
    sys.path.append(_EXP)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import kernel_probe as ref_kp  # noqa: E402
import lane_gather_bench as ref_lg  # noqa: E402
import r3_probes as ref_r3  # noqa: E402
from loupiote_tpu_torch.accel.wide import LEAF_TAG  # noqa: E402
from loupiote_tpu_torch.experiments import (  # noqa: E402
    device_sort_bench, kernel_probe as kp, lane_gather_bench as lg,
    measure_traversal as mt, r3_probes as r3)
from loupiote_tpu_torch.ops import wide  # noqa: E402
from loupiote_tpu_torch.ops.intersect import intersect_any  # noqa: E402
from torch_port_helpers import assert_same_hits, t_of  # noqa: E402

W, H = 128, 16  # two (8, 128) blocks
NOFETCH_STEPS = 100


@pytest.fixture(scope="module")
def arch():
    bufs, cam = mt.build("cpu", 2_000)
    dro, drd, alive = kp.sorted_diffuse_wave(bufs, cam, W, H)
    return bufs, (dro, drd, alive), kp.probe_args(bufs, dro, drd, alive)


def _untagged(trav_rows):
    """The table with LEAF_TAG cleared from internal rows' child pointers:
    what the reference probe was written against."""
    rows = trav_rows.numpy().copy()
    ri = rows.view(np.int32)
    internal = ri[:, 127] == 0
    for c in range(8):
        col = ri[:, 16 * c + 6]
        m = internal & (col >= 0)
        col[m] &= ~np.int32(LEAF_TAG)
    return rows


def _kwargs(bufs, probe):
    kw = kp.probe_kwargs(bufs, probe)
    if probe == "nofetch":
        kw["max_steps"] = NOFETCH_STEPS
    return kw


def _ref_probe(rows, args, kw):
    with pltpu.force_tpu_interpret_mode():
        out = ref_kp.probe_trace(jnp.asarray(rows),
                                 *(jnp.asarray(a.numpy()) for a in args[1:]),
                                 **kw)
        return [np.asarray(x).reshape(-1) for x in out]


@pytest.mark.parametrize("probe", kp.PROBES)
def test_probe_matches_reference(arch, probe):
    bufs, (dro, drd, _), args = arch
    kw = _kwargs(bufs, probe)
    kp.reset_counters()
    t, u, v, tri, steps = kp.probe_trace(*args, **kw)
    dropped = kp.dropped_pushes("cpu")
    rt, ru, rv, rtri = _ref_probe(_untagged(bufs.trav_rows), args, kw)
    t, u, v, tri = (x.numpy().reshape(-1) for x in (t, u, v, tri))
    ro, rd = dro.numpy(), drd.numpy()
    tp = bufs.tri_pack.numpy()
    same = assert_same_hits(tp, ro, rd, rtri, tri)
    np.testing.assert_allclose(t[same], rt[same], rtol=1e-5)
    np.testing.assert_allclose(u[same], ru[same], atol=1e-5)
    np.testing.assert_allclose(v[same], rv[same], atol=1e-5)
    hit = tri >= 0
    eu, ev, et = t_of(tp, ro, rd, tri)
    np.testing.assert_array_max_ulp(t[hit], et[hit], maxulp=2)
    np.testing.assert_allclose(u[hit], eu[hit], atol=1e-5)
    np.testing.assert_allclose(v[hit], ev[hit], atol=1e-5)
    assert steps.shape == (args[1].shape[0], 8)
    if probe == "nofetch":
        # Row 0 every step: the same children pushed until the stack is
        # full, then dropped; every live packet runs the whole bound.
        assert dropped > 0
        assert int(steps.max()) == NOFETCH_STEPS
        assert not hit.any()
    else:
        assert dropped == 0
    if probe in ("full", "noorder"):
        assert hit.mean() > 0.3  # closest hits of a diffuse wave
    if probe == "nomt":
        assert not hit.any()


def test_full_probe_equals_k1_twin(arch):
    """The full probe's closest hits are K1's (wide_trace_plain) on the
    same rays: tri equal except ties, t bit-equal where tri is."""
    bufs, (dro, drd, alive), args = arch
    t, _, _, tri, _ = kp.probe_trace(*args, **kp.probe_kwargs(bufs, "full"))
    tmax = torch.full((dro.shape[0],), 1e30)
    kt, ktri = wide.wide_trace_plain(bufs.trav_rows, dro, drd, tmax, alive,
                                     False, bufs.wide_end, bufs.wide_stack)
    t, tri = t.reshape(-1).numpy(), tri.reshape(-1).numpy()
    same = assert_same_hits(bufs.tri_pack.numpy(), dro.numpy(), drd.numpy(),
                            ktri.numpy(), tri)
    assert same.mean() > 0.99
    np.testing.assert_array_equal(t[same], kt.numpy()[same])


def test_reference_probe_misses_on_the_tagged_table(arch):
    """Fault R7: the reference probe follows a LEAF_TAG pointer past the
    table's end and returns no hit on the table as built; the port masks
    the tag and finds the closest hits."""
    bufs, _, args = arch
    kw = kp.probe_kwargs(bufs, "full")
    rtri = _ref_probe(bufs.trav_rows.numpy(), args, kw)[3]
    assert (rtri < 0).all()
    assert (kp.probe_trace(*args, **kw)[3] >= 0).any()


def test_make_waves_builds_the_diffuse_wave(arch):
    bufs, _, _ = arch
    cam = torch.from_numpy(mt.arch_camera())
    ro, rd, dro, drd, alive = mt.make_waves(bufs, cam, W, H, seed=5)
    R = W * H
    assert ro.shape == rd.shape == dro.shape == drd.shape == (R, 3)
    assert alive.dtype == torch.bool and alive.shape == (R,)
    np.testing.assert_allclose(drd.norm(dim=1).numpy(), 1.0, atol=1e-5)
    hit = intersect_any(bufs, ro, rd)
    assert torch.equal(alive, hit.tri >= 0) and alive.float().mean() > 0.5
    # Diffuse directions leave the surface on the side the ray came from.
    n = bufs.tri_shade[hit.tri.clamp_min(0).long(), 17:20]
    side = torch.sign((n * rd).sum(dim=1))
    assert ((n * drd).sum(dim=1) * side <= 1e-6)[alive].all()
    again = mt.make_waves(bufs, cam, W, H, seed=5)
    assert all(torch.equal(a, b) for a, b in zip(again, (ro, rd, dro, drd,
                                                          alive)))
    assert not torch.equal(mt.make_waves(bufs, cam, W, H, seed=6)[1], rd)


@pytest.mark.parametrize("entry", ["kernel_probe", "lane_gather_bench",
                                   "r3_probes", "device_sort_bench"])
def test_entry_points_need_a_card(entry):
    """The probes time CUDA kernels: without a card, or asked for the CPU,
    their entry points raise before any work."""
    mains = {"kernel_probe": kp.main, "lane_gather_bench": lg.main,
             "r3_probes": lambda device: r3.main([], device=device),
             "device_sort_bench": lambda device: device_sort_bench.main(
                 device=device)}
    with pytest.raises(RuntimeError):
        mains[entry](device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mains[entry](device="cuda")


@pytest.mark.parametrize("steps", [8, 64])
def test_lane_gather_matches_reference(steps):
    ins = lg.inputs(G=2)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(ref_lg.run(*(jnp.asarray(a) for a in ins),
                                    steps=steps))
    out = lg.run(*(torch.from_numpy(a) for a in ins), steps=steps).numpy()
    assert out.shape == ref.shape == (2, 8, 128)
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def _ref_r3(name, x, steps):
    """run_probe's kernel (r3_probes.py:147-156) around probe_body(name),
    grid (1,), in TPU interpret mode."""
    step = ref_r3.probe_body(name)

    def kernel(x_ref, o_ref):
        def body(c):
            y, i = c
            return step(y, i), i + 1

        out, _ = lax.while_loop(lambda c: c[1] < steps, body,
                                (x_ref[0], jnp.int32(0)))
        o_ref[0] = out

    spec = pl.BlockSpec((1, 8, 128), lambda g: (g, 0, 0),
                        memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        f = pl.pallas_call(kernel, grid=(1,), in_specs=[spec],
                           out_specs=spec,
                           out_shape=jax.ShapeDtypeStruct((1, 8, 128),
                                                          jnp.float32))
        return np.asarray(jax.jit(f)(jnp.asarray(x)))


@pytest.mark.parametrize("name", r3.PROBES)
def test_r3_probe_matches_reference(name):
    x = r3.tile("cpu")
    steps = 12
    ref = _ref_r3(name, x.numpy(), steps)
    out = r3.run_probe_kernel(name, x, steps).numpy()
    assert out.shape == (1, 8, 128)
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    assert (out == ref).mean() >= 0.99
