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

E2 (lane_gather_bench): exact in practice, held to 1e-6 relative on the
reference's inputs and bit-equal (NaN counted equal) on its edge cases. E3
(r3_probes): within 1e-6 relative and at least 99% of the elements
bit-equal. XLA:CPU contracts the reference's ``x + acc * c`` into a fused
multiply-add where the port (and its kernel, built with --fmad=false)
rounds twice: measured, 1 ulp on 1 of 1,024 elements of seggather after
12 steps, none elsewhere; mxu's dot may also sum in another order.
"""

import os
import sys

import hypothesis.extra.numpy as hnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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
from loupiote_tpu_torch import _build  # noqa: E402
from loupiote_tpu_torch.accel.wide import LEAF_TAG  # noqa: E402
from loupiote_tpu_torch.experiments import (  # noqa: E402
    device_sort_bench, kernel_probe as kp, lane_gather_bench as lg,
    measure_traversal as mt, r3_probes as r3)
from loupiote_tpu_torch.ops import wide  # noqa: E402
from loupiote_tpu_torch.ops.intersect import intersect_any  # noqa: E402
from torch_port_helpers import (assert_same_hits,  # noqa: E402
                                nonfinite_rays, t_of)

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


@pytest.fixture(scope="module")
def arch_nonfinite(arch):
    """The fixture's wave with the edge cases of nonfinite_rays: about one
    ray in eight of each origin component +-inf or NaN, of each direction
    component +-inf, -0 or +-1e-30."""
    bufs, (dro, drd, alive), _ = arch
    ro, rd = nonfinite_rays(dro, drd, 91)
    return bufs, (ro, rd), kp.probe_args(bufs, ro, rd, alive)


E1_CASES = [(p, False) for p in kp.PROBES] + [(p, True) for p in kp.PROBES]
E1_IDS = list(kp.PROBES) + [f"{p}-nonfinite" for p in kp.PROBES]


@pytest.mark.parametrize("probe, edge", E1_CASES, ids=E1_IDS)
def test_probe_matches_reference(request, probe, edge):
    """On the edge-case wave the twin's min / max return NaN as the
    reference's do, so tri is equal and t, u, v NaN-equal on every ray
    with a non-finite component."""
    fixture = "arch_nonfinite" if edge else "arch"
    bufs, (dro, drd, *_), args = request.getfixturevalue(fixture)
    kw = _kwargs(bufs, probe)
    _build.reset_counters()
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
    fin = np.isfinite(ro).all(1) & np.isfinite(rd).all(1)
    if edge:
        assert 0.3 < (~fin).mean() < 0.8
        np.testing.assert_array_equal(tri[~fin], rtri[~fin])
        for a, b in ((t, rt), (u, ru), (v, rv)):
            assert _nan_equal(a[~fin], b[~fin])
    if probe in ("full", "noorder"):
        assert hit[fin].mean() > 0.3  # closest hits of a diffuse wave
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


def _nan_equal(a, b):
    """Bit equality of two float32 arrays, NaN counted equal to NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return bool(((a.view(np.int32) == b.view(np.int32))
                 | (np.isnan(a) & np.isnan(b))).all())


@pytest.mark.parametrize("steps, edge", [
    (8, None), (64, None), (64, "high_links"), (64, "nonfinite")],
    ids=["8", "64", "high_links", "nonfinite"])
def test_lane_gather_matches_reference(steps, edge):
    """The edge cases: links with bits above 1,023 in both halves; lanes
    with +-inf and NaN origins and inf, -0 and 1e-30 directions, where
    min / max must return NaN as jnp.minimum / maximum do (NaN-equal)."""
    ins = lg.inputs(G=2, **({edge: True} if edge else {}))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(ref_lg.run(*(jnp.asarray(a) for a in ins),
                                    steps=steps))
    out = lg.run(*(torch.from_numpy(a) for a in ins), steps=steps).numpy()
    assert out.shape == ref.shape == (2, 8, 128)
    if edge is None:
        np.testing.assert_allclose(out, ref, rtol=1e-6)
    else:
        assert _nan_equal(out, ref)
    if edge == "nonfinite":
        assert np.isnan(out).any() and np.isfinite(out).mean() > 0.5


# -- E2's schedule (csrc/lane_gather.cu), modelled on the CPU ---------------
# The table is staged as three arrays, (minx, miny, minz, maxx),
# (maxy, maxz) and the link word hit | miss << 16 with each link masked to
# 1,024 and scaled to an element index, each holding E2_COPIES copies
# interleaved entry by entry (element e * E2_COPIES + c is copy c of entry
# e). Block b walks lanes [1,024 b, 1,024 (b + 1)), thread t lane
# 1,024 b + t, reading copy t mod E2_COPIES and starting at element
# (lane & 127) * E2_COPIES. min / max return NaN where an operand is NaN
# (PTX min.NaN / max.NaN). Held to the twin lane_gather_plain: bit-equal,
# NaN counted equal.

E2_COPIES = 8


def _e2_stage(tab):
    flat = tab.reshape(7, 1024)
    e = np.arange(E2_COPIES * 1024) // E2_COPIES
    s_lo = np.stack([flat[f][e] for f in range(4)], -1)
    s_hi = np.stack([flat[f][e] for f in (4, 5)], -1)
    link = flat[6].view(np.int32)[e]
    hit = (link & 1023) * E2_COPIES
    miss = ((link >> 16) & 1023) * E2_COPIES
    return s_lo, s_hi, (hit | (miss << 16)).astype(np.int32)


def _e2_model(ins, steps, minimum=np.minimum, maximum=np.maximum):
    tab, *rays = ins
    ox, oy, oz = (r.reshape(-1) for r in rays[:3])
    s_lo, s_hi, s_link = _e2_stage(tab)
    lane = np.arange(ox.size)
    thread = lane % lg.ENTRIES
    copy = thread % E2_COPIES
    with np.errstate(all="ignore"):
        ix, iy, iz = (np.float32(1) / np.where(np.abs(x) > np.float32(1e-20),
                                               x, np.float32(1e-20))
                      for x in (r.reshape(-1) for r in rays[3:]))
        cur = (lane & 127).astype(np.int32) * E2_COPIES
        acc = np.zeros(ox.size, np.float32)
        for _ in range(steps):
            lo, hi = s_lo[cur + copy], s_hi[cur + copy]
            lw = s_link[cur + copy]
            t1x, t2x = (lo[:, 0] - ox) * ix, (lo[:, 3] - ox) * ix
            t1y, t2y = (lo[:, 1] - oy) * iy, (hi[:, 0] - oy) * iy
            t1z, t2z = (lo[:, 2] - oz) * iz, (hi[:, 1] - oz) * iz
            tn = maximum(maximum(minimum(t1x, t2x), minimum(t1y, t2y)),
                         minimum(t1z, t2z))
            tf = minimum(minimum(maximum(t1x, t2x), maximum(t1y, t2y)),
                         maximum(t1z, t2z))
            hit = tf >= maximum(tn, np.float32(0))
            cur = np.where(hit, lw & 0xFFFF,
                           (lw.view(np.uint32) >> 16).astype(np.int32))
            acc = acc + tn
    return acc.reshape(rays[0].shape)


@pytest.mark.parametrize("edge", [False, True], ids=["inputs", "edge"])
@pytest.mark.parametrize("steps", [1, 64])
@pytest.mark.parametrize("G", [1, 2, 3])
def test_e2_block_schedule_matches_twin(G, steps, edge):
    ins = lg.inputs(G, high_links=edge, nonfinite=edge)
    twin = lg.lane_gather_plain(*(torch.from_numpy(a) for a in ins),
                                steps=steps).numpy()
    assert _nan_equal(_e2_model(ins, steps), twin)


def test_e2_edge_input_tells_nan_dropping_min_max_apart():
    """fminf / fmaxf (the design before) return the other operand where
    one is NaN: on the edge-case input the walk then differs."""
    ins = lg.inputs(2, high_links=True, nonfinite=True)
    twin = lg.lane_gather_plain(*(torch.from_numpy(a) for a in ins),
                                steps=64).numpy()
    assert not _nan_equal(_e2_model(ins, 64, np.fmin, np.fmax), twin)
    finite = lg.inputs(2)
    assert _nan_equal(
        _e2_model(finite, 64, np.fmin, np.fmax),
        lg.lane_gather_plain(*(torch.from_numpy(a) for a in finite),
                             steps=64).numpy())


def test_e2_model_constants_match_source():
    """The kernel's block size and copies are the ones this file models."""
    src = os.path.join(_ROOT, "loupiote_tpu_torch", "csrc", "lane_gather.cu")
    with open(src) as f:
        text = f.read()
    assert f"kThreads = {lg.ENTRIES};" in text
    assert f"kCopies = {E2_COPIES};" in text


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


def _nonfinite_tile():
    """The tile with NaN, +inf and -inf entries in some 32-column segments
    of some rows (segmin's minimum is NaN in a segment that holds a NaN,
    -inf in one that holds -inf and no NaN)."""
    x = r3.tile("cpu").clone().reshape(8, 128)
    x[0, 5] = float("nan")
    x[1, 40] = float("-inf")
    x[2, 70] = float("inf")
    x[3, 100] = float("nan")
    x[3, 101] = float("-inf")
    x[5, 0:32] = float("inf")
    x[7, 127] = float("nan")
    return x.reshape(1, 8, 128)


@pytest.mark.parametrize("name, edge", [(n, False) for n in r3.PROBES]
                         + [("segmin", True)],
                         ids=list(r3.PROBES) + ["segmin-nonfinite"])
def test_r3_probe_matches_reference(name, edge):
    """On the non-finite tile, segmin's min returns NaN as jnp.minimum
    does: NaN-equal, and the NaN segments' elements are NaN."""
    x = _nonfinite_tile() if edge else r3.tile("cpu")
    steps = 12
    ref = _ref_r3(name, x.numpy(), steps)
    out = r3.run_probe_kernel(name, x, steps).numpy()
    assert out.shape == (1, 8, 128)
    if edge:
        assert _nan_equal(out, ref)
        assert np.isnan(out[0, 0, :32]).all() and np.isnan(out[0, 3, 96:]).all()
        assert np.isneginf(out[0, 1, 32:64]).all()
        assert np.isfinite(out[0, 4]).all()
        return
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    assert (out == ref).mean() >= 0.99


# -- E3's warp-per-row schedule (csrc/r3_probes.cu), modelled on the CPU ----
# Warp w holds row w of the tile; lane l holds four of its elements in
# registers x[l, j]: column 32 j + l (strided), or 4 l + j (contiguous:
# cgather28, mxu, roll, segmin). A read of another element is a shuffle of
# one register from a source lane, as the kernel issues it, or, for the
# three ordered sums, a read of the per-warp scratch slice the warp writes
# that step (lanes 0-3 run the sums, one a segment, four terms a load). A
# sum the reference starts from x * 0 starts from +0 and each element adds
# its own x * 0 to it: the two differ at most in the sign of a zero sum,
# which the step's last add of i * 1e-9 (+0 or more) erases, and an
# infinite or NaN x still gives NaN. mxu exchanges its tile through shared
# memory. The model is held bit-equal to the twin's _step.

E3_CONTIGUOUS = ("cgather28", "mxu", "roll", "segmin")
LANES = np.arange(32)


def _e3_cols(name):
    j = np.arange(4)
    if name in E3_CONTIGUOUS:
        return 4 * LANES[:, None] + j[None, :]
    return 32 * j[None, :] + LANES[:, None]


def _shfl(v, src):
    """__shfl_sync of the per-lane values v (8 warps, 32 lanes) from the
    source lanes src (32,)."""
    return v[:, src]


def _quad_sums(sc, starts, n, m=None):
    """Lanes 0-3's sums of n terms of the scratch slices sc (8, 160) from
    starts[g] (a multiple of 4: LDS.128), times m[g] where given, in
    order; (8, 4)."""
    sums = torch.zeros(8, 4)
    for g in range(4):
        for f in range(n):
            v = sc[:, starts[g] + f]
            sums[:, g] = sums[:, g] + (v if m is None else v * m[g])
    return sums


def _e3_model_step(name, x, i):
    """One step of probe ``name`` on the registers x (8, 32, 4)."""
    f32 = np.float32
    fi = torch.tensor(f32(i))
    fi9 = fi * torch.tensor(f32(1e-9))
    x = x.clone()
    if name == "repeat":
        d = (_shfl(x[..., 0], LANES & 3) + fi) * f32(1e-6)
        return x + d[..., None]
    if name in ("bdim", "seggather1"):
        v = torch.stack([_shfl(x[..., 0], np.full(32, j)) for j in range(4)],
                        dim=-1)
        if name == "bdim":
            return x + (v + fi) * f32(1e-6)
        return x + v * f32(1e-7) + fi9
    if name in ("seggather", "selmerge", "cgather28"):
        sc = torch.zeros(8, 160)
        if name == "seggather":  # copy j: sc[36 j + m] = row[j + m]
            for j in range(4):
                sc[:, 36 * j + LANES[j:] - j] = x[:, j:, 0]
            sums = _quad_sums(sc, [36 * g for g in range(4)], 28)
        elif name == "selmerge":  # sc[f] = row[2 f]
            for j in range(4):
                sc[:, 16 * j + LANES[::2] // 2] = x[:, ::2, j]
            m = np.array([1.0, 1.0000001, 1.0000002, 1.0000003], f32)
            sums = _quad_sums(sc, [0] * 4, 56, [torch.tensor(v) for v in m])
        else:  # the row, 4 floats of padding a segment: segment g at 36 g
            for j in range(4):
                sc[:, 4 * (LANES + (LANES >> 3)) + j] = x[..., j]
            sums = _quad_sums(sc, [36 * g for g in range(4)], 28)
        if name == "cgather28":  # element (l, j) in segment l / 8
            seg = sums[:, LANES >> 3][..., None].expand(8, 32, 4)
        else:  # element (l, j) in segment j
            seg = sums[:, None, :].expand(8, 32, 4)
        scale = f32(1e-7) if name == "seggather" else f32(1e-9)
        return x + (x * f32(0.0) + seg) * scale + fi9
    if name == "mxu":  # the tile through shared memory, one barrier a step
        tile = torch.empty(8, 128)
        cols = torch.from_numpy(_e3_cols(name))
        for w in range(8):
            tile[w, cols] = x[w]
        off = fi * f32(1e-9)
        a = tile[:, :8].T + off  # a[w, k] = x[k, w] + off
        col = tile[:, cols]  # (k, 32, 4)
        s = a[:, 0, None, None] * col[0]
        for k in range(1, 8):
            s = s + a[:, k, None, None] * col[k]
        return x + s * f32(1e-7)
    if name == "transpose":
        return x + x * f32(1e-7) + fi9
    if name == "roll":  # i = 4 q + s: x[(j - s) % 4] of lane l - q - (j < s)
        q, s = (i >> 2) & 31, i & 3
        v = torch.stack([_shfl(x[..., (j - s) & 3],
                               (LANES - q - int(j < s)) & 31)
                         for j in range(4)], -1)
        return x + v * f32(1e-7)
    if name == "segmin":  # contiguous: a segment is 8 lanes
        seg = LANES & ~7
        n1, n2, n4 = (seg | ((LANES + d) & 7) for d in (1, 2, 4))
        m = x + fi9
        y = torch.stack([torch.minimum(m[..., 0], m[..., 1]),
                         torch.minimum(m[..., 1], m[..., 2]),
                         torch.minimum(m[..., 2], m[..., 3]),
                         torch.minimum(m[..., 3], _shfl(m[..., 0], n1))], -1)
        m = torch.stack([torch.minimum(y[..., 0], y[..., 2]),
                         torch.minimum(y[..., 1], y[..., 3]),
                         torch.minimum(y[..., 2], _shfl(y[..., 0], n1)),
                         torch.minimum(y[..., 3], _shfl(y[..., 1], n1))], -1)
        for src in (n1, n2, n4):
            m = torch.stack([torch.minimum(m[..., j], _shfl(m[..., j], src))
                             for j in range(4)], -1)
        return x + m * f32(1e-9)
    raise ValueError(name)


def _signed_tile():
    """A tile with negative values, both zeros, a row of -0 (whose sums
    from x * 0 are -0 where the model's are +0) and an infinite element
    (whose x * 0 is NaN)."""
    x = r3.tile("cpu").clone().reshape(8, 128) - 0.5
    x[0, :9] = torch.tensor([0.0, -0.0] * 4 + [0.0])
    x[3, 40:50] = -0.0
    x[5] = -0.0
    x[6, 100] = float("inf")
    return x.reshape(1, 8, 128)


@pytest.mark.parametrize("name, signed", [
    (n, s) for n in r3.PROBES for s in (False, True)] + [("segmin", None)],
    ids=[f"{n}-{s}" for n in r3.PROBES for s in ("tile", "signed")]
    + ["segmin-nonfinite"])
def test_r3_warp_schedule_matches_twin(name, signed):
    """signed None: the non-finite tile, where segmin's min.NaN keeps the
    NaN the twin's torch.minimum keeps."""
    x = (_nonfinite_tile() if signed is None
         else _signed_tile() if signed else r3.tile("cpu"))
    cols = torch.from_numpy(_e3_cols(name))
    y = x.reshape(8, 128)
    regs = y[:, cols]  # (8 warps, 32 lanes, 4)
    for i in range(12):
        y = r3._step(name, y, i)
        regs = _e3_model_step(name, regs, i)
        back = torch.empty(8, 128)
        for w in range(8):
            back[w, cols] = regs[w]
        if signed is None:  # NaN's bits are not kept: NaN-equal
            assert _nan_equal(back.numpy(), y.numpy()), (name, i)
            continue
        assert torch.equal(back.view(torch.int32), y.view(torch.int32)), (
            name, i)


# -- E1's warp-a-packet schedule (csrc/kernel_probe.cu), modelled on the CPU -
# One warp walks one packet: lane l holds rays l, 32 + l, 64 + l and 96 + l,
# and the warp keeps the packet's row, stack, cursor and stack pointer (on
# the card the warps of a persistent grid take packets from a counter, one
# after another; no packet's result depends on which warp walks it). At
# an internal row, children with a negative pointer are not tested; where
# the packet is octant-coherent (every active ray with finite origin and
# one sign of each inverse direction component) a child whose box has
# min <= max on each axis is tested against the packet's near and far
# planes, else by min / max of both slabs (PTX min.NaN / max.NaN: NaN in,
# NaN out, as torch.minimum / maximum); each lane takes the minimum of its
# rays' hit distances, the warp the minimum of the lanes' order-preserving
# keys (redux.sync); lane c ranks child c against the others' keys
# (shuffles), the ballot of the lanes with rank 0 names the nearest child,
# the lanes of the others push them, and the ballot of the pushes past the
# stack counts the dropped ones. At a leaf row the pop follows the
# triangle tests. Held to the twin
# probe_trace_plain: t, u, v, tri, steps bit-equal, dropped pushes equal.

BIG_KEY = None  # set below from dist_key(BIG)


def dist_key(f):
    """The kernel's key of float32 distances: unsigned order = float order
    of non-NaN values, -0 read as +0."""
    b = np.asarray(f, np.float32).view(np.uint32).copy()
    b[b == 0x80000000] = 0
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


BIG_KEY = int(dist_key(np.float32(kp.BIG)))


def _rank_lanes(kc, cp, noorder):
    """Lanes 0-7 of the kernel's rank step: child c's hit bit, its rank
    among the hit children by (key, index) (noorder: by index), the hit
    mask and the nearest child's lane (-1 if none)."""
    c = np.arange(8)
    h = (kc < BIG_KEY) & (cp >= 0)
    if noorder:
        r = np.array([h[:q].sum() for q in c])
    else:
        kq, kcc = kc[None, :], kc[:, None]
        nearer = (kq < kcc) | ((kq == kcc) & (c[None, :] < c[:, None]))
        r = (nearer & h[None, :]).sum(axis=1)
    first = np.flatnonzero(h & (r == 0))
    return h, r, (int(first[0]) if first.size else -1)


def _e1_model(bufs, args, probe, max_steps):
    kw = kp.probe_kwargs(bufs, probe)
    end, caps_in, S = kw["end_index"], kw["leaf_cap"], kw["stack_size"]
    caps = 0 if probe == "nomt" else caps_in
    rows = bufs.trav_rows
    rows_i = rows.view(torch.int32)
    G = args[1].shape[0]
    flat = [a.reshape(G * 8, 128) for a in args[1:]]
    outs = [torch.empty(G * 8, 128) for _ in range(3)]
    tri_o = torch.empty(G * 8, 128, dtype=torch.int32)
    steps_o = torch.zeros(G * 8, dtype=torch.int32)
    dropped = 0
    # Work the kernel does for active rays: box tests (a child with a
    # pointer), those on the packet's planes, triangle tests.
    work = {"box_tests": 0, "plane_tests": 0, "tri_tests": 0}
    from loupiote_tpu_torch.ops.intersect import moller_trumbore
    from loupiote_tpu_torch.ops.wide import _safe_inv
    for p in range(G * 8):
        o = [flat[a][p] for a in range(3)]
        d = [flat[a][p] for a in range(3, 6)]
        inv = [_safe_inv(x) for x in d]
        t, a = flat[6][p].clone(), flat[7][p] != 0
        u, v = torch.zeros(128), torch.zeros(128)
        tri = torch.full((128,), -1, dtype=torch.int32)
        fin = torch.stack([torch.isfinite(x) for x in o]).all(0)
        coherent = bool(fin[a].all())
        off = []
        for ax in range(3):
            neg, pos = (inv[ax] < 0) & a, (inv[ax] > 0) & a
            coherent &= not (bool(neg.any()) and bool(pos.any()))
            off.append(3 if bool(neg.any()) else 0)
        stack = np.zeros(S, np.int64)
        cur = ptr = steps = 0
        n_act = int(a.sum())
        done = not bool(a.any())

        def advance(nchild, near):
            nonlocal cur, ptr, done
            desc = nchild > 0
            pos = ptr + nchild - 1 if probe != "nostack" and desc else ptr
            top = max(pos - 1, 0)
            popped = int(stack[top]) if top < S else 0
            nxt = near if desc else (popped if pos > 0 else end)
            ptr = pos if desc else top
            done = nxt >= end
            cur = 0 if done else nxt

        while not done and steps < max_steps:
            row = 0 if probe == "nofetch" else cur
            rs, ri = rows[row], rows_i[row]
            if int(ri[127]) == 1:
                fc = int(ri[126])
                work["tri_tests"] += n_act * min(caps, fc & 15)
                for k in range(min(caps, fc & 15)):
                    uu, vv, tt = moller_trumbore(
                        o, d, tuple(rs[9 * k + j] for j in range(9)))
                    ok = (a & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                          & (tt > kp.T_MIN) & (tt < t))
                    t = torch.where(ok, tt, t)
                    u = torch.where(ok, uu, u)
                    v = torch.where(ok, vv, v)
                    tri = torch.where(ok, (fc >> 4) + k, tri)
                advance(0, 0)
            else:
                box = rs.view(8, 16)
                cp = ri.view(8, 16)[:, 6].numpy().astype(np.int64)
                kc = np.full(8, BIG_KEY, np.uint32)  # lane c's key
                for c in np.flatnonzero(cp >= 0):
                    b = box[c]
                    fast = coherent and bool((b[:3] <= b[3:6]).all())
                    work["box_tests"] += n_act
                    work["plane_tests"] += n_act * fast
                    if fast:
                        tn = torch.maximum(torch.maximum(
                            (b[off[0]] - o[0]) * inv[0],
                            (b[1 + off[1]] - o[1]) * inv[1]),
                            (b[2 + off[2]] - o[2]) * inv[2])
                        tf = torch.minimum(torch.minimum(
                            (b[3 - off[0]] - o[0]) * inv[0],
                            (b[4 - off[1]] - o[1]) * inv[1]),
                            (b[5 - off[2]] - o[2]) * inv[2])
                    else:
                        t1 = [(b[x] - o[x]) * inv[x] for x in range(3)]
                        t2 = [(b[x + 3] - o[x]) * inv[x] for x in range(3)]
                        tn = torch.maximum(torch.maximum(
                            torch.minimum(t1[0], t2[0]),
                            torch.minimum(t1[1], t2[1])), torch.minimum(t1[2], t2[2]))
                        tf = torch.minimum(torch.minimum(
                            torch.maximum(t1[0], t2[0]),
                            torch.maximum(t1[1], t2[1])), torch.maximum(t1[2], t2[2]))
                    hit = a & (tf >= torch.maximum(tn, torch.tensor(0.0))) & (
                        tn < t)
                    # Each lane's minimum over its rays 32 j + lane, then the
                    # warp's minimum key.
                    tnv, hv = tn.view(4, 32), hit.view(4, 32)
                    m = torch.full((32,), kp.BIG)
                    for j in range(4):
                        m = torch.where(hv[j], torch.minimum(m, tnv[j]), m)
                    kc[c] = dist_key(m.numpy()).min()
                h, r, first = _rank_lanes(kc, cp, probe == "noorder")
                nchild = int(h.sum())
                ptrs = np.where(cp >= 0, cp & int(LEAF_TAG - 1), cp)
                near = int(ptrs[first]) if first >= 0 else 0
                if probe != "nostack":
                    for c in np.flatnonzero(h & (r >= 1)):
                        pos = ptr + nchild - 1 - int(r[c])
                        if pos < S:
                            stack[pos] = ptrs[c]
                        else:
                            dropped += 1
                advance(nchild, near)
            steps += 1
        outs[0][p], outs[1][p], outs[2][p], tri_o[p] = t, u, v, tri
        steps_o[p] = steps
    shp = (G, 8, 128)
    return ((outs[0].view(shp), outs[1].view(shp), outs[2].view(shp),
             tri_o.view(shp), steps_o.view(G, 8)), dropped, work)


_E1_MODEL_RUNS = {}


def _e1_model_of(arch, probe, edge=False):
    """_e1_model on the fixture's blocks, once a variant and input for the
    module."""
    if (probe, edge) not in _E1_MODEL_RUNS:
        bufs, _, args = arch
        _E1_MODEL_RUNS[probe, edge] = _e1_model(
            bufs, args, probe, _kwargs(bufs, probe)["max_steps"])
    return _E1_MODEL_RUNS[probe, edge]


@pytest.mark.parametrize("probe, edge", [(p, False) for p in kp.PROBES]
                         + [("full", True)],
                         ids=list(kp.PROBES) + ["full-nonfinite"])
def test_probe_warp_schedule_matches_twin(request, probe, edge):
    """On the edge-case wave too: the model's min / max return NaN as the
    kernel's min.NaN / max.NaN do, and a NaN inverse direction leaves a
    packet with finite origins on its planes, where the NaN reaches tn."""
    arch = request.getfixturevalue("arch_nonfinite" if edge else "arch")
    bufs, _, args = arch
    kw = _kwargs(bufs, probe)
    d0 = kp.dropped_pushes("cpu")
    ref = kp.probe_trace_plain(*args, **kw)
    ref_drop = kp.dropped_pushes("cpu") - d0
    got, dropped, _ = _e1_model_of(arch, probe, edge)
    for g, r_ in zip(got, ref):
        if g.dtype == torch.float32:
            g, r_ = g.view(torch.int32), r_.view(torch.int32)
        assert torch.equal(g, r_)
    assert dropped == ref_drop
    if probe == "nofetch":
        assert dropped > 0


@pytest.mark.parametrize("stack_size", [0, kp.STACK_MAX + 1])
def test_probe_wrapper_refuses_a_stack_it_cannot_hold(arch, stack_size):
    """E1 keeps each packet's stack in shared memory, kMaxStack entries at
    most: the wrapper raises for a stack_size outside 1..STACK_MAX before
    anything is built or launched, and STACK_MAX is the kernel's limit."""
    bufs, _, args = arch
    kw = dict(kp.probe_kwargs(bufs, "full"), stack_size=stack_size)
    with pytest.raises(ValueError, match="stack_size"):
        kp._launch(*args, **kw)
    src = os.path.join(_ROOT, "loupiote_tpu_torch", "csrc",
                       "kernel_probe.cu")
    with open(src) as f:
        assert f"kMaxStack = {kp.STACK_MAX};" in f.read()
    assert bufs.wide_stack <= kp.STACK_MAX


@pytest.mark.parametrize("probe", kp.PROBES)
def test_probe_twin_counts_the_kernels_work(arch, probe):
    """The twin's work counts, which E1's bound reads, are the tests the
    kernel's schedule makes for active rays: a box test for each child with
    a pointer (none for an empty slot), the plane tests among them, and
    the triangle tests."""
    bufs, _, args = arch
    stats = {}
    kp.probe_trace_plain(*args, **_kwargs(bufs, probe), stats=stats)
    work = _e1_model_of(arch, probe)[2]
    assert stats == work
    # nomt tests no triangle, and nofetch reads the root (internal) row.
    assert (work["tri_tests"] > 0) == (probe not in ("nomt", "nofetch"))
    # The sorted wave's packets take the plane test for most children, not
    # for all.
    assert 0 < work["plane_tests"] < work["box_tests"]


_DISTANCES = st.one_of(
    st.sampled_from([0.0, -0.0, 1.0, -1.0, 2.5, -2.5, 1e30, -1e30, kp.BIG,
                     np.inf, -np.inf]),
    st.floats(width=32, allow_nan=False))


@settings(max_examples=400, deadline=None)
@given(hnp.arrays(np.float32, (8, 6), elements=_DISTANCES),
       hnp.arrays(np.bool_, (8, 6)),
       hnp.arrays(np.int64, 8, elements=st.integers(-1, 3)), st.booleans())
def test_key_minimum_ranks_children_as_fminf(tn, hit, cp, noorder):
    """Six lanes' distances to eight children (kBig where a lane misses):
    the minimum of the order-preserving keys ranks the children, names the
    nearest and finds the hit mask exactly as the fminf minimum of the
    distances does under the twin's rule (< and == on floats, ties by
    index), with -0 and +0, negative distances, equal distances and kBig
    among them."""
    masked = np.where(hit, tn, np.float32(kp.BIG))
    tnc = np.fmin.reduce(masked, axis=1)
    c = np.arange(8)
    hf = (tnc < np.float32(kp.BIG)) & (cp >= 0)
    if noorder:
        rf = np.cumsum(hf) - hf
    else:
        a_, b_ = tnc[None, :], tnc[:, None]
        nearer = (a_ < b_) | ((a_ == b_) & (c[None, :] < c[:, None]))
        rf = (nearer & hf[None, :]).sum(axis=1)
    h, r, first = _rank_lanes(dist_key(masked).min(axis=1), cp, noorder)
    assert (h == hf).all()
    assert (r[h] == rf[hf]).all()
    nearest = np.flatnonzero(hf & (rf == 0))
    assert first == (int(nearest[0]) if nearest.size else -1)


@settings(max_examples=400, deadline=None)
@given(_DISTANCES, _DISTANCES)
def test_dist_key_preserves_order(a, b):
    a, b = np.float32(a), np.float32(b)
    ka, kb = dist_key(a), dist_key(b)
    assert (ka < kb) == (a < b)
    assert (ka == kb) == (a == b)
