"""The trace's reduction on a synthetic event list: device work is summed
under the innermost labelled range around its launching call, user
annotations are not device work, idle gaps are named by what the host
launched to end them, and the metrics read the sums."""

from types import SimpleNamespace as NS

import pytest

from portbench.harness import metrics, tracing


class TR:
    def __init__(self, start, end):
        self.start, self.end = start, end


def host(name, parent=None, eid=-1):
    return NS(name=name, device_type="DeviceType.CPU", cpu_parent=parent,
              id=eid, time_range=TR(0, 0), is_user_annotation=False)


def dev(name, eid, start, end, annotation=False):
    return NS(name=name, device_type="DeviceType.CUDA", cpu_parent=None,
              id=eid, time_range=TR(start, end),
              is_user_annotation=annotation)


def frame_events():
    """One frame: raygen (1 kernel), shade0 with a shadow wave inside
    (2 kernels under shade0, 1 under shadow), a kernel under no range, and
    the device copy of the shade0 range, which is not work."""
    shade = host("shade0")
    shadow = host("shadow", shade)
    raygen = host("raygen")
    ev = [raygen, shade, shadow]

    def launch(parent, eid, name, t0, t1):
        op = host("aten::mul", parent)
        call = host("cudaLaunchKernel", op, eid)
        ev.extend([op, call, dev(name, eid, t0, t1)])

    launch(raygen, 1, "raygen_kernel", 0.0, 100.0)
    launch(shade, 2, "shade_a", 150.0, 250.0)
    launch(shadow, 3, "void wide_traverse_kernel<true>(...)", 250.0, 550.0)
    launch(shade, 4, "shade_b", 600.0, 700.0)
    launch(None, 5, "Memcpy DtoH", 1000.0, 1010.0)
    ev.append(dev("shade0", 99, 150.0, 700.0, annotation=True))
    return ev


def test_attribution():
    tokens = tracing.frame_tokens(1, denoised=False)
    got = tracing.attribute(frame_events(), tokens)
    assert got["raygen"] == [pytest.approx(0.1), 1]
    assert got["shade0"] == [pytest.approx(0.2), 2]
    assert got["shade0/shadow"] == [pytest.approx(0.3), 1]
    assert got["other"] == [pytest.approx(0.01), 1]
    assert got["intersect0"] == [0.0, 0]


def test_device_summary_excludes_annotations():
    s = tracing.device_summary(frame_events())
    assert s["busy_ms"] == pytest.approx(0.61)
    assert s["kernels"] == 4 and s["activities"] == 5
    assert "shade0" not in s["by_name"]


def test_idle_gaps():
    tokens = tracing.frame_tokens(1, denoised=False)
    gaps = dict(tracing.idle_gaps(frame_events(), tokens))
    assert gaps["shade0 / aten::mul"] == pytest.approx(50e-6 + 50e-6)
    assert gaps["no range / aten::mul"] == pytest.approx(300e-6)
    assert sum(gaps.values()) == pytest.approx((50 + 50 + 300) * 1e-6)


def ctx(**kw):
    base = dict(cell=None, size=(1920, 1080), spp=1, bounces=3, probe=False,
                triangles=259_874, scene_build_s=2.5, kind="NVIDIA H100",
                peaks={"hbm_bytes_per_s": 3.35e12})
    base.update(kw)
    return metrics.TraceContext(**base)


def test_metrics_read_passes_and_device():
    c = ctx(passes=tracing.attribute(frame_events(),
                                     tracing.frame_tokens(1, False)),
            pass_frames=2, device=tracing.device_summary(frame_events()),
            device_frames=1, device_wall_s=0.002)
    assert metrics.read("shade_ms", c) == pytest.approx(0.1)
    assert metrics.read("shadow_ms", c) == pytest.approx(0.15)
    assert metrics.read("intersect_ms", c) is None
    assert metrics.read("sort_ms", c) is None
    assert metrics.read("asvgf_ms", c) is None
    assert metrics.read("launches_per_frame", c) == 4
    assert metrics.read("idle_share", c) == pytest.approx(100 * (1 - 0.61 / 2))
    # K1: 0.3 ms of wide_traverse_kernel against 505,091,448 bytes.
    assert metrics.read("k1_roofline", c) == pytest.approx(
        100 * 505_091_448 / 3.35e12 / 0.3e-3)
    assert metrics.read("scene_build_s", c) == 2.5


def test_metrics_silent_without_a_trace():
    c = ctx()
    for name in ("shade_ms", "k1_roofline", "idle_share",
                 "launches_per_frame"):
        assert metrics.read(name, c) is None


def nested_events():
    """One frame whose ranges are user annotations on the host, as
    ``record_function`` makes them: ``intersect0`` holding ``tlas``,
    which holds ``select``, a kernel directly under each; ``shade0``
    holding ``shadow``; a copy under no range; the ranges' device-side
    annotations, which are not work."""
    def rng(name, parent=None):
        e = host(name, parent)
        e.is_user_annotation = True
        return e

    step = rng("ProfilerStep#3")
    isect = rng("intersect0", step)
    tlas = rng("tlas", isect)
    select = rng("select", tlas)
    shade = rng("shade0", step)
    shadow = rng("shadow", shade)
    ev = [step, isect, tlas, select, shade, shadow]

    def launch(parent, eid, name, t0, t1):
        op = host("aten::add", parent)
        call = host("cudaLaunchKernel", op, eid)
        ev.extend([op, call, dev(name, eid, t0, t1)])

    launch(isect, 1, "k_isect", 0.0, 100.0)
    launch(tlas, 2, "k_tlas", 100.0, 300.0)
    launch(select, 3, "k_select", 300.0, 700.0)
    launch(select, 4, "k_select", 700.0, 800.0)
    launch(shade, 5, "k_shade", 900.0, 950.0)
    launch(shadow, 6, "k_shadow", 950.0, 1250.0)
    launch(step, 7, "Memcpy DtoH", 1300.0, 1310.0)
    ev += [dev("intersect0", 90, 0.0, 800.0, annotation=True),
           dev("tlas", 91, 100.0, 800.0, annotation=True)]
    return ev


def test_by_range_reads_every_name():
    got = tracing.by_range(nested_events())
    assert got == {"intersect0": [pytest.approx(0.1), 1],
                   "tlas": [pytest.approx(0.2), 1],
                   "select": [pytest.approx(0.5), 2],
                   "shade0": [pytest.approx(0.05), 1],
                   "shadow": [pytest.approx(0.3), 1],
                   "": [pytest.approx(0.01), 1]}
    assert tracing.range_names(nested_events()) == {
        "intersect0", "tlas", "select", "shade0", "shadow"}
    # The tokens read as before: the nested ranges stay in intersect0.
    tokens = tracing.frame_tokens(1, denoised=False)
    passes = tracing.attribute(nested_events(), tokens)
    assert passes["intersect0"] == [pytest.approx(0.8), 4]
    assert passes["shade0"] == [pytest.approx(0.05), 1]
    assert passes["shade0/shadow"] == [pytest.approx(0.3), 1]
    assert passes["other"] == [pytest.approx(0.01), 1]
    # A trace whose ranges carry no annotation flag (the synthetic frame
    # above) attributes by tokens as before and has no named range.
    assert tracing.by_range(frame_events()) == {"": [pytest.approx(0.61),
                                                      5]}


def test_metrics_read_a_range_by_name():
    ev = nested_events()
    c = ctx(passes=tracing.attribute(ev, tracing.frame_tokens(1, False)),
            ranges=tracing.by_range(ev), pass_frames=2,
            device=tracing.device_summary(ev), device_frames=1,
            device_wall_s=0.002)
    assert metrics.range_ms(c, "select") == pytest.approx(0.25)
    assert metrics.range_ms(c, "tlas") == pytest.approx(0.1)
    assert metrics.range_ms(c, "intersect0") == pytest.approx(0.05)
    assert metrics.range_ms(c, "asvgf") is None
    assert metrics.range_ms(ctx(), "select") is None
    # The existing readers read what they read before.
    assert metrics.read("intersect_ms", c) == pytest.approx(0.4)
    assert metrics.read("shade_ms", c) == pytest.approx(0.025)
    assert metrics.read("shadow_ms", c) == pytest.approx(0.15)
    assert metrics.read("launches_per_frame", c) == 6
