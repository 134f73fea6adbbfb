"""The reduction of the program's spans and counters
(``harness/hostspans.py``) on synthetic spans and events: idle time split
by the innermost span sums to the window's idle time, the host readings
and the clock's checks read what the spans hold, and a program without
the recorder reads nothing; then the stretches on the CPU at a small
size."""

import sys
from types import SimpleNamespace as NS

import pytest

from conftest import small_cell
from portbench.harness import hostspans, metrics, program, runner


def test_innermost_segments_cover_nested_spans():
    host = [(0, 10, "step"), (1, 4, "step/raygen"), (2, 3, "step/raygen/sync"),
            (6, 9, "step/shade0"), (12, 14, "blit")]
    assert hostspans.innermost_segments(host) == [
        (0, 1, "step"), (1, 2, "step/raygen"), (2, 3, "step/raygen/sync"),
        (3, 4, "step/raygen"), (4, 6, "step"), (6, 9, "step/shade0"),
        (9, 10, "step"), (10, 12, ""), (12, 14, "blit")]


def test_idle_by_span_sums_to_the_window_less_the_work():
    host = [(0, 10, "step"), (1, 4, "step/raygen"), (6, 9, "step/shade0"),
            (12, 14, "blit")]
    # Device work at [0.5, 2], [3, 7] and [6.5, 8] (overlapping), [13, 20].
    acts = [(0.5, 2), (3, 7), (6.5, 8), (13, 20)]
    idle = hostspans.idle_by_span(host, acts, 0, 15)
    # Idle [0, 0.5] in step, [2, 3] in raygen, [8, 13]: shade0 to 9,
    # step to 10, no span to 12, then blit.
    assert idle == pytest.approx({"step": 1.5, "step/raygen": 1.0,
                                  "step/shade0": 1.0, "": 2.0, "blit": 1.0})
    busy_union = 1.5 + 5.0 + 2.0  # [0.5, 2], [3, 8], [13, 15]
    assert sum(idle.values()) == pytest.approx(15 - busy_union)
    assert hostspans.idle_in_passes(idle) == pytest.approx(200 / 6.5)
    assert hostspans.idle_in_passes({}) is None
    # A sync inside a pass counts as inside it.
    assert hostspans.idle_in_passes({"step/shade0/sync": 1.0,
                                     "step/sync": 3.0}) == 25.0


def recording(frames):
    """A spans.Recording holding ``frames`` frames, each: step 10 ms with
    two camera syncs (0.5 ms each), shade0 4 ms with a 1.5 ms shadow and
    a 0.25 ms NEE sync inside, asvgf 2 ms; blit 3 ms with a 1 ms
    read-back; and the counts of two waves."""
    from loupiote_tpu_torch.spans import Recording, Span

    rec = Recording()
    ms = 1_000_000
    for k in range(1, frames + 1):
        t = k * 100 * ms
        base = len(rec.spans)
        rec.spans += [
            Span("step", t, t + 10 * ms, -1, k),
            Span("sync", t, t + ms // 2, base, k),
            Span("sync", t + ms, t + 3 * ms // 2, base, k),
            Span("shade0", t + 2 * ms, t + 6 * ms, base, k),
            Span("shadow", t + 2 * ms, t + 7 * ms // 2, base + 3, k),
            Span("sync", t + 5 * ms, t + 5 * ms + ms // 4, base + 3, k),
            Span("asvgf", t + 7 * ms, t + 9 * ms, base, k),
            Span("blit", t + 20 * ms, t + 23 * ms, -1, k),
            Span("sync", t + 21 * ms, t + 22 * ms, base + 7, k),
        ]
        rec.count("sync", "camera", 2)
        rec.count("sync", "nee")
        rec.count("sync", "readback")
        rec.count("slots", "step/intersect0", 100)
        rec.count("live", "step/intersect0", 100)
        rec.count("slots", "step/shade0/shadow", 100)
        rec.count("live", "step/shade0/shadow", 50)
    rec.frame = frames
    return rec


def test_host_readings_of_a_recording():
    got = hostspans.host_readings(recording(3))
    assert got == pytest.approx({
        "step_host_ms": 10.0, "blit_ms": 3.0, "sync_wait_ms": 1.25,
        "host_syncs_per_frame": 4.0, "shade_host_ms": 2.5,
        "asvgf_host_ms": 2.0, "live_ray_share": 75.0})
    tenths = hostspans.by_tenth(recording(3))
    assert tenths["step"] == pytest.approx([10.0, 10.0, 10.0])
    assert set(tenths) == {"step", "shade0", "shadow", "asvgf"}


def test_named_readings_of_a_new_span_and_counter():
    """Any span or counter is read by name: a ``tlas`` span inside
    ``intersect0`` and a ``tlas_waves`` counter the recording above does
    not hold; the readings of the existing names are as before."""
    from loupiote_tpu_torch.spans import Span

    rec = recording(2)
    ms = 1_000_000
    for k in (1, 2):
        t = k * 100 * ms
        base = len(rec.spans)
        rec.spans += [Span("intersect0", t + 30 * ms, t + 34 * ms, -1, k),
                      Span("tlas", t + 31 * ms, t + 33 * ms, base, k)]
        rec.count("tlas_waves", "step/intersect0/tlas", 24)
    got = hostspans.named_readings(rec)
    assert got["span_ms:tlas"] == pytest.approx(2.0)
    assert got["span_ms:intersect0"] == pytest.approx(4.0)
    assert got["span_ms:shade0"] == pytest.approx(4.0)
    assert got["span_ms:sync"] == pytest.approx(2.25)
    assert got["count:tlas_waves"] == 24.0
    assert got["count:tlas_waves:step/intersect0/tlas"] == 24.0
    assert got["count:slots"] == 200.0
    assert got["count:sync:camera"] == 2.0
    assert hostspans.named_readings(recording(0)) == {}
    assert hostspans.host_readings(rec) == pytest.approx({
        "step_host_ms": 10.0, "blit_ms": 3.0, "sync_wait_ms": 1.25,
        "host_syncs_per_frame": 4.0, "shade_host_ms": 2.5,
        "asvgf_host_ms": 2.0, "live_ray_share": 75.0})


def test_a_metric_file_reads_by_name(monkeypatch):
    monkeypatch.setattr(hostspans, "_measure",
                        lambda ctx: hostspans.named_readings(recording(3)))
    monkeypatch.setattr(hostspans, "_last", None)
    ctx = NS()
    assert hostspans.reading(ctx, "span_ms:shade0") == pytest.approx(4.0)
    assert hostspans.reading(ctx, "count:slots") == 200.0
    assert hostspans.reading(ctx, "span_ms:tlas") is None


def test_readers_read_the_stretch_once(monkeypatch):
    calls = []

    def measure(ctx):
        calls.append(ctx)
        return {"step_host_ms": 12.5, "live_ray_share": 80.0}

    monkeypatch.setattr(hostspans, "_measure", measure)
    monkeypatch.setattr(hostspans, "_last", None)
    ctx = NS()
    assert metrics.read("step_host_ms.viewer", ctx) == 12.5
    assert metrics.read("live_ray_share", ctx) == 80.0
    assert metrics.read("asvgf_host_ms.denoised", ctx) is None
    assert calls == [ctx]


def test_no_recorder_no_reading(monkeypatch):
    monkeypatch.setitem(sys.modules, "loupiote_tpu_torch.spans", None)
    monkeypatch.setattr(hostspans, "_last", None)
    assert hostspans.reading(NS(), "step_host_ms") is None


def test_clock_offsets_and_calls_on_synthetic_events():
    mine = [("step", 1_000_000), ("raygen", 1_010_000), ("sync", 1_020_000),
            ("sync", 1_030_000)]
    ranges = [("step", 1_004_000), ("raygen", 1_012_000),
              ("sync", 1_021_000), ("sync", 1_035_000)]
    assert hostspans.clock_offsets(mine, ranges) == [4.0, 2.0, 1.0, 5.0]

    def host(name, parent=None, eid=-1, start=0.0):
        return NS(name=name, device_type="DeviceType.CPU", cpu_parent=parent,
                  id=eid, time_range=NS(start=start, end=start + 1),
                  is_user_annotation=False)

    step = host("step")
    raygen = host("raygen", step)
    sync = host("sync", raygen)
    shade = host("shade0", step)
    evs = [step, raygen, sync, shade,
           host("cudaMemcpyAsync", host("aten::copy_", sync), 1, 10.0),
           host("cudaStreamSynchronize", host("aten::copy_", sync)),
           host("cudaMemcpyAsync", host("aten::clone", shade), 2, 20.0),
           host("cudaStreamSynchronize", host("aten::nonzero", shade)),
           host("cudaDeviceSynchronize", host("wait"))]
    assert hostspans.waiting_calls(evs) == {
        "cudaMemcpyAsync": {"sync": 1, "shade0": 1},
        "cudaStreamSynchronize": {"sync": 1, "shade0": 1},
        "cudaDeviceSynchronize": {"wait": 1}}
    dev = NS(name="Memcpy HtoD", device_type="DeviceType.CUDA", id=1,
             cpu_parent=None, time_range=NS(start=14.5, end=15.0),
             is_user_annotation=False)
    assert hostspans.launch_lags(evs + [dev]) == [4.5]


@pytest.fixture(scope="module")
def cpu_session():
    import torch

    cell = small_cell("viewer720p-flythrough-denoised", triangles=20_000,
                      scale=0.5)
    scene, hdr = runner.make_inputs(cell, 7)
    return program.build(cell, scene, hdr, 7, torch.device("cpu"))


def test_stretches_on_the_cpu(cpu_session, monkeypatch):
    import torch

    from loupiote_tpu_torch import spans

    monkeypatch.setattr(hostspans, "HOST_SECONDS", 0.2)
    monkeypatch.setattr(hostspans, "BLOCKS", 1)
    monkeypatch.setattr(hostspans, "BLOCK_SECONDS", 0.05)
    dev = torch.device("cpu")
    got = hostspans.host_stretch(spans, cpu_session, dev)
    assert got["step_host_ms"] > got["asvgf_host_ms"] > 0
    assert got["host_syncs_per_frame"] == 6.0  # 2 + 1 + 2 + 1
    assert 0 < got["live_ray_share"] < 100
    assert got["span_ms:step"] == pytest.approx(got["step_host_ms"])
    assert got["count:sync"] == 6.0 and got["count:slots"] > 0
    # No device activity in a CPU trace: no idle reading.
    assert hostspans.idle_stretch(spans, cpu_session, dev, 1) == {}
    hostspans.clock_stretch(spans, cpu_session, dev)
    assert spans.active() is None
