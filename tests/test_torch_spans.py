"""The port's span recorder (loupiote_tpu_torch/spans.py) on the CPU.

Standards: the spans of a frame form the tree of its passes (names,
nesting, frame numbers, self times) in every frame mode and on the
tile-parallel path; recording changes no pixel and no random number;
with no recording on nothing is kept; the live-ray counts and the sync
sites are what the frame's waves and copies are; mapped onto the Unix
clock, each span starts within 200 us of the profiler's range of the
same name.
"""

import numpy as np
import pytest
import torch

import loupiote_tpu_torch as lt
from loupiote_tpu_torch import spans
from loupiote_tpu_torch.app import Driver
from loupiote_tpu_torch.parallel import make_mesh
from loupiote_tpu_torch.render import CameraController

HALL_ORIGIN = np.array([0.0, 5.0, 34.0], np.float32)
HALL_DIR = np.array([0.15, -0.12, -1.0], np.float32) / np.linalg.norm(
    np.array([0.15, -0.12, -1.0], np.float32))
# Inside the hall, facing its open -x side: every primary ray leaves it.
OPEN_ORIGIN = np.array([-18.0, 6.0, 0.0], np.float32)
OPEN_DIR = np.array([-1.0, 0.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def hall():
    """A hall past the sort threshold, so the frame sorts its bounces."""
    bufs = lt.build_scene_buffers(lt.build_arch_scene(100_000), device="cpu")
    assert bufs.num_nodes > lt.ops.shade.SORT_MIN_NODES
    return bufs


def driver(bufs, mode=lt.BlitMode.PATHTRACE, origin=HALL_ORIGIN,
           direction=HALL_DIR, mesh=None):
    cfg = lt.RenderConfig(downsample_factor=1.0, bounces_static=2,
                          bounces_moving=2)
    d = Driver((32, 16), cfg, device="cpu")
    if mesh is not None:
        d.renderer = lt.Renderer((32, 16), cfg, mesh=mesh)
    d.renderer.set_resources(bufs)
    d.camera_controller = CameraController.from_origin_dir(origin,
                                                           direction)
    d.settings.blit_mode = mode
    d.settings.accumulate = True
    return d


def outline(rec, frame):
    """The frame's spans in order, each indented by its depth."""
    return ["  " * (len(rec.path(i)) - 1) + s.name
            for i, s in enumerate(rec.spans) if s.frame == frame]


def frame_outline(mode, shards=1):
    bounce0 = ["  intersect0", "  gbuffer", "  shade0", "    shadow",
               "    sync"]
    bounce1 = ["  sortb1", "  intersect1", "  shade1", "    shadow",
               "    shadow"]
    trace = (["  raygen", "    sync"] + bounce0 + bounce1) * shards
    finish = ["  finish"] + (["    asvgf"] if mode in (
        lt.BlitMode.DENOISED_PATHTRACE, lt.BlitMode.TEMPORAL) else [])
    reads = 2 if mode == lt.BlitMode.GBUFFER else 1
    return (["step", "  sync", "  sync"] + trace + finish
            + ["blit"] + ["  sync"] * reads)


@pytest.mark.parametrize("mode", [lt.BlitMode.PATHTRACE,
                                  lt.BlitMode.DENOISED_PATHTRACE,
                                  lt.BlitMode.TEMPORAL,
                                  lt.BlitMode.GBUFFER])
def test_frame_span_tree(hall, mode):
    d = driver(hall, mode)
    d.step(dt=1 / 60)
    d.renderer.blit()
    with spans.recording() as rec:
        for _ in range(2):
            d.step(dt=1 / 60)
            d.renderer.blit()
    assert rec.frame == 2
    for k in (1, 2):
        assert outline(rec, k) == frame_outline(mode)
    assert [s.frame for s in rec.spans] == sorted(s.frame for s in rec.spans)
    assert all(s.end_ns >= s.start_ns for s in rec.spans)
    own = rec.self_ns()
    assert min(own) >= 0
    for k in (1, 2):
        roots = [s for s in rec.spans if s.frame == k and s.parent < 0]
        assert [s.name for s in roots] == ["step", "blit"]
        assert sum(own[i] for i, s in enumerate(rec.spans)
                   if s.frame == k) == sum(s.ns for s in roots)
    # A child lies inside its parent.
    for s in rec.spans:
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_tile_frames_keep_the_pass_spans_under_the_frame(hall):
    cpu = torch.device("cpu")
    d = driver(hall, mesh=make_mesh(2, 1, devices=[cpu, cpu]))
    with spans.recording() as rec:
        d.step(dt=1 / 60)
        d.renderer.blit()
    assert outline(rec, 1) == frame_outline(lt.BlitMode.PATHTRACE, shards=2)
    assert rec.counts[("slots", "step/intersect0")] == 32 * 16


@pytest.mark.parametrize("mode", [lt.BlitMode.PATHTRACE,
                                  lt.BlitMode.DENOISED_PATHTRACE])
def test_recording_changes_no_pixel(hall, mode):
    quiet, recorded = driver(hall, mode), driver(hall, mode)
    images = []
    for d, on in ((quiet, False), (recorded, True)):
        with spans.recording() if on else _nothing():
            for _ in range(3):
                d.step(dt=1 / 60)
                images.append(d.renderer.blit())
    for a, b in zip(images[:3], images[3:]):
        np.testing.assert_array_equal(a, b)
    for name in ("accum", "denoised", "asvgf_illum", "asvgf_moments"):
        assert torch.equal(getattr(quiet.renderer.state, name),
                           getattr(recorded.renderer.state, name))
    assert torch.equal(quiet.renderer.generator.get_state(),
                       recorded.renderer.generator.get_state())


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_recording_off_keeps_nothing(hall):
    d = driver(hall)
    with spans.recording() as rec:
        pass
    assert spans.active() is None
    d.step(dt=1 / 60)
    d.renderer.blit()
    spans.rays(torch.ones(4, dtype=torch.bool))
    with spans.sync("elsewhere"):
        pass
    assert rec.spans == [] and rec.counts == {} and rec.frame == 0
    assert spans.active() is None


def test_live_rays_against_slots(hall):
    slots = 32 * 16
    d = driver(hall)
    with spans.recording() as rec:
        d.step(dt=1 / 60)
    live = {k: v for (n, k), v in rec.counts.items() if n == "live"}
    assert rec.counts[("slots", "step/intersect0")] == slots
    assert live["step/intersect0"] == slots  # bounce 0: every slot
    assert 0 < live["step/intersect1"] <= slots
    # The last bounce's two shadow waves (NEE, final gather) share a key.
    assert rec.counts[("slots", "step/shade1/shadow")] == 2 * slots
    assert set(live) == {k for (n, k) in rec.counts if n == "slots"}
    d = driver(hall, origin=OPEN_ORIGIN, direction=OPEN_DIR)
    with spans.recording() as rec:
        d.step(dt=1 / 60)
    assert rec.counts[("live", "step/intersect0")] == slots
    assert rec.counts[("live", "step/intersect1")] == 0  # every ray left
    assert rec.counts[("live", "step/shade0/shadow")] == 0


def test_sync_sites_of_a_frame(hall):
    d = driver(hall)
    with spans.recording() as rec:
        d.step(dt=1 / 60)
        d.renderer.blit()
    sites = {k: v for (n, k), v in rec.counts.items() if n == "sync"}
    # Two camera matrices, the field of view, one NEE flag a bounce but
    # the last, the image read back.
    assert sites == {"camera": 2, "vfov": 1, "nee": 1, "readback": 1}
    assert rec.total("sync") == sum(s.name == "sync" for s in rec.spans)


def test_spans_map_onto_the_profiler_clock(hall):
    from torch.profiler import ProfilerActivity, profile

    d = driver(hall)
    d.step(dt=1 / 60)
    got = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("warm"):
            pass
        with spans.recording() as rec:
            d.step(dt=1 / 60)
            d.renderer.blit()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    names = {s.name for s in rec.spans}
    for e in prof.events():
        if e.name in names:
            got.append((e.name, start_ns + e.time_range.start * 1e3))
    got.sort(key=lambda g: g[1])
    mapped = sorted(((s.name, rec.unix_ns(s.start_ns)) for s in rec.spans),
                    key=lambda m: m[1])
    assert [g[0] for g in got] == [m[0] for m in mapped]
    off_us = [abs(g[1] - m[1]) / 1e3 for g, m in zip(got, mapped)]
    assert max(off_us) < 200, off_us
