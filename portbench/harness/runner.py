"""One run of one cell: set-up, the warm-up frames, the timed window, the
traced frames (``trace``), then the reference's check of the frames the
program rendered."""

from __future__ import annotations

import gc
import math
import statistics
import sys
import time

import numpy as np

from . import inputs, judge, metrics, program, tracing
from .cells import Cell, metric_names, metric_units
from .peaks import peaks_for

FORBIDDEN = ("jax", "jaxlib", "flax", "loupiote_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that no run may hold: JAX and
    the JAX package, compared whole (``loupiote_tpu_torch`` is not
    ``loupiote_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def make_inputs(cell: Cell, seed: int):
    """(the scene, the sky's ``.hdr`` bytes or None) of a cell and seed."""
    sc = cell.config["scene"]
    scene = inputs.build_hall(triangles=int(sc["triangles"]),
                              layout_seed=int(sc["layout_seed"]),
                              textured=bool(sc["textured"]),
                              props=int(sc["props"]))
    hdr = None
    if sc.get("sky"):
        h, w = sc["sky"]["height"], sc["sky"]["width"]
        hdr = inputs.hdr_bytes(inputs.sky_equirect(h, w, seed))
    return scene, hdr


def flat_triangles(scene) -> int:
    return sum(len(scene.meshes[i.mesh_index].indices) // 3
               for i in scene.instances)


def _device_allocs(dev) -> int:
    """cudaMalloc calls of the caching allocator so far (0 off the card):
    one in the window is a synchronising call a steady frame should not
    make."""
    import torch

    if dev.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(dev).get("num_device_alloc", 0))


def p95(times: list) -> float:
    """The 95th percentile (inclusive quantiles; one time is its own)."""
    if len(times) == 1:
        return times[0]
    return statistics.quantiles(times, n=20, method="inclusive")[18]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """The result of one run (the dict the last line prints), with
    ``"exit"`` set where the run must print none."""
    import torch

    from ..reference.session import Session as Reference

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    traffic = cell.traffic
    scene, hdr = make_inputs(cell, seed)
    session = program.build(cell, scene, hdr, seed, dev)
    r = session.driver.renderer
    log(f"cell {cell.name}: internal {r.size[0]}x{r.size[1]}, window "
        f"{r.window_size[0]}x{r.window_size[1]}, "
        f"{flat_triangles(scene)} triangles, BVH2 nodes "
        f"{session.driver.stats.get('bvh_nodes')}, scene build "
        f"{session.scene_build_s:.3f} s")

    warm = int(traffic["warmup_frames"])
    t_warm = []
    for _ in range(warm):
        t0 = time.perf_counter()
        session.captured_frame()
        t_warm.append(time.perf_counter() - t0)
    warm_caps = list(session.captures)
    session.captures.clear()
    if on_card:
        torch.cuda.synchronize(dev)
    # What set-up made lives on: the collector's full passes in the window
    # need not walk it again.
    gc.collect()
    gc.freeze()
    setup_s = time.monotonic() - t_start
    log(f"warm-up frames (s): {', '.join(f'{t:.4f}' for t in t_warm)}; "
        f"set-up {setup_s:.3f} s")

    # The window: its first frame, one frame drawn from the seed and its
    # last are checked.
    first = warm + 1
    est = seconds / max(t_warm[-1], 1e-3)
    pick = np.random.default_rng([seed, 0x6a756467]).random()
    middle = first + 1 + int(pick * max(0.8 * est - 3.0, 0.0))
    times = []
    last = None
    allocs = _device_allocs(dev)
    t_w0 = time.perf_counter()
    while not times or time.perf_counter() - t_w0 < seconds:
        t0 = time.perf_counter()
        k = session.frames + 1
        if k in (first, middle):
            session.captured_frame()
        else:
            before = r.state
            img = session.frame()
            last = program.Capture(k, before, r.state, img)
        times.append(time.perf_counter() - t0)
    window_s = time.perf_counter() - t_w0
    if last is not None:
        session.captures.append(last)
    window_caps = list(session.captures)
    session.captures.clear()
    frames = len(times)
    frame_ms = window_s * 1e3 / frames
    tenth = max(frames // 10, 1)
    log(f"frame ms by tenth of the window: " + ", ".join(
        f"{1e3 * statistics.fmean(times[i:i + tenth]):.1f}"
        for i in range(0, frames, tenth)) + f"; device allocations in the "
        f"window {_device_allocs(dev) - allocs}")
    w, h = r.size
    spp = cell.config["render"]["samples_per_frame"]
    bounces = cell.config["render"]["bounces_static"]
    log(f"window: {frames} frames in {window_s:.3f} s; frame {frame_ms:.4f} "
        f"ms, p95 {p95(times) * 1e3:.4f} ms; "
        f"{w * h * spp * bounces * 2 / (frame_ms / 1e3) / 1e6:.2f} Mrays/s "
        f"(pixels x bounces x 2 / frame time)")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    result: dict = {"correct": False, "attempted": frames, "failed": 0}
    units = metric_units(cell)
    found = {}
    if not trace:
        e2e = {"frame_ms": frame_ms, "frame_p95_ms": p95(times) * 1e3,
               "setup_s": setup_s}
        # A quantity may go by another name in some cells (the viewer's
        # frame time, held to its own bound): ``<prefix>_<quantity>``.
        found = {n: next(v for q, v in e2e.items() if n == q
                         or n.endswith("_" + q))
                 for n in metric_names(cell, "end_to_end")}
    dev_info = {"platform": "gpu" if on_card else dev.type,
                "kind": (torch.cuda.get_device_name(dev) if on_card
                         else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        nframes = int(traffic["trace_frames"])
        ev, wall = program.profiled(session, nframes, cpu=False, device=dev)
        summary = tracing.device_summary(ev)
        del ev
        tokens = tracing.frame_tokens(bounces, traffic["mode"] == "denoised")
        ev, _ = program.profiled(session, nframes, cpu=True, device=dev)
        passes = tracing.attribute(ev, tokens)
        ranges = tracing.by_range(ev)
        gaps = tracing.idle_gaps(ev, tokens)
        del ev
        ctx = metrics.TraceContext(
            cell=cell, size=(w, h), spp=spp, bounces=bounces,
            probe=hdr is not None, triangles=flat_triangles(scene),
            scene_build_s=session.scene_build_s, kind=dev_info["kind"],
            peaks=peaks_for(dev_info["kind"]) if on_card else {},
            passes=passes, pass_frames=nframes, ranges=ranges,
            device=summary, device_frames=nframes, device_wall_s=wall)
        found = {name: metrics.read(name, ctx)
                 for name in metric_names(cell, "per_layer")}
        dev_info.update(busy_s=summary["busy_ms"] / 1e3, window_s=wall)
        ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {
            "device_ops": [[n[:160], ms / 1e3] for n, ms in ops],
            "idle_gaps": gaps}
        log("passes (device ms over the traced frames): " + ", ".join(
            f"{t} {v[0]:.3f}" for t, v in passes.items()))
    result["metrics"] = {n: {"value": v, "unit": units[n]}
                         for n, v in found.items() if v is not None}
    result["device"] = dev_info

    # The program's state is freed before the reference runs; only the
    # checked frames' states stay.
    del session, r
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        return {"exit": 3, "why": f"loaded after the window: {bad}"}

    t0 = time.perf_counter()
    ref = Reference(scene, hdr, cell.config, traffic["mode"],
                    bool(traffic["accumulate"]), seed, dev,
                    float(traffic["dt"]))
    out = judge.judge(ref, warm_caps, window_caps,
                      inputs.CameraPath(traffic["camera"], seed))
    for k, where, nums in out["frames"]:
        log(f"check frame {k} ({where}): " + ", ".join(
            f"{n} {v!r}" for n, v in nums.items()))
    log(f"reference check: {time.perf_counter() - t0:.1f} s")
    limits = cell.limits
    result["correct"] = judge.verdict(out["worst"], limits)
    result["failed"] = sum(
        any(not (math.isfinite(nums[n]) and nums[n] <= limits[n])
            for n in limits) for _, _, nums in out["frames"])
    result["compared"] = {n: {"value": out["worst"][n], "limit": limits[n]}
                          for n in judge.NUMBERS}
    bad = forbidden_modules()
    if bad:
        return {"exit": 3, "why": f"loaded: {bad}"}
    return result
