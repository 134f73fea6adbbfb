"""What the program's own spans and counters say
(``loupiote_tpu_torch/spans.py``), read in a traced run on the card for
the per-layer metrics ``step_host_ms``, ``blit_ms``, ``sync_wait_ms``,
``host_syncs_per_frame``, ``shade_host_ms``, ``asvgf_host_ms``,
``live_ray_share`` and ``idle_in_passes``, and by name for any other.

1. The host's time: a fresh process of the same cell and seed (``python3
   -m portbench.harness.hostspans <cell> <seed>``) builds the session,
   renders the warm-up frames, then frames with recording off and on in
   turns (the recorder's cost), then ``HOST_SECONDS`` of frames with it
   on: the host's ms a frame in each span, the sync sites and the
   live-ray counts, and by name (``named_readings``) every span's host
   ms a frame and every counter's total a frame, which a metric file
   reads as ``reading(ctx, "span_ms:<name>")`` or
   ``reading(ctx, "count:<name>")``. On an H100 a process that has run
   the profiler issued a viewer frame 30-60% slower than before it, so
   the run's own process, after its profiled frames, would not read what
   its window ran.
2. After the run's two profiled stretches, the traffic's
   ``trace_frames`` frames with recording on under the profiler of CUDA
   activity alone (after a dropped warm-up frame, as the harness's own):
   each device-idle interval is split by the innermost span open on the
   host, both on the Unix clock that the profiler stamps its trace with.
3. Then one frame under the CPU and CUDA profiler: each span's start
   against the profiler's range of the same name (the clock mapping's
   check), and the runtime calls that make the host wait, by the span
   around them.

A metric's reader gets only the run's ``TraceContext``, which holds no
session, so ``reading`` takes the session, the seed and the window's
frame time from the ``runner.run_cell`` call that is reading the
metrics. The first reader of a run measures, the others read what it
kept. Where the program has no recorder, or the run is not on the card,
every reading is None.
"""

from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from typing import Optional

from . import program, runner, tracing
from .cells import ROOT, find_cell

HOST_SECONDS = 4.0
BLOCKS, BLOCK_SECONDS = 6, 0.5
PASS = re.compile(r"raygen|sortb\d+|intersect\d+|gbuffer|shade\d+|shadow"
                  r"|asvgf")
# Runtime calls that make the host wait for the device (a copy from or
# to pageable host memory does; one between device buffers does not, and
# shows under the pass that made it).
WAITING_CALLS = ("cudaStreamSynchronize", "cudaMemcpyAsync",
                 "cudaDeviceSynchronize")

_last: Optional[tuple] = None  # (ctx, readings) of the run read last


def reading(ctx, name: str) -> Optional[float]:
    """The reading ``name`` of the run whose context is ``ctx``."""
    global _last
    if _last is None or _last[0] is not ctx:
        _last = (ctx, _measure(ctx))
    return (_last[1] or {}).get(name)


def _run_locals() -> Optional[dict]:
    """The locals of the ``runner.run_cell`` call up the stack (its
    ``session``, ``dev``, ``seed`` and the window's ``frame_ms``), None
    outside one."""
    f = sys._getframe(1)
    while f is not None:
        if f.f_code is runner.run_cell.__code__:
            return f.f_locals
        f = f.f_back
    return None


def _measure(ctx) -> Optional[dict]:
    try:
        from loupiote_tpu_torch import spans
    except ImportError:  # a program without the recorder
        return None
    run = _run_locals()
    if run is None or run["dev"].type != "cuda":
        return None
    session, dev = run["session"], run["dev"]
    frames = int(ctx.cell.traffic["trace_frames"])
    try:
        out = fresh_process(ctx.cell.name, run["seed"], run["frame_ms"])
        out.update(idle_stretch(spans, session, dev, frames))
        clock_stretch(spans, session, dev)
    except Exception:  # the run's other metrics and its check go on
        import traceback

        runner.log("spans: the stretches failed, no reading:\n"
                   + traceback.format_exc())
        return None
    return out


def _wait(spans, dev) -> None:
    import torch

    with spans.span("wait"):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


# -- 1. the host's time by span, in a fresh process --------------------------

def fresh_process(cell_name: str, seed: int, window_frame_ms: float) -> dict:
    """The host readings of ``main`` run in a process of its own; its
    standard error goes to this run's."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "portbench.harness.hostspans",
                        cell_name, str(seed)], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    sys.stderr.write(p.stderr)
    if p.returncode != 0:
        raise RuntimeError(f"the fresh process exited {p.returncode}")
    got = json.loads(p.stdout.strip().splitlines()[-1])
    runner.log(f"spans: the fresh process took "
               f"{time.perf_counter() - t0:.1f} s; this run's window "
               f"(recording off): {window_frame_ms:.4f} ms a frame")
    return got


def main(argv=None) -> int:
    """In a fresh process: the cell's session on the card, its warm-up
    frames, then ``host_stretch``; prints the readings as one JSON line."""
    import gc

    import torch

    from loupiote_tpu_torch import spans

    name, seed = (argv or sys.argv[1:])[:2]
    torch.set_num_threads(1)
    cell = find_cell(name)
    dev = torch.device("cuda")
    scene, hdr = runner.make_inputs(cell, int(seed))
    session = program.build(cell, scene, hdr, int(seed), dev)
    for _ in range(int(cell.traffic["warmup_frames"])):
        session.frame()
    torch.cuda.synchronize(dev)
    gc.collect()
    gc.freeze()
    print(json.dumps(host_stretch(spans, session, dev)), flush=True)
    return 0


def host_stretch(spans, session, dev) -> dict:
    """Frames with recording off and on in turns, ``BLOCKS`` blocks of
    ``BLOCK_SECONDS`` each side (the frame time of each side, so that the
    host's drift falls on both alike), then ``HOST_SECONDS`` with
    recording on: its host readings."""
    blocks: dict = {False: [], True: []}
    for i in range(2 * BLOCKS):
        on = i % 2 == 1
        with spans.recording() if on else contextlib.nullcontext():
            t0 = time.perf_counter()
            n = 0
            while time.perf_counter() - t0 < BLOCK_SECONDS:
                session.frame()
                n += 1
            _wait(spans, dev)
            blocks[on].append((time.perf_counter() - t0) * 1e3 / n)
    with spans.recording() as rec:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < HOST_SECONDS:
            session.frame()
        _wait(spans, dev)
    out = host_readings(rec)
    named = named_readings(rec)
    off, on = (statistics.median(blocks[k]) for k in (False, True))
    runner.log(f"spans: recording off and on in turns, {BLOCKS} blocks of "
               f"{BLOCK_SECONDS} s each: median {off:.4f} ms a frame off, "
               f"{on:.4f} on ({100 * (on / off - 1):+.2f}%); blocks off "
               + ", ".join(f"{v:.2f}" for v in blocks[False]) + "; on "
               + ", ".join(f"{v:.2f}" for v in blocks[True]))
    runner.log("spans: host ms a frame by tenth of the recorded stretch: "
               + "; ".join(f"{name} " + ", ".join(f"{v:.2f}" for v in vals)
                           for name, vals in by_tenth(rec).items()))
    runner.log("spans: counts " + ", ".join(
        f"{n}[{k}] {v}" for (n, k), v in sorted(rec.counts.items())))
    runner.log("spans: readings " + ", ".join(
        f"{k} {v!r}" for k, v in out.items()))
    runner.log("spans: by name " + ", ".join(
        f"{k} {v:.4f}" for k, v in named.items()))
    out.update(named)
    return out


def host_readings(rec) -> dict:
    """The host readings of a recording of whole frames: ms a frame of the
    ``step`` and ``blit`` spans, of ``sync`` spans inside ``step``, of the
    ``shade{N}`` spans less their ``shadow`` children, of ``asvgf``
    (None where it did not run); sync sites a frame; live rays over slots
    in %."""
    n = rec.frame
    if n <= 0:
        return {}
    paths = [rec.path(i) for i in range(len(rec.spans))]

    def total_ms(keep) -> float:
        return sum(s.ns for s, p in zip(rec.spans, paths) if keep(s, p)) / 1e6

    shade = total_ms(lambda s, p: re.fullmatch(r"shade\d+", s.name)
                     is not None)
    shadow = total_ms(lambda s, p: s.name == "shadow" and len(p) > 1
                      and re.fullmatch(r"shade\d+", p[-2]) is not None)
    asvgf = total_ms(lambda s, p: s.name == "asvgf")
    slots = rec.total("slots")
    return {
        "step_host_ms": total_ms(lambda s, p: s.name == "step") / n,
        "blit_ms": total_ms(lambda s, p: s.name == "blit") / n,
        "sync_wait_ms": total_ms(lambda s, p: s.name == "sync"
                                 and p[0] == "step") / n,
        "host_syncs_per_frame": rec.total("sync") / n,
        "shade_host_ms": (shade - shadow) / n,
        "asvgf_host_ms": asvgf / n if asvgf > 0 else None,
        "live_ray_share": (100.0 * rec.total("live") / slots if slots
                           else None),
    }


def named_readings(rec) -> dict:
    """Readings by name, for any span or counter of the program, over a
    recording of whole frames: ``span_ms:<name>``, the host ms a frame in
    the spans of that name (with what they hold); ``count:<name>``, the
    counts named ``<name>`` a frame, summed over their keys; and
    ``count:<name>:<key>``, one key's count a frame."""
    n = rec.frame
    if n <= 0:
        return {}
    out: dict = {}
    for s in rec.spans:
        if s.end_ns >= 0:
            key = f"span_ms:{s.name}"
            out[key] = out.get(key, 0.0) + s.ns / 1e6 / n
    for (name, key), v in sorted(rec.counts.items()):
        out[f"count:{name}"] = out.get(f"count:{name}", 0.0) + v / n
        out[f"count:{name}:{key}"] = v / n
    return out


def by_tenth(rec) -> dict:
    """{name: [host ms a frame in each tenth of the frames]} for ``step``
    and each pass span."""
    n = rec.frame
    tenth = max(n // 10, 1)
    sums: dict = {}
    for s in rec.spans:
        if s.frame <= 0 or not (s.name == "step" or PASS.fullmatch(s.name)):
            continue
        row = sums.setdefault(s.name, [0.0] * ((n + tenth - 1) // tenth))
        row[(s.frame - 1) // tenth] += s.ns / 1e6
    counts = [min(tenth, n - i * tenth)
              for i in range((n + tenth - 1) // tenth)]
    return {name: [v / c for v, c in zip(row, counts)]
            for name, row in sums.items()}


# -- 2. the device's idle time by span --------------------------------------

def _profiled(spans, session, dev, frames: int, cpu: bool):
    """(recording, events, trace start ns) of ``frames`` frames under the
    profiler, after one traced frame that the schedule drops; the
    recording's frames 2 .. frames + 1 are the traced ones."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else []
    if cpu or not acts:
        acts.append(ProfilerActivity.CPU)
    got, start = [], []

    def ready(p):
        got.extend(p.events())
        start.append(p.profiler.kineto_results.trace_start_ns())

    with spans.recording() as rec:
        with profile(activities=acts, on_trace_ready=ready,
                     schedule=schedule(wait=0, warmup=1,
                                       active=frames)) as prof:
            for _ in range(frames + 1):
                session.frame()
                _wait(spans, dev)
                prof.step()
    return rec, got, start[0]


def idle_stretch(spans, session, dev, frames: int) -> dict:
    rec, events, start_ns = _profiled(spans, session, dev, frames, cpu=False)
    acts = [(t0 + start_ns / 1e3, t1 + start_ns / 1e3)
            for _, _, t0, t1 in tracing.device_activities(events)]
    host = [(rec.unix_ns(s.start_ns) / 1e3, rec.unix_ns(s.end_ns) / 1e3,
             "/".join(rec.path(i)))
            for i, s in enumerate(rec.spans) if s.frame >= 2]
    if not acts or not host:
        return {}
    t0, t1 = host[0][0], max(h[1] for h in host)
    idle = idle_by_span(host, acts, t0, t1)
    busy = sum(min(b, t1) - max(a, t0) for a, b in acts if b > t0 and a < t1)
    total = sum(idle.values())
    runner.log(f"spans: device idle over {frames} traced frames: "
               f"{total / 1e3 / frames:.3f} ms a frame by span, "
               f"{(t1 - t0 - busy) / 1e3 / frames:.3f} ms a frame as the "
               f"window less the device's work")
    by_name: dict = {}
    for path, us in idle.items():
        name = path.rsplit("/", 1)[-1] if path else "(no span)"
        by_name[name] = by_name.get(name, 0.0) + us
    runner.log("spans: idle ms a frame by innermost span: " + ", ".join(
        f"{k} {v / 1e3 / frames:.3f}"
        for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])))
    return {"idle_in_passes": idle_in_passes(idle)}


def innermost_segments(host: list) -> list:
    """``(start, end, path)`` pieces of the time the nested spans ``host``
    (``(start, end, path)`` in the order they opened) cover, each under
    the innermost span open in it; "" between spans."""
    segs, stack, t = [], [], None
    for a, b, path in host:
        while stack and stack[-1][0] <= a:
            end, p = stack.pop()
            segs.append((t, end, p))
            t = end
        if t is not None and a > t:
            segs.append((t, a, stack[-1][1] if stack else ""))
        stack.append((b, path))
        t = a
    while stack:
        end, p = stack.pop()
        segs.append((t, end, p))
        t = end
    return [s for s in segs if s[1] > s[0]]


def idle_by_span(host: list, acts: list, t0: float, t1: float) -> dict:
    """{span path: idle time} over [t0, t1]: the time no device activity
    (``(start, end)``) runs, split by the innermost span open on the host
    (``innermost_segments``; "" where none is). Sums to [t0, t1] less the
    union of the activities."""
    busy = []
    for a, b in sorted(acts):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    idle, t = [], t0
    for a, b in busy:
        if a > t:
            idle.append((t, a))
        t = b
    if t < t1:
        idle.append((t, t1))
    segs = innermost_segments(host)
    # Time outside every span inside the window is "".
    cover, t = [], t0
    for a, b, p in segs:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if a > t:
            cover.append((t, a, ""))
        cover.append((a, b, p))
        t = b
    if t < t1:
        cover.append((t, t1, ""))
    out: dict = {}
    i = 0
    for a, b in idle:
        while i < len(cover) and cover[i][1] <= a:
            i += 1
        j = i
        while j < len(cover) and cover[j][0] < b:
            lo, hi = max(a, cover[j][0]), min(b, cover[j][1])
            if hi > lo:
                out[cover[j][2]] = out.get(cover[j][2], 0.0) + hi - lo
            j += 1
    return out


def idle_in_passes(idle: dict) -> Optional[float]:
    """100 x the idle time under a pass span (the innermost open span or
    one around it) over all idle time."""
    total = sum(idle.values())
    if total <= 0:
        return None
    inside = sum(v for path, v in idle.items()
                 if any(PASS.fullmatch(p) for p in path.split("/") if p))
    return 100.0 * inside / total


# -- 3. the clock mapping and the waiting calls ------------------------------

def clock_stretch(spans, session, dev) -> None:
    rec, events, start_ns = _profiled(spans, session, dev, 1, cpu=True)
    names = {s.name for s in rec.spans}
    ranges = sorted(((e.name, start_ns + e.time_range.start * 1e3)
                     for e in events if tracing._is_cpu(e)
                     and e.name in names), key=lambda r: r[1])
    mine = sorted(((s.name, rec.unix_ns(s.start_ns)) for s in rec.spans
                   if s.frame == 2), key=lambda m: m[1])
    off = clock_offsets(mine, ranges)
    if off:
        runner.log(f"spans: clock: mapped span starts against the "
                   f"profiler's ranges of the same name, {len(off)} spans:"
                   f" median |d| {statistics.median(off):.1f} us, max "
                   f"{max(off):.1f} us")
    else:
        runner.log("spans: clock: no span matched a profiler range")
    lags = launch_lags(events)
    if lags:
        runner.log(f"spans: clock: device activity start less its launching "
                   f"call's start over {len(lags)} activities: min "
                   f"{min(lags):.1f} us, median {statistics.median(lags):.1f}"
                   f" us (below 0: the device's times run behind)")
    calls = waiting_calls(events)
    runner.log("spans: waiting calls in a traced frame (runtime call: "
               "{innermost span: count}): " + "; ".join(
                   f"{c} {d}" for c, d in calls.items())
               + f"; sync sites counted {rec.total('sync')}")


def clock_offsets(mine: list, ranges: list) -> list:
    """|start difference| in us of each ``(name, unix ns)`` span against
    the profiler range of the same name in the same order."""
    by_name: dict = {}
    for name, t in ranges:
        by_name.setdefault(name, []).append(t)
    seen: dict = {}
    out = []
    for name, t in mine:
        k = seen.get(name, 0)
        seen[name] = k + 1
        ts = by_name.get(name, [])
        if k < len(ts):
            out.append(abs(ts[k] - t) / 1e3)
    return out


def launch_lags(events) -> list:
    """Each device activity's start less that of the runtime call that
    launched it, in us, in one trace."""
    calls = {e.id: e for e in events
             if tracing._is_cpu(e) and e.name.startswith("cu")}
    return [float(e.time_range.start - calls[e.id].time_range.start)
            for e in events if not tracing._is_cpu(e) and e.id in calls
            and not tracing._is_annotation(e)]


def waiting_calls(events) -> dict:
    """{runtime call: {innermost program span around it: count}} of the
    calls that make the host wait (``WAITING_CALLS``) in a CPU and CUDA
    trace, the span named from the range path of the call."""
    out: dict = {}
    for e in events:
        if not tracing._is_cpu(e) or e.name not in WAITING_CALLS:
            continue
        path = tracing._range_path(e)
        where = next((p for p in reversed(path)
                      if p in ("sync", "wait") or PASS.fullmatch(p)
                      or p in ("step", "blit", "finish")), "(no span)")
        d = out.setdefault(e.name, {})
        d[where] = d.get(where, 0) + 1
    return out


if __name__ == "__main__":
    sys.exit(main())
