"""Reduction of ``torch.profiler`` traces of a run's frames to what the
per-layer metrics read.

Two traces, each of a few frames after the timed window: one with CUDA
activity alone, for the device's busy time, the kernels by name and the
launch count (the CPU profiler's own cost slows the host and so inflates
the idle share), and one with CPU and CUDA activity, for the split of
device time by the program's ``record_function`` ranges and for what the
host was issuing before each idle gap.

The attribution is a frozen copy of the port's
``loupiote_tpu_torch/app/trace_parse.py`` (each device activity counts
under the innermost labelled range around the runtime call that launched
it), and ``by_range`` counts the same activities under the innermost
range of any name; the busy arithmetic is that of the port's
``scripts/torch_profile_interactive.py``: the sum of the device's kernel,
copy and fill intervals, user annotations excluded.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, Optional


def frame_tokens(bounces: int, denoised: bool) -> list:
    """The range tokens of one frame, innermost-first where nested."""
    toks = ["raygen"]
    for b in range(bounces):
        if b > 0:
            toks.append(f"sortb{b}")
        toks += [f"intersect{b}", f"shade{b}/shadow", f"shade{b}"]
    toks.append("gbuffer")
    if denoised:
        toks.append("asvgf")
    return toks


def _is_cpu(evt) -> bool:
    return str(getattr(evt, "device_type", "CPU")).rsplit(".", 1)[-1] \
        .upper() == "CPU"


def _is_annotation(evt) -> bool:
    return (bool(getattr(evt, "is_user_annotation", False))
            or "annotation" in str(getattr(evt, "activity_type", "")).lower()
            or evt.name.startswith("ProfilerStep"))


def _range_path(evt) -> list:
    names = []
    while evt is not None:
        names.append(evt.name)
        evt = evt.cpu_parent
    return names[::-1]


def _label_of(path: list, tokens: list) -> Optional[str]:
    for i in range(len(path) - 1, -1, -1):
        for tok in tokens:
            parts = tok.split("/")
            if parts[-1] != path[i]:
                continue
            j = i
            for p in reversed(parts[:-1]):
                j -= 1
                while j >= 0 and path[j] != p:
                    j -= 1
                if j < 0:
                    break
            else:
                return tok
    return None


def device_activities(events: Iterable, ranges=()) -> list:
    """``(launching host event or None, name, start us, end us)`` of every
    device activity (kernel, copy, fill) of a trace, in start order."""
    events = list(events)
    runtime = {e.id: e for e in events
               if _is_cpu(e) and e.name.startswith("cu")}
    out = []
    for e in events:
        if _is_cpu(e) or e.name in ranges or _is_annotation(e):
            continue
        out.append((runtime.get(e.id), e.name, float(e.time_range.start),
                    float(e.time_range.end)))
    out.sort(key=lambda a: a[2])
    return out


def is_kernel(name: str) -> bool:
    """A launched kernel, not a copy or a fill."""
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset"))


def attribute(events: Iterable, tokens: list) -> dict:
    """{token: [device ms, activity count]} of a CPU and CUDA trace, and
    "other" for device work under no token's range."""
    ranges = {p for tok in tokens for p in tok.split("/")}
    sums = OrderedDict((tok, [0.0, 0]) for tok in tokens)
    sums["other"] = [0.0, 0]
    for parent, _, t0, t1 in device_activities(events, ranges):
        tok = (_label_of(_range_path(parent), tokens)
               if parent is not None else None)
        acc = sums[tok if tok is not None else "other"]
        acc[0] += (t1 - t0) / 1e3
        acc[1] += 1
    return dict(sums)


def range_names(events: Iterable) -> set:
    """The names of the ``record_function`` ranges of a CPU and CUDA
    trace (user annotations on the host), the profiler's steps left out."""
    return {e.name for e in events if _is_cpu(e) and _is_annotation(e)
            and not e.name.startswith("ProfilerStep")}


def _innermost_range(evt) -> str:
    """The name of the innermost ``record_function`` range around a host
    event, "" where there is none."""
    while evt is not None:
        if _is_annotation(evt) and not evt.name.startswith("ProfilerStep"):
            return evt.name
        evt = evt.cpu_parent
    return ""


def by_range(events: Iterable) -> dict:
    """{range name: [device ms, activity count]} of a CPU and CUDA trace:
    each device activity under the innermost ``record_function`` range
    open around the runtime call that launched it, for every name (a
    span of the program is the range of its name); "" for activities
    under none. Unlike ``attribute``, no list of tokens: a range inside
    ``intersect0`` keeps its own device time."""
    events = list(events)
    sums: dict = {}
    for parent, _, t0, t1 in device_activities(events, range_names(events)):
        acc = sums.setdefault(_innermost_range(parent), [0.0, 0])
        acc[0] += (t1 - t0) / 1e3
        acc[1] += 1
    return sums


def idle_gaps(events: Iterable, tokens: list, top: int = 10) -> list:
    """The idle gaps between device activities of a CPU and CUDA trace,
    summed by what the host issued to end each: ``range token / op`` of
    the runtime call that launched the activity after the gap. The
    ``top`` largest ``[name, seconds]``."""
    ranges = {p for tok in tokens for p in tok.split("/")}
    acts = device_activities(events, ranges)
    sums: dict = {}
    end = None
    for parent, name, t0, t1 in acts:
        if end is not None and t0 > end:
            label = "no launching call"
            if parent is not None:
                path = _range_path(parent)
                tok = _label_of(path, tokens) or "no range"
                op = path[-2] if len(path) >= 2 else path[-1]
                label = f"{tok} / {op}"
            sums[label] = sums.get(label, 0.0) + (t0 - end) / 1e6
        end = t1 if end is None else max(end, t1)
    return sorted(([k, v] for k, v in sums.items()),
                  key=lambda kv: -kv[1])[:top]


def device_summary(events: Iterable) -> dict:
    """Busy ms, kernel count and ms by kernel name of a trace."""
    acts = device_activities(events)
    by_name: dict = {}
    busy = 0.0
    kernels = 0
    for _, name, t0, t1 in acts:
        ms = (t1 - t0) / 1e3
        busy += ms
        by_name[name] = by_name.get(name, 0.0) + ms
        kernels += is_kernel(name)
    return {"busy_ms": busy, "kernels": kernels, "by_name": by_name,
            "activities": len(acts)}
