"""Per-pass device time from a ``torch.profiler`` trace of one frame
(counterpart of ``loupiote_tpu/app/trace_parse.py``, whose XSpace parser
reads a ``jax.profiler`` trace).

The integrator, ``shade_step`` and the renderer put a
``torch.profiler.record_function`` range around each stage under the
reference's tokens (``raygen``, ``sortb{N}``, ``intersect{N}``,
``gbuffer``, ``shade{N}`` with ``shadow`` inside it, ``asvgf``).
Each device kernel (and copy or memset) in a ``torch.profiler`` trace
shares its correlation id with the CUDA runtime call that launched it,
a host event nested in the op (or, for a kernel launched through ctypes,
the range) it was launched under. ``attribute_passes`` walks up from that
call to the innermost range whose path names a token, so a kernel of the
shadow wave inside ``shade1`` counts once, under ``shade1/shadow``, and
never again under ``shade1``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, Optional


def frame_scope_labels(bounces: int, denoised: bool = False
                       ) -> "OrderedDict[str, str]":
    """Scope-token -> label map for one frame, in the reference's label
    vocabulary (its performance window)."""
    m: "OrderedDict[str, str]" = OrderedDict()
    m["raygen"] = "ray generation"
    for b in range(bounces):
        if b > 0:
            m[f"sortb{b}"] = f"sort {b}"
        m[f"intersect{b}"] = ("primary intersection" if b == 0
                              else f"intersection {b}")
        m[f"shade{b}/shadow"] = f"shadow {b}"
        m[f"shade{b}"] = f"shading {b}"
    if denoised:
        m["asvgf"] = "asvgf"
    return m


def _is_cpu(evt) -> bool:
    return str(getattr(evt, "device_type", "CPU")).rsplit(".", 1)[-1] \
        .upper() == "CPU"


def _range_path(evt) -> list:
    """Names of ``evt`` and its host ancestors, outermost first."""
    names = []
    while evt is not None:
        names.append(evt.name)
        evt = evt.cpu_parent
    return names[::-1]


def _label_of(path: list, tokens: list) -> Optional[str]:
    """The token of the innermost range in ``path`` that ends a token
    whose other components are ranges above it, in order."""
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


def device_events(events: Iterable, ranges=()) -> list:
    """``(host event, device ms)`` of each device activity (kernel, copy,
    memset) in a ``torch.profiler`` event list (``prof.events()``), with
    the host event it was launched under: the CUDA runtime call that
    launched it (the activity's id is that call's correlation id), whose
    host ancestors are the op and the ranges around the launch; None where
    the trace holds no such call. ``ranges``: range names, whose
    device-side copies are not activities."""
    events = list(events)
    runtime = {e.id: e for e in events
               if _is_cpu(e) and e.name.startswith("cu")}
    out = []
    for e in events:
        # The device's own copy of a range or of the profiler's step (a
        # GPU user annotation) spans the kernels under it: not an
        # activity.
        if (_is_cpu(e) or e.name in ranges
                or e.name.startswith("ProfilerStep")
                or "annotation" in str(getattr(e, "activity_type",
                                               "")).lower()):
            continue
        out.append((runtime.get(e.id),
                    (e.time_range.end - e.time_range.start) / 1e3))
    return out


def attribute_passes(events: Iterable, scope_labels: "OrderedDict[str, str]"
                     ) -> "OrderedDict[str, float]":
    """Device ms per pass label (``other`` for activities under no
    labelled range) from a ``torch.profiler`` event list. Range names
    themselves are host events: only device activities are summed."""
    tokens = list(scope_labels)
    ranges = {p for tok in tokens for p in tok.split("/")} | {"gbuffer"}
    sums: "OrderedDict[str, float]" = OrderedDict(
        (label, 0.0) for label in scope_labels.values())
    sums["other"] = 0.0
    for parent, ms in device_events(events, ranges):
        tok = (_label_of(_range_path(parent), tokens)
               if parent is not None else None)
        sums[scope_labels[tok] if tok is not None else "other"] += ms
    return sums


def matched_share(sums: "OrderedDict[str, float]") -> float:
    """Share of the device time under a label."""
    total = sum(sums.values())
    return (total - sums.get("other", 0.0)) / total if total > 0 else 0.0
