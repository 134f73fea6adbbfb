"""Per-layer metrics found by name: ``portbench/metrics/<name>.py``
defines ``read(ctx)``, which returns the metric's value from a traced
run's context (``TraceContext``), or None where the run holds nothing for
it to read, and the metric is then left out of the result's line. One
quantity split by the end-to-end metric it moves (``idle_share`` in the
headline cell, ``idle_share.viewer`` in a viewer cell) is read by the
file of its name before the first dot, unless a file has its whole
name."""

from __future__ import annotations

import importlib.util
import os
from dataclasses import dataclass, field
from typing import Optional

from .cells import BENCH_DIR

METRICS_DIR = os.path.join(BENCH_DIR, "metrics")


@dataclass
class TraceContext:
    cell: object  # cells.Cell
    size: tuple  # internal (width, height)
    spp: int
    bounces: int
    probe: bool
    triangles: int  # of the flattened scene
    scene_build_s: float
    kind: str  # the card's name
    peaks: dict
    # The CPU and CUDA trace: {token: [device ms, activities]}.
    passes: dict = field(default_factory=dict)
    pass_frames: int = 0
    # The same trace by the innermost range of any name
    # (``tracing.by_range``): {name: [device ms, activities]}.
    ranges: dict = field(default_factory=dict)
    # The CUDA-only trace: tracing.device_summary, its frames and wall s.
    device: dict = field(default_factory=dict)
    device_frames: int = 0
    device_wall_s: float = 0.0


def load(name: str):
    path = os.path.join(METRICS_DIR, name + ".py")
    if not os.path.exists(path):
        path = os.path.join(METRICS_DIR, name.split(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read(name: str, ctx: TraceContext) -> Optional[float]:
    return load(name).read(ctx)


def pass_ms(ctx: TraceContext, match) -> Optional[float]:
    """Device ms a frame of the traced passes whose token ``match``
    accepts; None where no device activity ran under any of them."""
    hits = [v for tok, v in ctx.passes.items() if tok != "other"
            and match(tok)]
    if ctx.pass_frames <= 0 or sum(v[1] for v in hits) == 0:
        return None
    return sum(v[0] for v in hits) / ctx.pass_frames


def range_ms(ctx: TraceContext, name: str) -> Optional[float]:
    """Device ms a frame of the activities whose innermost range is
    ``name`` (any span of the program, ``tlas`` inside ``intersect0``
    included), over the CPU and CUDA trace's frames; None where none ran
    under it."""
    v = ctx.ranges.get(name)
    if ctx.pass_frames <= 0 or not v or v[1] == 0:
        return None
    return v[0] / ctx.pass_frames
