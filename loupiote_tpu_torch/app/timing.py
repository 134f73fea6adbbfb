"""Per-pass timing: labelled timers for the performance window
(counterpart of ``loupiote_tpu/app/timing.py``).

``Queries`` brackets passes and the whole frame on the host clock; with
``sync=True`` a pass's end waits for the card that holds its result
(``torch.cuda.synchronize``), which is exact but stops the pipelining.
``Renderer.measure_passes`` records the card's own per-pass times into it.
``profiler_trace`` records a ``torch.profiler`` trace for kernel-level
inspection.
"""

from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import List, Optional

import torch


class Queries:
    """Frame-scoped labeled timers (Queries::start/end/resolve analog)."""

    def __init__(self, max_queries: int = 16, sync: bool = False):
        self.max_queries = max_queries
        self.sync = sync
        self._current: "OrderedDict[str, float]" = OrderedDict()
        self._resolved: "OrderedDict[str, float]" = OrderedDict()
        self._open: Optional[tuple] = None
        self._frame_start = 0.0
        self._frame_ms = 0.0

    # -- frame brackets (start_frame/end_frame analog) ----------------------
    def start_frame(self) -> None:
        self._current = OrderedDict()
        self._frame_start = time.perf_counter()

    def end_frame(self) -> None:
        self._frame_ms = (time.perf_counter() - self._frame_start) * 1e3

    # -- pass brackets -------------------------------------------------------
    def start(self, label: str) -> None:
        self._open = (label, time.perf_counter())

    def end(self, result=None) -> None:
        if self._open is None:
            return
        label, t0 = self._open
        if self.sync and result is not None:
            _synchronize(result)
        if len(self._current) < self.max_queries:
            self._current[label] = (time.perf_counter() - t0) * 1e3
        self._open = None

    @contextlib.contextmanager
    def scope(self, label: str):
        self.start(label)
        try:
            yield
        finally:
            self.end()

    def record(self, label: str, ms: float) -> None:
        """Record an externally measured duration under ``label`` (used by
        Renderer.measure_passes to surface per-pass kernel timings)."""
        if len(self._current) < self.max_queries:
            self._current[label] = ms

    def resolve(self) -> None:
        """Latch this frame's timings (Queries::resolve analog)."""
        self._resolved = self._current

    # -- the performance window's surface ----------------------------------
    def values(self) -> List[float]:
        return list(self._resolved.values())

    def labels(self) -> List[str]:
        return list(self._resolved.keys())

    @property
    def frame_ms(self) -> float:
        return self._frame_ms


def _synchronize(result) -> None:
    """Wait for the card that holds ``result`` (a tensor, or a tuple, list
    or dict of them); nothing to wait for off the card."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _synchronize(v)
    elif hasattr(result, "__dataclass_fields__"):
        for f in result.__dataclass_fields__:
            _synchronize(getattr(result, f))


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block (the card's kernels
    when one is used) and write it as a Chrome trace,
    ``logdir/trace.json``; yields the profiler."""
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
