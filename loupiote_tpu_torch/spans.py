"""Host spans and counters of a frame, on the clock of the device trace.

    with spans.recording() as rec:       # on: spans and counts are kept
        driver.step()
        driver.renderer.blit()
    rec.frame_ms()                       # {"step": ms, "raygen": ms, ...}
    rec.counts[("sync", "camera")]       # host syncs at that site

``span(name)`` opens the ``torch.profiler.record_function`` range of the
same name while a profiler is on, so its trace attributes device work to
it, and while a recording is on it also keeps a ``Span``: the name, its start and end on
``time.perf_counter_ns``, its parent and its frame. ``Driver.step`` opens
each frame's ``step`` span with ``new_frame=True``, which advances the
frame number that the spans of that frame share. With no recording and
no profiler on, a span costs two checks: it keeps nothing, opens no
range, launches nothing and does not wait for the device.

Counts are kept where the work happens: ``count(name, key)`` adds to one
on the host. ``sync(site)`` is a ``sync`` span around a copy between host
and device (which waits for the device's queue), counted by site on the
host. ``rays(active)`` counts a wave's live rays against its slots, keyed
by the path of the open spans: the slots on the host, the live rays as one
reduction added into a ``DeviceCounter``, read once when the recording
stops.

``Recording.clock`` is one ``(perf_counter_ns, time_ns)`` pair taken when
the recording starts; ``Recording.unix_ns`` puts a span's times on the
Unix clock, on which ``torch.profiler`` stamps its trace
(``kineto_results.trace_start_ns()`` plus an event's offset).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Iterator, Optional

import torch
from torch.profiler import record_function

from ._build import DeviceCounter


@dataclass
class Span:
    name: str
    start_ns: int  # time.perf_counter_ns
    end_ns: int  # -1 while open
    parent: int  # index in Recording.spans, -1 for a root
    frame: int

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


def _clock_pair() -> tuple:
    """(perf_counter_ns, time_ns) read together: the closest of a few
    tries, the perf counter taken at the middle of the pair around it."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, u)
    return best[1], best[2]


class Recording:
    """The spans and counts kept while one ``recording()`` is on."""

    def __init__(self):
        self.spans: list = []
        # (name, key) -> count: ("sync", site), ("slots", path),
        # ("live", path), the last read from the device at the end, and
        # the two-level traversal's ("tlas_path", path), ("tlas", kind),
        # ("blas", kernel) and, from the device, ("blas_walks", "k2").
        self.counts: dict = {}
        self.frame = 0  # the current frame's number; 0 before any frame
        self.clock = _clock_pair()
        self._open: list = []
        self._device: dict = {}  # (name, key) -> DeviceCounter

    # -- kept by span, sync and rays ----------------------------------------
    def _open_span(self, name: str, new_frame: bool) -> int:
        if new_frame:
            self.frame += 1
        i = len(self.spans)
        parent = self._open[-1] if self._open else -1
        self.spans.append(Span(name, time.perf_counter_ns(), -1, parent,
                               self.frame))
        self._open.append(i)
        return i

    def _close_span(self, i: int) -> None:
        self.spans[i].end_ns = time.perf_counter_ns()
        self._open.pop()  # spans nest: the last one opened closes first

    def count(self, name: str, key: str, n: int = 1) -> None:
        self.counts[(name, key)] = self.counts.get((name, key), 0) + int(n)

    def count_device(self, name: str, key: str, value: torch.Tensor) -> None:
        self.device_tensor(name, key, value.device).add_(value)

    def device_tensor(self, name: str, key: str, device) -> torch.Tensor:
        """The int64 one-element tensor on ``device`` that the count
        ``(name, key)`` reads when the recording stops."""
        c = self._device.get((name, key))
        if c is None:
            c = self._device[(name, key)] = DeviceCounter(torch.int64)
        return c.tensor(device)

    def open_path(self) -> str:
        return "/".join(self.spans[i].name for i in self._open)

    def _stop(self) -> None:
        for key, c in self._device.items():
            self.count(*key, c.total())
        self._device.clear()

    # -- views -------------------------------------------------------------
    def unix_ns(self, t_ns: int) -> int:
        """A ``perf_counter_ns`` time on the Unix clock."""
        return t_ns - self.clock[0] + self.clock[1]

    def path(self, i: int) -> list:
        """The names from span ``i``'s root down to it."""
        names = []
        while i >= 0:
            names.append(self.spans[i].name)
            i = self.spans[i].parent
        return names[::-1]

    def self_ns(self) -> list:
        """Each span's duration less what its child spans cover."""
        out = [s.ns for s in self.spans]
        for s in self.spans:
            if s.parent >= 0:
                out[s.parent] -= s.ns
        return out

    def frame_ms(self, frame: Optional[int] = None) -> dict:
        """{name: ms} of frame ``frame``'s spans (the current frame when
        None), each name's durations summed."""
        frame = self.frame if frame is None else frame
        ns: dict = {}
        for s in self.spans:
            if s.frame == frame and s.end_ns >= 0:
                ns[s.name] = ns.get(s.name, 0) + s.ns
        return {name: v / 1e6 for name, v in ns.items()}

    def total(self, name: str) -> int:
        """The sum of the counts named ``name`` over their keys."""
        return sum(v for (n, _), v in self.counts.items() if n == name)


_active: Optional[Recording] = None
_profiler_on = torch._C._autograd._profiler_enabled


def active() -> Optional[Recording]:
    """The recording that is on, or None."""
    return _active


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Keep spans and counts while the block runs; yields the
    ``Recording``, whose device counts are read when the block ends. One
    recording at a time: starting a second while one is on raises."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already on")
    rec = Recording()
    _active = rec
    try:
        yield rec
    finally:
        _active = None
        rec._stop()


class span:
    """``with span(name):`` the ``record_function`` range ``name``, and the
    span kept in the recording that is on. ``new_frame``: the span opens
    a new frame (``Driver.step``)."""

    __slots__ = ("_name", "_new_frame", "_range", "_rec", "_i")

    def __init__(self, name: str, new_frame: bool = False):
        self._name = name
        self._new_frame = new_frame

    def __enter__(self):
        rec = self._rec = _active
        if rec is not None:
            self._i = rec._open_span(self._name, self._new_frame)
        # A range records nothing while no profiler is on, and entering one
        # costs the host ~10 us: a two-level frame opens hundreds.
        self._range = (record_function(self._name) if _profiler_on()
                       else None)
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._rec is not None:
            self._rec._close_span(self._i)


def count(name: str, key: str, n: int = 1) -> None:
    """While recording, add ``n`` to the count ``(name, key)`` on the
    host."""
    if _active is not None:
        _active.count(name, key, n)


def sync(site: str) -> span:
    """A ``sync`` span around a copy between host and device at ``site``;
    counts ``("sync", site)`` while recording."""
    if _active is not None:
        _active.count("sync", site)
    return span("sync")


def device_count(name: str, key: str, device) -> Optional[torch.Tensor]:
    """While recording, the int64 one-element tensor on ``device`` that a
    kernel adds the count ``(name, key)`` into, read when the recording
    stops; None with no recording on, so the kernel counts nothing."""
    rec = _active
    return None if rec is None else rec.device_tensor(name, key, device)


def rays(active_mask: torch.Tensor) -> None:
    """While recording, count a wave's slots and live rays (``active_mask``
    True) under the path of the open spans: ``("slots", path)`` on the
    host, ``("live", path)`` as one reduction on the mask's device."""
    rec = _active
    if rec is None:
        return
    key = rec.open_path()
    rec.count("slots", key, active_mask.numel())
    rec.count_device("live", key, active_mask.sum())
