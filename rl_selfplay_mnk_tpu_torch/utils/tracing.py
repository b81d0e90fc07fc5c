"""Spans at the port's layer boundaries, on the clock that ``torch.profiler``
stamps its events with.

    from rl_selfplay_mnk_tpu_torch.utils import tracing

    tracing.enable()
    ...                    # train: the training loops open their spans
    tracing.disable()
    for rec in tracing.records():
        print(rec["name"], rec["parent"], rec["end_ns"] - rec["start_ns"], rec["device_s"])

Off (the default), ``span(name)`` checks one flag and returns a shared
no-op context: nothing is allocated, no CUDA event made, no profiler range
entered. On, each span is a record: its name, its parent (the innermost
span open when it began, by index into ``records()``), its host start and
end in nanoseconds on the profiler's clock (``time.time_ns``'s scale, from
one anchor pair taken at ``enable()`` so that a span reads only
``perf_counter_ns``) and, once CUDA is initialised, a CUDA event pair on
the current stream (never while that stream is capturing a graph). While a
profiler records, an enabled span also enters ``record_function(name)``,
so that traces carry it.

A span given an ``Interval`` measures into it whether tracing is on or
off: that is how the metrics line gets its rollout and update seconds
(``PPOLearner``, ``FusedTrainer.phase_times``), and the fused summary its
``capture_s`` and ``block_walls``. An interval is made once and reused.

The spans (PERF.md, "Spans and counters"): ``capture`` (``capture.warmup``,
``capture.graphs``), ``block``, ``iteration``, ``opponent``, ``rollout``,
``update`` (``update.prepare``, ``update.epochs``), ``finish``, ``read``,
``validation``. Whoever reads ``records()`` writes them out; this module
has no exporter.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

_enabled = False
_records: list = []
_stack: list = []  # the open spans, innermost last
_anchor = (0, 0)  # (perf_counter_ns, time_ns) at enable()


def _mark(event) -> bool:
    """Record ``event`` on the current stream unless it is capturing."""
    if torch.cuda.is_current_stream_capturing():
        return False
    event.record()
    return True


class Interval:
    """A reusable pair of marks: host nanoseconds (``perf_counter_ns``)
    and, for a CUDA device, an event pair on the current stream."""

    __slots__ = ("events", "on_card", "start_ns", "end_ns")

    def __init__(self, device=None):
        cuda = device is not None and torch.device(device).type == "cuda"
        self.events = ((torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True)) if cuda else None)
        self.on_card = False
        self.start_ns = self.end_ns = 0

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        self.on_card = self.events is not None and _mark(self.events[0])
        return self

    def __exit__(self, *exc):
        if self.on_card:
            self.events[1].record()
        self.end_ns = time.perf_counter_ns()
        return False

    @property
    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def device_s(self) -> float:
        """Seconds on the device between the marks (the host's where there
        is no event pair); read after a host read that follows the span."""
        if not self.on_card:
            return self.host_s
        return self.events[0].elapsed_time(self.events[1]) / 1e3


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Span:
    """One enabled span, as ``records()`` reports it."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "events", "interval", "_range")

    def __init__(self, name: str, interval: Optional[Interval]):
        self.name, self.interval = name, interval
        self.parent = self.events = self._range = None
        self.start_ns = self.end_ns = 0

    def __enter__(self):
        self.parent = _stack[-1] if _stack else None
        _stack.append(self)
        _records.append(self)
        if torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            if _mark(events[0]):
                self.events = events
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _stack.pop()
        interval = self.interval
        if interval is not None:
            interval.start_ns, interval.end_ns = self.start_ns, self.end_ns
            interval.on_card = self.events is not None
            if interval.on_card:
                interval.events = self.events
        return False


def span(name: str, interval: Optional[Interval] = None):
    """The context of span ``name``; with ``interval``, measured into it
    whether tracing is on or off."""
    if not _enabled:
        return _NULL if interval is None else interval
    return Span(name, interval)


def enable() -> None:
    """Record spans from now on (the anchor of the profiler's clock is
    taken here)."""
    global _enabled, _anchor
    _anchor = (time.perf_counter_ns(), time.time_ns())
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def clear() -> None:
    """Forget the recorded spans (the open ones stay open, unrecorded)."""
    del _records[:]


def records() -> list:
    """The recorded spans in the order they began: dicts of ``name``,
    ``parent`` (an index into this list, or None), ``start_ns`` and
    ``end_ns`` on the profiler's clock and ``device_s`` (None without an
    event pair). Waits for the card where a span has events."""
    done = [s for s in _records if s.end_ns]
    if any(s.events is not None for s in done):
        torch.cuda.synchronize()
    index = {id(s): i for i, s in enumerate(done)}
    shift = _anchor[1] - _anchor[0]
    return [{"name": s.name, "parent": index.get(id(s.parent)),
             "start_ns": s.start_ns + shift, "end_ns": s.end_ns + shift,
             "device_s": (s.events[0].elapsed_time(s.events[1]) / 1e3
                          if s.events is not None else None)}
            for s in done]
