"""The in-process metrics registry: typed counters and gauges (port of
``repro.obs.registry``).

One flat namespace of dotted metric names (``engine.lattice_runs``,
``span.kernels.nvcc.count``, ``span.lattice.sweep.seconds``) holding plain
numbers. Every mutation can stream to the JSONL sink
(``repro_torch.obs.sink``) so a run's counter history is replayable offline.

Reset semantics:

  * :func:`reset_metrics` with a ``prefix`` zeroes exactly that namespace;
  * :func:`reset_metrics` with no prefix zeroes everything (tests use
    prefix resets).

No torch imports; safe from anywhere.
"""
from __future__ import annotations

import threading
from typing import Union

from repro_torch.obs.sink import emit

Number = Union[int, float]

_METRICS: dict[str, Number] = {}
# increments can fire from threads (kernels built in parallel); keep them
# atomic under any threaded caller
_LOCK = threading.Lock()


def counter_add(name: str, delta: Number = 1, emit_event: bool = True) -> Number:
    """Add ``delta`` to counter ``name`` (created at 0) and return the new
    total. Streams a ``counter`` event to the sink unless ``emit_event`` is
    False (span bookkeeping passes False — the span event already carries
    the same numbers)."""
    with _LOCK:
        total = _METRICS.get(name, 0) + delta
        _METRICS[name] = total
    if emit_event:
        emit("counter", name, delta=delta, total=total)
    return total


def gauge_set(name: str, value: Number, emit_event: bool = True) -> Number:
    """Set gauge ``name`` to ``value`` (last write wins)."""
    with _LOCK:
        _METRICS[name] = value
    if emit_event:
        emit("gauge", name, value=value)
    return value


def metric_value(name: str, default: Number = 0) -> Number:
    """Current value of one metric (``default`` when never touched)."""
    return _METRICS.get(name, default)


def metrics_snapshot(prefix: str = "") -> dict:
    """Copy of every metric whose name starts with ``prefix``."""
    with _LOCK:
        return {k: v for k, v in _METRICS.items() if k.startswith(prefix)}


def reset_metrics(prefix: str = "") -> None:
    """Zero (drop) every metric under ``prefix``; no prefix drops all."""
    with _LOCK:
        for k in [k for k in _METRICS if k.startswith(prefix)]:
            del _METRICS[k]


class Counter:
    """Typed handle on one monotonically-increasing registry counter."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def add(self, delta: Number = 1) -> Number:
        return counter_add(self.name, delta)

    @property
    def value(self) -> Number:
        return metric_value(self.name)


class Gauge:
    """Typed handle on one last-write-wins registry gauge."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def set(self, value: Number) -> Number:
        return gauge_set(self.name, value)

    @property
    def value(self) -> Number:
        return metric_value(self.name)


def counter(name: str) -> Counter:
    """A :class:`Counter` handle for ``name`` (registered lazily at first add)."""
    return Counter(name)


def gauge(name: str) -> Gauge:
    """A :class:`Gauge` handle for ``name``."""
    return Gauge(name)
