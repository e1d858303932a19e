"""Host-side timing spans: ``with span("lattice.sweep"): ...`` (port of
``repro.obs.spans``).

A span measures one wall-clock interval, accumulates it into the registry
(``span.<name>.count`` / ``span.<name>.seconds`` — so totals are queryable
in-process without replaying the sink) and streams one ``span`` event per
exit to the JSONL sink. Usable as a context manager or a decorator
(:class:`span` subclasses ``ContextDecorator``).

Spans are HOST-side: they time Python-visible work (kernel builds, the
issue of a lattice's rounds, stream-out), never device execution — CUDA
runs asynchronously, so a span around device work ends when the work is
issued unless the block synchronizes. For device time, set
``REPRO_OBS_PROFILE=1`` (``repro_torch.obs.profile``) and read the captured
``torch.profiler`` trace.
"""
from __future__ import annotations

import time
from contextlib import ContextDecorator

from repro_torch.obs.registry import counter_add, metric_value
from repro_torch.obs.sink import emit


class span(ContextDecorator):
    """Time one interval under a dotted name, with optional static fields.

    ``fields`` are attached to the emitted event verbatim (keep them
    JSON-serializable scalars); :meth:`annotate` adds more from inside the
    block. Exceptions propagate — the span still records, stamped with
    ``error`` — so instrumenting a call site never changes its control flow.
    """

    def __init__(self, name: str, **fields):
        self.name = name
        self.fields = fields
        self.seconds: float | None = None  # set on exit
        self._t0: float | None = None

    def annotate(self, **fields) -> "span":
        self.fields.update(fields)
        return self

    def __enter__(self) -> "span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.seconds = time.perf_counter() - self._t0
        counter_add(f"span.{self.name}.count", 1, emit_event=False)
        counter_add(f"span.{self.name}.seconds", self.seconds, emit_event=False)
        if exc_type is not None:
            self.fields.setdefault("error", exc_type.__name__)
        emit("span", self.name, seconds=round(self.seconds, 6), **self.fields)
        return False  # never swallow exceptions


def span_totals(name: str) -> dict:
    """In-process totals for one span name: ``{"count", "seconds"}``."""
    return {
        "count": metric_value(f"span.{name}.count"),
        "seconds": metric_value(f"span.{name}.seconds"),
    }
