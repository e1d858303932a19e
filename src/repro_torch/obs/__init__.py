"""repro_torch.obs — the flight recorder (port of ``repro.obs``, the same
names).

Three layers, all opt-in and free when off:

  * host side (:mod:`repro_torch.obs.spans`, :mod:`repro_torch.obs.registry`):
    timing spans and a typed counter/gauge registry, streaming JSONL events
    per process via ``REPRO_OBS_DIR`` (:mod:`repro_torch.obs.sink`);
  * on the device (:class:`ObsConfig` +
    :class:`repro_torch.core.metrics.RoundDiagnostics`): cheap per-round
    scalar taps computed beside each round, gated by a static flag;
  * reporting (:mod:`repro_torch.obs.report`, :mod:`repro_torch.obs.profile`):
    ``python -m repro_torch.obs.report`` renders a run's JSONL into summary
    tables and CI gates; ``REPRO_OBS_PROFILE=1`` captures ``torch.profiler``
    traces.

No module here imports torch at import time.
"""
from repro_torch.obs.config import DEFAULT_OBS, ObsConfig
from repro_torch.obs.profile import maybe_profile, profiling_enabled
from repro_torch.obs.registry import (
    Counter,
    Gauge,
    counter,
    counter_add,
    gauge,
    gauge_set,
    metric_value,
    metrics_snapshot,
    reset_metrics,
)
from repro_torch.obs.sink import (
    ENV_OBS_DIR,
    ENV_OBS_PROFILE,
    close_sink,
    emit,
    event_files,
    obs_dir,
    process_coords,
    read_events,
)
from repro_torch.obs.spans import span, span_totals

__all__ = [
    "ObsConfig",
    "DEFAULT_OBS",
    "span",
    "span_totals",
    "Counter",
    "Gauge",
    "counter",
    "gauge",
    "counter_add",
    "gauge_set",
    "metric_value",
    "metrics_snapshot",
    "reset_metrics",
    "emit",
    "obs_dir",
    "process_coords",
    "read_events",
    "event_files",
    "close_sink",
    "maybe_profile",
    "profiling_enabled",
    "ENV_OBS_DIR",
    "ENV_OBS_PROFILE",
]
