"""Opt-in ``torch.profiler`` capture around lattice dispatches (port of
``repro.obs.profile``).

``REPRO_OBS_PROFILE=1`` (any value but ``0``/empty) makes
:func:`maybe_profile` wrap its block in ``torch.profiler.profile`` — CPU
activity, and CUDA activity when the block runs on a card — write the
capture as a Chrome trace under ``$REPRO_OBS_DIR/profile/<tag>/`` (or
``./repro-obs/profile`` when no sink dir is set) and emit a ``profile``
event pointing at it. The block synchronizes the card before it ends, so
the capture holds the device work it issued (the reference's
``block_until_ready``). Off — the default — it is a passthrough: no
profiler, one env lookup.

The engine wraps :meth:`SimEngine.run_lattice_cells` with this, so

    REPRO_OBS_PROFILE=1 REPRO_OBS_DIR=/tmp/obs python my_sweep.py

yields a trace of the real lattice rounds (``chrome://tracing`` or
Perfetto) alongside the JSONL events describing the same run.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager

from repro_torch.obs.sink import ENV_OBS_PROFILE, emit, obs_dir


def profiling_enabled() -> bool:
    """True when ``REPRO_OBS_PROFILE`` asks for profiler captures."""
    return os.environ.get(ENV_OBS_PROFILE, "") not in ("", "0")


@contextmanager
def maybe_profile(tag: str, device=None):
    """Capture a ``torch.profiler`` trace of the block when enabled; no-op
    otherwise. ``device`` is where the block runs: on a CUDA device the
    capture adds CUDA activity and the block synchronizes that device
    before the capture ends. A profiler that fails raises: the capture was
    asked for."""
    if not profiling_enabled():
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    base = obs_dir() or os.path.abspath("repro-obs")
    trace_dir = os.path.join(base, "profile", tag)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(device)
    trace = os.path.join(trace_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(trace)
    emit("profile", tag, trace_dir=trace_dir, trace=trace, cuda=cuda)
