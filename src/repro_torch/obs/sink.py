"""The per-process JSONL event sink behind every obs span/counter/gauge
(port of ``repro.obs.sink``; the same files, events and fields).

One env contract:

    REPRO_OBS_DIR=<dir>      stream every obs event into <dir> as JSONL
    REPRO_OBS_PROFILE=1      additionally capture torch.profiler traces around
                             lattice dispatches (see ``repro_torch.obs.profile``)

When ``REPRO_OBS_DIR`` is unset, :func:`emit` still returns the assembled
event (the in-memory registry keeps working) but writes nothing — the
default path costs one env lookup per event.

Multihost: every event is stamped with this process's index/count, read from
the ``REPRO_DIST_*`` env contract a launcher writes into each worker
(deliberately NOT from ``torch.distributed.get_rank()`` — the sink must
never depend on a process group, and the env contract is available before
one is initialized). Each process appends to its own file,
``events-p<index>of<count>-<pid>.jsonl``, so N workers under one shared
``REPRO_OBS_DIR`` produce exactly one file per worker and no cross-process
write interleaving.

This module imports nothing of torch: it is safe to import from anywhere.
"""
from __future__ import annotations

import io
import json
import os
import time
from typing import Iterator, TextIO

ENV_OBS_DIR = "REPRO_OBS_DIR"
ENV_OBS_PROFILE = "REPRO_OBS_PROFILE"

# the multihost env contract (obs sits BELOW sim in the layering and keeps
# its own copy of the names)
_ENV_PROCESS_ID = "REPRO_DIST_PROCESS_ID"
_ENV_NUM_PROCESSES = "REPRO_DIST_NUM_PROCESSES"


def obs_dir() -> str | None:
    """The sink directory from ``$REPRO_OBS_DIR``; None when unset."""
    path = os.environ.get(ENV_OBS_DIR) or None
    if not path:
        return None
    return os.path.abspath(os.path.expanduser(path))


def process_coords() -> tuple[int, int]:
    """(process_index, process_count) from the ``REPRO_DIST_*`` env contract
    (0, 1) outside a distributed run — never touches a process group."""
    try:
        idx = int(os.environ.get(_ENV_PROCESS_ID) or 0)
        count = int(os.environ.get(_ENV_NUM_PROCESSES) or 1)
    except ValueError:
        return 0, 1
    return idx, max(count, 1)


# one appending handle per sink directory (a process writes one file per dir)
_HANDLES: dict[str, TextIO] = {}


def _handle(path: str) -> TextIO:
    h = _HANDLES.get(path)
    if h is None or h.closed:
        os.makedirs(path, exist_ok=True)
        idx, count = process_coords()
        name = f"events-p{idx:03d}of{count:03d}-{os.getpid()}.jsonl"
        # line-buffered on top of emit()'s per-event flush: a worker killed
        # mid-stream (SIGKILL, os._exit fault injection) leaves at worst one
        # torn trailing line, which read_events skips — every completed event
        # line survives the writer
        h = _HANDLES[path] = open(
            os.path.join(path, name), "a", buffering=1, encoding="utf-8"
        )
    return h


def emit(kind: str, name: str, **fields) -> dict:
    """Assemble (and, when the sink is active, persist) one obs event.

    Every event carries a wall-clock timestamp, the emitting process's
    index/count (multihost stamp) and pid, plus the caller's fields. Lines
    are flushed immediately: a crashed worker's events survive it.
    """
    idx, count = process_coords()
    event = {
        "ts": round(time.time(), 6),
        "kind": kind,
        "name": name,
        "process_index": idx,
        "process_count": count,
        "pid": os.getpid(),
        **fields,
    }
    path = obs_dir()
    if path:
        h = _handle(path)
        h.write(json.dumps(event) + "\n")
        h.flush()
    return event


def close_sink() -> None:
    """Close every open sink handle (test hygiene; reopens lazily)."""
    for h in _HANDLES.values():
        if not h.closed:
            h.close()
    _HANDLES.clear()


def event_files(path: str) -> list[str]:
    """The sink's event files under ``path``, sorted by name (= by process
    index, then pid)."""
    if not os.path.isdir(path):
        return []
    return sorted(
        os.path.join(path, n)
        for n in os.listdir(path)
        if n.startswith("events-") and n.endswith(".jsonl")
    )


def read_events(path: str) -> Iterator[dict]:
    """Yield every event recorded under sink directory ``path`` (all
    processes' files, file order then line order). Malformed lines — e.g. a
    line torn by a killed worker — are skipped, not raised."""
    for fname in event_files(path):
        with io.open(fname, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue
