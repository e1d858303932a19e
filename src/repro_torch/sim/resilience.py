"""Fault-tolerant lattice sweeps: checkpoint/resume + deterministic faults
(port of ``repro.sim.resilience``).

A lattice run's carry (:class:`~repro_torch.sim.engine.LatticeState` —
params, each seed's draw stream with its channel-process state, ``AlgState``)
holds EVERYTHING that evolves across rounds, and it is tensors only, so a
sweep can be segmented into ``checkpoint_every``-round chunks whose carry is
persisted between chunks and re-entered after a crash:

  * :func:`run_lattice_checkpointed` — ``run_lattice``'s policy-fused path,
    chunked: :meth:`SimEngine.run_lattice_chunk` advances the carry one
    chunk, and after each chunk the full carry + the records so far are
    written through ``repro_torch.checkpoint``'s crash-atomic npz saver.
    GUARANTEE: a sweep interrupted at any checkpoint boundary and resumed
    produces bit-identical records to the uninterrupted (chunked) run — the
    chunks issue the same ops on the same carries, and the npz round-trip is
    bytewise on every leaf (the generators' states included). On a CUDA
    card the repeat rests on the local update's deterministic convolutions
    (``repro_torch.device.cudnn_deterministic``), which every run of the
    port uses, ``run_lattice`` as much as this one.
  * worker sharding — :func:`run_worker_shard` runs one contiguous slice of
    the fused flat cell grid (per-rank checkpoints, per-rank shard npz) and
    :func:`merge_shards` reassembles the full :class:`LatticeRecords`. A
    seed's draws do not depend on which cells share the slice, so the
    shards' cells draw what they draw in the full grid.
  * deterministic fault injection — the ``REPRO_FAULT_*`` env contract:

        REPRO_FAULT_KILL=<rank>:<round>   worker <rank> hard-exits (code
                                          113) at the first checkpoint
                                          boundary after <round>
        REPRO_FAULT_NAN=<cell>:<round>    flat-fused cell <cell>'s aggregate
                                          ŷ is poisoned to NaN at exactly
                                          round <round> (the round's
                                          ``fault_round`` hook; every other
                                          cell is bitwise unchanged)

    NaN faults compose with ``POFLConfig.on_nonfinite="skip"`` (the
    quarantine): the poisoned round holds params/AlgState and is counted on
    the records' ``health`` subtree.

Checkpoint layout (all writes crash-atomic, npz is the commit point):

    <dir>/ckpt-<t_next:06d>.npz        {"state": LatticeState, "records": ...}
    <dir>/ckpt-<t_next:06d>.meta.json  {"t_next", "fingerprint", ...}

Discovery keys on npz presence (the atomic saver publishes the sidecar
FIRST), and the fingerprint — spec + config + cell slice — refuses to
resume a checkpoint written by a different sweep. The records' ``diag``,
``eval`` and ``health`` subtrees go through the npz under the reference's
keys. ``repro_torch.launch.distributed.supervise_workers`` restarts a
worker that a fault or a crash took down, and :func:`run_worker_shard`
resumes it from its own checkpoints (``--workload resilient``).
"""
from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import re
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.metrics import RoundDiagnostics, RoundHealth
from repro_torch.core.pofl import DeviceData, POFLConfig
from repro_torch.obs.config import ObsConfig
from repro_torch.obs.sink import emit, process_coords
from repro_torch.obs.spans import span
from repro_torch.sim.engine import (
    FUSED_ALGORITHM, FUSED_POLICY, RECORD_SCALARS, RoundRecord, SimEngine, zip_records,
)
from repro_torch.sim.lattice import (
    LatticeRecords, LatticeSpec, assemble_flat_fused, eval_schedule, fused_flat_grid,
    records_to_host,
)
from repro_torch.sim.tasks import EvalRecord

# -- the REPRO_FAULT_* env contract ----------------------------------------

ENV_FAULT_KILL = "REPRO_FAULT_KILL"  # "<rank>:<round>"
ENV_FAULT_NAN = "REPRO_FAULT_NAN"    # "<flat fused cell>:<round>"
FAULT_ENV_VARS = (ENV_FAULT_KILL, ENV_FAULT_NAN)
# distinctive exit code of an injected kill (distinguishable from a real
# crash in a supervisor's logs)
FAULT_EXIT_CODE = 113

_CKPT_RE = re.compile(r"ckpt-(\d+)\.npz$")


def _parse_fault(name: str) -> tuple[int, int] | None:
    """Parse one ``<int>:<int>`` fault env var; None when unset (a
    malformed value raises — a silently ignored fault would make a CI
    fault-injection job vacuously green)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        a, b = raw.split(":")
        return int(a), int(b)
    except ValueError as e:
        raise ValueError(f"{name} must be '<int>:<int>', got {raw!r}") from e


def fault_kill() -> tuple[int, int] | None:
    """The ``REPRO_FAULT_KILL`` (rank, round) injection point, or None."""
    return _parse_fault(ENV_FAULT_KILL)


def fault_nan() -> tuple[int, int] | None:
    """The ``REPRO_FAULT_NAN`` (flat cell, round) injection point, or None."""
    return _parse_fault(ENV_FAULT_NAN)


def fault_nan_rounds(lo: int, hi: int) -> np.ndarray:
    """The per-cell NaN-injection rounds for the ``[lo, hi)`` slice of the
    fused flat grid: all ``-1`` (never) unless ``REPRO_FAULT_NAN`` names a
    cell inside the slice."""
    fault = np.full(hi - lo, -1, np.int32)
    nan_point = fault_nan()
    if nan_point is not None and lo <= nan_point[0] < hi:
        fault[nan_point[0] - lo] = nan_point[1]
    return fault


def _maybe_fault_kill(t_next: int, rank: int) -> None:
    """Hard-exit (``os._exit(113)``) when ``REPRO_FAULT_KILL`` names this
    rank and the sweep has passed the injected round. Called AFTER the
    checkpoint for ``t_next`` is committed, so the kill point is exactly a
    checkpoint boundary — recovery is deterministic and loses nothing."""
    kill = fault_kill()
    if kill is None or kill[0] != rank or t_next <= kill[1]:
        return
    emit(
        "fault", "resilience.fault_kill",
        rank=rank, round=kill[1], t_next=t_next, exit_code=FAULT_EXIT_CODE,
    )
    os._exit(FAULT_EXIT_CODE)


# -- checkpoint plumbing ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Where/how often a chunked sweep persists its carry.

    ``every`` is the chunk length in rounds; ``keep`` bounds how many recent
    checkpoints stay on disk (older ones are pruned after each successful
    save — never the one just written)."""

    dir: str
    every: int
    keep: int = 2

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {self.every}")


def _ckpt_path(ckpt_dir: str, t_next: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt-{t_next:06d}.npz")


def latest_checkpoint(ckpt_dir: str) -> tuple[int, str] | None:
    """The most advanced published checkpoint under ``ckpt_dir`` as
    ``(t_next, npz_path)``, or None. Keys on npz presence only — the
    crash-atomic saver guarantees a visible npz is complete and its
    ``.meta.json`` sidecar was published first."""
    best: tuple[int, str] | None = None
    for path in glob.glob(os.path.join(ckpt_dir, "ckpt-*.npz")):
        m = _CKPT_RE.search(path)
        if m is None:
            continue
        t = int(m.group(1))
        if best is None or t > best[0]:
            best = (t, path)
    return best


def _prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    found = sorted(
        (int(_CKPT_RE.search(p).group(1)), p)
        for p in glob.glob(os.path.join(ckpt_dir, "ckpt-*.npz"))
        if _CKPT_RE.search(p)
    )
    for t, path in found[:-keep] if keep > 0 else []:
        for stale in (path, _ckpt_path(ckpt_dir, t)[:-4] + ".meta.json"):
            if os.path.exists(stale):
                os.remove(stale)


def _fingerprint(
    spec: LatticeSpec, cfg: POFLConfig, scenario: str,
    scenario_params: dict | None, cell_range: tuple[int, int],
) -> str:
    """Identity of one sweep's checkpoint stream: resuming under a different
    spec/config/slice must fail loudly, not deserialize garbage."""
    payload = repr((
        spec, dataclasses.replace(cfg, seed=0), scenario,
        sorted((scenario_params or {}).items()), cell_range,
    ))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _records_from_npz(z, prefix: str = "records/") -> RoundRecord:
    """Rebuild the host-side flat record tree from its '/'-joined npz keys
    (optional subtrees are present iff their keys are)."""

    def subtree(name, kind):
        if f"{prefix}{name}/{kind._fields[0]}" not in z.files:
            return None
        return kind(*(z[f"{prefix}{name}/{f}"] for f in kind._fields))

    return RoundRecord(
        *(z[f"{prefix}{f}"] for f in RECORD_SCALARS),
        diag=subtree("diag", RoundDiagnostics), eval=subtree("eval", EvalRecord),
        health=subtree("health", RoundHealth),
    )


def _concat_records(parts: list[RoundRecord], axis: int = 1) -> RoundRecord:
    """Concatenate host record trees along the round axis (leaves (b, t))
    or, ``axis=0``, the cell axis."""
    if len(parts) == 1:
        return parts[0]
    return zip_records(lambda *xs: np.concatenate(xs, axis=axis), *parts)


# -- the chunked runner ----------------------------------------------------


def _run_cells_checkpointed(
    loss_fn: Callable,
    data: DeviceData,
    params0,
    spec: LatticeSpec,
    base_cfg: POFLConfig | None = None,
    eval_fn: Callable | None = None,
    channel_cfg: ChannelConfig | None = None,
    scenario: str = "static_rayleigh",
    scenario_params: dict | None = None,
    obs: ObsConfig | None = None,
    checkpoint: CheckpointConfig | None = None,
    resume: bool = True,
    cell_range: tuple[int, int] | None = None,
    stop_after_round: int | None = None,
    device=None,
) -> RoundRecord | None:
    """The core chunked loop over the ``[lo, hi)`` slice of the fused flat
    cell grid → host-side flat records ((b, T) leaves), or None when
    ``stop_after_round`` simulated an interruption (tests/harness only;
    the checkpoint for every completed chunk is already on disk)."""
    base_cfg = base_cfg or POFLConfig(n_devices=data.n_devices)
    algs = tuple(spec.algorithms)
    if not algs:
        raise ValueError("spec.algorithms must name at least one algorithm")
    traced_algs = len(algs) > 1
    cfg = dataclasses.replace(
        base_cfg,
        policy=FUSED_POLICY,
        local_algorithm=FUSED_ALGORITHM if traced_algs else algs[0],
        n_devices=data.n_devices,
    )
    noise, alpha, seed, policy, alg = fused_flat_grid(spec)
    lo, hi = cell_range if cell_range is not None else (0, noise.size)
    if not (0 <= lo < hi <= noise.size):
        raise ValueError(f"cell_range {cell_range} outside the {noise.size}-cell grid")
    rank = process_coords()[0]
    fingerprint = _fingerprint(spec, cfg, scenario, scenario_params, (lo, hi))

    engine = SimEngine(
        loss_fn, data, cfg, channel_cfg=channel_cfg, scenario=scenario,
        scenario_params=scenario_params, eval_fn=eval_fn, device=device, obs=obs,
    )
    fault = fault_nan_rounds(lo, hi)
    # no fault: no poisoning op at all (the rounds of run_lattice)
    fault_b = torch.as_tensor(fault).to(engine.device) if (fault >= 0).any() else None

    T = spec.n_rounds
    do_eval, _ = eval_schedule(spec, eval_fn is not None)
    chunk = checkpoint.every if checkpoint is not None else max(T, 1)

    # the initial carry — also the structure template (devices, dtypes) a
    # persisted carry is restored into
    state = engine.lattice_start(
        params0, noise[lo:hi], alpha[lo:hi], seed[lo:hi], policy[lo:hi],
        None if alg is None else alg[lo:hi],
    )
    t_next = 0
    rec_parts: list[RoundRecord] = []

    if checkpoint is not None and resume:
        found = latest_checkpoint(checkpoint.dir)
        if found is not None:
            ck_t, ck_path = found
            with open(ck_path[:-4] + ".meta.json") as f:
                meta = json.load(f)
            if meta.get("fingerprint") != fingerprint:
                raise ValueError(
                    f"checkpoint {ck_path} was written by a different sweep "
                    f"(fingerprint {meta.get('fingerprint')!r} != "
                    f"{fingerprint!r}); refusing to resume"
                )
            state = load_pytree(ck_path, {"state": state})["state"]
            with np.load(ck_path) as z:
                rec_parts = [_records_from_npz(z)]
            t_next = int(meta["t_next"])
            emit(
                "checkpoint", "resilience.resume",
                path=ck_path, t_next=t_next, rank=rank, cells=int(hi - lo),
            )

    emit(
        "heartbeat", "resilience.heartbeat",
        round=t_next, total=T, rank=rank, cells=int(hi - lo),
    )
    with span(
        "resilience.sweep", cells=int(hi - lo), n_rounds=T,
        chunk=chunk, resumed_at=t_next,
    ):
        while t_next < T:
            k = min(chunk, T - t_next)
            state, recs = engine.run_lattice_chunk(
                state, range(t_next, t_next + k), do_eval[t_next:t_next + k],
                fault_b=fault_b, chunked=True,
            )
            rec_parts.append(records_to_host(recs))
            t_next += k
            emit(
                "heartbeat", "resilience.heartbeat",
                round=t_next, total=T, rank=rank, cells=int(hi - lo),
            )
            if checkpoint is not None:
                flat = _concat_records(rec_parts)
                rec_parts = [flat]
                save_pytree(
                    _ckpt_path(checkpoint.dir, t_next),
                    {"state": state, "records": flat},
                    metadata={
                        "t_next": t_next,
                        "fingerprint": fingerprint,
                        "cells": [int(lo), int(hi)],
                        "n_rounds": T,
                        "rank": rank,
                    },
                )
                _prune_checkpoints(checkpoint.dir, checkpoint.keep)
                emit(
                    "checkpoint", "resilience.checkpoint",
                    t_next=t_next, total=T, rank=rank,
                )
                _maybe_fault_kill(t_next, rank)
            if stop_after_round is not None and stop_after_round <= t_next < T:
                return None  # simulated interruption (checkpoint committed)
    if not rec_parts:  # a run of no round
        return records_to_host(engine.empty_records(hi - lo))
    return _concat_records(rec_parts)


def run_lattice_checkpointed(
    loss_fn: Callable,
    data: DeviceData,
    params0,
    spec: LatticeSpec,
    base_cfg: POFLConfig | None = None,
    eval_fn: Callable | None = None,
    channel_cfg: ChannelConfig | None = None,
    scenario: str = "static_rayleigh",
    scenario_params: dict | None = None,
    obs: ObsConfig | None = None,
    checkpoint: CheckpointConfig | None = None,
    checkpoint_every: int | None = None,
    checkpoint_dir: str | None = None,
    resume: bool = True,
    device=None,
    _stop_after_round: int | None = None,
) -> LatticeRecords | None:
    """``run_lattice``'s policy-fused sweep, chunked + checkpointable.

    ``checkpoint`` (or the ``checkpoint_every``/``checkpoint_dir`` pair)
    segments the T rounds into chunks and persists the full carry + partial
    records after each; ``resume=True`` re-enters from the newest checkpoint
    in the directory (fingerprint-guarded). With ``checkpoint_every=None``
    and no ``REPRO_FAULT_*`` env the whole sweep is one chunk and nothing is
    written. ``device`` is where it runs: the CUDA card by default.

    Returns the full-grid :class:`LatticeRecords` (same axes/ordering as
    ``run_lattice``). Bit-identity contract: interrupted-and-resumed equals
    uninterrupted — both run the same rounds on the same carries.

    ``_stop_after_round`` (tests/harness) simulates a crash: the runner
    returns None at the first checkpoint boundary ≥ the given round, with
    that checkpoint already committed.
    """
    if checkpoint is None and checkpoint_every is not None:
        if checkpoint_dir is None:
            raise ValueError("checkpoint_every needs checkpoint_dir")
        checkpoint = CheckpointConfig(dir=checkpoint_dir, every=checkpoint_every)
    flat = _run_cells_checkpointed(
        loss_fn, data, params0, spec,
        base_cfg=base_cfg, eval_fn=eval_fn, channel_cfg=channel_cfg,
        scenario=scenario, scenario_params=scenario_params, obs=obs,
        checkpoint=checkpoint, resume=resume,
        stop_after_round=_stop_after_round, device=device,
    )
    if flat is None:
        return None
    do_eval, eval_rounds = eval_schedule(spec, eval_fn is not None)
    return assemble_flat_fused(spec, flat, do_eval, eval_rounds)


# -- worker sharding -------------------------------------------------------


def shard_bounds(n_cells: int, rank: int, count: int) -> tuple[int, int]:
    """Contiguous near-equal split of the flat fused grid across ``count``
    workers (every cell owned exactly once)."""
    if not (0 <= rank < count):
        raise ValueError(f"rank {rank} outside 0..{count - 1}")
    return (rank * n_cells) // count, ((rank + 1) * n_cells) // count


def run_worker_shard(
    loss_fn: Callable,
    data: DeviceData,
    params0,
    spec: LatticeSpec,
    shard_out: str,
    ckpt_dir: str,
    checkpoint_every: int,
    rank: int | None = None,
    count: int | None = None,
    **kw: Any,
) -> tuple[int, int]:
    """Run THIS worker's slice of the sweep (rank/count default to the
    ``REPRO_DIST_*`` env contract), checkpointing under ``<ckpt_dir>/r<rank>``
    and publishing the finished flat records to ``shard_out`` (crash-atomic).
    Returns the ``(lo, hi)`` slice."""
    if rank is None or count is None:
        rank, count = process_coords()
    lo, hi = shard_bounds(spec.n_cells, rank, count)
    checkpoint = CheckpointConfig(
        dir=os.path.join(ckpt_dir, f"r{rank}"), every=checkpoint_every
    )
    flat = _run_cells_checkpointed(
        loss_fn, data, params0, spec,
        checkpoint=checkpoint, cell_range=(lo, hi), **kw,
    )
    save_pytree(
        shard_out, {"records": flat},
        metadata={
            "lo": int(lo), "hi": int(hi), "rank": int(rank),
            "count": int(count), "has_eval": kw.get("eval_fn") is not None,
        },
    )
    emit(
        "shard", "resilience.shard_done",
        rank=rank, lo=int(lo), hi=int(hi), path=shard_out,
    )
    return lo, hi


def merge_shards(spec: LatticeSpec, shard_paths: list[str]) -> LatticeRecords:
    """Reassemble per-worker shard npzs (``run_worker_shard`` outputs) into
    the full-grid :class:`LatticeRecords`. The shards must tile the grid
    exactly — gaps or overlaps raise."""
    shards = []
    has_eval = False
    for path in shard_paths:
        base = path[:-4] if path.endswith(".npz") else path
        with open(base + ".meta.json") as f:
            meta = json.load(f)
        with np.load(base + ".npz") as z:
            recs = _records_from_npz(z)
        shards.append((meta["lo"], meta["hi"], recs))
        has_eval = has_eval or bool(meta.get("has_eval"))
    shards.sort(key=lambda s: s[0])
    expect = 0
    for lo, hi, _ in shards:
        if lo != expect:
            raise ValueError(f"shards do not tile the grid: expected lo={expect}, got {lo}")
        expect = hi
    if expect != spec.n_cells:
        raise ValueError(f"shards cover {expect} cells, grid has {spec.n_cells}")
    flat = _concat_records([s[2] for s in shards], axis=0)
    do_eval, eval_rounds = eval_schedule(spec, has_eval)
    return assemble_flat_fused(spec, flat, do_eval, eval_rounds)
