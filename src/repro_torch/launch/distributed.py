"""Local multi-process launcher for the port's sharded lattice runs (port of
``repro.launch.distributed``).

Spawns N coordinated worker processes ON THIS MACHINE — a shared
rendezvous address on localhost and a distinct rank per worker — so the
multi-rank lattice path (``repro_torch.sim.multihost`` + ``run_lattice``
over a ``DeviceMesh``) runs end to end on one box: over gloo on the CPU,
and on a card machine with rank r on ``cuda:{r % torch.cuda.device_count()}``
(NCCL when every rank has its own card; gloo when ranks share one, as two
ranks on a one-card machine do). The port runs one rank a device, so
``--devices-per-proc`` (the reference's fake CPU device pool) must be 1.

Worker contract (written into each child's environment; a cluster launcher
exports the same variables per rank instead):

    REPRO_DIST_COORDINATOR          host:port of rank 0's rendezvous store
    REPRO_DIST_NUM_PROCESSES        total rank count
    REPRO_DIST_PROCESS_ID           this process's rank
    REPRO_DIST_LOCAL_PROCESS_ID     its place among its host's ranks
    REPRO_DIST_LOCAL_NUM_PROCESSES  the ranks on its host

The last two pick a rank's card and the backend. This launcher starts
every rank on the host it runs on, so they equal the first two; a topology
over several hosts (unverified) must give them, or torchrun's
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``.

Observability: the worker env copies the launcher's ``os.environ``, so a
``REPRO_OBS_DIR`` set on the launcher is inherited by every worker, each
writing its own ``events-p<rank>of<count>-<pid>.jsonl`` there.

Usage:

    # the parity workload: 2 ranks on the CPU, records → npz
    python -m repro_torch.launch.distributed --procs 2 --workload parity \\
        --device cpu --out /tmp/records.npz

    # the same on the card, with the full-width CNN lattice held round by
    # round over a cells mesh and a (1, 2) model mesh
    python -m repro_torch.launch.distributed --procs 2 --workload parity \\
        --device cuda --cnn-rounds 3 --out /tmp/records.npz

    # lattice throughput over the ranks
    python -m repro_torch.launch.distributed --procs 2 --workload bench \\
        --out /tmp/bench.json

    # the supervised, checkpointed sweep: a killed rank restarts and resumes
    REPRO_FAULT_KILL=1:2 python -m repro_torch.launch.distributed --procs 2 \\
        --workload resilient --checkpoint-dir /tmp/ck --out /tmp/recs.npz

    # the LM trainer over a (data, model) mesh of the ranks (here (2, 1)):
    # qwen2-0.5b at full width cut to 4 layers, 8 × 2,048 tokens over 8 FL
    # devices; each round's records → npz, each rank's final blocks → .pt
    python -m repro_torch.launch.distributed --procs 2 --workload train \\
        --device cuda --layers 4 --model 1 --dtype float32 --out /tmp/train.npz \\
        --save-blocks

    # serving over a (data, model) mesh of the ranks (here (1, 2): the KV
    # cache split by sequence): qwen2-0.5b, a prefill of 8 × 2,048 tokens,
    # then 8 decode steps against a 128 × 32,768 cache filled from a seed;
    # each rank's results → <out>.rank<r>.pt (torchrun's env works too:
    # torchrun --nproc-per-node 2 -m repro_torch.launch.distributed --worker
    # --workload serve ...)
    python -m repro_torch.launch.distributed --procs 2 --workload serve \
        --device cuda --model 2 --cache-len 32768 --out /tmp/serve

    # the MoE over two data ranks: olmoe-1b-7b trained at 1 of 16 layers,
    # served at full depth with 8 steps of 128 rows (each layer's routing
    # group spans both ranks) after its prefill
    python -m repro_torch.launch.distributed --procs 2 --workload train \
        --device cuda --arch olmoe-1b-7b --layers 1 --model 1 --dtype float32 \
        --out /tmp/train.npz
    python -m repro_torch.launch.distributed --procs 2 --workload serve \
        --device cuda --arch olmoe-1b-7b --model 1 --cache-batch 128 \
        --cache-len 256 --out /tmp/serve

    # any script that calls sim.multihost.initialize_distributed() itself
    python -m repro_torch.launch.distributed --procs 2 -- python my_script.py

Every rendezvous has the process group's timeout and every child the
launcher's ``--timeout``: a hang fails loudly and is never waited out.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch.sharding import tensor_bytes
from repro_torch.sim.engine import RoundRecord
from repro_torch.sim.multihost import (
    ENV_COORDINATOR,
    ENV_LOCAL_NUM_PROCESSES,
    ENV_LOCAL_PROCESS_ID,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    find_free_port,
)

# the per-round ARRAY record fields (the engine's RoundRecord minus its
# optional subtrees: np.savez would pickle a None subtree as an object array)
_RECORD_FIELDS = tuple(f for f in RoundRecord._fields if f not in ("diag", "eval", "health"))


@dataclasses.dataclass
class WorkerResult:
    process_id: int
    returncode: int
    output: str  # merged stdout+stderr


def worker_env(
    coordinator: str,
    num_processes: int,
    process_id: int,
    devices_per_proc: int = 1,
    base_env: dict | None = None,
) -> dict:
    """Environment for one spawned worker: the ``REPRO_DIST_*`` contract
    (every rank on this host, so its local place is its rank) and import
    roots matching the parent (``repro_torch``'s src dir + the parent
    cwd). One rank a device, so ``devices_per_proc`` must be 1: the
    reference's XLA device-count flag has no torch meaning."""
    if devices_per_proc != 1:
        raise ValueError(
            f"devices_per_proc must be 1: the port runs one rank a device (got "
            f"{devices_per_proc}); start more ranks with --procs instead"
        )
    env = dict(os.environ if base_env is None else base_env)
    env[ENV_COORDINATOR] = coordinator
    env[ENV_NUM_PROCESSES] = str(num_processes)
    env[ENV_PROCESS_ID] = str(process_id)
    # every rank runs on this host
    env[ENV_LOCAL_NUM_PROCESSES] = str(num_processes)
    env[ENV_LOCAL_PROCESS_ID] = str(process_id)
    import repro_torch

    src_root = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    roots = [src_root, os.getcwd()]
    if env.get("PYTHONPATH"):
        roots.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(roots)
    return env


def _kill(proc: subprocess.Popen) -> None:
    proc.kill()
    proc.wait()


def spawn_local(
    worker_argv: list[str],
    n_procs: int = 2,
    devices_per_proc: int = 1,
    timeout: float = 900.0,
    base_env: dict | None = None,
) -> list[WorkerResult]:
    """Run ``worker_argv`` as ``n_procs`` coordinated local processes.

    Every worker gets the same argv and the per-rank env contract; the call
    blocks until all exit. ``timeout`` is one ABSOLUTE deadline for the
    whole topology; stragglers past it are killed with their output kept.
    Results come back in rank order; nothing is raised on failure (see
    :func:`run_workers`).
    """
    import tempfile

    coordinator = f"127.0.0.1:{find_free_port()}"
    # every env BEFORE the first spawn: a partial spawn would leave rank 0
    # waiting on the rendezvous for ranks that never started
    envs = [worker_env(coordinator, n_procs, pid, devices_per_proc, base_env)
            for pid in range(n_procs)]
    # each worker streams into its own file, never a pipe: ranks block on
    # each other through collectives, so output must never backpressure
    outs = [tempfile.TemporaryFile(mode="w+") for _ in envs]
    procs = [subprocess.Popen(worker_argv, env=env, stdout=f, stderr=subprocess.STDOUT,
                              text=True) for env, f in zip(envs, outs)]
    deadline = time.monotonic() + timeout
    deadline_killed = set()
    try:
        for rank, proc in enumerate(procs):
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                _kill(proc)
                if proc.returncode != 0:  # not a straggler that exited cleanly first
                    deadline_killed.add(rank)
    finally:
        for rank, proc in enumerate(procs):
            if proc.poll() is None:
                _kill(proc)
                deadline_killed.add(rank)
    results = []
    for rank, (proc, f) in enumerate(zip(procs, outs)):
        f.seek(0)
        out = f.read()
        f.close()
        rc = proc.returncode if proc.returncode is not None else -9
        if rank in deadline_killed:
            out += f"\n[launcher] killed at the {timeout}s deadline (rc={rc})"
        results.append(WorkerResult(rank, rc, out))
    return results


def _raise_failed(results: list[WorkerResult], what: str) -> None:
    failed = [r for r in results if r.returncode != 0]
    if failed:
        tails = "\n".join(
            f"--- worker {r.process_id} (rc={r.returncode}) ---\n{r.output[-4000:]}"
            for r in failed
        )
        raise RuntimeError(f"{len(failed)}/{len(results)} {what} failed:\n{tails}")


def run_workers(
    worker_argv: list[str],
    n_procs: int = 2,
    devices_per_proc: int = 1,
    timeout: float = 900.0,
    base_env: dict | None = None,
) -> list[WorkerResult]:
    """:func:`spawn_local` that raises ``RuntimeError`` (with output tails)
    when any worker exits nonzero — never a success over a half-failed
    topology."""
    results = spawn_local(worker_argv, n_procs, devices_per_proc, timeout, base_env)
    _raise_failed(results, "distributed workers")
    return results


# --------------------------------------------------------------------------
# supervised workers: per-rank restart with capped exponential backoff
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Per-rank supervision policy for :func:`supervise_workers`.

    ``max_restarts`` bounds restarts PER RANK; restart ``i`` waits
    ``min(backoff_base * 2**(i-1), backoff_cap)`` seconds first.
    ``liveness_timeout`` (seconds; None disables) declares a rank dead when
    its obs event files under the shared ``REPRO_OBS_DIR`` go that long
    without an mtime update (the resilient workload heartbeats once a
    checkpoint chunk), so a wedged rank is killed and restarted."""

    max_restarts: int = 2
    backoff_base: float = 0.25
    backoff_cap: float = 8.0
    liveness_timeout: float | None = None
    poll_interval: float = 0.2


def supervise_workers(
    worker_argv: list[str],
    n_procs: int = 2,
    devices_per_proc: int = 1,
    timeout: float = 900.0,
    supervisor: SupervisorConfig | None = None,
    base_env: dict | None = None,
) -> list[WorkerResult]:
    """Run ``worker_argv`` as ``n_procs`` INDEPENDENT local workers, each
    under per-rank supervision: a rank that exits nonzero (a crash, an
    injected ``REPRO_FAULT_KILL``) or goes heartbeat-silent is restarted
    with capped exponential backoff, up to ``max_restarts`` times, and
    resumes from its own checkpoints. ``timeout`` stays the absolute
    backstop for the whole topology.

    Workers here must not rely on each other (no collectives): one rank is
    restarted alone while the others run on. ``REPRO_FAULT_*`` is stripped
    from every RESTARTED rank's environment (an injected fault is one-shot),
    and each restart emits one ``supervisor.restart`` event.

    Raises ``RuntimeError`` with per-rank output tails when a rank's restart
    budget is spent (or the deadline fires); returns rank-ordered
    :class:`WorkerResult` s (the final attempt's rc, supervisor notes inline).
    """
    import glob
    import tempfile

    from repro_torch.obs.sink import emit, obs_dir
    from repro_torch.sim.resilience import FAULT_ENV_VARS

    sup = supervisor or SupervisorConfig()
    coordinator = f"127.0.0.1:{find_free_port()}"
    sink = obs_dir() if base_env is None else (base_env.get("REPRO_OBS_DIR") or None)

    outs = [tempfile.TemporaryFile(mode="w+") for _ in range(n_procs)]
    procs: list[subprocess.Popen | None] = [None] * n_procs
    attempts = [0] * n_procs
    next_start = [0.0] * n_procs  # monotonic time before which a rank waits
    started_wall = [0.0] * n_procs
    done: list[WorkerResult | None] = [None] * n_procs
    deadline = time.monotonic() + timeout

    def note(rank: int, text: str) -> None:
        f = outs[rank]
        f.flush()
        f.seek(0, os.SEEK_END)  # the child shares the file; never rewind it
        f.write(f"[supervisor] {text}\n")
        f.flush()

    def start(rank: int) -> None:
        env = worker_env(coordinator, n_procs, rank, devices_per_proc, base_env)
        if attempts[rank] > 0:
            for var in FAULT_ENV_VARS:  # injected faults are one-shot
                env.pop(var, None)
        note(rank, f"start rank {rank} attempt {attempts[rank]}")
        outs[rank].seek(0, os.SEEK_END)
        procs[rank] = subprocess.Popen(worker_argv, env=env, stdout=outs[rank],
                                       stderr=subprocess.STDOUT, text=True)
        started_wall[rank] = time.time()

    def collect(rank: int) -> str:
        f = outs[rank]
        f.flush()
        f.seek(0)
        return f.read()

    def last_signal(rank: int) -> float:
        """Wall time of the rank's latest sign of life: its newest obs
        event-file mtime, floored at this attempt's start."""
        sig = started_wall[rank]
        if sink:
            pattern = os.path.join(sink, f"events-p{rank:03d}of{n_procs:03d}-*.jsonl")
            for p in glob.glob(pattern):
                try:
                    sig = max(sig, os.path.getmtime(p))
                except OSError:  # the file went between the glob and the stat
                    pass
        return sig

    def on_crash(rank: int, rc: int, why: str) -> None:
        procs[rank] = None
        if attempts[rank] >= sup.max_restarts:
            note(rank, f"rank {rank} {why} (rc={rc}); restart budget "
                       f"({sup.max_restarts}) exhausted")
            done[rank] = WorkerResult(rank, rc if rc != 0 else 1, collect(rank))
            return
        attempts[rank] += 1
        delay = min(sup.backoff_base * 2 ** (attempts[rank] - 1), sup.backoff_cap)
        next_start[rank] = time.monotonic() + delay
        note(rank, f"rank {rank} {why} (rc={rc}); restart "
                   f"{attempts[rank]}/{sup.max_restarts} in {delay:.2f}s")
        emit("supervisor", "supervisor.restart", rank=rank, rc=rc, attempt=attempts[rank],
             backoff=delay, why=why)

    try:
        while any(d is None for d in done):
            now = time.monotonic()
            if now > deadline:
                for rank, proc in enumerate(procs):
                    if proc is not None and proc.poll() is None:
                        _kill(proc)
                    if done[rank] is None:
                        note(rank, f"killed at the {timeout}s deadline")
                        done[rank] = WorkerResult(rank, -9, collect(rank))
                break
            for rank in range(n_procs):
                if done[rank] is not None:
                    continue
                proc = procs[rank]
                if proc is None:
                    if now >= next_start[rank]:
                        start(rank)
                    continue
                rc = proc.poll()
                if rc is None:
                    if (sup.liveness_timeout is not None
                            and time.time() - last_signal(rank) > sup.liveness_timeout):
                        _kill(proc)
                        on_crash(rank, proc.returncode, "went silent")
                    continue
                if rc == 0:
                    done[rank] = WorkerResult(rank, 0, collect(rank))
                else:
                    on_crash(rank, rc, "crashed")
            if any(d is None for d in done):
                time.sleep(sup.poll_interval)
    finally:
        for proc in procs:
            if proc is not None and proc.poll() is None:
                _kill(proc)
        for f in outs:
            f.close()

    results = [d for d in done if d is not None]
    _raise_failed(results, f"supervised workers (restart budget {sup.max_restarts}/rank)")
    return results


# --------------------------------------------------------------------------
# LatticeRecords <-> npz (the parity harness compares across processes)
# --------------------------------------------------------------------------


def save_records(path: str, records, meta: dict) -> None:
    """Persist a ``LatticeRecords`` (+ run metadata) to one ``.npz``."""
    np.savez(
        path,
        __axes__=json.dumps(records.axes),
        __meta__=json.dumps(meta),
        eval_rounds=records.eval_rounds,
        **{f: getattr(records, f) for f in _RECORD_FIELDS},
    )


def load_records(path: str):
    """Inverse of :func:`save_records` → ``(LatticeRecords, meta)``."""
    from repro_torch.sim.lattice import LatticeRecords

    with np.load(path) as z:
        axes = json.loads(str(z["__axes__"]))
        meta = json.loads(str(z["__meta__"]))
        records = LatticeRecords(axes=axes, eval_rounds=z["eval_rounds"],
                                 **{f: z[f] for f in _RECORD_FIELDS})
    return records, meta


# --------------------------------------------------------------------------
# the parity workload — ONE task definition shared by the workers and the
# single-host run they are compared with
# --------------------------------------------------------------------------


def parity_spec(n_rounds: int = 4):
    """The pinned 2-policy × 2-noise × 3-seed grid (6 cells a policy, not a
    multiple of every topology, so the run pads the cell axis)."""
    from repro_torch.sim.lattice import LatticeSpec

    return LatticeSpec(policies=("pofl", "channel"), noise_powers=(1e-11, 1e-9),
                       alphas=(0.1,), seeds=(0, 1000, 2000), n_rounds=n_rounds,
                       eval_every=2)


def _parity_task(device):
    """The parity workload's logreg task: 640 MNIST-shaped rows on 8 devices
    (label shards), zero weights, an eval on the first 200 rows."""
    from repro_torch.data.partition import partition_noniid_shards
    from repro_torch.data.synthetic import make_classification_dataset
    from repro_torch.models.small import logreg_logits, logreg_loss

    x, y = make_classification_dataset("mnist_like", 640, torch.Generator().manual_seed(0))
    data = partition_noniid_shards(x, y, n_devices=8)
    params0 = {"w": torch.zeros(784, 10), "b": torch.zeros(10)}
    xe, ye = x[:200].to(device), y[:200].to(device)

    def eval_fn(p):
        return logreg_loss(p, xe, ye), (logreg_logits(p, xe).argmax(-1) == ye).float().mean()

    return logreg_loss, data, params0, eval_fn


def _cnn_parity_lattice(device, n_rounds: int):
    """The paper's CNN at full width (D = 258,634, N = 30, 10 scheduled,
    σ_z² = 1e-10, ``pallas_fused``) over 5 policies × 3 seeds: the CNN
    lattice the port's card runs → ``(task, spec, cfg)``."""
    from repro_torch.core.pofl import POFLConfig
    from repro_torch.core.scheduling import POLICIES
    from repro_torch.sim.lattice import LatticeSpec
    from repro_torch.sim.tasks import make_model_task

    task = make_model_task("cnn", n_devices=30, n_train=3000, n_test=1000, seed=0,
                           channel_bias=1.0, device=device)
    spec = LatticeSpec(policies=POLICIES, noise_powers=(1e-10,), alphas=(0.1,),
                       seeds=(0, 1, 2), n_rounds=n_rounds, eval_every=5)
    return task, spec, POFLConfig(n_devices=30, n_scheduled=10, backend="pallas_fused")


def _rel_diff(got: dict, want: dict) -> dict:
    """Each float field's largest |got − want| over max|want|, and whether
    the decisions (|S|) are equal."""
    out = {f: float(np.abs(got[f] - want[f]).max() / max(np.abs(want[f]).max(), 1e-30))
           for f in want if f != "n_scheduled" and want[f].size}
    out["decisions_equal"] = bool(np.array_equal(got["n_scheduled"], want["n_scheduled"]))
    return out


def _record_fields(rec) -> dict:
    return {f: np.asarray(getattr(rec, f), np.float64) for f in _RECORD_FIELDS}


def _select_cells(state, idx):
    """A lattice state's cells ``idx`` (a list), with the draw streams of
    their seeds only, as a rank holding those cells starts them."""
    from repro_torch.core.local_update import AlgState
    from repro_torch.flatten_util import tree_map

    sel = torch.as_tensor(idx, device=state.noise.device)
    seed_of = state.seed_idx[sel].tolist()
    used = sorted(set(seed_of))
    return state._replace(
        params=tree_map(lambda p: p[sel], state.params),
        streams=[state.streams[i] for i in used],
        seed_idx=torch.tensor([used.index(i) for i in seed_of], device=sel.device),
        noise=state.noise[sel], alpha=state.alpha[sel], policy=state.policy[sel],
        alg=None if state.alg is None else AlgState(
            *(None if f is None else f[sel] for f in state.alg)),
        algorithm=None if state.algorithm is None else state.algorithm[sel],
    )


class ShardedCost:
    """What the sharded calls cost on this rank, and nothing of the
    unsharded twin rounds run beside them: the card synchronized around
    each call, each call's seconds, their peak device memory and the
    kernel launches they made (the change of the aircomp kernels' counts
    around each call). Wrap a call as ``cost(fn, *args, **kw)``."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.seconds_by_call: list[float] = []
        self.peak = 0
        self.launches = {"aircomp_fused": 0, "aircomp_fused_batch": 0}

    def __call__(self, fn, *args, **kw):
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        before = _launches()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if cuda:
            torch.cuda.synchronize(self.device)
            self.peak = max(self.peak, torch.cuda.max_memory_allocated(self.device))
        self.seconds_by_call.append(time.perf_counter() - t0)
        for k, v in _launches().items():
            self.launches[k] += v - before[k]
        return out

    def report(self, cell_rounds: int) -> dict:
        seconds = sum(self.seconds_by_call)
        return {"seconds": seconds, "seconds_by_call": list(self.seconds_by_call),
                "cell_rounds_per_s": cell_rounds / seconds,
                "max_memory_allocated": self.peak if self.device.type == "cuda" else None,
                "launches": dict(self.launches)}


def lattice_rounds_from_state(loss_fn, data, params0, spec, cfg, eval_fn, mesh,
                              device=None) -> tuple[list[dict], dict]:
    """Each round of ``spec``'s fused one-algorithm lattice on ``mesh``,
    from the unsharded run's state before it, against the unsharded round
    → ``(one _rel_diff a round, the sharded rounds' ShardedCost report)``
    (every rank holds the same list). Each rank runs the unsharded rounds
    too, so its block starts from the state the unsharded run reached: a
    difference cannot grow over rounds (the rule for a different cell
    batch, which may sum in another order)."""
    import dataclasses as dc

    from repro_torch.core import local_update, scheduling
    from repro_torch.core.pofl import FUSED_POLICY
    from repro_torch.sim.engine import SimEngine
    from repro_torch.sim.lattice import cell_axes, eval_schedule, records_to_host
    from repro_torch.sim.multihost import axis_size, gather_records, shard_to_global

    cfg = dc.replace(cfg, policy=FUSED_POLICY, n_devices=data.n_devices,
                     local_algorithm=spec.algorithms[0])
    full = SimEngine(loss_fn, data, cfg, eval_fn=eval_fn, device=device)
    shard = SimEngine(loss_fn, data, cfg, eval_fn=eval_fn, device=device, mesh=mesh)
    axes = cell_axes(spec, [local_update.algorithm_id(spec.algorithms[0])],
                     [scheduling.policy_id(p) for p in spec.policies])
    axes["algorithm_b"] = None
    n = len(axes["seed_b"])
    pad = (-n) % axis_size(mesh, "cells")
    mine = shard_to_global(np.minimum(np.arange(n + pad), n - 1), mesh).tolist()
    do_eval, _ = eval_schedule(spec, eval_fn is not None)
    state = full.lattice_start(params0, **axes)
    cost, out = ShardedCost(device), []
    for t in range(spec.n_rounds):
        _, rec_blk = cost(shard.lattice_round, _select_cells(state, mine), t, bool(do_eval[t]))
        state, rec = full.lattice_round(state, t, bool(do_eval[t]))
        got = gather_records(records_to_host(rec_blk), mesh)
        out.append(_rel_diff({f: v[:n] for f, v in _record_fields(got).items()},
                             _record_fields(records_to_host(rec))))
    return out, cost.report(n * spec.n_rounds)


def model_sharded_rounds_from_state(task, cfg, mesh, n_rounds: int, seed: int = 0,
                                    device=None) -> tuple[list[dict], dict]:
    """``round_algorithm`` of one ``pofl`` run on ``mesh``'s model axis
    against the unsharded round, each round from the unsharded run's params
    on the same draws → ``(one _rel_diff a round (the metrics and the new
    flat params), the model-sharded rounds' ShardedCost report)``."""
    import dataclasses as dc

    from repro_torch.core.pofl import round_algorithm
    from repro_torch.flatten_util import ravel_pytree, tree_map
    from repro_torch.sim.engine import SimEngine

    cfg = dc.replace(cfg, policy="pofl")
    full = SimEngine(task.loss_fn, task.data, cfg, device=device)
    ms = SimEngine(task.loss_fn, task.data, cfg, device=device, mesh=mesh).model_shard
    params = tree_map(lambda p: p.to(full.device), task.params0)
    stream, cost, out = full.draw_stream(seed), ShardedCost(device), []

    def fields(p, m):
        return {"params": ravel_pytree(p)[0].double().cpu().numpy(),
                **{f: np.asarray(float(getattr(m, f))) for f in
                   ("e_com", "e_var", "grad_norm", "n_scheduled", "a_scalar")}}

    for t in range(n_rounds):
        stream, d = full.next_draws(stream, task.dim)
        args = (task.loss_fn, full.data, cfg, params, d.h, d.batch_idx, d.sched, d.z, t)
        p_ms, _, m_ms = cost(round_algorithm, *args, model_shard=ms)
        p_full, _, m_full = round_algorithm(*args)
        out.append(_rel_diff(fields(p_ms, m_ms), fields(p_full, m_full)))
        params = p_full
    return out, cost.report(n_rounds)


def parity_records(n_rounds: int = 4, mesh=None, device=None, **kw):
    """One ``run_lattice`` of the parity workload (its logreg task and
    :func:`parity_spec`) over ``mesh`` → its ``LatticeRecords``."""
    from repro_torch.core.pofl import POFLConfig
    from repro_torch.sim.lattice import run_lattice

    loss_fn, data, params0, eval_fn = _parity_task(resolve_device(device))
    return run_lattice(loss_fn, data, params0, parity_spec(n_rounds),
                       base_cfg=POFLConfig(n_devices=8, n_scheduled=3), eval_fn=eval_fn,
                       mesh=mesh, device=device, **kw)


def run_parity_lattice(mesh=None, n_rounds: int = 4, device=None):
    """Run the parity workload twice over ``mesh`` → ``(records, meta)``:
    the second run must repeat the first bitwise (``repeat_exact``), the
    per-policy loop (``fuse_policies=False``) is held to the fused grid
    (``fused_vs_fallback``, bitwise in ``fused_matches_fallback``), and
    with a mesh every round is held to the unsharded round from the
    unsharded run's state (``rounds_from_state``)."""
    from repro_torch.core.pofl import POFLConfig

    records, repeat, fallback = (
        parity_records(n_rounds, mesh, device, **kw)
        for kw in ({}, {}, {"fuse_policies": False}))
    want = _record_fields(records)
    meta = {
        "n_rounds": n_rounds,
        "repeat_exact": all(np.array_equal(getattr(records, f), getattr(repeat, f))
                            for f in _RECORD_FIELDS),
        "fused_matches_fallback": all(np.array_equal(getattr(records, f), getattr(fallback, f))
                                      for f in _RECORD_FIELDS),
        "fused_vs_fallback": _rel_diff(_record_fields(fallback), want),
    }
    if mesh is not None:
        loss_fn, data, params0, eval_fn = _parity_task(resolve_device(device))
        meta["rounds_from_state"], _ = lattice_rounds_from_state(
            loss_fn, data, params0, parity_spec(n_rounds),
            POFLConfig(n_devices=8, n_scheduled=3), eval_fn, mesh, device)
    return records, meta


def _timed_run(task, spec, cfg, mesh, device) -> dict:
    """One ``run_lattice`` over ``mesh``: its cell-rounds/s and, on a card,
    this rank's peak device memory."""
    from repro_torch.sim.lattice import run_lattice

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run_lattice(task.loss_fn, task.data, task.params0, spec, base_cfg=cfg, eval_fn=task.eval,
                mesh=mesh, device=device)
    if cuda:
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    return {"seconds": seconds, "cell_rounds_per_s": spec.n_cells * spec.n_rounds / seconds,
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev) if cuda else None}


def _cnn_parity(n_rounds: int, cells_mesh, model_mesh, device) -> dict:
    """The full-width CNN lattice over the cells mesh and the model mesh,
    each round from the unsharded state, and ``pofl`` rounds of
    ``round_algorithm`` on the model mesh from the unsharded params → per
    mesh its ``rounds_from_state`` and the sharded rounds' own cost
    (``sharded``: this rank's seconds, peak memory and launches), and the
    model mesh's ``round_algorithm_from_state`` with its own
    (``round_algorithm_sharded``)."""
    task, spec, cfg = _cnn_parity_lattice(resolve_device(device), n_rounds)
    out = {}
    for name, mesh in (("cells", cells_mesh), ("model", model_mesh)):
        if mesh is not None:
            rounds, cost = lattice_rounds_from_state(
                task.loss_fn, task.data, task.params0, spec, cfg, task.eval, mesh, device)
            out[name] = {"rounds_from_state": rounds, "sharded": cost}
    if model_mesh is not None:
        rounds, cost = model_sharded_rounds_from_state(task, cfg, model_mesh, n_rounds,
                                                       device=device)
        out["model"].update(round_algorithm_from_state=rounds, round_algorithm_sharded=cost)
    return out


# --------------------------------------------------------------------------
# worker entry points
# --------------------------------------------------------------------------


def _launches() -> dict:
    from repro_torch.kernels.aircomp import kernel

    return {"aircomp_fused": kernel.launches, "aircomp_fused_batch": kernel.batch_launches}


def _worker_parity(args) -> None:
    from repro_torch.core.pofl import POFLConfig
    from repro_torch.sim.lattice import make_cell_mesh, make_cell_model_mesh
    from repro_torch.sim.multihost import ensure_process_group

    ensure_process_group(device=args.device)
    stamps = {"group": time.time()}  # when the rank got to each step (epoch seconds)
    rank, world = dist.get_rank(), dist.get_world_size()
    cells_mesh = make_cell_mesh()
    model_mesh = make_cell_model_mesh(1, world) if world > 1 else None
    records, meta = run_parity_lattice(mesh=cells_mesh, n_rounds=args.n_rounds,
                                       device=args.device)
    if model_mesh is not None:
        loss_fn, data, params0, eval_fn = _parity_task(resolve_device(args.device))
        meta["model_rounds_from_state"], _ = lattice_rounds_from_state(
            loss_fn, data, params0, parity_spec(args.n_rounds),
            POFLConfig(n_devices=8, n_scheduled=3), eval_fn, model_mesh, args.device)
    stamps["logreg"] = time.time()
    if args.cnn_rounds:
        meta["cnn"] = _cnn_parity(args.cnn_rounds, cells_mesh, model_mesh, args.device)
        stamps["cnn"] = time.time()
    meta.update(process_count=world, process_index=rank, backend=dist.get_backend())
    # rank-specific, so gathered: the sharded CNN calls' own costs, the stamps
    mine = {"stamps": stamps}
    for name, part in meta.get("cnn", {}).items():
        mine[name] = part.pop("sharded")
        if "round_algorithm_sharded" in part:
            mine["round_algorithm"] = part.pop("round_algorithm_sharded")
    per_rank: list = [None] * world
    dist.all_gather_object(per_rank, mine)
    meta["per_rank"] = per_rank
    print(f"[worker {rank}] {json.dumps(meta)}", flush=True)
    if rank == 0 and args.out:
        save_records(args.out, records, meta)
    dist.destroy_process_group()


def bench_spec(n_rounds: int = 30):
    """The throughput bench's sweep (the reference's ``BENCH_SWEEP_KW``): 5
    policies × 3 seeds, 10 scheduled, eval every 10."""
    from repro_torch.core.scheduling import POLICIES
    from repro_torch.sim.lattice import LatticeSpec

    return LatticeSpec(policies=POLICIES, noise_powers=(1e-11,), alphas=(0.1,),
                       seeds=(0, 1, 2), n_rounds=n_rounds, eval_every=10)


def _worker_bench(args) -> None:
    from repro_torch.core.pofl import POFLConfig
    from repro_torch.sim.lattice import make_cell_mesh
    from repro_torch.sim.multihost import ensure_process_group
    from repro_torch.sim.tasks import make_model_task

    ensure_process_group(device=args.device)
    mesh = make_cell_mesh()
    task = make_model_task("logreg", n_devices=20, n_train=2000, n_test=1000, seed=0,
                           device=resolve_device(args.device))
    spec = bench_spec(args.n_rounds)
    cfg = POFLConfig(n_devices=20, n_scheduled=10, backend=args.backend)
    t0 = time.time()
    cold = _timed_run(task, spec, cfg, mesh, args.device)
    steady = _timed_run(task, spec, cfg, mesh, args.device)
    payload = {
        "lattice_seconds": cold["seconds"],
        "steady_seconds": steady["seconds"],
        "steady_cell_rounds_per_s": steady["cell_rounds_per_s"],
        "wall_seconds": time.time() - t0,
        "cells": spec.n_cells,
        "n_rounds": spec.n_rounds,
        "n_hosts": dist.get_world_size(),
        "mesh_devices": dist.get_world_size(),
        "backend": args.backend,
        "max_memory_allocated": steady["max_memory_allocated"],
    }
    print(f"[worker {dist.get_rank()}] bench {json.dumps(payload)}", flush=True)
    if dist.get_rank() == 0 and args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# the resilient workload — independent rank-sharded checkpointed sweep (no
# collectives, so a crashed rank restarts alone and resumes from its own
# checkpoints)
# --------------------------------------------------------------------------


def resilient_spec(n_rounds: int = 6):
    """The pinned fault-injection grid: 2 policies × 2 seeds × 2 local
    algorithms (fedavg and the stateful feddyn, so a resumed carry holds
    ``AlgState``) over the churn scenario — 8 cells, split across ranks."""
    from repro_torch.sim.lattice import LatticeSpec

    return LatticeSpec(policies=("pofl", "channel"), noise_powers=(1e-11,), alphas=(0.1,),
                       seeds=(0, 1000), n_rounds=n_rounds, eval_every=2,
                       algorithms=("fedavg", "feddyn"))


def _resilient_task():
    """The resilient workers' task: 320 16-dim rows on 8 devices,
    Dirichlet-mixed (unequal true shard sizes in ``n_samples``)."""
    from repro_torch.data.partition import partition_dirichlet_mixed
    from repro_torch.data.synthetic import make_classification_dataset
    from repro_torch.models.small import logreg_loss

    x, y = make_classification_dataset("mnist_like", 320, torch.Generator().manual_seed(0),
                                       dim=16)
    data = partition_dirichlet_mixed(x, y, n_devices=8, seed=0)
    return logreg_loss, data, {"w": torch.zeros(16, 10), "b": torch.zeros(10)}


def resilient_shard(rank: int, count: int, n_rounds: int, checkpoint_dir: str,
                    checkpoint_every: int, device=None) -> tuple[int, int]:
    """Rank ``rank`` of ``count``'s shard of the resilient sweep,
    checkpointed every ``checkpoint_every`` rounds under ``checkpoint_dir``
    and published as ``shard-r<rank>.npz`` there → its ``(lo, hi)`` cells.
    What a resilient worker runs; a clean run of the sweep is every rank's
    shard, in one process or many."""
    from repro_torch.core.pofl import POFLConfig
    from repro_torch.sim.resilience import fault_nan, run_worker_shard

    loss_fn, data, params0 = _resilient_task()
    cfg = POFLConfig(n_devices=8, n_scheduled=3,
                     on_nonfinite="skip" if fault_nan() is not None else "propagate")
    return run_worker_shard(loss_fn, data, params0, resilient_spec(n_rounds),
                            os.path.join(checkpoint_dir, f"shard-r{rank}.npz"), checkpoint_dir,
                            checkpoint_every, rank=rank, count=count, base_cfg=cfg,
                            scenario="churn", device=resolve_device(device))


def _worker_resilient(args) -> None:
    """Run THIS rank's shard of the resilient sweep (rank/count from the
    ``REPRO_DIST_*`` env). Independent per rank: it makes no process group."""
    from repro_torch.obs.sink import process_coords

    rank, count = process_coords()
    lo, hi = resilient_shard(rank, count, args.n_rounds, args.checkpoint_dir,
                             args.checkpoint_every, args.device)
    print(f"[worker {rank}] shard cells [{lo}, {hi}) -> "
          f"{os.path.join(args.checkpoint_dir, f'shard-r{rank}.npz')}", flush=True)


# --------------------------------------------------------------------------
# the train workload — POFLTrainer over a (data, model) mesh of ranks
# --------------------------------------------------------------------------

TRAIN_PROBES, TRAIN_NOISE, TRAIN_SGD_LR = 2, 1e-10, 0.01
# the workload's cell: FL devices, global batch, tokens an example
TRAIN_FL, TRAIN_BATCH, TRAIN_SEQ = 8, 8, 2048
TRAIN_ROUND_FIELDS = ("loss", "e_com", "a", "n_scheduled", "coeffs", "noise_amp", "grad_mean",
                      "grad_var", "grad_norm")
RANK_OPS = ("gather", "reduce", "broadcast")


def train_setup(arch: str, layers: int, n_fl: int, batch: int, seq: int,
                optimizer: str = "sgd", dtype: str = "bfloat16", n_rounds: int = 3,
                device=None):
    """The train workload's trainer and data, shared by its ranks and the
    one-process run they are held to → ``(cfg, shape, TrainerConfig,
    Optimizer, batch_fn)``: ``arch``'s full-width config cut to ``layers``
    layers (0: its own depth), ``batch`` × ``seq`` tokens over ``n_fl`` FL
    devices, half of them scheduled, policy pofl, sketch mode with
    TRAIN_PROBES probes, σ_z² TRAIN_NOISE; ``sgd(TRAIN_SGD_LR)`` or
    ``adamw(cosine_schedule(3e-4, n_rounds, warmup=2))``; round t's batch
    taken from ``make_token_dataset`` as the reference's example takes it,
    on ``device``."""
    from repro_torch import configs
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.launch.train import TrainerConfig
    from repro_torch.models.config import InputShape
    from repro_torch.optim.optimizers import adamw, cosine_schedule, sgd

    cfg = configs.cut_depth(configs.base_config(arch), layers or None)
    shape = InputShape(f"train_{batch}x{seq}", seq, batch, "train")
    tcfg = TrainerConfig(policy="pofl", n_scheduled=max(1, n_fl // 2), noise_power=TRAIN_NOISE,
                         stats_mode="sketch", n_probes=TRAIN_PROBES, dtype=dtype)
    opt = {"sgd": lambda: sgd(TRAIN_SGD_LR),
           "adamw": lambda: adamw(cosine_schedule(3e-4, n_rounds, warmup=2))}[optimizer]()
    dev = resolve_device(device)
    corpus = make_token_dataset(batch * 8, seq, cfg.vocab_size,
                                torch.Generator(device=dev).manual_seed(0))

    def batch_fn(t):
        idx = torch.arange(batch, device=dev) + (t * batch) % (batch * 7)
        return {"tokens": corpus[idx]}

    return cfg, shape, tcfg, opt, batch_fn


def train_rounds(trainer, batch_fn, n_rounds: int, dt_init: str = "zeros"):
    """``n_rounds`` rounds from ``trainer.init_state(seed + 1, dt_init)`` →
    ``(params, opt_state, records, round_ms)``: records holds each
    TRAIN_ROUND_FIELDS value a round (numpy, stacked over rounds), the
    rounds timed on the host clock up to a synchronised device."""
    params, opt_state = trainer.init_state(trainer.tcfg.seed + 1, dt_init)
    rows, round_ms = [], []
    for t in range(n_rounds):
        batch = batch_fn(t)
        t0 = time.perf_counter()
        params, opt_state, diag = trainer.train_round(params, opt_state, batch)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        round_ms.append((time.perf_counter() - t0) * 1e3)
        rows.append(diag)
    records = {k: np.stack([np.asarray(r[k].detach().cpu()) for r in rows])
               for k in TRAIN_ROUND_FIELDS}
    return params, opt_state, records, round_ms


def counted_collectives() -> dict:
    """This process's collectives since the ``ranks.`` and ``span.ranks.``
    metrics were reset: each op's calls, wire bytes and (on a timed mesh)
    seconds."""
    from repro_torch.obs.registry import metric_value
    from repro_torch.obs.spans import span_totals

    return {op: {"calls": metric_value(f"ranks.{op}.calls"),
                 "bytes": metric_value(f"ranks.{op}.bytes"),
                 "seconds": span_totals(f"ranks.{op}")["seconds"]} for op in RANK_OPS}


def train_plan(args) -> list[dict]:
    """The train workload's runs, each ``{"arch", "layers", "model",
    "dtype", "n_rounds"}``: ``--plan`` (a JSON file: a list of such dicts, a
    missing key taken from its flag, and optionally ``dt_init``, the
    weights' ``api.model_init`` option), else one run from the flags."""
    flags = {"arch": args.arch, "layers": args.layers, "model": args.model,
             "dtype": args.dtype, "n_rounds": args.n_rounds}
    if not args.plan:
        return [flags]
    with open(args.plan) as f:
        return [{**flags, **run} for run in json.load(f)]


def plan_out(out: str, i: int, n_runs: int) -> str:
    """Where run ``i`` of ``n_runs`` writes ``out``: ``out`` itself for one
    run, else ``<stem>.<i><ext>``."""
    if n_runs == 1:
        return out
    stem, ext = os.path.splitext(out)
    return f"{stem}.{i}{ext}"


def _worker_train(args) -> None:
    """One rank of the train workload: ``POFLTrainer`` over a (data,
    model) mesh of every rank on TRAIN_BATCH × TRAIN_SEQ tokens over
    TRAIN_FL FL devices with ``sgd``, each run of :func:`train_plan` in
    turn in one process group (a launch costs its ranks' start and their
    group's set-up once, ``PERF.md`` §6): its ``arch`` cut to ``layers`` on
    the mesh of ``model`` ranks a model group, in ``dtype`` for
    ``n_rounds``, each from its model's initial weights. Rank 0 writes a run's records and every
    rank's costs to its ``--out`` (:func:`plan_out`; npz, the costs as JSON
    under ``meta``: each collective's calls, wire bytes and seconds, the
    card synchronised around it, the bytes of the fp32 weights its steps
    differentiate, its TP blocks where ``--model`` > 1 splits a dense or
    SSM model, and the run's seconds from its set-up to its outputs); with
    ``--save-blocks`` each rank also writes its final parameter blocks to
    ``<out>.rank<r>.pt``."""
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.sim.multihost import ensure_process_group

    ensure_process_group(device=args.device)
    meshes = {}
    runs = train_plan(args)
    for i, run in enumerate(runs):
        if run["model"] not in meshes:
            meshes[run["model"]] = make_rank_mesh(model=run["model"], n_fl=TRAIN_FL,
                                                  device=args.device, timed=True)
        _train_run(args, meshes[run["model"]], run, plan_out(args.out, i, len(runs)))
    dist.destroy_process_group()


def _train_run(args, mesh, run: dict, out: str) -> None:
    """One run of :func:`_worker_train` on ``mesh``, written to ``out``."""
    from repro_torch.launch.train import POFLTrainer
    from repro_torch.obs.registry import metric_value, reset_metrics

    t0 = time.perf_counter()
    n_rounds = run["n_rounds"]
    cfg, shape, tcfg, opt, batch_fn = train_setup(
        run["arch"], run["layers"], TRAIN_FL, TRAIN_BATCH, TRAIN_SEQ, "sgd", run["dtype"],
        n_rounds, args.device)
    trainer = POFLTrainer(cfg, shape, mesh, tcfg, optimizer=opt)
    counters = kernel_counters()
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(mesh.device)
    reset_metrics("span.ranks.")
    reset_metrics("ranks.")
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    params, opt_state, records, round_ms = train_rounds(trainer, batch_fn, n_rounds,
                                                        run.get("dt_init", "zeros"))
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    rank = dist.get_rank()
    mine = {"rank": rank, "coordinates": mesh.coordinates(), "round_ms": round_ms,
            "collectives": counted_collectives(),
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(mesh.device)
                                  if mesh.device.type == "cuda" else None),
            "params_bytes": tensor_bytes(params), "opt_state_bytes": tensor_bytes(opt_state),
            "compute_weight_bytes": metric_value("ranks.compute_weight_bytes"),
            "launches": launches}
    per_rank: list = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, mine)
    print(f"[worker {rank}] train {json.dumps(mine)}", flush=True)
    if out and args.save_blocks:
        torch.save({k: v.cpu() for k, v in flat_tree(params).items()}, f"{out}.rank{rank}.pt")
    meta = {"arch": run["arch"], "n_layers": cfg.n_layers, "mesh": mesh.shape,
            "n_fl": TRAIN_FL, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "n_rounds": n_rounds,
            "dtype": run["dtype"], "backend": dist.get_backend(), "per_rank": per_rank,
            "seconds": time.perf_counter() - t0}
    if rank == 0 and out:
        np.savez(out, meta=np.asarray(json.dumps(meta)), **records)
    del trainer, params, opt_state
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# the serve workload — Server over a (data, model) mesh of ranks
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServeRun:
    """One run of the serve workload: ``arch``'s full-width config cut to
    ``layers`` layers (0: its own depth) served in ``dtype`` from
    ``model_init(seed, dt_init=dt_init)`` (:func:`serve_weights`); a prefill of ``batch`` × ``prompt`` seeded tokens,
    then ``steps`` greedy decode steps: from the prefill's cache grown by
    ``steps`` slots (``cache_len`` 0), or from a ``cache_batch`` ×
    ``cache_len`` cache filled from the seed (:func:`seeded_cache`) at its
    last ``steps`` positions. ``model``: ranks a model group of the mesh it
    runs on (0: the launcher's ``--model``), so one process group can serve
    a plan over several layouts of the same ranks, data- and
    tensor-parallel, without a second rendezvous (a launched rank is slow to
    reach its group)."""

    arch: str = "qwen2-0.5b"
    layers: int = 0
    dtype: str = "bfloat16"
    batch: int = 8
    prompt: int = 2048
    steps: int = 8
    cache_batch: int = 128
    cache_len: int = 0
    seed: int = 0
    model: int = 0
    dt_init: str = "zeros"


def serve_weights(run: ServeRun, cfg, device) -> dict:
    """``run``'s fp32 weights on ``device``: ``model_init`` from its seed
    and its ``dt_init``."""
    from repro_torch.models import api

    return api.model_init(cfg, run.seed, device, dt_init=run.dt_init)


def seeded_cache(cfg, batch: int, length: int, filled: int, dtype, device, seed: int,
                 mesh=None):
    """A dense model's KV cache of ``batch`` × ``length`` slots whose first
    ``filled`` slots hold positions 0 … filled − 1 and k, v drawn layer by
    layer (standard normal in ``dtype``) from a ``torch.Generator`` on
    ``device`` seeded with ``seed``, the rest empty. On a ``RankMesh`` this
    rank's blocks (``cache_pspecs``): each layer is drawn whole and cut, so
    every mesh holds the same values; a prefill of that many tokens would
    cost far more than the decode it feeds."""
    from repro_torch.launch.sharding import Sharding, cache_shardings
    from repro_torch.models.cache import AttnCache, init_attn_cache

    whole = init_attn_cache(cfg, batch, length, dtype=dtype, device="meta")
    cut = cache_shardings(whole, mesh).k if mesh is not None else None
    dims = cut.block_shape(whole.k.shape) if cut is not None else whole.k.shape
    k = torch.empty(dims, dtype=dtype, device=device)
    v = torch.empty(dims, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for i in range(cfg.n_layers):
        for dst in (k, v):
            layer = torch.randn(whole.k.shape[1:], generator=gen, dtype=dtype, device=device)
            layer[:, filled:] = 0
            dst[i] = layer if cut is None else Sharding(mesh, cut.spec[1:]).block(layer)
            del layer
    pos = torch.full((length,), -1, dtype=torch.int32, device=device)
    pos[:filled] = torch.arange(filled, dtype=torch.int32, device=device)
    return AttnCache(k=k, v=v, pos=pos)


def _on_host(cache):
    return type(cache)(*(x.cpu() for x in cache))


def serve_inputs(run: ServeRun, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """``run``'s seeded inputs, on the host: the prompt (batch, prompt) and
    the first tokens (cache_batch, 1) of a decode from a seeded cache."""
    gen = torch.Generator().manual_seed(run.seed)
    tokens = torch.randint(0, cfg.vocab_size, (run.batch, run.prompt), generator=gen)
    return tokens, torch.randint(0, cfg.vocab_size, (run.cache_batch, 1), generator=gen)


def serve_run(run: ServeRun, where) -> dict:
    """``run`` on a device or over a ``RankMesh`` (``where``) → this rank's
    results: the bytes of the weights it serves (over model ranks its TP
    blocks), its rows' first tokens and last-position logits, its blocks of
    the prefill's cache, its decoded tokens and each step's logits (the
    logits whole: ``Server.gather_logits`` after each timed part; all on
    the host), the decode's final blocks when it decoded from the prefill,
    whether each step's position reached every rank's ``pos``; the prefill's
    ms, ms a decode step and the whole batch's tokens/s (the card
    synchronised at both ends), the peak memory of the decode, each
    kernel's launches in the prefill and in the decode (the counts zeroed
    just before each), and the collectives (``counted_collectives``) of the
    prefill and its logits' gather, of the decode steps alone (``steps``:
    the timed part) and of the decode with the gathers of its logits and
    tokens. A MoE model's runs also return every layer's routing
    (``models.layers.recorded_routes``, on the host after the timed part):
    the prefill's a layer, the decode's a step and layer (``routes``)."""
    from repro_torch import configs
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.launch.serve import Server
    from repro_torch.models.layers import recorded_routes
    from repro_torch.models.config import InputShape
    from repro_torch.obs.registry import reset_metrics

    dtype = getattr(torch, run.dtype)
    cfg = configs.cut_depth(configs.base_config(run.arch), run.layers or None)
    mesh = where if isinstance(where, RankMesh) else None
    dev = mesh.device if mesh is not None else resolve_device(where)
    counters = kernel_counters()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def zero():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def read():
        return {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}

    tokens, seeded_first = serve_inputs(run, cfg)
    own = run.cache_len == 0  # decode from the prefill's cache
    server = Server(cfg, InputShape("prompt", run.prompt + run.steps, run.batch, "decode"),
                    where, dtype)
    params = _in_turns(mesh, lambda: server.load_params(serve_weights(run, cfg, dev)))
    weight_bytes = tensor_bytes(params)
    reset_metrics("span.ranks.")
    reset_metrics("ranks.")
    sync()
    zero()
    t0 = time.perf_counter()
    with recorded_routes() as prefill_routes:
        first, logits, cache = server.prefill(params, server.batch_block({"tokens": tokens}),
                                              pad_to=run.prompt + run.steps if own else None)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = read()
    logits = server.gather_logits(logits)
    out = {"weight_bytes": weight_bytes,
           "prefill": {"first": first.cpu(), "logits": logits[:, -1].cpu(),
                       "cache": _on_host(cache), "ms": prefill_ms, "launches": launches,
                       "collectives": counted_collectives(),
                       "routes": _routes_on_host(prefill_routes)}}
    start = run.prompt
    if not own:
        del cache
        server = Server(cfg, InputShape("decode", run.cache_len, run.cache_batch, "decode"),
                        where, dtype)
        start = run.cache_len - run.steps
        cache = seeded_cache(cfg, run.cache_batch, run.cache_len, start, dtype, dev, run.seed,
                             mesh)
        first = server.batch_block({"t": seeded_first})["t"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_metrics("span.ranks.")
    reset_metrics("ranks.")
    sync()
    zero()
    t0 = time.perf_counter()
    with recorded_routes() as decode_routes:
        toks, cache, steps = server.decode(params, first, cache, start, run.steps + 1,
                                           keep_logits=True)
    sync()
    decode_s = time.perf_counter() - t0
    launches = read()
    step_collectives = counted_collectives()
    steps = server.gather_logits(steps)
    whole = server.gather_tokens(toks)
    written = torch.arange(start, start + run.steps, dtype=torch.int32)
    if hasattr(cache, "pos"):  # an SSM state holds no positions
        written = cache.pos[start:start + run.steps].cpu()
    out["decode"] = {
        "tokens": toks.cpu(), "logits": steps.cpu(), "whole_tokens": whole.cpu(),
        "cache": _on_host(cache) if own else None, "start": start,
        "positions_written": bool(torch.equal(written, torch.arange(
            start, start + run.steps, dtype=torch.int32))),
        "ms_per_step": decode_s * 1e3 / run.steps,
        "tokens_per_s": whole.shape[0] * run.steps / decode_s,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                              else None),
        "cache_bytes": tensor_bytes(list(cache)),
        "launches": launches, "steps_collectives": step_collectives,
        "collectives": counted_collectives(), "routes": _routes_on_host(decode_routes)}
    del cache, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _in_turns(mesh, fn):
    """``fn()`` on one device, or over a ``RankMesh`` on each rank in turn,
    rank order, each waiting for the one before it: ranks that share a card
    then hold one whole fp32 draw of the weights on it at a time (olmoe-1b-7b's
    is 27.7 GB, beside its 13.8 GB served in bf16)."""
    if mesh is None:
        return fn()
    out = None
    for rank in range(dist.get_world_size()):
        if rank == dist.get_rank():
            out = fn()
            if mesh.device.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return out


def _routes_on_host(routes: list) -> list:
    """Recorded ``MoERoute`` s with their tensors on the host."""
    return [type(r)(*(x.cpu() if isinstance(x, torch.Tensor) else x for x in r)) for r in routes]


def serve_plan(args) -> list[ServeRun]:
    """The serve workload's runs: ``--plan`` (a JSON file: a list of
    :class:`ServeRun` fields), else one run from the flags."""
    if args.plan:
        with open(args.plan) as f:
            return [ServeRun(**r) for r in json.load(f)]
    return [ServeRun(arch=args.arch, layers=args.layers, dtype=args.dtype, batch=args.batch,
                     prompt=args.prompt, steps=args.steps, cache_batch=args.cache_batch,
                     cache_len=args.cache_len)]


def _worker_serve(args) -> None:
    """One rank of the serve workload: a ``Server`` over a (data, model)
    mesh of every rank (a run's ``model`` ranks a model group, else
    ``--model``; the launcher's env or torchrun's), each run of
    :func:`serve_plan` through :func:`serve_run`. Every rank prints its
    figures (one JSON line a run) and, with ``--out``, writes its results
    (each with its mesh and place) to ``<out>.rank<r>.pt``."""
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.launch.train import _join_ranks

    _join_ranks(args.device)  # torchrun's env; else make_rank_mesh joins the launcher's
    meshes = {}
    results = []
    for run in serve_plan(args):
        model = run.model or args.model
        if model not in meshes:
            meshes[model] = make_rank_mesh(model=model, device=args.device, timed=True)
        mesh = meshes[model]
        out = serve_run(run, mesh)
        out["run"] = dataclasses.asdict(run)
        out["mesh"] = mesh.shape
        out["coordinates"] = mesh.coordinates()
        results.append(out)
        figures = {k: out["decode"][k] for k in ("ms_per_step", "tokens_per_s",
                                                 "peak_memory_bytes", "collectives")}
        figures.update(weight_bytes=out["weight_bytes"], prefill_ms=out["prefill"]["ms"],
                       prefill_collectives=out["prefill"]["collectives"])
        print(f"[worker {dist.get_rank()}] serve {json.dumps({**out['run'], **figures})}",
              flush=True)
    if args.out:
        torch.save({"backend": dist.get_backend(), "runs": results},
                   f"{args.out}.rank{dist.get_rank()}.pt")
    dist.destroy_process_group()


def flat_tree(tree, prefix: str = "") -> dict:
    """A dict tree as ``{"a/b": leaf}``."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat_tree(v, f"{prefix}{k}/").items()}
    return {prefix.rstrip("/"): tree}


def kernel_counters() -> dict:
    """Every kernel's launch counter: ``{name: (module, attribute)}``."""
    from repro_torch.kernels.aircomp import kernel as aircomp
    from repro_torch.kernels.attention import kernel as attn
    from repro_torch.kernels.ssd import kernel as ssd

    return {"aircomp_fused": (aircomp, "launches"),
            "aircomp_fused_batch": (aircomp, "batch_launches"),
            "flash_attention": (attn, "launches"), "ssd_scan": (ssd, "launches")}


def _worker_argv(workload: str, **flags) -> list[str]:
    argv = [sys.executable, "-m", "repro_torch.launch.distributed", "--worker",
            "--workload", workload]
    for name, value in flags.items():
        if value is not None:
            argv += [f"--{name.replace('_', '-')}", str(value)]
    return argv


def run_resilient(
    n_procs: int,
    checkpoint_dir: str,
    out: str = "",
    n_rounds: int = 6,
    checkpoint_every: int = 2,
    timeout: float = 900.0,
    supervisor: SupervisorConfig | None = None,
    device: str | None = None,
):
    """Supervise the resilient workload across ``n_procs`` independent local
    workers, then merge their shards into one full-grid ``LatticeRecords``
    (written to ``out`` as npz when given). Survives injected or real rank
    crashes up to the per-rank restart budget."""
    from repro_torch.sim.resilience import merge_shards

    os.makedirs(checkpoint_dir, exist_ok=True)
    supervise_workers(
        _worker_argv("resilient", n_rounds=n_rounds, checkpoint_dir=checkpoint_dir,
                     checkpoint_every=checkpoint_every, device=device),
        n_procs=n_procs, timeout=timeout, supervisor=supervisor,
    )
    records = merge_shards(resilient_spec(n_rounds),
                           [os.path.join(checkpoint_dir, f"shard-r{r}.npz")
                            for r in range(n_procs)])
    if out:
        save_records(out, records, {"n_rounds": n_rounds, "n_procs": n_procs,
                                    "workload": "resilient"})
    return records


def run_bench(
    n_procs: int,
    devices_per_proc: int = 1,
    backend: str = "jnp",
    n_rounds: int = 30,
    timeout: float = 1200.0,
    device: str | None = None,
) -> dict:
    """Spawn the bench workload across ``n_procs`` local ranks and return
    rank 0's timing payload."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "bench.json")
        run_workers(_worker_argv("bench", out=out, backend=backend, n_rounds=n_rounds,
                                 device=device),
                    n_procs=n_procs, devices_per_proc=devices_per_proc, timeout=timeout)
        with open(out) as f:
            return json.load(f)


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--" in argv:
        split = argv.index("--")
        argv, command = argv[:split], argv[split + 1:]
    else:
        command = None

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--procs", type=int, default=2, metavar="N",
                        help="number of coordinated local ranks")
    parser.add_argument("--devices-per-proc", type=int, default=1, metavar="K",
                        help="devices a rank: 1 (the port runs one rank a device)")
    parser.add_argument("--workload", default="parity",
                        choices=("parity", "bench", "resilient", "train", "serve"),
                        help="built-in workload when no `-- command` is given")
    parser.add_argument("--out", default="",
                        help="rank-0 output path (npz for parity and resilient, json for bench)")
    parser.add_argument("--n-rounds", type=int, default=4)
    parser.add_argument("--backend", default="jnp", help="bench: the aggregation backend")
    parser.add_argument("--device", default=None,
                        help="cpu, or cuda (each rank its card: cuda:{rank %% cards}); "
                             "default: the rank's card")
    parser.add_argument("--cnn-rounds", type=int, default=0,
                        help="parity: also hold the full-width CNN lattice, this many "
                             "rounds, round by round over the cells and model meshes")
    parser.add_argument("--timeout", type=float, default=900.0,
                        help="seconds before every rank still running is killed")
    parser.add_argument("--checkpoint-dir", default="",
                        help="resilient workload: checkpoint/shard directory "
                             "(default: a temp dir)")
    parser.add_argument("--checkpoint-every", type=int, default=2,
                        help="resilient workload: rounds per checkpoint chunk")
    parser.add_argument("--max-restarts", type=int, default=2,
                        help="supervisor: restart budget per rank")
    parser.add_argument("--liveness-timeout", type=float, default=None,
                        help="supervisor: seconds of heartbeat silence (REPRO_OBS_DIR "
                             "mtimes) before a rank is killed and restarted")
    parser.add_argument("--arch", default="qwen2-0.5b", help="train, serve: the config's name")
    parser.add_argument("--layers", type=int, default=0,
                        help="train, serve: the depth (0: the config's own)")
    parser.add_argument("--model", type=int, default=1,
                        help="train, serve: ranks a model group (the rest are data ranks)")
    parser.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                        help="train: the compute dtype (the masters are fp32); serve: the "
                             "serving dtype")
    parser.add_argument("--batch", type=int, default=8, help="serve: the prompt's rows")
    parser.add_argument("--prompt", type=int, default=2048, help="serve: the prompt's tokens")
    parser.add_argument("--steps", type=int, default=8, help="serve: the decode steps")
    parser.add_argument("--cache-batch", type=int, default=128,
                        help="serve: the seeded cache's rows")
    parser.add_argument("--cache-len", type=int, default=0,
                        help="serve: the seeded cache's slots, decoded at its last --steps "
                             "positions (0: decode from the prefill)")
    parser.add_argument("--plan", default="",
                        help="serve: a JSON file of runs (a list of ServeRun fields) in place "
                             "of the flags', each on the mesh its 'model' field names (0: "
                             "--model); train: a JSON file of runs (a list of {arch, layers, "
                             "model, dtype, n_rounds}, a missing key its flag's), run i "
                             "writing <stem>.<i><ext> of --out")
    parser.add_argument("--save-blocks", action="store_true",
                        help="train: every rank writes its final blocks to <out>.rank<r>.pt")
    parser.add_argument("--worker", action="store_true",
                        help=argparse.SUPPRESS)  # internal: run AS a worker
    args = parser.parse_args(argv)

    if args.worker:
        {"parity": _worker_parity, "resilient": _worker_resilient,
         "bench": _worker_bench, "train": _worker_train,
         "serve": _worker_serve}[args.workload](args)
        return

    if args.procs < 1:
        parser.error("--procs must be >= 1")
    if args.devices_per_proc != 1:
        parser.error("--devices-per-proc must be 1: the port runs one rank a device")

    if args.workload == "resilient" and command is None:
        import tempfile

        ckpt_dir = args.checkpoint_dir or tempfile.mkdtemp(prefix="repro-ckpt-")
        records = run_resilient(
            n_procs=args.procs, checkpoint_dir=ckpt_dir, out=args.out,
            n_rounds=args.n_rounds, checkpoint_every=args.checkpoint_every,
            timeout=args.timeout, device=args.device,
            supervisor=SupervisorConfig(max_restarts=args.max_restarts,
                                        liveness_timeout=args.liveness_timeout),
        )
        print(f"[launcher] resilient sweep done: {records.e_com.shape} "
              f"(checkpoints under {ckpt_dir})")
        return

    train = {} if args.workload not in ("train", "serve") else dict(
        arch=args.arch, layers=args.layers, model=args.model, dtype=args.dtype,
        plan=args.plan or None)
    if args.workload == "serve":
        train.update(batch=args.batch, prompt=args.prompt, steps=args.steps,
                     cache_batch=args.cache_batch, cache_len=args.cache_len)
    worker_argv = command or _worker_argv(
        args.workload, out=args.out or None, n_rounds=args.n_rounds, backend=args.backend,
        device=args.device, cnn_rounds=args.cnn_rounds or None, **train)
    if command is None and args.save_blocks:
        worker_argv.append("--save-blocks")
    results = run_workers(worker_argv, n_procs=args.procs,
                          devices_per_proc=args.devices_per_proc, timeout=args.timeout)
    sys.stdout.write(results[0].output)


if __name__ == "__main__":
    main()
