"""Multi-process lattice plumbing (port of ``repro.sim.multihost``).

The reference runs one controller per host over ``jax.distributed`` and
shards the lattice's flat cell axis over a mesh of devices. The port runs
ONE RANK PER DEVICE through ``torch.distributed``: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks, with
``mesh_dim_names`` ``("cells",)`` or ``("cells", "model")``, and the rank
with place r among its host's ranks computes on
``cuda:{r % torch.cuda.device_count()}`` unless the caller asks for the
CPU (on one host, r is the rank). A single process is a one-rank mesh. So where the
reference tells local devices (``make_cell_mesh``) from global ones
(:func:`make_global_cell_mesh`), the port has only the ranks of the process
group: both spellings build the same mesh.

  * :func:`initialize_distributed` wires ``torch.distributed`` from explicit
    args or the ``REPRO_DIST_*`` env contract written by
    ``repro_torch.launch.distributed`` (``init_process_group`` with
    ``init_method="tcp://<coordinator>"``): NCCL when every rank of this host
    has its own card, gloo on the CPU or where ranks share a card; a rank's
    card is picked by its place on its host. Without the env it is a no-op;
    it is idempotent. :func:`ensure_process_group`
    makes a one-rank group when none exists (a one-rank mesh in a single
    process).
  * :func:`make_global_cell_mesh` / :func:`make_global_cell_model_mesh`
    build the meshes over the process group's ranks, cells-major; asking for
    more ranks than the group holds raises ``ValueError``.
  * :func:`shard_to_global` gives this rank's block of a host array that
    every rank holds whole (the cell grid is built from the spec on every
    rank), as the reference's commits only the addressable shards.
  * :func:`gather_records` brings a tree of per-rank host records to EVERY
    rank in ONE rendezvous (``all_gather_object`` over the cells axis),
    concatenated in cell order, so every rank returns the same
    ``LatticeRecords``. One collective per leaf is what the reference's
    docstring records as racing on gloo; one object gather is one rendezvous
    on gloo and NCCL alike.

Nothing here touches ``torch.distributed`` at import time. Every rendezvous
and every collective has the group's timeout (:data:`INIT_TIMEOUT` unless
the caller gives one), so a half-formed topology fails loudly.
"""
from __future__ import annotations

import dataclasses
import datetime
import ipaddress
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.obs.spans import span

ENV_COORDINATOR = "REPRO_DIST_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_DIST_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_DIST_PROCESS_ID"
# the port's addition to the contract: this rank's place among the ranks of
# its host, and their count (torchrun's LOCAL_RANK / LOCAL_WORLD_SIZE are
# read when these are not set)
ENV_LOCAL_PROCESS_ID = "REPRO_DIST_LOCAL_PROCESS_ID"
ENV_LOCAL_NUM_PROCESSES = "REPRO_DIST_LOCAL_NUM_PROCESSES"

INIT_TIMEOUT = 120.0  # seconds: the rendezvous and every collective of a group

LAUNCHER_HINT = "start the ranks with `python -m repro_torch.launch.distributed --procs N`"


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """One process's view of the topology. ``local_process_id`` and
    ``local_num_processes`` place the rank among the ranks of its own host
    (``None``: not given, see :meth:`local`)."""

    coordinator: str   # "host:port" of rank 0's rendezvous store
    num_processes: int
    process_id: int
    local_process_id: int | None = None
    local_num_processes: int | None = None

    def local(self) -> tuple[int, int]:
        """``(this rank's place on its host, the ranks on its host)``: the
        fields when given; else the whole topology when it is one host (one
        rank, or a loopback coordinator, as the port's launcher writes).
        Ranks over several hosts must give them: otherwise ``ValueError``."""
        if self.local_process_id is not None and self.local_num_processes is not None:
            return self.local_process_id, self.local_num_processes
        if self.num_processes == 1 or _is_loopback(self.coordinator):
            return self.process_id, self.num_processes
        raise ValueError(
            f"{self.num_processes} ranks with a coordinator at {self.coordinator}: a "
            f"topology over several hosts must also export {ENV_LOCAL_PROCESS_ID} and "
            f"{ENV_LOCAL_NUM_PROCESSES} (or LOCAL_RANK and LOCAL_WORLD_SIZE), which pick "
            f"each rank's card and the backend; runs over several hosts are unverified"
        )


def _is_loopback(coordinator: str) -> bool:
    host = coordinator.rsplit(":", 1)[0].strip("[]")
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def _env_pair(names: tuple[str, str]) -> tuple[int, int] | None:
    values = [os.environ.get(n) for n in names]
    if not any(values):
        return None
    if not all(values):
        raise ValueError(f"partial local topology in the env: export both of {list(names)}")
    return int(values[0]), int(values[1])


def distributed_env() -> DistributedConfig | None:
    """Read the ``REPRO_DIST_*`` env contract; ``None`` when not set.

    The contract is written by ``repro_torch.launch.distributed`` for every
    worker it spawns; a cluster launcher can export the same variables
    instead (the local pair, or torchrun's ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``, where the ranks span several hosts).
    """
    names = (ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID)
    values = [os.environ.get(n) for n in names]
    if not any(values):
        return None
    missing = [n for n, v in zip(names, values) if not v]
    if missing:
        raise ValueError(
            f"partial REPRO_DIST_* env contract: missing {missing}; a "
            f"distributed worker must export all of {list(names)}"
        )
    local = (_env_pair((ENV_LOCAL_PROCESS_ID, ENV_LOCAL_NUM_PROCESSES))
             or _env_pair(("LOCAL_RANK", "LOCAL_WORLD_SIZE")) or (None, None))
    return DistributedConfig(
        coordinator=values[0],
        num_processes=int(values[1]),
        process_id=int(values[2]),
        local_process_id=local[0],
        local_num_processes=local[1],
    )


def default_backend(local_num_processes: int, device=None) -> str:
    """NCCL when the ranks compute on cards and every rank of this host has
    its own (``local_num_processes``, the ranks on this host, ≤ its cards);
    gloo on the CPU or where ranks share a card (NCCL refuses two ranks on
    one card)."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu or not torch.cuda.is_available():
        return "gloo"
    return "nccl" if local_num_processes <= torch.cuda.device_count() else "gloo"


def initialize_distributed(cfg: DistributedConfig | None = None, backend: str | None = None,
                           timeout: float = INIT_TIMEOUT, device=None) -> bool:
    """Initialize the default process group from ``cfg`` or the env contract.

    Idempotent; a no-op (returning whether a group exists) when neither
    names a topology, so single-process callers can call it unconditionally.
    ``backend`` defaults to :func:`default_backend` over the ranks of this
    host (``device`` "cpu" forces gloo). Unless the ranks compute on the
    CPU, this rank's card becomes ``cuda:{local rank % cards}``, the current
    device (``repro_torch.device.resolve_device`` returns it). Returns True
    when this process is part of a process group.
    """
    if dist.is_initialized():
        return True
    cfg = cfg or distributed_env()
    if cfg is None:
        return False
    local_rank, local_count = cfg.local()
    backend = backend or default_backend(local_count, device)
    cpu = device is not None and torch.device(device).type == "cpu"
    if torch.cuda.is_available() and not cpu:
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{cfg.coordinator}",
        world_size=cfg.num_processes, rank=cfg.process_id,
        timeout=datetime.timedelta(seconds=timeout),
    )
    return True


def find_free_port() -> int:
    """Bind-and-release a localhost TCP port for a rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ensure_process_group(device=None) -> None:
    """The default process group: the env contract's, or a one-rank group on
    a free localhost port when there is neither (a single process is a
    one-rank mesh; NCCL on a card, gloo on the CPU)."""
    if initialize_distributed(device=device):
        return
    initialize_distributed(
        DistributedConfig(f"127.0.0.1:{find_free_port()}", 1, 0), device=device)


def _mesh_device_type() -> str:
    """The DeviceMesh's device type: its collectives' (NCCL moves CUDA
    tensors; gloo's mesh is a CPU mesh, whatever the ranks compute on)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def cells_mesh_over(n_ranks: int | None, hint: str):
    """Shared constructor behind ``sim.lattice.make_cell_mesh`` and
    :func:`make_global_cell_mesh`: validate the count against the process
    group and build the 1-D ``("cells",)`` mesh over its first ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    ensure_process_group()
    world = dist.get_world_size()
    n = world if n_ranks is None else int(n_ranks)
    if not 1 <= n <= world:
        raise ValueError(f"mesh wants {n} ranks but the process group holds {world} {hint}")
    return DeviceMesh(_mesh_device_type(), torch.arange(n), mesh_dim_names=("cells",))


def make_global_cell_mesh(n_ranks: int | None = None):
    """A 1-D ``("cells",)`` mesh over the first ``n_ranks`` ranks of the
    process group (``None``: every rank)."""
    return cells_mesh_over(n_ranks, hint=f"({LAUNCHER_HINT})")


def cell_model_mesh_over(cells: int | None, model: int, hint: str):
    """Shared constructor behind the 2-D ``("cells", "model")`` meshes:
    validate the counts and lay the ranks out cells-major, so the first
    ``model`` ranks form cell-shard 0. ``cells=None`` takes every full group
    of ``model`` ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    ensure_process_group()
    world = dist.get_world_size()
    if cells is None:
        cells = world // model
    n = cells * model
    if not (1 <= cells and 1 <= n <= world):
        raise ValueError(
            f"mesh wants {cells}x{model} = {n} ranks but the process group holds "
            f"{world} {hint}"
        )
    return DeviceMesh(_mesh_device_type(), torch.arange(n).reshape(cells, model),
                      mesh_dim_names=("cells", "model"))


def make_global_cell_model_mesh(cells: int | None = None, model: int = 1):
    """A 2-D ``("cells", "model")`` mesh over the process group's ranks."""
    return cell_model_mesh_over(cells, model, hint=f"({LAUNCHER_HINT})")


def mesh_process_span(mesh) -> tuple[int, ...]:
    """Sorted ranks (processes) of ``mesh``."""
    return tuple(sorted(int(r) for r in mesh.mesh.flatten().tolist()))


def mesh_spans_processes(mesh) -> bool:
    """True when ``mesh`` holds more than one rank."""
    return mesh is not None and len(mesh_process_span(mesh)) > 1


def axis_size(mesh, axis: str) -> int:
    """The size of ``mesh``'s axis ``axis`` (1 when it has no such axis)."""
    names = mesh.mesh_dim_names
    return int(mesh.size(names.index(axis))) if axis in names else 1


def shard_to_global(host_arr, mesh, axis: str = "cells") -> np.ndarray:
    """This rank's block of ``host_arr`` along its leading axis, split
    evenly over ``mesh``'s ``axis`` (every rank passes the SAME full array;
    its length must divide). A one-rank axis returns the whole array."""
    host_arr = np.asarray(host_arr)
    n = axis_size(mesh, axis)
    if host_arr.shape[0] % n:
        raise ValueError(f"{host_arr.shape[0]} rows do not split over {n} {axis} ranks")
    block = host_arr.shape[0] // n
    k = mesh.get_local_rank(axis) if n > 1 else 0
    return host_arr[k * block:(k + 1) * block]


def gather_records(tree, mesh=None):
    """Every cells rank's host record tree, concatenated along the cell axis
    in cell order, on EVERY rank: ONE ``all_gather_object`` rendezvous over
    ``mesh``'s ``cells`` axis (the ranks of one model group hold the same
    records, and each model column gathers its own copy). Without a process
    group, or ``mesh`` None, the tree as it is."""
    from repro_torch.sim.engine import zip_records

    if mesh is None or not dist.is_initialized():
        return tree
    group = mesh.get_group("cells")
    leaves: list = []
    zip_records(leaves.append, tree)
    parts: list = [None] * dist.get_world_size(group)
    with span("multihost.gather", leaves=len(leaves)):
        dist.all_gather_object(parts, (mesh.get_local_rank("cells"), tree), group=group)
    ordered = [t for _, t in sorted(parts, key=lambda p: p[0])]
    return zip_records(lambda *xs: np.concatenate(xs, axis=0), *ordered)
