"""Meshes of the LM steps (port of ``repro.launch.mesh``).

Three kinds (the one-card and rank meshes extend the shape-only one),
each carrying what the steps and ``launch.sharding`` read
from a mesh: ``axis_names``, ``shape[axis]`` (and ``mesh_dim_names``,
``size(i)``), ``devices.size``; ``("pod", "data")`` are the batch axes.

  * :class:`HostMesh` (:func:`make_host_mesh`): named axes over ONE card,
    where an FL device is a slice of the batch, not a rank. Its batch axes'
    product is the number of FL devices; nothing is sharded. The count is
    an argument where the reference reads its host's device count
    (``--xla_force_host_platform_device_count`` in
    ``examples/train_pofl_lm.py``).
  * :class:`ShapeMesh` (:func:`make_production_mesh`): the reference's
    production mesh as names and sizes only, (data, model) = (16, 16) or
    (pod, data, model) = (2, 16, 16). No machine here has 256 ranks; this
    is what the reference's dry run gets from its 512 placeholder CPU
    devices. The spec functions, ``auto_microbatches`` and the dry run read
    it; collectives refuse it.
  * :class:`RankMesh` (:func:`make_rank_mesh`): (data, model) over the
    ranks of the ``torch.distributed`` process group, data-major. The FL
    devices lie in contiguous blocks over the data ranks (data rank r holds
    FL devices r·n_fl/R_data … (r + 1)·n_fl/R_data − 1); ranks along
    "model" hold their blocks of every parameter by its spec, and split a
    dense or SSM model's products tensor-parallel (any other model they
    compute whole: ``launch/steps.py::tp_trains``). Its :func:`batch_ways` is the FL
    device count, as on one card; with one rank it is the one-card trainer's
    mesh.

Every collective a rank mesh runs goes through :meth:`RankMesh.collective`,
which counts it and its wire bytes a rank (:func:`wire_bytes`) under
``ranks.<op>.calls`` and ``ranks.<op>.bytes`` in the obs registry; the dry
run reckons the same counts from the specs
(``launch.dryrun.rank_collectives``). A mesh made with ``timed`` also
times each collective under the span ``ranks.<op>``, the card
synchronised on both sides; untimed, NCCL's collectives stay asynchronous.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh as axis names and sizes only: nothing runs on it."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def mesh_dim_names(self) -> tuple[str, ...]:
        return self.axis_names

    def size(self, i: int | None = None) -> int:
        return math.prod(self.axis_sizes) if i is None else self.axis_sizes[i]

    @property
    def devices(self) -> np.ndarray:
        """Placeholder cells (``None``), one a device of the mesh."""
        return np.full(self.axis_sizes, None, dtype=object)

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.axis_sizes)

    def coordinates(self, rank: int | None = None) -> dict:
        raise ValueError(f"the {self.name} mesh is shape-only: it has no ranks")

    def collective(self, op: str, nbytes: int = 0):
        raise ValueError(f"the {self.name} mesh is shape-only: no collective runs on it")


@dataclasses.dataclass(frozen=True)
class HostMesh(ShapeMesh):
    """Named axes over one device: ``shape[axis]`` ways each."""

    device: torch.device = None

    @property
    def devices(self) -> np.ndarray:
        """The mesh's cells, every one the same device (``.size`` is the
        product of the axes)."""
        cells = np.empty(math.prod(self.axis_sizes), dtype=object)
        cells[:] = [self.device] * cells.size
        return cells.reshape(self.axis_sizes)


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh(ShapeMesh):
    """(data, model) over the process group's ranks (``device_mesh``);
    ``device`` is this rank's, ``n_fl`` the FL devices of the whole batch;
    ``timed``: whether :meth:`collective` times each collective."""

    device_mesh: object = None  # torch.distributed.device_mesh.DeviceMesh
    n_fl: int = 1
    device: torch.device = None
    timed: bool = False

    @property
    def devices(self) -> np.ndarray:
        """The ranks, laid out as the mesh."""
        return self.device_mesh.mesh.numpy()

    @property
    def n_ranks(self) -> int:
        return self.size()

    @property
    def backend(self) -> str:
        import torch.distributed as dist

        return dist.get_backend()

    def coordinates(self, rank: int | None = None) -> dict:
        """``{axis: place}`` of ``rank`` (this rank when ``None``)."""
        import torch.distributed as dist

        rank = dist.get_rank() if rank is None else rank
        where = np.argwhere(self.devices == rank)[0]
        return dict(zip(self.axis_names, (int(k) for k in where)))

    def get_group(self, axis: str):
        return self.device_mesh.get_group(axis)

    @contextlib.contextmanager
    def collective(self, op: str, nbytes: int = 0):
        """Count one collective ``op`` of ``nbytes`` wire bytes a rank; on a
        ``timed`` mesh also time it under the span ``ranks.<op>``, the card
        synchronised on both sides so the span holds the collective alone."""
        from repro_torch.obs.registry import counter_add
        from repro_torch.obs.spans import span

        counter_add(f"ranks.{op}.calls", 1, emit_event=False)
        counter_add(f"ranks.{op}.bytes", nbytes, emit_event=False)
        if not self.timed:
            yield
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with span(f"ranks.{op}"):
            yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)


def wire_bytes(op: str, result: int, g: int) -> int:
    """Wire bytes a rank of a ring ``all-gather`` or ``all-reduce`` over
    ``g`` ranks whose result on a rank is ``result`` bytes (the reference
    dry run's rule), or of a ``broadcast`` (its payload)."""
    if op == "all-gather":
        return result * (g - 1) // g
    if op == "all-reduce":
        return 2 * result * (g - 1) // g
    if op == "broadcast":
        return result
    raise ValueError(f"no wire rule for {op!r}")


def activate_mesh(mesh):
    """A context manager that makes ``mesh`` the ambient mesh: the port's
    steps take their mesh as an argument, so it yields the mesh unchanged."""
    return contextlib.nullcontext(mesh)


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The reference's production mesh, shape-only: (data=16, model=16), or
    (pod=2, data=16, model=16) with ``multi_pod``."""
    if multi_pod:
        return ShapeMesh(("pod", "data", "model"), (2, 16, 16))
    return ShapeMesh(("data", "model"), (16, 16))


def make_host_mesh(model: int = 2, n_devices: int = 1, device=None) -> HostMesh:
    """A (data, model) mesh of ``n_devices`` cells (the reference's host
    device count) on ``device`` (the card unless the caller says
    otherwise): ``model = min(model, n_devices)``, ``data = n_devices //
    model``."""
    model = min(model, n_devices)
    return HostMesh(("data", "model"), (n_devices // model, model), resolve_device(device))


def make_rank_mesh(model: int = 1, n_fl: int | None = None, device=None,
                   timed: bool = False) -> RankMesh:
    """(data, model) over every rank of the process group (the env
    contract's, or a one-rank group in a single process: NCCL on a card,
    gloo on the CPU), ``model`` ranks a model group, data-major. ``n_fl``
    FL devices (default: one a data rank, which a serving mesh leaves as it
    is: serving reads no FL device) must split evenly over the data ranks.
    ``device``: this rank's compute device (its card unless given).
    ``timed``: time every collective (spans ``ranks.<op>``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.sim.multihost import LAUNCHER_HINT, ensure_process_group

    ensure_process_group(device=device)
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"{world} ranks do not split into model groups of {model} "
                         f"({LAUNCHER_HINT})")
    data = world // model
    n_fl = data if n_fl is None else int(n_fl)
    if n_fl < 1 or n_fl % data:
        raise ValueError(f"{n_fl} FL devices do not split over {data} data ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh(device_type, torch.arange(world).reshape(data, model),
                    mesh_dim_names=("data", "model"))
    return RankMesh(("data", "model"), (data, model), dm, n_fl, resolve_device(device), timed)


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh axes that carry (FL-device ×) batch parallelism."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def batch_ways(mesh) -> int:
    """The FL device count: a rank mesh's ``n_fl``, else the product of the
    batch axes."""
    if isinstance(mesh, RankMesh):
        return mesh.n_fl
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n
