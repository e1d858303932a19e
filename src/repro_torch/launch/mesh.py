"""Meshes of the LM trainer on one card (port of ``repro.launch.mesh``).

On one card an FL device is a slice of the batch, not a rank, so the
port's host mesh is a shape with named axes (:class:`HostMesh`) that
carries what the trainer and ``launch.steps`` read from a mesh:
``axis_names``, ``shape[axis]`` and ``devices.size``. ``("pod", "data")``
are the batch axes; their product is the number of FL devices
(:func:`batch_ways`). :func:`make_host_mesh` takes that count where the
reference reads the host's device count (``--xla_force_host_platform_device_count``
in ``examples/train_pofl_lm.py``). The production mesh over ranks waits
with the LM sharding specs (ROADMAP queue A item 14.8).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """Named axes over one device: ``shape[axis]`` ways each."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def devices(self) -> np.ndarray:
        """The mesh's cells, every one the same device (``.size`` is the
        product of the axes)."""
        cells = np.empty(math.prod(self.axis_sizes), dtype=object)
        cells[:] = [self.device] * cells.size
        return cells.reshape(self.axis_sizes)


def activate_mesh(mesh):
    """A context manager that makes ``mesh`` the ambient mesh: on one card
    there is nothing to activate, so it yields the mesh unchanged."""
    return contextlib.nullcontext(mesh)


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "make_production_mesh: the LM sharding over ranks is ROADMAP queue A item 14.8")


def make_host_mesh(model: int = 2, n_devices: int = 1, device=None) -> HostMesh:
    """A (data, model) mesh of ``n_devices`` cells (the reference's host
    device count) on ``device`` (the card unless the caller says
    otherwise): ``model = min(model, n_devices)``, ``data = n_devices //
    model``."""
    model = min(model, n_devices)
    return HostMesh(("data", "model"), (n_devices // model, model), resolve_device(device))


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh axes that carry (FL-device ×) batch parallelism."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def batch_ways(mesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n
