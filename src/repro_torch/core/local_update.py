"""Local updates (port of ``repro.core.local_update``).

This slice ports the reference's default path: ``fedavg`` (and ``fedprox``,
whose proximal term is zero on the only step) at ``local_steps=1``, where
each device uploads one mini-batch gradient. Multi-step FedAvg/FedProx,
FedDyn and SCAFFOLD raise ``NotImplementedError`` until ROADMAP queue A
item 5 ports them.

The mini-batch rows come in as an index tensor (:func:`minibatch_indices`
draws it from a ``torch.Generator`` in normal use), so the same draw can be
fed to the reference. :func:`local_update_stage_cells` is the same step for
every cell of a lattice round at once: params with a leading cell axis, one
row draw per cell, and an outer ``vmap`` over cells around the per-device
``vmap(grad)``.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.func import grad, vmap

from repro_torch.flatten_util import ravel_batched

# The reference's append-only id table: an algorithm's id is its index here.
ALGORITHMS = ("fedavg", "fedprox", "feddyn", "scaffold")

# algorithms whose single local step is exactly one plain gradient
STATELESS = ("fedavg", "fedprox")


def minibatch_indices(data, batch_size: int, generator: torch.Generator) -> torch.Tensor:
    """Per-device mini-batch rows (N, B) int64, drawn on the generator's device.

    Equal shards draw uniformly over all rows; padded heterogeneous shards
    (``data.n_samples``) over each device's valid prefix only. The engine
    checks once, at construction, that every device has a row.
    """
    n, m = data.n_devices, data.samples_per_device
    dev = generator.device
    if data.n_samples is None:
        return torch.randint(0, m, (n, batch_size), generator=generator, device=dev)
    ns = data.n_samples.to(device=dev)
    u = torch.rand(n, batch_size, generator=generator, device=dev)
    return torch.minimum((u * ns[:, None]).long(), ns[:, None].long() - 1)


def draw_minibatch(data, batch_idx: torch.Tensor):
    """Gather each device's mini-batch rows → (feats, labels), each leading
    (N, B); a (C, N, B) row draw (one per cell) gives (C, N, B) leads."""
    rows = torch.arange(data.n_devices, device=batch_idx.device)[:, None]
    return data.features[rows, batch_idx], data.labels[rows, batch_idx]


def _device_gradients(loss_fn: Callable, params, feats, labels) -> torch.Tensor:
    """vmap(grad) over the device axis → stacked flat gradients (N, D)."""
    grads = vmap(grad(loss_fn), in_dims=(None, 0, 0))(params, feats, labels)
    return ravel_batched(grads)


def local_gradient_stage(loss_fn: Callable, data, cfg, params, batch_idx) -> torch.Tensor:
    """Step 2 of Algorithm 1: one mini-batch gradient per device → (N, D)."""
    feats, labels = draw_minibatch(data, batch_idx)
    return _device_gradients(loss_fn, params, feats, labels)


def check_local_update(cfg) -> None:
    """Raise unless ``cfg`` names the ported local update (one plain step)."""
    name = cfg.local_algorithm
    if name not in ALGORITHMS:
        raise ValueError(f"unknown local_algorithm {name!r}; choose from {ALGORITHMS}")
    if cfg.local_steps < 1:
        raise ValueError(f"local_steps must be >= 1, got {cfg.local_steps}")
    if cfg.local_steps != 1 or name not in STATELESS:
        raise NotImplementedError(
            f"local_algorithm={name!r} at local_steps={cfg.local_steps} is not "
            "ported yet (ROADMAP queue A item 5: multi-step local updates, "
            "FedDyn and SCAFFOLD)"
        )


def local_update_stage(loss_fn: Callable, data, cfg, params, batch_idx, t) -> torch.Tensor:
    """Steps 2–2b: the per-device upload Δ_i (N, D).

    At ``local_steps=1`` under a stateless algorithm Δ_i is the plain
    mini-batch gradient; ``t`` (the round) only matters for multi-step
    local learning rates, which are not ported yet.
    """
    del t
    check_local_update(cfg)
    return local_gradient_stage(loss_fn, data, cfg, params, batch_idx)


def local_update_stage_cells(
    loss_fn: Callable, data, cfg, params_c, batch_idx_c, t
) -> torch.Tensor:
    """:func:`local_update_stage` for C cells at once → (C, N, D).

    ``params_c`` has a leading cell axis on every leaf and ``batch_idx_c``
    is (C, N, B): each cell's rows come from its own seed's draw. Each cell
    computes exactly :func:`_device_gradients` (an outer ``vmap`` over cells).
    """
    del t
    check_local_update(cfg)
    feats, labels = draw_minibatch(data, batch_idx_c)
    return vmap(functools.partial(_device_gradients, loss_fn))(params_c, feats, labels)
