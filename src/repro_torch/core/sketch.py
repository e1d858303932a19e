"""JVP-sketched per-device gradient statistics (port of ``repro.core.sketch``).

Algorithm 1 needs every FL device's gradient scalars (M_i, V_i, ‖g_i‖)
before it schedules. Each is a function of inner products g_i · v, the
directional derivatives of the per-device loss vector, which one
forward-mode pass (``torch.func.jvp``) gives for every device at once::

    jvp(L, params, v)[1][i] = g_i · v        L(params) = (L_1, ..., L_N)

  * M_i    = (g_i · 1) / D                   exact, one JVP along all ones
  * ‖g_i‖² = E_{v~N(0,I)}[(g_i · v)²]        Hutchinson, k probes
  * V_i    = ‖g_i‖²/D − M_i²                 derived, clamped at 0

D is the leaves' true size. The probes are an argument, a list of
param-shaped dicts: normal use draws them from a ``torch.Generator``
(:func:`draw_probes`), a parity test hands in the reference's draws.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.aircomp import GradStats
from repro_torch.flatten_util import tree_leaves, tree_map, tree_unflatten


def draw_probes(params, n_probes: int, generator: torch.Generator) -> list:
    """``n_probes`` standard-normal param-shaped dicts, each drawn leaf by
    leaf in sorted-key order on the generator's device."""
    return [tree_unflatten(params, [torch.randn(leaf.shape, generator=generator,
                                                dtype=leaf.dtype, device=generator.device)
                                    for leaf in tree_leaves(params)])
            for _ in range(n_probes)]


def sketch_device_stats(per_device_loss: Callable, params, probes: list,
                        dim: int | None = None) -> GradStats:
    """Estimate (M_i, V_i, ‖g_i‖) for every FL device.

    Args:
      per_device_loss: params -> (n_devices,) loss vector (one scalar per
        FL device, each the mean loss over that device's examples).
      params: the model's parameters, a dict of tensors.
      probes: the Hutchinson probes, a list of param-shaped dicts.
      dim: D, the whole model's parameter count, where ``params`` are a
        model rank's blocks of it (default: their count).
    """
    if dim is None:
        dim = sum(leaf.numel() for leaf in tree_leaves(params))

    # the exact per-device gradient mean: one JVP along all ones
    ones = tree_map(torch.ones_like, params)
    _, dots_ones = torch.func.jvp(per_device_loss, (params,), (ones,))
    mean = dots_ones / dim

    sq = torch.stack([torch.func.jvp(per_device_loss, (params,), (v,))[1] ** 2
                      for v in probes])
    norm_sq = sq.mean(dim=0)
    var = torch.clamp_min(norm_sq / dim - mean**2, 0.0)
    return GradStats(mean=mean, var=var, norm=torch.sqrt(norm_sq))


def exact_device_stats(
    per_device_grad: Callable,
    params,
    n_devices: int,
) -> tuple[GradStats, object]:
    """The faithful path: one backward a device, each device's gradient
    reduced to its scalars at once (the stacked gradients are never held).

    Args:
      per_device_grad: (params, i) -> grads dict of FL device i.
    Returns (stats, None), as the reference does.
    """
    means, variances, norms = [], [], []
    for i in range(n_devices):
        leaves = tree_leaves(per_device_grad(params, i))
        total = sum(leaf.numel() for leaf in leaves)
        s = sum(leaf.float().sum() for leaf in leaves)
        sq = sum((leaf.float() ** 2).sum() for leaf in leaves)
        mean = s / total
        means.append(mean)
        variances.append(torch.clamp_min(sq / total - mean**2, 0.0))
        norms.append(torch.sqrt(sq))
    return GradStats(mean=torch.stack(means), var=torch.stack(variances),
                     norm=torch.stack(norms)), None
