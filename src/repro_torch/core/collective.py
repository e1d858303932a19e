"""The AirComp superposition as a collective (port of ``repro.core.collective``).

Over-the-air computation exploits the MAC's superposition: every device
transmits at once and the receiver observes the *sum*. Over ranks the same
pattern is a weighted all-reduce over the FL-device ranks plus the
receiver's Gaussian noise, a *noisy all-reduce*:

    ŷ = Σ_i c_i · g_i + ν·z,   c_i = mask_i · ρ_i,  ν = sqrt(V_g)/a

One rank holds one device's gradient (``torch.distributed``, one rank a
device). Under ground rule 1 of the port the receiver noise is injected:
``z`` is a standard-normal draw that every rank passes alike, where the
reference draws it from a key every slice shares.

  * :func:`aircomp_allreduce` — the building block each rank calls with its
    own gradient.
  * :func:`make_sharded_aggregator` — stacked per-device gradients (N, D)
    over a mesh axis of N ranks, the twin of ``core.aircomp``'s Eq. 16
    path.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def aircomp_allreduce(local_grads, coeff, noise_amp, z, group=None):
    """Noisy weighted all-reduce of a tree of tensors over ``group``.

    Args:
      local_grads: tree (a tensor, or a dict of them) of this rank's gradient.
      coeff:       scalar c_i of this rank (0 if unscheduled).
      noise_amp:   scalar ν = sqrt(V_g)/a, the receiver-noise amplitude.
      z:           standard-normal noise of ``local_grads``' structure, the
                   SAME on every rank (the server's noise is common).
      group:       the process group of the FL-device ranks (``None``: the
                   default group).

    Returns the tree of ``Σ_ranks coeff · leaf + noise_amp · z``, the same
    on every rank; one ``all_reduce`` a leaf.
    """
    coeff = torch.as_tensor(coeff)
    noise_amp = torch.as_tensor(noise_amp)

    def reduce(leaf, noise):
        if isinstance(leaf, dict):
            return {k: reduce(v, noise[k]) for k, v in leaf.items()}
        summed = leaf * coeff.to(leaf.device, leaf.dtype)
        dist.all_reduce(summed, group=group)
        return summed + noise_amp.to(leaf.device, leaf.dtype) * noise

    return reduce(local_grads, z)


def make_sharded_aggregator(mesh, axis_name: str = "data"):
    """Aggregator for stacked per-device gradients ``(N, D)`` over the mesh
    axis ``axis_name`` (a ``DeviceMesh`` axis of N ranks).

    Every rank passes the same (N, D) ``g`` and (N,) ``coeffs``, as every
    host of the reference holds the global array; rank i of the axis
    contributes row i. Returns ``fn(g, coeffs, noise_amp, z) -> (D,)``, the
    same on every rank, with ``z`` the (D,) standard-normal noise every rank
    passes alike: the distributed twin of ``aircomp.aircomp_aggregate``'s
    Eq. 16 path.
    """
    names = mesh.mesh_dim_names
    n = int(mesh.size(names.index(axis_name)))
    group = mesh.get_group(axis_name)
    me = mesh.get_local_rank(axis_name)

    def agg(g, coeffs, noise_amp, z):
        if g.shape[0] != n or coeffs.shape != (n,):
            raise ValueError(f"the {axis_name!r} axis has {n} ranks: g must be ({n}, D) and "
                             f"coeffs ({n},), got {tuple(g.shape)} and {tuple(coeffs.shape)}")
        return aircomp_allreduce(g[me], coeffs[me], noise_amp, z, group)

    return agg
