"""Parameter sharding rule (port of the first part of ``repro.launch.sharding``).

The reference's rule for a parameter leaf (DESIGN.md §5): the LAST dim
divisible by |model| goes over ``"model"`` (tensor parallel), the largest
remaining dim divisible by the batch ways over ``("pod", "data")`` (FSDP);
leaves under ``MIN_SHARD_SIZE`` elements stay whole. A spec is a tuple with
one entry a dim: ``None`` (whole), an axis name, or a tuple of axis names,
as a ``jax.sharding.PartitionSpec`` lists them.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (one rank a
device). The lattice's ``("cells", "model")`` mesh has no batch axes, so
it never shards a dim over them. The LM specs of the reference's module
(``params_pspecs``, ``cache_pspecs``, ``activation_specs``,
``moe_strategy``) come with the LM over ranks (ROADMAP queue A item 14.8).
"""
from __future__ import annotations

import math

from repro_torch.sim.multihost import axis_size

MIN_SHARD_SIZE = 4096  # leaves smaller than this stay whole

_BATCH_AXES = ("pod", "data")


def _fsdp_axes(mesh) -> tuple[str, ...]:
    """The mesh axes that carry (FL-device ×) batch parallelism."""
    return tuple(a for a in mesh.mesh_dim_names if a in _BATCH_AXES)


def param_spec(shape, mesh, skip_leading: int = 0) -> tuple:
    """The spec of a parameter leaf of ``shape`` on ``mesh`` (module
    docstring); ``skip_leading`` dims (a stacked layer axis) stay whole."""
    spec: list = [None] * len(shape)
    dims = list(range(skip_leading, len(shape)))
    if not dims or math.prod(shape[d] for d in dims) < MIN_SHARD_SIZE:
        return tuple(spec)

    msize = int(mesh.size(mesh.mesh_dim_names.index("model")))
    fax = _fsdp_axes(mesh)
    fsize = math.prod(axis_size(mesh, a) for a in fax)

    model_dim = None
    for d in reversed(dims):
        if shape[d] % msize == 0 and shape[d] >= msize:
            spec[d] = "model"
            model_dim = d
            break

    cands = [d for d in dims
             if d != model_dim and shape[d] % fsize == 0 and shape[d] >= fsize]
    if cands and fax:
        d = max(cands, key=lambda i: shape[i])
        spec[d] = fax if len(fax) > 1 else fax[0]
    return tuple(spec)
