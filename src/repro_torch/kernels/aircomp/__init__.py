"""Fused AirComp aggregation: CUDA kernel, plain version, dispatch."""
from repro_torch.kernels.aircomp.kernel import DEFAULT_TILE_D, aircomp_fused, aircomp_fused_batch
from repro_torch.kernels.aircomp.ops import (
    aircomp_aggregate_fused,
    aircomp_aggregate_fused_batch,
)
from repro_torch.kernels.aircomp.ref import aircomp_fused_batch_ref, aircomp_fused_ref

__all__ = [
    "DEFAULT_TILE_D",
    "aircomp_aggregate_fused",
    "aircomp_aggregate_fused_batch",
    "aircomp_fused",
    "aircomp_fused_batch",
    "aircomp_fused_batch_ref",
    "aircomp_fused_ref",
]
