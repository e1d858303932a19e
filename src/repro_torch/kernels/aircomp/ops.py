"""Public op: fused AirComp aggregation, dispatched by the device of ``g``.

A CPU tensor goes to the plain PyTorch version; a CUDA tensor goes to the
hand-written kernel, or the call raises. There is no fallback from the
kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.aircomp.kernel import aircomp_fused, aircomp_fused_batch
from repro_torch.kernels.aircomp.ref import aircomp_fused_batch_ref, aircomp_fused_ref


def aircomp_aggregate_fused(g, coeff, m_g, v_g, a, z) -> torch.Tensor:
    """Fused Eq. 5→8: ŷ = Σ_i coeff_i·(g_i − M_g) + sqrt(V_g)/a·z + M_g."""
    if g.device.type == "cpu":
        return aircomp_fused_ref(g, coeff, m_g, v_g, a, z)
    if g.device.type == "cuda":
        return aircomp_fused(g, coeff, m_g, v_g, a, z)
    raise ValueError(f"aircomp_aggregate_fused: no path for device {g.device}")


def aircomp_aggregate_fused_batch(g, coeff, m_g, v_g, a, z) -> torch.Tensor:
    """Trial-batched fused Eq. 5→8 over (B, N, D) gradients → ŷ (B, D), one
    kernel launch for all B trials on a CUDA tensor."""
    if g.device.type == "cpu":
        return aircomp_fused_batch_ref(g, coeff, m_g, v_g, a, z)
    if g.device.type == "cuda":
        return aircomp_fused_batch(g, coeff, m_g, v_g, a, z)
    raise ValueError(f"aircomp_aggregate_fused_batch: no path for device {g.device}")
