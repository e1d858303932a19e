"""Plain PyTorch version of the fused AirComp aggregation (the kernel's oracle).

Port of ``repro.kernels.aircomp.ref.aircomp_fused_ref``: the Eq. 5→8
physical chain collapsed into one expression,

    s_i[d]  = (g_i[d] − M_g) / sqrt(V_g)                       (Eq. 5)
    y~[d]   = Σ_i coeff_i · a · s_i[d] + z[d]                  (Eq. 7, b_i h_i = ρ_i a)
    ŷ[d]    = sqrt(V_g)/a · y~[d] + M_g                        (Eq. 8)
            = Σ_i coeff_i·g_i[d] − W·M_g + (sqrt(V_g)/a)·z[d] + M_g,   W = Σ_i coeff_i
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import eps_guard


def aircomp_fused_ref(g, coeff, m_g, v_g, a, z) -> torch.Tensor:
    """Args:
      g:     (n_devices, D) stacked local gradients
      coeff: (n_devices,)   mask_i · ρ_i
      m_g, v_g, a: scalars  (global mean/variance, denoise scalar)
      z:     (D,)           receiver noise ~ N(0, σ_z²)
    Returns ŷ: (D,)

    ``a`` is cancelled algebraically in the signal term, as the kernel does,
    so an empty schedule (a=inf from the min over nothing, coeff all zero)
    stays finite: the naive a·s → (…)/a composition would give 0·inf = NaN.
    """
    sqrt_vg = torch.sqrt(eps_guard(torch.as_tensor(v_g, dtype=torch.float32)))
    acc = (coeff[:, None] * g).sum(dim=0)  # Eq. 7 signal, a cancelled
    w = coeff.sum()
    return acc - w * m_g + sqrt_vg / a * z + m_g  # Eq. 8


def aircomp_fused_batch_ref(g, coeff, m_g, v_g, a, z) -> torch.Tensor:
    """Trial-batched plain version: a leading (B,) trial axis on every
    argument (g (B, N, D), coeff (B, N), m_g/v_g/a (B,), z (B, D)) → (B, D).

    Each trial is :func:`aircomp_fused_ref` with its own scalars, ``a``
    cancelled the same way, so a trial with an empty schedule stays finite.
    """
    sqrt_vg = torch.sqrt(eps_guard(torch.as_tensor(v_g, dtype=torch.float32)))
    acc = (coeff[:, :, None] * g).sum(dim=1)  # Eq. 7 signal, a cancelled
    w = coeff.sum(dim=1)
    return (acc - (w * m_g)[:, None] + (sqrt_vg / a)[:, None] * z
            + m_g[:, None])  # Eq. 8
