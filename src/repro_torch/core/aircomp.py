"""AirComp signal chain (port of ``repro.core.aircomp``, paper Sec. II-B).

  * gradient normalization into unit-variance symbols          (Eq. 5)
  * optimal transceiver design under per-device power budget   (Lemma 1)
  * the noisy superposed aggregation                           (Eq. 16)
  * the closed-form communication distortion                   (Eq. 15)

All functions take *stacked* per-device gradients ``g`` of shape
``(n_devices, D)`` plus per-device scalars; ``mask`` selects the scheduled
set S^t. The receiver noise comes in as a standard-normal draw ``z`` (D,).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.numerics import eps_guard, safe_div


class GradStats(NamedTuple):
    """Per-device first/second moments of the local gradient (Sec. II-B)."""

    mean: torch.Tensor  # M_i^t, (n_devices,)
    var: torch.Tensor   # V_i^t, (n_devices,)
    norm: torch.Tensor  # ||g_i^t||_2, (n_devices,)  (uploaded for scheduling)


def local_stats(g: torch.Tensor) -> GradStats:
    """The scalars each device uploads over the control channel."""
    mean = g.mean(dim=-1)
    var = ((g - mean[:, None]) ** 2).mean(dim=-1)
    # a sum of squares, as the reference's norm computes it: on the CPU
    # torch.linalg.vector_norm over the CNN's D = 258,634 sits 1.2e-5 from
    # float64, the sum 5.6e-8 (the reference's own distance)
    norm = torch.sqrt((g * g).sum(dim=-1))
    return GradStats(mean=mean, var=var, norm=norm)


def global_stats(stats: GradStats, rho: torch.Tensor, mask: torch.Tensor):
    """Server-side global normalization stats M_g, V_g = Σ_{i∈S} ρ_i {M_i, V_i}."""
    w = rho * mask
    return (w * stats.mean).sum(), (w * stats.var).sum()


def normalize(g: torch.Tensor, m_g: torch.Tensor, v_g: torch.Tensor) -> torch.Tensor:
    """Eq. 5: s_i = (g_i - M_g 1) / sqrt(V_g)."""
    return (g - m_g) / torch.sqrt(eps_guard(v_g))


def denoise_scalar(
    rho: torch.Tensor, h_abs: torch.Tensor, mask: torch.Tensor, tx_power: float
) -> torch.Tensor:
    """Lemma 1, Eq. 13: a = min_{i∈S} sqrt(P) |h_i| / ρ_i (over the scheduled set)."""
    ratio = safe_div(math.sqrt(tx_power) * h_abs, rho)
    return torch.where(mask > 0, ratio, math.inf).min()


def transmit_scalars(rho: torch.Tensor, h: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Lemma 1, Eq. 12: b_i = ρ_i a / h_i (channel-inversion pre-equalization)."""
    return rho.to(h.dtype) * a.to(h.dtype) / h


def power_check(
    rho: torch.Tensor, h: torch.Tensor, a: torch.Tensor, tx_power: float
) -> torch.Tensor:
    """|b_i|² ≤ P for all devices (Eq. 6) — holds by construction of Lemma 1."""
    return transmit_scalars(rho, h, a).abs() ** 2 <= tx_power * (1.0 + 1e-5)


def distortion_closed_form(
    v_g: torch.Tensor,
    rho: torch.Tensor,
    h_abs: torch.Tensor,
    mask: torch.Tensor,
    dim: int,
    tx_power: float,
    noise_power: float,
) -> torch.Tensor:
    """Eq. 15: e_com = D σ_z² V_g / P · max_{i∈S} ρ_i² / |h_i|²."""
    ratio = torch.where(mask > 0, safe_div(rho, h_abs) ** 2, 0.0)
    return dim * noise_power * v_g / tx_power * ratio.max()


def noise_std(noise_power):
    """σ_z from σ_z²: a Python number stays one, a tensor (the lattice's
    per-cell σ_z²) stays a tensor on its device, so no value leaves it."""
    if isinstance(noise_power, torch.Tensor):
        return torch.sqrt(noise_power)
    return math.sqrt(noise_power)


def combine_given_stats(
    g: torch.Tensor,
    rho: torch.Tensor,
    h: torch.Tensor,
    mask: torch.Tensor,
    z: torch.Tensor,
    m_g: torch.Tensor,
    v_g: torch.Tensor,
    a: torch.Tensor,
    simulate_physical: bool = True,
) -> torch.Tensor:
    """The D-elementwise tail of the Eq. 5→16 chain, given the global stats
    (M_g, V_g), the denoise scalar ``a`` and the scaled noise ``z``."""
    if simulate_physical:
        s = normalize(g, m_g, v_g)  # (n_devices, D) symbols
        b = transmit_scalars(rho, h, a)  # (n_devices,) complex
        # an empty scheduled set gives a=inf and rho=0, so b = 0·inf = NaN;
        # zero unscheduled transmitters *before* the mask multiply
        b = torch.where(mask > 0, b, torch.zeros((), dtype=b.dtype, device=b.device))
        tx = (mask.to(h.dtype) * b * h)[:, None] * s.to(h.dtype)
        y_tilde = torch.real(tx.sum(dim=0)) + z  # superposition (Eq. 7)
        return torch.sqrt(eps_guard(v_g)) * y_tilde / a + m_g  # Eq. 8
    noise = torch.sqrt(eps_guard(v_g)) / a * z
    return ((mask * rho)[:, None] * g).sum(dim=0) + noise  # Eq. 16


def aircomp_aggregate(
    g: torch.Tensor,
    rho: torch.Tensor,
    h: torch.Tensor,
    mask: torch.Tensor,
    z: torch.Tensor,
    tx_power: float,
    noise_power: float,
    simulate_physical: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full Eq. 5→16 signal chain. Returns (ŷ, e_com).

    Args:
      g:    (n_devices, D) stacked local gradients.
      rho:  (n_devices,) aggregation weights ρ_i (already include 1/p_i in PO-FL).
      h:    (n_devices,) complex channel coefficients.
      mask: (n_devices,) 0/1 scheduled indicator.
      z:    (D,) standard-normal receiver noise draw (scaled by σ_z here).
      simulate_physical: walk the full physical path (normalize → transmit
        scale → superpose → denoise → denormalize) if True, else the
        Lemma-1-simplified Eq. 16 (identical in law).
    """
    stats = local_stats(g)
    m_g, v_g = global_stats(stats, rho, mask)
    h_abs = h.abs()
    a = denoise_scalar(rho, h_abs, mask, tx_power)
    dim = g.shape[-1]
    # the post-detection noise is a real Gaussian with variance σ_z² per
    # entry, which is what the Eq. 15 closed form assumes
    z = z * noise_std(noise_power)
    y_hat = combine_given_stats(
        g, rho, h, mask, z, m_g, v_g, a, simulate_physical=simulate_physical
    )
    e_com = distortion_closed_form(v_g, rho, h_abs, mask, dim, tx_power, noise_power)
    return y_hat, e_com
