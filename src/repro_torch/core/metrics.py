"""Per-round metrics, the Thm. 1 bound and the diagnostics taps (port of
``repro.core.metrics``).

``RoundMetrics`` has the reference's fields in its order. ``loss`` is always
zero (the caller's eval fills the records), ``health`` is the non-finite
quarantine's :class:`RoundHealth` under ``POFLConfig.on_nonfinite="skip"``
and ``None`` otherwise, and ``diag`` is the :class:`RoundDiagnostics` taps
when the round is asked for them (``ObsConfig(diagnostics=True)``) and
``None`` otherwise.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.numerics import EPS, safe_div


class RoundMetrics(NamedTuple):
    """Per-round diagnostics matching the Thm. 1 decomposition."""

    loss: torch.Tensor         # global train loss f(w^t): zeros, filled by the caller
    e_com: torch.Tensor        # Eq. 15 closed-form communication distortion
    e_var: torch.Tensor        # realized global update variance
    grad_norm: torch.Tensor    # ||ŷ^t||
    n_scheduled: torch.Tensor  # realized |S^t|
    a_scalar: torch.Tensor     # denoise scalar a^t (Lemma 1)
    diag: Any = None           # RoundDiagnostics when ObsConfig asks, else None
    health: Any = None         # RoundHealth when POFLConfig.on_nonfinite="skip"


class RoundHealth(NamedTuple):
    """The non-finite quarantine's record (``on_nonfinite="skip"``): 1.0 in a
    round whose aggregate ŷ^t held a non-finite entry, whose update was
    therefore not applied, else 0.0."""

    nonfinite: torch.Tensor


def zero_round_health(device=None) -> RoundHealth:
    """The all-zero health record of one round."""
    return RoundHealth(nonfinite=torch.zeros((), dtype=torch.float32, device=device))


def bound_objective(e_com: torch.Tensor, e_var: torch.Tensor, alpha: float) -> torch.Tensor:
    """The (P1) objective: (1+α)·e_com + (1+1/α)·e_var."""
    return (1.0 + alpha) * e_com + (1.0 + 1.0 / alpha) * e_var


class RoundDiagnostics(NamedTuple):
    """Cheap per-round scalar taps computed beside the round on the device.

    Carried as the records' ``diag`` subtree when
    ``ObsConfig(diagnostics=True)``: a handful of reductions over (N,)
    vectors a round, next to the (N, D) gradient work. ``None`` (the
    default) adds no op and no record field.
    """

    noise_eff: torch.Tensor        # V_g σ_z² / a² — per-entry noise power the
    #                                model update absorbs after the Eq. 8
    #                                denoise/denormalize reweighting
    sched_entropy: torch.Tensor    # -Σ p log p of the scheduling distribution
    eps_clamps: torch.Tensor       # how many EPS guard sites sat at the floor
    grad_norm_spread: torch.Tensor  # std_i ||g_i|| — device gradient dispersion


def diagnostics_taps(
    probs: torch.Tensor,
    grad_norms: torch.Tensor,
    v_g: torch.Tensor,
    a_scalar: torch.Tensor,
    h_abs: torch.Tensor,
    tx_power: float,
    noise_power,
) -> RoundDiagnostics:
    """The :class:`RoundDiagnostics` taps from round intermediates.

    ``noise_eff`` inverts the aggregation reweighting: the receiver noise
    ``z`` enters the model update as ``sqrt(V_g)·z/a`` (Eq. 8), so its
    effective per-entry power is ``V_g σ_z² / a²`` — the distortion Eq. 15
    divided by D, realized rather than worst-case. ``eps_clamps`` counts
    guard sites at the :data:`~repro_torch.core.numerics.EPS` floor this
    round (deep-fade channels, underflowed probabilities, degenerate V_g).
    ``grad_norm_spread`` is the population std (``jnp.std``'s).
    """
    a_sq = torch.clamp_min(a_scalar * a_scalar, EPS)
    noise_eff = safe_div(torch.clamp_min(v_g, EPS) * noise_power, a_sq)
    p = probs / torch.clamp_min(probs.sum(), EPS)
    sched_entropy = -torch.where(p > 0.0, p * torch.log(torch.clamp_min(p, EPS)), 0.0).sum()
    eps_clamps = (
        (tx_power * h_abs * h_abs <= EPS).float().sum()
        + (probs <= EPS).float().sum()
        + (v_g <= EPS).float()
    )
    return RoundDiagnostics(
        noise_eff=noise_eff,
        sched_entropy=sched_entropy,
        eps_clamps=eps_clamps,
        grad_norm_spread=torch.std(grad_norms, correction=0),
    )
