"""Per-round metrics and the Thm. 1 bound (port of ``repro.core.metrics``).

``RoundMetrics`` has the reference's fields in its order. ``loss`` is always
zero (the caller's eval fills the records), ``health`` is the non-finite
quarantine's :class:`RoundHealth` under ``POFLConfig.on_nonfinite="skip"``
and ``None`` otherwise, and ``diag`` (the reference's diagnostics taps,
ROADMAP queue A item 16) is always ``None``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.numerics import safe_div  # noqa: F401  (the reference's re-export)


class RoundMetrics(NamedTuple):
    """Per-round diagnostics matching the Thm. 1 decomposition."""

    loss: torch.Tensor         # global train loss f(w^t): zeros, filled by the caller
    e_com: torch.Tensor        # Eq. 15 closed-form communication distortion
    e_var: torch.Tensor        # realized global update variance
    grad_norm: torch.Tensor    # ||ŷ^t||
    n_scheduled: torch.Tensor  # realized |S^t|
    a_scalar: torch.Tensor     # denoise scalar a^t (Lemma 1)
    diag: Any = None           # the reference's diagnostics taps: not ported, None
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
