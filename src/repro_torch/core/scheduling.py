"""Device scheduling policies (port of ``repro.core.scheduling``, Sec. IV).

Policies give *single-draw* probabilities p_i^t (Σp=1); the schedule is drawn
without replacement with the Eq. 36 renormalization, and the aggregation
weights follow Eq. 37. The draws come in as tensors — Gumbel vectors for the
sequential and top-k samplers, uniforms for the Bernoulli variant — so the
same values can be fed to the reference; :func:`gumbel` makes them from a
``torch.Generator`` in normal use.

Policies: ``pofl`` (Eq. 34/35), ``importance``, ``channel``, ``noisefree``
(Eq. 34/35 with σ_z² = 0) and ``deterministic`` (uniform subset, direct
biased aggregation). The lattice carries the policy as data, an id of
``POLICY_IDS`` per cell (:func:`scheduling_probs_by_id`).

Every function here is written for one cell and stays correct under
``torch.func.vmap`` over cells: no in-place write of a batched value into a
fresh tensor, and no value read back to the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.numerics import EPS, eps_guard, safe_div

# The reference's append-only id table: a policy's id is its index here.
POLICIES = ("pofl", "importance", "channel", "noisefree", "deterministic")
POLICY_IDS = {name: i for i, name in enumerate(POLICIES)}
NOISEFREE_ID = POLICY_IDS["noisefree"]
DETERMINISTIC_ID = POLICY_IDS["deterministic"]


def policy_id(policy: str) -> int:
    """The integer id of ``policy`` (its index in ``POLICIES``)."""
    try:
        return POLICY_IDS[policy]
    except KeyError:
        raise ValueError(f"unknown policy {policy!r}; choose from {POLICIES}") from None


def gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(-log(U))`` with U uniform in (0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def pofl_q(
    grad_norms: torch.Tensor,
    grad_vars: torch.Tensor,
    h_abs: torch.Tensor,
    data_frac: torch.Tensor,
    dim: int,
    alpha: float,
    tx_power: float,
    noise_power: float,
) -> torch.Tensor:
    """Eq. 35:  Q_i = sqrt((1+α)·Ṽ_g D σ_z² m_i²/(P|h_i|²M²) + (1+1/α)·m_i²||g_i||²/M²)."""
    v_g_tilde = (data_frac * grad_vars).sum()
    # guard the denominator, not |h|: eps_guard(h)**2 underflows to 0 in
    # float32 for |h| ≲ 1e-19
    com_term = safe_div(
        (1.0 + alpha) * v_g_tilde * dim * noise_power * data_frac**2,
        tx_power * h_abs**2,
    )
    var_term = (1.0 + 1.0 / alpha) * data_frac**2 * grad_norms**2
    return torch.sqrt(com_term + var_term)


def scheduling_probs(
    policy: str,
    grad_norms: torch.Tensor,
    grad_vars: torch.Tensor,
    h_abs: torch.Tensor,
    data_frac: torch.Tensor,
    dim: int,
    alpha: float,
    tx_power: float,
    noise_power: float,
) -> torch.Tensor:
    """Single-draw probabilities p_i (Eq. 34 for pofl; Remark 2 for baselines)."""
    if policy == "pofl":
        q = pofl_q(grad_norms, grad_vars, h_abs, data_frac, dim, alpha, tx_power, noise_power)
    elif policy == "noisefree":
        q = pofl_q(grad_norms, grad_vars, h_abs, data_frac, dim, alpha, tx_power, 0.0)
    elif policy == "importance":
        q = data_frac * grad_norms
    elif policy == "channel":
        q = h_abs**2
    elif policy == "deterministic":
        q = torch.ones_like(h_abs)
    else:
        raise ValueError(f"unknown policy {policy!r}; choose from {POLICIES}")
    q = eps_guard(q)
    return q / q.sum()


def scheduling_probs_by_id(
    policy_id: torch.Tensor,
    grad_norms: torch.Tensor,
    grad_vars: torch.Tensor,
    h_abs: torch.Tensor,
    data_frac: torch.Tensor,
    dim: int,
    alpha,
    tx_power: float,
    noise_power,
) -> torch.Tensor:
    """:func:`scheduling_probs` with the policy as data: an integer tensor
    of ``POLICY_IDS``.

    Every policy's score is computed, each exactly as the string version
    computes it, and the id selects one by value (``torch.where``), so the
    card never waits on the host to learn the policy. ``alpha`` and
    ``noise_power`` may be tensors (per cell, under a ``vmap`` over cells).
    The eps-guard and the normalization are the string version's.
    """
    scores = {
        "pofl": pofl_q(grad_norms, grad_vars, h_abs, data_frac, dim, alpha, tx_power,
                       noise_power),
        "importance": data_frac * grad_norms,
        "channel": h_abs**2,
        "noisefree": pofl_q(grad_norms, grad_vars, h_abs, data_frac, dim, alpha,
                            tx_power, 0.0),
        "deterministic": torch.ones_like(h_abs),
    }
    q = scores[POLICIES[-1]]
    for name in POLICIES[:-1]:
        q = torch.where(policy_id == POLICY_IDS[name], scores[name], q)
    q = eps_guard(q)
    return q / q.sum()


class Schedule(NamedTuple):
    """One round's draw: indices Y_{t,k}, their step-k renormalized probs q_k,
    and the 0/1 device mask.

    When fewer than ``n_scheduled`` devices are selectable (some probs are
    exactly 0), the realized |S^t| is clamped to the selectable count:
    surplus draws carry the sentinel ``indices=-1`` with ``step_probs=inf``
    (→ zero Eq. 37 weight) and leave the mask untouched.
    """

    indices: torch.Tensor     # (S,) int32 — Y_{t,1..S}; -1 = no draw
    step_probs: torch.Tensor  # (S,) — q^t_{Y_{t,k}} at the k-th selection (Eq. 36)
    mask: torch.Tensor        # (N,) float — 1{i ∈ S^t}


def sample_without_replacement(
    gumbels: torch.Tensor, probs: torch.Tensor, n_scheduled: int,
    method: str = "sequential",
) -> Schedule:
    """Sampling without replacement with Eq. 36 renormalization.

    ``method="sequential"`` takes ``gumbels`` of shape (S, N): step k draws
    ``argmax(logits + gumbels[k])`` over the still-selectable devices, which
    is the reference's ``jax.random.categorical`` draw given the same Gumbel
    vector. ``method="topk"`` takes one (N,) vector and keeps the top S of
    ``log p_i + gumbels_i`` (the Gumbel top-k trick: the same law, one draw).
    Devices with zero probability are never drafted; once the selectable
    mass is exhausted the remaining draws are the ``Schedule`` sentinel.
    """
    n = probs.shape[0]
    dev = probs.device
    log_p = torch.log(eps_guard(probs))

    if method == "topk":
        selectable = probs > 0
        perturbed = torch.where(selectable, log_p, -math.inf) + gumbels
        order = torch.topk(perturbed, min(n_scheduled, n)).indices
        if n_scheduled > n:
            order = torch.cat([order, order.new_zeros(n_scheduled - n)])
        real = torch.arange(n_scheduled, device=dev) < selectable.sum()
        indices = torch.where(real, order, -1).to(torch.int32)
        safe = indices.clamp_min(0).long()
        p_sel = torch.where(real, probs[safe], 0.0)
        cum_prev = torch.cat([p_sel.new_zeros(1), torch.cumsum(p_sel, 0)[:-1]])
        step_probs = torch.where(real, safe_div(p_sel, 1.0 - cum_prev), math.inf)
        mask = probs.new_zeros(n).index_add(0, safe, real.to(probs.dtype))
        return Schedule(indices=indices, step_probs=step_probs, mask=mask)
    if method != "sequential":
        raise ValueError(f"unknown sampling method {method!r}")

    mask = probs.new_zeros(n)
    cum_p = probs.new_zeros(1)
    indices, step_probs = [], []
    for k in range(n_scheduled):
        selectable = ((1.0 - mask) > 0) & (probs > 0)
        live = torch.where(selectable, probs, 0.0)
        any_live = live.sum() > 0
        q = safe_div(live, 1.0 - cum_p)
        # (1,)-shaped, so picking by it is a gather on the device: indexing
        # with a 0-d tensor would read the index back to the host
        drawn = torch.argmax(
            torch.where(selectable, log_p, -math.inf) + gumbels[k]
        ).view(1)
        indices.append(torch.where(any_live, drawn, -1))
        step_probs.append(torch.where(any_live, q.gather(0, drawn), math.inf))
        mask = torch.where(any_live, mask.index_fill(0, drawn, 1.0), mask)
        cum_p = cum_p + torch.where(any_live, probs.gather(0, drawn), 0.0)
    return Schedule(
        indices=torch.cat(indices).to(torch.int32),
        step_probs=torch.cat(step_probs),
        mask=mask,
    )


def aggregation_weights(
    schedule: Schedule, probs: torch.Tensor, data_frac: torch.Tensor, n_scheduled: int
) -> torch.Tensor:
    """Per-device aggregation weights ρ_i scattered to an (N,) vector.

    Eq. 37: ŷ uses (1/|S|)·m_i/(M·q_{Y_k}) for the k-th selected device, with
    |S| the realized draw count (sentinel draws carry zero weight).
    """
    del probs, n_scheduled
    n = data_frac.shape[0]
    idx = schedule.indices.long().remainder(n)  # the sentinel -1 lands on N-1
    w_k = safe_div(data_frac[idx], schedule.step_probs)
    real = schedule.indices >= 0
    w_k = torch.where(real, w_k, 0.0)
    n_drawn = real.to(w_k.dtype).sum()
    w_k = w_k / torch.clamp_min(n_drawn, 1.0)
    return data_frac.new_zeros(n).index_add(0, idx, w_k)


def bernoulli_inclusion_probs(probs: torch.Tensor, n_scheduled: int) -> torch.Tensor:
    """Inclusion probabilities π_i = min(1, c·p_i) with Σπ = S (c by bisection)."""
    n = probs.shape[0]
    # bracket on the smallest POSITIVE prob: zero entries stay at π=0
    min_pos = torch.where(probs > 0, probs, math.inf).min()
    lo, hi = probs.new_zeros(()), safe_div(n, min_pos)
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        below = torch.clamp_max(mid * probs, 1.0).sum() < n_scheduled
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    c = 0.5 * (lo + hi)
    return torch.clamp(c * probs, EPS, 1.0)


def sample_bernoulli(
    u: torch.Tensor, probs: torch.Tensor, n_scheduled: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """PO-FL-B: device i is scheduled independently when ``u_i < π_i``.

    ``u`` is an (N,) uniform draw. Returns (mask, pi).
    """
    pi = bernoulli_inclusion_probs(probs, n_scheduled)
    return (u < pi).to(torch.float32), pi


def bernoulli_weights(pi: torch.Tensor, data_frac: torch.Tensor) -> torch.Tensor:
    """Horvitz–Thompson weights ρ_i = m_i/(M π_i) (applied with the mask)."""
    return safe_div(data_frac, pi)


def deterministic_weights(schedule: Schedule, data_frac: torch.Tensor) -> torch.Tensor:
    """Baseline direct aggregation: m_i / Σ_{j∈S} m_j on the selected set (biased)."""
    sel = schedule.mask * data_frac
    return safe_div(sel, sel.sum())


def global_update_variance(
    g: torch.Tensor, rho: torch.Tensor, mask: torch.Tensor, data_frac: torch.Tensor,
    n_scheduled: int,
) -> torch.Tensor:
    """e_var (Thm. 1): ||Σ_{i∈S} ρ_i g_i − Σ_j (m_j/M) g_j||² (Eq. 37 weights)."""
    del n_scheduled
    est = ((rho * mask)[:, None] * g).sum(dim=0)
    target = (data_frac[:, None] * g).sum(dim=0)
    return ((est - target) ** 2).sum()
