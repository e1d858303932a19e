"""PO-FL — Algorithm 1 (port of ``repro.core.pofl``).

The round is the reference's pipeline of stages

    local_update_stage → scheduling_stage → aggregation_stage → apply_update_stage

composed by :func:`round_algorithm`. Each stage takes its random draws as
tensors — the channel ``h``, the mini-batch rows, the sampler's Gumbel
vectors or uniforms, and the receiver noise ``z`` — which
:class:`repro_torch.sim.engine.SimEngine` makes from a ``torch.Generator``,
with the channel process's availability ``avail`` (dropout, churn), which
masks the scheduling probabilities. The local stage runs ``cfg.local_steps``
SGD steps under ``cfg.local_algorithm`` (``core.local_update``), whose
per-device state (:class:`~repro_torch.core.local_update.AlgState`) the
round takes and returns.
Every stage runs inside a ``torch.profiler.record_function`` range named
``pofl.<stage>``, which is how a profile of the real round is broken down.

:func:`round_algorithm_cells` is the round of every cell of a lattice at
once (ranges ``lattice.<stage>``): each stage runs the per-cell function of
:func:`round_algorithm` under ``torch.func.vmap`` over cells, so a lattice
cell and a ``run_pofl`` run share one code path, except that under
``pallas_fused`` one launch of the trial-batched kernel aggregates all
cells. The policy may be data there, an id of ``scheduling.POLICY_IDS``
per cell (``policy_id``), and so may the local-update algorithm
(``algorithm_id``, ``local_update.ALGORITHM_IDS``).

``diagnostics=True`` adds the reference's per-round taps
(:class:`~repro_torch.core.metrics.RoundDiagnostics`) to the metrics,
computed beside the round from values it already has; off (the default),
the round issues no extra op and ``metrics.diag`` is ``None``.

``cfg.on_nonfinite="skip"`` is the reference's non-finite quarantine: a
round whose aggregate ŷ holds a non-finite entry keeps its params and
AlgState (a value select per cell, never a branch on the host) and is
flagged on ``metrics.health``; the draws advance as usual. ``fault_round``
poisons ŷ with NaN at one round, the reference's fault-injection hook.

``backend`` selects the aggregation:

  * ``jnp``          — the reference arithmetic in plain PyTorch (Eq. 16, or
    the full Eq. 5→8 chain under ``simulate_physical``).
  * ``pallas_fused`` — the fused Eq. 5→8 aggregation, which on a CUDA tensor
    is the hand-written kernel (``kernels/aircomp``) and on a CPU tensor its
    plain version. Semantics are the physical chain, which differs from
    Eq. 16 by ``(1−Σρ)·M_g``.

The names are the reference's, so a ``POFLConfig`` carries over.
"""
from __future__ import annotations

import dataclasses
import enum
import functools
import math
from typing import Any, Callable, NamedTuple

import torch
from torch.func import vmap
from torch.profiler import record_function

from repro_torch.core import aircomp, scheduling
from repro_torch.core.channel import ChannelConfig, ChannelState  # noqa: F401  (re-exported)
from repro_torch.core.local_update import (  # noqa: F401  (re-exported API)
    AlgState, local_gradient_stage, local_update_stage, local_update_stage_cells,
)
from repro_torch.core.metrics import (
    RoundDiagnostics, RoundHealth, RoundMetrics, diagnostics_taps,
)
from repro_torch.core.numerics import safe_div
from repro_torch.flatten_util import ravel_pytree


class AggregationBackend(str, enum.Enum):
    """How the transmit/aggregate stage realizes the Eq. 5→8 signal chain."""

    JNP = "jnp"                    # reference arithmetic (Eq. 16 or full Eq. 5→8)
    PALLAS_FUSED = "pallas_fused"  # fused kernel (physical semantics)


BACKENDS = tuple(b.value for b in AggregationBackend)

# The cfg.policy of a POLICY-FUSED engine (``repro_torch.sim.lattice``):
# each cell carries its policy as an id, so the policy string is
# deliberately not a real policy.
FUSED_POLICY = "__fused__"


@dataclasses.dataclass(frozen=True)
class POFLConfig:
    """Hyper-parameters for the PO-FL simulator (defaults = paper Sec. V-A)."""

    n_devices: int = 30
    n_scheduled: int = 10
    alpha: float = 0.1
    policy: str = "pofl"
    # "without_replacement" (sequential Eq. 36 draws), "topk" (Gumbel top-k,
    # same law), or "bernoulli" (PO-FL-B Horvitz–Thompson variant)
    sampler: str = "without_replacement"
    tx_power: float = 1.0
    noise_power: float = 1e-11
    batch_size: int = 10
    lr0: float = 0.1
    lr_decay: float = 0.95
    lr_min: float = 1e-5
    simulate_physical: bool = False  # full Eq.5→8 path vs Eq.16 (same in law)
    backend: str = "jnp"             # AggregationBackend of the aggregation stage
    local_algorithm: str = "fedavg"  # core.local_update.ALGORITHMS name
    local_steps: int = 1             # K local SGD steps per device per round
    local_lr: float | None = None    # local step size η_l; None → cfg.lr(t)
    fedprox_mu: float = 0.0          # FedProx proximal coefficient μ
    feddyn_alpha: float = 0.1        # FedDyn dynamic-regularizer coefficient
    # "propagate": a non-finite ŷ flows on; "skip": the round is quarantined
    on_nonfinite: str = "propagate"
    seed: int = 0

    def lr(self, t: int) -> float:
        """Paper Sec. V-A: η^t = max(η0 · 0.95^t, 1e-5)."""
        return max(self.lr0 * self.lr_decay**t, self.lr_min)


class DeviceData(NamedTuple):
    """Stacked per-device datasets.

    Equal shards: ``features`` is ``(N, m, ...)`` and ``n_samples`` is None.
    Heterogeneous shards are padded to a common ``m_max`` and
    ``n_samples[i] ≤ m_max`` marks device i's valid prefix; the m_i/M
    fractions follow the true counts. ``labels`` are int64.
    """

    features: torch.Tensor  # (N, m_max, ...)
    labels: torch.Tensor    # (N, m_max)
    n_samples: Any = None   # (N,) int valid-prefix lengths, or None (equal)

    @property
    def n_devices(self) -> int:
        return self.features.shape[0]

    @property
    def samples_per_device(self) -> int:
        """Padded (maximum) shard length m_max."""
        return self.features.shape[1]

    @property
    def data_frac(self) -> torch.Tensor:
        """m_i / M — uniform for equal shards, true fractions otherwise."""
        n = self.n_devices
        if self.n_samples is None:
            return torch.full((n,), 1.0 / n, device=self.features.device)
        ns = self.n_samples.to(device=self.features.device, dtype=torch.float32)
        return ns / ns.sum()

    def to(self, device) -> "DeviceData":
        return DeviceData(*(None if t is None else t.to(device) for t in self))


class History(NamedTuple):
    """Host-side metric record of :func:`run_pofl`."""

    loss: list
    e_com: list
    e_var: list
    test_acc: list
    test_round: list


# --------------------------------------------------------------------------
# the round pipeline stages
# --------------------------------------------------------------------------


def sampler_draw(cfg: POFLConfig, generator: torch.Generator) -> torch.Tensor:
    """The random input :func:`scheduling_stage` takes for ``cfg``: (S, N)
    Gumbel vectors for the sequential sampler, one (N,) Gumbel vector for
    top-k, (N,) uniforms for the Bernoulli variant.

    A policy-fused ``cfg`` (:data:`FUSED_POLICY`: the policy is a per-cell
    id) with the Bernoulli sampler draws both inputs a cell may need, as one
    (S+1, N) tensor: the S Gumbel vectors of the deterministic policy's
    draw, then the uniforms.
    """
    n, dev = cfg.n_devices, generator.device
    if cfg.policy == FUSED_POLICY and cfg.sampler == "bernoulli":
        gumbels = scheduling.gumbel((cfg.n_scheduled, n), generator)
        return torch.cat([gumbels, torch.rand(1, n, generator=generator, device=dev)])
    if cfg.policy != "deterministic" and cfg.sampler == "bernoulli":
        return torch.rand(n, generator=generator, device=dev)
    if cfg.sampler == "topk":
        return scheduling.gumbel((n,), generator)
    return scheduling.gumbel((cfg.n_scheduled, n), generator)


def scheduling_stage(
    cfg: POFLConfig,
    stats: aircomp.GradStats,
    h_abs: torch.Tensor,
    data_frac: torch.Tensor,
    dim: int,
    alpha,
    noise_power,
    sched_draw: torch.Tensor,
    avail: torch.Tensor | None = None,
    policy_id: torch.Tensor | None = None,
    return_probs: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Step 4: p_i^t (Eq. 34/Remark 2) → draw S^t → weights ρ (Eq. 37/HT).

    Returns ``(rho, mask)``, or ``(rho, mask, probs)`` when ``return_probs``
    (the diagnostics taps need the scheduling distribution; the extra output
    changes no arithmetic). ``sched_draw`` is :func:`sampler_draw`'s tensor
    (of a policy-fused ``cfg`` when ``policy_id`` is given). ``avail`` (an
    (N,) 0/1 mask of a process that drops devices) zeroes the unavailable
    devices' probabilities and renormalises before any draw; ``None`` skips
    the masking. With no device available the probabilities are all zero
    and the draw schedules none.

    ``policy_id`` (an integer tensor of ``scheduling.POLICY_IDS``) replaces
    ``cfg.policy``: the probabilities come from
    ``scheduling_probs_by_id`` and the deterministic weight rule is a value
    select over values computed from the same draw, as the string dispatch
    draws them.
    """
    method = "topk" if cfg.sampler == "topk" else "sequential"
    if policy_id is not None:
        probs = scheduling.scheduling_probs_by_id(
            policy_id, stats.norm, stats.var, h_abs, data_frac, dim,
            alpha, cfg.tx_power, noise_power,
        )
    else:
        probs = scheduling.scheduling_probs(
            cfg.policy, stats.norm, stats.var, h_abs, data_frac, dim,
            alpha, cfg.tx_power, noise_power,
        )
    if avail is not None:
        masked = probs * avail
        probs = safe_div(masked, masked.sum())
    rho, mask = _draw(cfg, probs, data_frac, sched_draw, method, policy_id)
    return (rho, mask, probs) if return_probs else (rho, mask)


def _draw(cfg, probs, data_frac, sched_draw, method, policy_id):
    """Steps 4b–c of :func:`scheduling_stage`: draw S^t from ``probs`` and
    weight it → ``(rho, mask)``."""
    if policy_id is not None:
        is_det = policy_id == scheduling.DETERMINISTIC_ID
        bernoulli = cfg.sampler == "bernoulli"
        sched = scheduling.sample_without_replacement(
            sched_draw[:-1] if bernoulli else sched_draw, probs, cfg.n_scheduled,
            method=method,
        )
        rho_det = scheduling.deterministic_weights(sched, data_frac)
        if bernoulli:
            mask_b, pi = scheduling.sample_bernoulli(sched_draw[-1], probs, cfg.n_scheduled)
            rho = torch.where(is_det, rho_det, scheduling.bernoulli_weights(pi, data_frac))
            return rho, torch.where(is_det, sched.mask, mask_b)
        rho_seq = scheduling.aggregation_weights(sched, probs, data_frac, cfg.n_scheduled)
        return torch.where(is_det, rho_det, rho_seq), sched.mask
    if cfg.policy == "deterministic":
        sched = scheduling.sample_without_replacement(
            sched_draw, probs, cfg.n_scheduled, method=method
        )
        return scheduling.deterministic_weights(sched, data_frac), sched.mask
    if cfg.sampler == "bernoulli":
        mask, pi = scheduling.sample_bernoulli(sched_draw, probs, cfg.n_scheduled)
        return scheduling.bernoulli_weights(pi, data_frac), mask
    sched = scheduling.sample_without_replacement(
        sched_draw, probs, cfg.n_scheduled, method=method
    )
    rho = scheduling.aggregation_weights(sched, probs, data_frac, cfg.n_scheduled)
    return rho, sched.mask


def fused_aggregation_inputs(
    cfg: POFLConfig,
    g: torch.Tensor,
    rho: torch.Tensor,
    h: torch.Tensor,
    mask: torch.Tensor,
    z: torch.Tensor,
    noise_power,
):
    """The scalar prelude of the fused aggregation for one cell →
    ``(coeff, m_g, v_g, a, scaled z, e_com)``: everything the kernel takes
    beside ``g``, and the Eq. 15 closed form."""
    stats = aircomp.local_stats(g)
    m_g, v_g = aircomp.global_stats(stats, rho, mask)
    h_abs = h.abs()
    a = aircomp.denoise_scalar(rho, h_abs, mask, cfg.tx_power)
    coeff = mask * rho  # b_i h_i = ρ_i a exactly (Lemma-1 channel inversion)
    e_com = aircomp.distortion_closed_form(
        v_g, rho, h_abs, mask, g.shape[-1], cfg.tx_power, noise_power
    )
    return coeff, m_g, v_g, a, z * aircomp.noise_std(noise_power), e_com


def aggregation_stage(
    cfg: POFLConfig,
    g: torch.Tensor,
    rho: torch.Tensor,
    h: torch.Tensor,
    mask: torch.Tensor,
    z: torch.Tensor,
    noise_power,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Step 5: transmit + AirComp aggregate per ``cfg.backend`` → (ŷ, e_com).

    ``z`` is the standard-normal receiver noise draw (D,).
    """
    return _aggregate(cfg, g, rho, h, mask, z, noise_power)[:2]


def _aggregate(cfg, g, rho, h, mask, z, noise_power) -> tuple:
    """:func:`aggregation_stage` → ``(ŷ, e_com, V_g, a)``: the prelude's
    V_g and a beside ŷ, so the round's metrics and taps reuse them. The
    ``jnp`` backend gives ``aircomp.aircomp_aggregate``'s values bitwise."""
    coeff, m_g, v_g, a, z, e_com = fused_aggregation_inputs(
        cfg, g, rho, h, mask, z, noise_power
    )
    if AggregationBackend(cfg.backend) is AggregationBackend.JNP:
        y_hat = aircomp.combine_given_stats(
            g, rho, h, mask, z, m_g, v_g, a, simulate_physical=cfg.simulate_physical
        )
    else:
        from repro_torch.kernels.aircomp import aircomp_aggregate_fused  # late: kernels↔core

        y_hat = aircomp_aggregate_fused(g, coeff, m_g, v_g, a, z)
    return y_hat, e_com, v_g, a


def apply_update_stage(cfg: POFLConfig, params, y_hat: torch.Tensor, t: int):
    """Step 6: w^{t+1} = w^t − η^t ŷ^t (flat update, re-raveled)."""
    flat, unravel = ravel_pytree(params)
    return unravel(flat - cfg.lr(t) * y_hat)


def _schedule(cfg, data_frac, g, h, sched_draw, alpha, noise_power, policy_id=None,
              avail=None, diagnostics=False):
    """Steps 3–4 of one cell: the uploaded statistics, then the schedule
    → ``(rho, mask)``; with ``diagnostics`` also what the taps read there,
    ``(rho, mask, probs, norms)``."""
    stats = aircomp.local_stats(g)
    out = scheduling_stage(
        cfg, stats, h.abs(), data_frac, g.shape[-1], alpha, noise_power, sched_draw,
        avail=avail, policy_id=policy_id, return_probs=diagnostics,
    )
    return (*out, stats.norm) if diagnostics else out


def _diag_values(cfg, h, probs, norm, v_g, a, agg_noise_power) -> tuple:
    """One cell's :class:`RoundDiagnostics` as a tuple of tensors (so the
    lattice can ``vmap`` it): the taps of ``diagnostics_taps`` from the
    schedule's probabilities and norms, the aggregation's V_g and a, and
    the σ_z² it used (0 for ``noisefree``)."""
    return tuple(diagnostics_taps(probs, norm, v_g, a, h.abs(), cfg.tx_power,
                                  agg_noise_power))


def _metric_values(cfg, data_frac, g, rho, mask, y_hat, e_com, a) -> tuple:
    """One cell's ``(e_com, e_var, grad_norm, n_scheduled, a_scalar)``: only
    tensors, so the lattice can ``vmap`` it (``torch.func.vmap`` refuses a
    ``None`` output)."""
    return (
        e_com,
        scheduling.global_update_variance(g, rho, mask, data_frac, cfg.n_scheduled),
        torch.linalg.vector_norm(y_hat),
        mask.sum(),
        a,
    )


def _check_on_nonfinite(cfg: POFLConfig) -> None:
    if cfg.on_nonfinite not in ("propagate", "skip"):
        raise ValueError(
            f"POFLConfig.on_nonfinite must be 'propagate' or 'skip', got {cfg.on_nonfinite!r}"
        )


def _poison(y_hat: torch.Tensor, t: int, fault_round) -> torch.Tensor:
    """ŷ with every row whose ``fault_round`` equals ``t`` set to NaN, as a
    value select (``fault_round`` a tensor of ŷ's leading shape; -1 never
    fires)."""
    fire = torch.as_tensor(fault_round, device=y_hat.device) == t
    return torch.where(fire[..., None], torch.full_like(y_hat, math.nan), y_hat)


def _hold(finite: torch.Tensor, new, old):
    """The quarantine's select over a params tree: ``new`` where ``finite``
    (one flag, or one a cell along the leading axis), else ``old``."""
    if isinstance(new, dict):
        return {k: _hold(finite, v, old[k]) for k, v in new.items()}
    return torch.where(finite.reshape(finite.shape + (1,) * (new.dim() - finite.dim())),
                       new, old)


def _quarantine(finite: torch.Tensor, new_params, params, alg_state, alg_state_in):
    """Hold the params and the AlgState where the round's ŷ is not finite →
    ``(params, alg_state, RoundHealth)``."""
    if alg_state is not None:
        alg_state = AlgState(*(None if n is None else _hold(finite, n, o)
                               for n, o in zip(alg_state, alg_state_in)))
    return (_hold(finite, new_params, params), alg_state,
            RoundHealth(nonfinite=(~finite).float()))


# --------------------------------------------------------------------------
# the composed round
# --------------------------------------------------------------------------


def round_algorithm(
    loss_fn: Callable,
    data: DeviceData,
    cfg: POFLConfig,
    params,
    h: torch.Tensor,
    batch_idx: torch.Tensor,
    sched_draw: torch.Tensor,
    z: torch.Tensor,
    t: int,
    noise_power: float | None = None,
    alpha: float | None = None,
    avail: torch.Tensor | None = None,
    alg_state: AlgState | None = None,
    algorithm_id: torch.Tensor | None = None,
    fault_round=None,
    diagnostics: bool = False,
) -> tuple[Any, AlgState | None, RoundMetrics]:
    """Steps 2–6 of Algorithm 1 for one round → ``(new_params, alg_state, metrics)``.

    ``h`` is this round's channel, ``batch_idx`` the mini-batch rows ((N, B),
    or (K, N, B) for K = ``cfg.local_steps`` > 1), ``sched_draw`` the
    sampler's input (:func:`sampler_draw`) and ``z`` the standard-normal
    receiver noise (D,). ``avail`` is the (N,) availability of a process
    that drops devices (``None``: no mask). ``alg_state`` is the per-device
    local-algorithm state (``None`` for a stateless algorithm) and
    ``algorithm_id`` an optional id that replaces ``cfg.local_algorithm``.

    ``fault_round`` (an int or 0-d tensor; ``None`` adds no op) sets ŷ to
    NaN when it equals ``t``. Under ``cfg.on_nonfinite="skip"`` a non-finite
    ŷ, injected or not, leaves ``params`` and ``alg_state`` as they came in
    and sets ``metrics.health.nonfinite`` to 1; under ``"propagate"``
    ``metrics.health`` is ``None``. ``diagnostics`` fills ``metrics.diag``
    with the :class:`RoundDiagnostics` taps (``None`` when off: no extra
    op). Nothing here reads a value back to the host, so the card runs the
    round without waiting on Python.
    """
    _check_on_nonfinite(cfg)
    noise_power = cfg.noise_power if noise_power is None else noise_power
    alpha = cfg.alpha if alpha is None else alpha
    agg_noise_power = 0.0 if cfg.policy == "noisefree" else noise_power
    data_frac = data.data_frac
    alg_state_in = alg_state  # what the quarantine holds

    with record_function("pofl.local_update"):
        g, alg_state = local_update_stage(
            loss_fn, data, cfg, params, batch_idx, t,
            alg_state=alg_state, algorithm_id=algorithm_id,
        )  # (N, D)

    with record_function("pofl.scheduling"):
        rho, mask, *taps_in = _schedule(cfg, data_frac, g, h, sched_draw, alpha, noise_power,
                                        avail=avail, diagnostics=diagnostics)

    with record_function("pofl.aggregation"):
        y_hat, e_com, v_g, a = _aggregate(cfg, g, rho, h, mask, z, agg_noise_power)
        if fault_round is not None:
            y_hat = _poison(y_hat, t, fault_round)

    with record_function("pofl.update"):
        new_params = apply_update_stage(cfg, params, y_hat, t)
        health = None
        if cfg.on_nonfinite == "skip":
            new_params, alg_state, health = _quarantine(
                torch.isfinite(y_hat).all(), new_params, params, alg_state, alg_state_in)

    with record_function("pofl.metrics"):
        values = _metric_values(cfg, data_frac, g, rho, mask, y_hat, e_com, a)
        diag = RoundDiagnostics(*_diag_values(cfg, h, *taps_in, v_g, a, agg_noise_power)) \
            if diagnostics else None
        metrics = RoundMetrics(y_hat.new_zeros(()), *values, diag=diag, health=health)
    return new_params, alg_state, metrics


def round_algorithm_cells(
    loss_fn: Callable,
    data: DeviceData,
    cfg: POFLConfig,
    params_c,
    h_c: torch.Tensor,
    batch_idx_c: torch.Tensor,
    sched_c: torch.Tensor,
    z_c: torch.Tensor,
    t: int,
    noise_power_c: torch.Tensor,
    alpha_c: torch.Tensor,
    policy_id_c: torch.Tensor,
    avail_c: torch.Tensor | None = None,
    alg_state_c: AlgState | None = None,
    algorithm_id_c: torch.Tensor | None = None,
    fault_round_c: torch.Tensor | None = None,
    diagnostics: bool = False,
) -> tuple[Any, AlgState | None, RoundMetrics]:
    """One round of C lattice cells at once → ``(params_c, alg_state_c, metrics)``.

    Every argument carries a leading cell axis: the params' leaves, the
    draws ``h_c`` (C, N), ``batch_idx_c`` (C, N, B) or (C, K, N, B),
    ``sched_c`` (of a policy-fused ``cfg``), ``z_c`` (C, D) and ``avail_c``
    (C, N) (``None``: no mask), the per-cell ``noise_power_c``, ``alpha_c``
    and ``policy_id_c`` (C,), the policy as an id of ``scheduling.POLICY_IDS``,
    and the optional per-cell ``alg_state_c`` ((C, N, D) fields) and
    ``algorithm_id_c`` (C,). Cell c computes :func:`round_algorithm` of its
    policy and algorithm on its slice: each stage is the per-cell function
    under ``vmap`` over cells (the local update batches its gradients the
    same way), except that under ``pallas_fused`` the aggregation's scalar
    prelude is vmapped and then ONE launch of the trial-batched kernel
    aggregates the (C, N, D) updates. σ_z² = 0 for ``noisefree`` cells is a
    value select. ``fault_round_c`` (C,) poisons a cell's ŷ at its round
    (-1 never fires). Under ``cfg.on_nonfinite="skip"`` each cell whose ŷ
    row is not finite keeps its params and AlgState, selected per cell
    after the aggregation, and is flagged on ``metrics.health`` (C,).
    ``diagnostics`` fills ``metrics.diag`` with each cell's taps (vmapped as
    tensors, the :class:`RoundDiagnostics` built outside). The metrics are
    (C,) tensors; nothing is read back to the host.
    """
    _check_on_nonfinite(cfg)
    agg_noise_c = torch.where(policy_id_c == scheduling.NOISEFREE_ID, 0.0, noise_power_c)
    data_frac = data.data_frac
    alg_state_in = alg_state_c

    with record_function("lattice.local_update"):
        g, alg_state_c = local_update_stage_cells(
            loss_fn, data, cfg, params_c, batch_idx_c, t,
            alg_state_c=alg_state_c, algorithm_id_c=algorithm_id_c,
        )

    with record_function("lattice.scheduling"):
        schedule = functools.partial(_schedule, cfg, data_frac, diagnostics=diagnostics)
        cell_args = (g, h_c, sched_c, alpha_c, noise_power_c, policy_id_c)
        if avail_c is None:
            rho, mask, *taps_in = vmap(schedule)(*cell_args)
        else:
            rho, mask, *taps_in = vmap(schedule)(*cell_args, avail_c)

    with record_function("lattice.aggregation"):
        if AggregationBackend(cfg.backend) is AggregationBackend.JNP:
            y_hat, e_com, v_g, a = vmap(functools.partial(_aggregate, cfg))(
                g, rho, h_c, mask, z_c, agg_noise_c
            )
        else:
            from repro_torch.kernels.aircomp import aircomp_aggregate_fused_batch  # late

            coeff, m_g, v_g, a, z, e_com = vmap(
                functools.partial(fused_aggregation_inputs, cfg)
            )(g, rho, h_c, mask, z_c, agg_noise_c)
            y_hat = aircomp_aggregate_fused_batch(
                g, coeff.contiguous(), m_g.contiguous(), v_g.contiguous(),
                a.contiguous(), z,
            )
        if fault_round_c is not None:
            y_hat = _poison(y_hat, t, fault_round_c)

    with record_function("lattice.update"):
        new_params = vmap(lambda p, y: apply_update_stage(cfg, p, y, t))(params_c, y_hat)
        health = None
        if cfg.on_nonfinite == "skip":
            new_params, alg_state_c, health = _quarantine(
                torch.isfinite(y_hat).all(dim=-1), new_params, params_c, alg_state_c,
                alg_state_in)

    with record_function("lattice.metrics"):
        values = vmap(functools.partial(_metric_values, cfg, data_frac))(
            g, rho, mask, y_hat, e_com, a
        )
        diag = RoundDiagnostics(*vmap(functools.partial(_diag_values, cfg))(
            h_c, *taps_in, v_g, a, agg_noise_c)) if diagnostics else None
        metrics = RoundMetrics(y_hat.new_zeros(y_hat.shape[0]), *values, diag=diag,
                               health=health)
    return new_params, alg_state_c, metrics


def make_round_step(loss_fn: Callable, data: DeviceData, channel: ChannelState,
                    cfg: POFLConfig):
    """The single-round step of Algorithm 1: ``round_step(params, draws, t)
    → (params, metrics)``.

    Where the reference's step takes a PRNG key and samples the round's
    fading from ``channel``, this one takes the round's draws as tensors
    (a :class:`repro_torch.sim.engine.RoundDraws`, e.g. from
    ``SimEngine.draws``): ``draws.h`` is the realization ``channel.sample``
    gives, and the mini-batch rows, sampler input and noise come with it.
    The channel is static, so no device is ever unavailable.
    """

    def round_step(params, draws, t):
        new_params, _, m = round_algorithm(
            loss_fn, data, cfg, params, draws.h, draws.batch_idx, draws.sched, draws.z, t
        )
        return new_params, m

    return round_step


def run_pofl(
    loss_fn,
    params0,
    data: DeviceData,
    cfg: POFLConfig,
    n_rounds: int,
    eval_fn: Callable | None = None,
    eval_every: int = 5,
    channel_cfg: ChannelConfig | None = None,
    device=None,
) -> tuple[Any, History]:
    """Run Algorithm 1 for ``n_rounds`` and return (params, history).

    A thin wrapper over :class:`repro_torch.sim.engine.SimEngine`. Runs on
    the CUDA card unless ``device`` says otherwise; with no card and no
    ``device`` it raises.
    """
    from repro_torch.sim.engine import SimEngine  # late import: sim builds on core

    engine = SimEngine(loss_fn, data, cfg, channel_cfg=channel_cfg, device=device)
    return engine.run_with_history(
        params0, n_rounds, eval_fn=eval_fn, eval_every=eval_every, seed=cfg.seed
    )
