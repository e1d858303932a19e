"""The PO-FL round engine (port of ``repro.sim.engine``).

A Python loop over rounds around :func:`repro_torch.core.pofl.round_algorithm`
(:meth:`SimEngine.run_with_history`, what ``run_pofl`` runs), and around
:func:`repro_torch.core.pofl.round_algorithm_cells` for the cells of a
lattice (:meth:`SimEngine.run_lattice_cells`, what ``run_lattice`` runs).
The reference's key discipline

    key = PRNGKey(cfg.seed)
    k_chan_init, key = split(key)           # channel process init
    per round: key, k_round = split(key)
               k_batch, k_chan, k_sched, k_noise = split(k_round, 4)

becomes one ``torch.Generator`` on the run's device, seeded with the seed:
the channel process draws its initial state from it, then every round draws,
in order, the channel ``h``, the mini-batch rows, the sampler's input and
the receiver noise ``z`` (:meth:`SimEngine.draws`). The numbers differ from
the reference's threefry streams; the law is the same.

In a lattice every cell of seed s starts from ``PRNGKey(s)`` in the
reference, so all the policies, noise levels and alphas at one seed see the
same channel, mini-batches, sampler draws and noise (common random numbers,
which the policy comparison rests on). The port keeps that with one
:meth:`SimEngine.draws` stream per distinct seed: each round the per-seed
draws are stacked and gathered to the cells by seed index.

Nothing reads a value back to the host inside a round. ``run_with_history``
keeps the per-round metrics on the device until an eval boundary (or the
end of the run), where they come to the host together;
``run_lattice_cells`` returns its records on the device.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, NamedTuple

import torch

from repro_torch.core.channel import ChannelConfig
from repro_torch.core.local_update import ALGORITHMS, minibatch_indices
from repro_torch.core.pofl import (
    FUSED_POLICY, DeviceData, History, POFLConfig, round_algorithm,
    round_algorithm_cells, sampler_draw,
)
from repro_torch.device import resolve_device
from repro_torch.flatten_util import tree_leaves, tree_map
from repro_torch.sim.scenario import make_channel_process


class RoundRecord(NamedTuple):
    """Per-round metric record; in a lattice every field is (cells, rounds).

    ``diag``, ``eval`` and ``health`` are the reference's optional subtrees
    (diagnostics taps, task-eval curves, quarantine counters); the port
    does not fill them yet, so they are always ``None``.
    """

    e_com: torch.Tensor        # Eq. 15 closed-form communication distortion
    e_var: torch.Tensor        # realized global update variance (Thm. 1)
    grad_norm: torch.Tensor    # ||ŷ^t||
    n_scheduled: torch.Tensor  # realized |S^t|
    loss: torch.Tensor         # eval loss (0 where not evaluated)
    acc: torch.Tensor          # eval accuracy (0 where not evaluated)
    diag: Any = None
    eval: Any = None
    health: Any = None


# the always-present record fields (diag/eval/health are optional subtrees)
RECORD_SCALARS = ("e_com", "e_var", "grad_norm", "n_scheduled", "loss", "acc")


class LatticeState(NamedTuple):
    """What a lattice run carries from round to round (:meth:`SimEngine.lattice_round`)."""

    params: Any                  # each leaf with a leading (B,) cell axis
    streams: list                # one SimEngine.draws iterator per distinct seed
    seed_idx: torch.Tensor       # (B,) each cell's index into the streams
    noise: torch.Tensor          # (B,) σ_z² per cell
    alpha: torch.Tensor          # (B,) α per cell
    policy: torch.Tensor         # (B,) POLICY_IDS per cell


class RoundDraws(NamedTuple):
    """One round's random inputs, in the order the generator makes them."""

    h: torch.Tensor          # (N,) complex64 channel
    batch_idx: torch.Tensor  # (N, B) int64 mini-batch rows
    sched: torch.Tensor      # the sampler's input (pofl.sampler_draw)
    z: torch.Tensor          # (D,) standard-normal receiver noise


def _default_channel_cfg(cfg: POFLConfig) -> ChannelConfig:
    return ChannelConfig(
        n_devices=cfg.n_devices, tx_power=cfg.tx_power, noise_power=cfg.noise_power,
    )


class SimEngine:
    """Round loop for one (task, config, channel scenario) on one device.

    Args:
      loss_fn: per-device loss ``f(params, x, y)``.
      data:    stacked per-device :class:`DeviceData`; moved to ``device``.
      cfg:     :class:`POFLConfig`.
      channel_cfg: physical-layer constants; defaults to the ones
        ``run_pofl`` builds from ``cfg``.
      scenario: channel-process name (``sim.scenario.CHANNEL_SCENARIOS``).
      eval_fn: ``params -> (loss, acc)`` that :meth:`run_lattice_cells`
        runs on each cell's params after a round flagged by ``do_eval``
        (``run_with_history`` takes its own).
      device:  where the run lives; the CUDA card by default, and with no
        card and no ``device`` given the engine raises.
    """

    def __init__(
        self,
        loss_fn: Callable,
        data: DeviceData,
        cfg: POFLConfig,
        channel_cfg: ChannelConfig | None = None,
        scenario: str = "static_rayleigh",
        eval_fn: Callable | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if cfg.local_algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown local_algorithm {cfg.local_algorithm!r}; choose from {ALGORITHMS}"
            )
        if cfg.on_nonfinite == "skip":
            raise NotImplementedError(
                "on_nonfinite='skip' (the non-finite quarantine) is not ported yet "
                "(ROADMAP queue A item 11)"
            )
        if cfg.on_nonfinite != "propagate":
            raise ValueError(
                f"POFLConfig.on_nonfinite must be 'propagate' or 'skip', got "
                f"{cfg.on_nonfinite!r}"
            )
        # checked once here, on the host, so the rounds never read it back
        if data.n_samples is not None and bool((data.n_samples < 1).any()):
            raise ValueError(
                "every device needs n_samples >= 1; drop empty devices from "
                "the partition instead"
            )
        self.loss_fn = loss_fn
        self.data = data.to(self.device)
        self.cfg = cfg
        self.channel_cfg = channel_cfg or _default_channel_cfg(cfg)
        self.process = make_channel_process(scenario, self.channel_cfg)
        self.eval_fn = eval_fn

    def draws(self, seed: int, dim: int) -> Iterator[RoundDraws]:
        """The run's random inputs, round after round (the key discipline)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        chan = self.process.init(gen)
        while True:
            chan, h = self.process.step(chan, gen)
            yield RoundDraws(
                h=h,
                batch_idx=minibatch_indices(self.data, self.cfg.batch_size, gen),
                sched=sampler_draw(self.cfg, gen),
                z=torch.randn(dim, generator=gen, device=self.device),
            )

    def lattice_start(self, params0, noise_b, alpha_b, seed_b, policy_b) -> LatticeState:
        """The state of a lattice run before its first round: each cell's
        params (a copy of ``params0``), one draw stream per distinct seed,
        and the per-cell axes on the device. All host → device copies of a
        run happen here. The engine must be policy-fused (``cfg.policy`` is
        :data:`FUSED_POLICY`): each cell's policy is its id in ``policy_b``."""
        dev = self.device
        if self.cfg.policy != FUSED_POLICY:
            raise ValueError(
                f"a lattice engine is policy-fused: cfg.policy must be FUSED_POLICY, "
                f"got {self.cfg.policy!r}"
            )
        seeds = [int(s) for s in seed_b]
        distinct = sorted(set(seeds))
        params = tree_map(
            lambda p: torch.as_tensor(p).to(dev, torch.float32)
            .expand(len(seeds), *p.shape).clone(),
            params0,
        )
        dim = sum(p[0].numel() for p in tree_leaves(params))
        return LatticeState(
            params=params,
            streams=[self.draws(s, dim) for s in distinct],
            seed_idx=torch.tensor([distinct.index(s) for s in seeds], device=dev),
            noise=torch.as_tensor(noise_b, dtype=torch.float32).to(dev),
            alpha=torch.as_tensor(alpha_b, dtype=torch.float32).to(dev),
            policy=torch.as_tensor(policy_b, dtype=torch.int64).to(dev),
        )

    def lattice_round(self, state: LatticeState, t: int, do_eval: bool):
        """Round ``t`` of every cell → ``(state', record)``, ``record`` the
        (B,) tensors of :data:`RECORD_SCALARS`. The cells of one seed share
        that seed's draws. ``eval_fn`` runs on each cell's new params when
        ``do_eval``; ``loss``/``acc`` are 0 otherwise. Under ``pallas_fused``
        one launch of the batch kernel aggregates the round. Nothing is read
        back to the host."""
        per_seed = [next(it) for it in state.streams]
        d = RoundDraws(*(
            torch.stack(x).index_select(0, state.seed_idx) for x in zip(*per_seed)
        ))
        params, m = round_algorithm_cells(
            self.loss_fn, self.data, self.cfg, state.params, d.h, d.batch_idx, d.sched,
            d.z, t, state.noise, state.alpha, state.policy,
        )
        loss = acc = torch.zeros_like(state.noise)
        if do_eval and self.eval_fn is not None:
            evals = [
                self.eval_fn(tree_map(lambda p, c=c: p[c], params))
                for c in range(state.noise.shape[0])
            ]
            loss, acc = (
                torch.stack([torch.as_tensor(v, dtype=torch.float32) for v in vals])
                for vals in zip(*evals)
            )
        record = (m.e_com, m.e_var, m.grad_norm, m.n_scheduled, loss, acc)
        return state._replace(params=params), record

    def run_lattice_cells(
        self, params0, t_ints, do_eval, noise_b, alpha_b, seed_b, policy_b,
    ) -> RoundRecord:
        """Every cell of a lattice, round by round → a :class:`RoundRecord`
        of (B, T) tensors on the engine's device.

        ``noise_b``, ``alpha_b``, ``seed_b`` and ``policy_b`` (ids of
        ``scheduling.POLICY_IDS``) are the flattened (B,) cell axes of a
        policy-fused engine. Every cell starts from ``params0``; ``do_eval``
        flags the rounds after which ``eval_fn`` runs (:meth:`lattice_round`).
        """
        state = self.lattice_start(params0, noise_b, alpha_b, seed_b, policy_b)
        rounds = []
        for t, ev in zip(t_ints, do_eval):
            state, record = self.lattice_round(state, int(t), bool(ev))
            rounds.append(record)
        if not rounds:
            empty = torch.zeros(len(state.seed_idx), 0, device=self.device)
            return RoundRecord(*(empty for _ in RECORD_SCALARS))
        return RoundRecord(*(torch.stack(f, dim=1) for f in zip(*rounds)))

    def run_with_history(
        self,
        params0,
        n_rounds: int,
        eval_fn: Callable | None = None,
        eval_every: int = 5,
        seed: int | None = None,
    ) -> tuple[Any, History]:
        """Run ``n_rounds`` rounds → (params, History).

        ``eval_fn(params) -> (loss, acc)`` runs after round 0, every
        ``eval_every`` rounds and after the last round; those are the only
        points where values come back to the host.
        """
        params = tree_map(
            lambda p: torch.as_tensor(p).to(self.device, torch.float32, copy=True),
            params0,
        )
        dim = sum(p.numel() for p in tree_leaves(params))
        seed = self.cfg.seed if seed is None else seed
        eval_ts = set() if eval_fn is None else {
            t for t in range(n_rounds) if t % eval_every == 0 or t == n_rounds - 1
        }

        hist = History(loss=[], e_com=[], e_var=[], test_acc=[], test_round=[])
        e_com, e_var = [], []
        draws = self.draws(seed, dim)
        for t in range(n_rounds):
            d = next(draws)
            params, m = round_algorithm(
                self.loss_fn, self.data, self.cfg, params,
                d.h, d.batch_idx, d.sched, d.z, t,
            )
            e_com.append(m.e_com)
            e_var.append(m.e_var)
            if t in eval_ts or t == n_rounds - 1:
                hist.e_com.extend(torch.stack(e_com).tolist())
                hist.e_var.extend(torch.stack(e_var).tolist())
                e_com, e_var = [], []
            if t in eval_ts:
                loss, acc = eval_fn(params)
                hist.loss.append(float(loss))
                hist.test_acc.append(float(acc))
                hist.test_round.append(t)
        return params, hist
