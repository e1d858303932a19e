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
in order, the channel process's step (``h`` and the availability
``avail``), the mini-batch rows (K of them for ``cfg.local_steps`` = K),
the sampler's input and the receiver noise ``z``. The numbers differ from
the reference's threefry streams; the law is the same.

A seed's stream is a value, as the reference's key chain is: a
:class:`DrawStream` holds the generator's state (``get_state()``) and the
channel process's state tensors, :meth:`SimEngine.draw_stream` makes it and
:meth:`SimEngine.next_draws` advances it one round, returning the round's
:class:`RoundDraws` and the stream after them. So a run's carry
(:class:`SimState`, :class:`LatticeState`) is tensors only and can be
written to an npz and read back (``repro_torch.sim.resilience``);
:meth:`SimEngine.draws` iterates one stream.

In a lattice every cell of seed s starts from ``PRNGKey(s)`` in the
reference, so all the policies, noise levels and alphas at one seed see the
same channel, mini-batches, sampler draws and noise (common random numbers,
which the policy comparison rests on). The port keeps that with one
:class:`DrawStream` per distinct seed: each round the per-seed draws are
stacked and gathered to the cells by seed index.

Each run carries its per-device local-algorithm state
(:class:`~repro_torch.core.local_update.AlgState`) from round to round. A
lattice over several algorithms is ALGORITHM-fused: the engine's
``cfg.local_algorithm`` is :data:`FUSED_ALGORITHM`, each cell carries its
algorithm as an id and the full state (``h`` and ``c``).

A :class:`~repro_torch.sim.tasks.TaskEval` ``eval_fn`` fills the records'
``eval`` subtree (:class:`~repro_torch.sim.tasks.EvalRecord`, zeros on the
rounds that do not evaluate); any other ``eval_fn`` leaves it ``None``.
Under ``cfg.on_nonfinite="skip"`` a round whose ŷ is not finite keeps the
params and AlgState it started from (per cell in a lattice) and the records'
``health`` subtree flags it; the draws advance as usual. With
``obs=ObsConfig(diagnostics=True)`` every round also computes the
:class:`~repro_torch.core.metrics.RoundDiagnostics` taps, which fill the
records' ``diag`` subtree (``None`` when off, and then no round issues an
extra op).

Observability (``repro_torch.obs``): a lattice run is a ``lattice.dispatch``
span, wrapped in ``maybe_profile("lattice")`` (a ``torch.profiler`` capture
under ``REPRO_OBS_PROFILE=1``), and counts ``engine.lattice_runs`` in the
registry. The port traces and compiles no program, so where the
reference's ``lattice.run`` events report re-traces and compiles,
``trace_delta`` and ``engine_compiles`` are 0 and ``compile_delta`` counts
the ``nvcc`` builds of kernels (``span.kernels.nvcc.count``) made during
the call, 0 on a warm call.

Nothing reads a value back to the host inside a round. ``run_with_history``
keeps the per-round metrics on the device until an eval boundary (or the
end of the run), where they come to the host together;
``run_lattice_cells`` returns its records on the device.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, NamedTuple

import torch

from repro_torch.core.channel import ChannelConfig
from repro_torch.core.local_update import (
    ALGORITHMS, AlgState, init_state, minibatch_indices,
)
from repro_torch.core.metrics import RoundDiagnostics, RoundHealth
from repro_torch.core.pofl import (
    FUSED_POLICY, DeviceData, History, POFLConfig, round_algorithm,
    round_algorithm_cells, sampler_draw,
)
from repro_torch.device import resolve_device
from repro_torch.flatten_util import tree_leaves, tree_map
from repro_torch.obs.config import DEFAULT_OBS, ObsConfig
from repro_torch.obs.profile import maybe_profile
from repro_torch.obs.registry import counter_add
from repro_torch.obs.spans import span
from repro_torch.sim.scenario import make_channel_process
from repro_torch.sim.tasks import EvalRecord, TaskEval, zero_eval_record

# The cfg.local_algorithm of an ALGORITHM-FUSED engine (a lattice over
# several algorithms): each cell carries its algorithm as an id, so the
# string is deliberately not a real algorithm.
FUSED_ALGORITHM = "__fused__"


class DrawStream(NamedTuple):
    """One seed's draws as a value (:meth:`SimEngine.draw_stream`,
    :meth:`SimEngine.next_draws`): the generator's state and the channel
    process's state, the reference's key chain and ``chan`` carry."""

    rng: torch.Tensor  # torch.Generator.get_state(): uint8, on the CPU
    chan: Any          # the channel process's state: a tuple of tensors


class SimState(NamedTuple):
    """What a run carries from round to round (the reference's scan carry).

    ``key`` is the port's counterpart of the reference's PRNG chain: the
    seed's :class:`DrawStream`, which holds the channel process's state as
    well; ``chan`` is ``None``. ``alg`` is the per-device local-algorithm
    state (:class:`~repro_torch.core.local_update.AlgState`), ``None`` for a
    stateless algorithm.
    """

    params: Any       # model tree
    key: Any          # the seed's DrawStream
    chan: Any         # None: the DrawStream holds the channel-process state
    alg: Any = None   # AlgState, or None (stateless)


class RoundRecord(NamedTuple):
    """Per-round metric record; in a lattice every field is (cells, rounds).

    ``eval`` is the :class:`~repro_torch.sim.tasks.EvalRecord` subtree
    when the engine's ``eval_fn`` is a ``TaskEval``, else ``None``.
    ``health`` is the quarantine's
    :class:`~repro_torch.core.metrics.RoundHealth` under
    ``cfg.on_nonfinite="skip"``, else ``None``. ``diag`` is the
    :class:`~repro_torch.core.metrics.RoundDiagnostics` taps under
    ``ObsConfig(diagnostics=True)``, else ``None``.
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
    """What a lattice run carries from round to round
    (:meth:`SimEngine.lattice_round`): tensors only, so it can be written
    to an npz and read back (``repro_torch.sim.resilience``)."""

    params: Any                  # each leaf with a leading (B,) cell axis
    streams: list                # one DrawStream per distinct seed
    seed_idx: torch.Tensor       # (B,) each cell's index into the streams
    noise: torch.Tensor          # (B,) σ_z² per cell
    alpha: torch.Tensor          # (B,) α per cell
    policy: torch.Tensor         # (B,) POLICY_IDS per cell
    alg: Any = None              # AlgState with (B, N, D) fields, or None
    algorithm: Any = None        # (B,) ALGORITHM_IDS per cell, or None (static)


class RoundDraws(NamedTuple):
    """One round's random inputs, in the order the generator makes them
    (the channel process's step gives ``h`` and ``avail``)."""

    h: torch.Tensor          # (N,) complex64 channel
    batch_idx: torch.Tensor  # (N, B) int64 mini-batch rows; (K, N, B) at K > 1
    sched: torch.Tensor      # the sampler's input (pofl.sampler_draw)
    z: torch.Tensor          # (D,) standard-normal receiver noise
    avail: torch.Tensor      # (N,) 0/1 availability (all ones if it cannot drop)


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
      scenario_params: the scenario's parameters (e.g. ``corr=0.95``, or
        ``base="gauss_markov"`` under ``dropout``).
      eval_fn: ``params -> (loss, acc)`` that :meth:`run_lattice_cells`
        runs on each cell's params after a round flagged by ``do_eval``
        (``run_with_history`` takes its own); a ``TaskEval`` also fills
        the records' ``eval`` subtree.
      device:  where the run lives; the CUDA card by default, and with no
        card and no ``device`` given the engine raises.
      obs:     :class:`~repro_torch.obs.config.ObsConfig`;
        ``diagnostics=True`` computes the taps every round and fills the
        records' ``diag``. ``run_with_history`` computes them too and, as
        in the reference, its ``History`` does not carry them.
    """

    def __init__(
        self,
        loss_fn: Callable,
        data: DeviceData,
        cfg: POFLConfig,
        channel_cfg: ChannelConfig | None = None,
        scenario: str = "static_rayleigh",
        scenario_params: dict | None = None,
        eval_fn: Callable | None = None,
        device=None,
        obs: ObsConfig | None = None,
    ):
        self.device = resolve_device(device)
        self.obs = obs or DEFAULT_OBS
        if cfg.local_algorithm not in ALGORITHMS + (FUSED_ALGORITHM,):
            raise ValueError(
                f"unknown local_algorithm {cfg.local_algorithm!r}; choose from {ALGORITHMS}"
            )
        if cfg.on_nonfinite not in ("propagate", "skip"):
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
        self.process = make_channel_process(
            scenario, self.channel_cfg, **(scenario_params or {}))
        self.eval_fn = eval_fn
        self.task_eval = eval_fn if isinstance(eval_fn, TaskEval) else None
        # the generator every stream's round runs on, its state set from the
        # stream first (a stream's state is a value, never this object)
        self._gen = torch.Generator(device=self.device)

    def draw_stream(self, seed: int) -> DrawStream:
        """Seed ``seed``'s stream before its first round: the generator
        seeded with it, after the channel process drew its initial state."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        chan = self.process.init(gen)
        return DrawStream(rng=gen.get_state(), chan=chan)

    def next_draws(self, stream: DrawStream, dim: int) -> tuple[DrawStream, RoundDraws]:
        """One round of ``stream`` (the key discipline) → ``(stream after
        it, the round's draws)``; ``dim`` is the size of the noise ``z``."""
        gen = self._gen
        gen.set_state(stream.rng)
        chan, h, avail = self.process.step(stream.chan, self.process.draw(gen))
        k_steps = self.cfg.local_steps
        rows = [minibatch_indices(self.data, self.cfg.batch_size, gen)
                for _ in range(k_steps)]
        draws = RoundDraws(
            h=h,
            batch_idx=rows[0] if k_steps == 1 else torch.stack(rows),
            sched=sampler_draw(self.cfg, gen),
            z=torch.randn(dim, generator=gen, device=self.device),
            avail=avail,
        )
        return DrawStream(rng=gen.get_state(), chan=chan), draws

    def draws(self, seed: int, dim: int) -> Iterator[RoundDraws]:
        """The run's random inputs, round after round: seed ``seed``'s
        stream advanced by :meth:`next_draws`."""
        stream = self.draw_stream(seed)
        while True:
            stream, d = self.next_draws(stream, dim)
            yield d

    def _avail(self, d: RoundDraws):
        """The round's availability mask, or ``None`` where the process
        never drops a device (the round then skips the masking)."""
        return d.avail if self.process.can_drop else None

    def _alg_state(self, dim: int, cells: int | None = None) -> AlgState | None:
        """The zero local-algorithm state of a run (``cells``: of a lattice,
        each field (cells, N, D)); ``None`` for a stateless algorithm."""
        fused = self.cfg.local_algorithm == FUSED_ALGORITHM
        state = init_state(self.cfg.local_algorithm, self.cfg.n_devices, dim, full=fused,
                           device=self.device)
        if state is None or cells is None:
            return state
        return AlgState(*(None if f is None else f.new_zeros((cells,) + f.shape)
                          for f in state))

    def _eval(self, params, cells: int, do_eval: bool):
        """Each cell's eval after a round → ``(loss, acc, eval record)``,
        (B,) tensors (zeros when not ``do_eval``); the record is ``None``
        unless ``eval_fn`` is a ``TaskEval``."""
        zeros = torch.zeros(cells, device=self.device)
        if not do_eval or self.eval_fn is None:
            rec = None if self.task_eval is None else zero_eval_record((cells,), self.device)
            return zeros, zeros, rec
        per_cell = [tree_map(lambda p, c=c: p[c], params) for c in range(cells)]
        if self.task_eval is not None:
            rec = EvalRecord(*(torch.stack(f) for f in zip(
                *(self.task_eval.record(p) for p in per_cell))))
            return rec.loss, rec.acc, rec
        loss, acc = (torch.stack([torch.as_tensor(v, dtype=torch.float32) for v in vals])
                     for vals in zip(*(self.eval_fn(p) for p in per_cell)))
        return loss, acc, None

    def lattice_start(self, params0, noise_b, alpha_b, seed_b, policy_b,
                      algorithm_b=None) -> LatticeState:
        """The state of a lattice run before its first round: each cell's
        params (a copy of ``params0``) and zero local-algorithm state, one
        draw stream per distinct seed, and the per-cell axes on the device.
        All host → device copies of a run happen here. The engine must be
        policy-fused (``cfg.policy`` is :data:`FUSED_POLICY`): each cell's
        policy is its id in ``policy_b``; an algorithm-fused engine
        (``cfg.local_algorithm`` is :data:`FUSED_ALGORITHM`) takes each
        cell's algorithm id in ``algorithm_b``."""
        dev = self.device
        if self.cfg.policy != FUSED_POLICY:
            raise ValueError(
                f"a lattice engine is policy-fused: cfg.policy must be FUSED_POLICY, "
                f"got {self.cfg.policy!r}"
            )
        if (algorithm_b is None) != (self.cfg.local_algorithm != FUSED_ALGORITHM):
            raise ValueError(
                "algorithm_b goes with an algorithm-fused engine (cfg.local_algorithm "
                "FUSED_ALGORITHM) and only with one"
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
            streams=[self.draw_stream(s) for s in distinct],
            seed_idx=torch.tensor([distinct.index(s) for s in seeds], device=dev),
            noise=torch.as_tensor(noise_b, dtype=torch.float32).to(dev),
            alpha=torch.as_tensor(alpha_b, dtype=torch.float32).to(dev),
            policy=torch.as_tensor(policy_b, dtype=torch.int64).to(dev),
            alg=self._alg_state(dim, cells=len(seeds)),
            algorithm=None if algorithm_b is None
            else torch.as_tensor(algorithm_b, dtype=torch.int64).to(dev),
        )

    def lattice_round(self, state: LatticeState, t: int, do_eval: bool,
                      fault_b=None) -> tuple[LatticeState, RoundRecord]:
        """Round ``t`` of every cell → ``(state', record)``, ``record`` a
        :class:`RoundRecord` of (B,) tensors: its ``diag`` the taps under
        ``ObsConfig(diagnostics=True)``, its ``eval`` an ``EvalRecord``
        under a ``TaskEval`` and its ``health`` the quarantine's flags under
        ``cfg.on_nonfinite="skip"`` (each ``None`` otherwise). The cells of
        one seed share that seed's draws: each stream of ``state.streams``
        advances one round (:meth:`next_draws`).
        ``fault_b`` (B,) poisons a cell's ŷ at its round (-1 never fires).
        ``eval_fn`` runs on each cell's new params when ``do_eval``;
        ``loss``/``acc`` are 0 otherwise. Under ``pallas_fused`` one launch
        of the batch kernel aggregates the round. Nothing is read back to
        the host."""
        dim = sum(p[0].numel() for p in tree_leaves(state.params))
        streams, draws = zip(*(self.next_draws(s, dim) for s in state.streams))
        state = state._replace(streams=list(streams))
        d = RoundDraws(*(
            torch.stack(x).index_select(0, state.seed_idx) for x in zip(*draws)
        ))
        params, alg, m = round_algorithm_cells(
            self.loss_fn, self.data, self.cfg, state.params, d.h, d.batch_idx, d.sched,
            d.z, t, state.noise, state.alpha, state.policy, avail_c=self._avail(d),
            alg_state_c=state.alg, algorithm_id_c=state.algorithm, fault_round_c=fault_b,
            diagnostics=self.obs.diagnostics,
        )
        loss, acc, ev = self._eval(params, state.noise.shape[0], do_eval)
        record = RoundRecord(m.e_com, m.e_var, m.grad_norm, m.n_scheduled, loss, acc,
                             diag=m.diag, eval=ev, health=m.health)
        return state._replace(params=params, alg=alg), record

    def run_lattice_cells(
        self, params0, t_ints, do_eval, noise_b, alpha_b, seed_b, policy_b,
        algorithm_b=None,
    ) -> RoundRecord:
        """Every cell of a lattice, round by round → a :class:`RoundRecord`
        of (B, T) tensors on the engine's device (its ``diag``, ``eval`` and
        ``health`` subtrees of them where :meth:`lattice_round` fills them).

        ``noise_b``, ``alpha_b``, ``seed_b``, ``policy_b`` (ids of
        ``scheduling.POLICY_IDS``) and, for an algorithm-fused engine,
        ``algorithm_b`` (ids of ``local_update.ALGORITHM_IDS``) are the
        flattened (B,) cell axes of a policy-fused engine. Every cell starts
        from ``params0``; ``do_eval`` flags the rounds after which
        ``eval_fn`` runs (:meth:`lattice_round`), all of them one
        :meth:`run_lattice_chunk`.
        """
        state = self.lattice_start(params0, noise_b, alpha_b, seed_b, policy_b,
                                   algorithm_b)
        counter_add("engine.lattice_runs")
        return self.run_lattice_chunk(state, t_ints, do_eval)[1]

    def run_lattice_chunk(self, state: LatticeState, t_ints, do_eval, fault_b=None,
                          **span_fields) -> tuple[LatticeState, RoundRecord]:
        """Rounds ``t_ints`` of every cell from ``state`` → ``(state after
        them, RoundRecord of (B, len(t_ints)) tensors)``: the carry comes in
        and goes out, so ``repro_torch.sim.resilience`` can persist it
        between chunks. ``do_eval`` flags the rounds after which ``eval_fn``
        runs, ``fault_b`` is :meth:`lattice_round`'s. The rounds run in a
        ``lattice.dispatch`` span (host time: the rounds are issued, not
        waited for; ``span_fields`` join its event) inside
        ``maybe_profile("lattice")``."""
        cells = len(state.seed_idx)
        rounds = []
        with maybe_profile("lattice", self.device), span(
            "lattice.dispatch", fused=True, cells=cells, **span_fields
        ):
            for t, ev in zip(t_ints, do_eval):
                state, record = self.lattice_round(state, int(t), bool(ev), fault_b=fault_b)
                rounds.append(record)
        return state, stack_rounds(rounds) if rounds else self.empty_records(cells)

    def empty_records(self, cells: int) -> RoundRecord:
        """The (B, 0) records of a run of no round, with this engine's
        subtrees."""
        empty = torch.zeros(cells, 0, device=self.device)
        return RoundRecord(
            *(empty for _ in RECORD_SCALARS),
            diag=RoundDiagnostics(*(empty for _ in RoundDiagnostics._fields))
            if self.obs.diagnostics else None,
            eval=None if self.task_eval is None
            else zero_eval_record((cells, 0), self.device),
            health=RoundHealth(empty) if self.cfg.on_nonfinite == "skip" else None)

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
        points where values come back to the host. The run carries a
        :class:`SimState`: the params, the seed's :class:`DrawStream` and
        the local-algorithm state, which starts at zero. Under
        ``cfg.on_nonfinite="skip"`` a round whose ŷ is not finite leaves
        the params and the state as they were, and its ``e_com``/``e_var``
        are recorded as computed.
        """
        if self.cfg.local_algorithm == FUSED_ALGORITHM:
            raise ValueError("run_with_history runs one algorithm: cfg.local_algorithm "
                             "must name one, not FUSED_ALGORITHM")
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
        state = SimState(params=params, key=self.draw_stream(seed), chan=None,
                         alg=self._alg_state(dim))
        for t in range(n_rounds):
            key, d = self.next_draws(state.key, dim)
            params, alg, m = round_algorithm(
                self.loss_fn, self.data, self.cfg, state.params,
                d.h, d.batch_idx, d.sched, d.z, t, avail=self._avail(d), alg_state=state.alg,
                diagnostics=self.obs.diagnostics,
            )
            state = SimState(params=params, key=key, chan=None, alg=alg)
            e_com.append(m.e_com)
            e_var.append(m.e_var)
            if t in eval_ts or t == n_rounds - 1:
                hist.e_com.extend(torch.stack(e_com).tolist())
                hist.e_var.extend(torch.stack(e_var).tolist())
                e_com, e_var = [], []
            if t in eval_ts:
                loss, acc = eval_fn(state.params)
                hist.loss.append(float(loss))
                hist.test_acc.append(float(acc))
                hist.test_round.append(t)
        return state.params, hist


def zip_records(fn: Callable, *trees):
    """``fn`` over the matching leaves of record trees of one structure (a
    ``RoundRecord`` and its optional subtrees)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(zip_records(fn, *f) for f in zip(*trees)))
    return fn(*trees)


def stack_rounds(rounds: list[RoundRecord]) -> RoundRecord:
    """Per-round records of (B,) tensors → one record of (B, T) tensors,
    its subtrees (``diag``, ``eval``, ``health``) stacked field by field."""
    return zip_records(lambda *xs: torch.stack(xs, dim=1), *rounds)
