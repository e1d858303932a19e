"""Experiment lattices (port of ``repro.sim.lattice``).

A :class:`LatticeSpec` names the sweep axes

    algorithms × policies × noise_powers × alphas × seeds   (× n_rounds)

and :func:`run_lattice` runs every cell of it at once: the cells are a
leading batch axis of one round (``core.pofl.round_algorithm_cells``), the
policy is an id per cell (``core.scheduling.POLICY_IDS``), and so is the
local-update algorithm when the spec names several
(``core.local_update.ALGORITHM_IDS``; one algorithm keeps its static
dispatch). Under ``backend="pallas_fused"`` one launch of the trial-batched
CUDA kernel aggregates all cells each round. Any channel scenario of
``sim.scenario.CHANNEL_SCENARIOS`` with its parameters, any
``base_cfg.local_steps``, a ``TaskEval`` (whose curves fill
``LatticeRecords.eval``) and ``base_cfg.on_nonfinite="skip"`` (whose flags
fill ``LatticeRecords.health``) are accepted. The flat cell order is the
reference's: the algorithm axis leads, then policy-major, so the records
reshape to the reference's ``(A, P, Nn, Na, Ns, T|E)`` grid.
``fuse_policies=False`` and ``fuse_algorithms=False`` are the reference's
loops: one sub-lattice a policy (or an algorithm) on the same cell program,
each from the same seeds' draw streams, stacked on its axis. The records
stay on the device for the whole run and come to the host once, at the end.

A mesh and ``obs`` diagnostics raise ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import local_update, scheduling
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.metrics import RoundHealth
from repro_torch.core.pofl import DeviceData, POFLConfig
from repro_torch.sim.engine import (
    FUSED_ALGORITHM, FUSED_POLICY, RECORD_SCALARS, SimEngine,
)
from repro_torch.sim.tasks import EvalRecord


@dataclasses.dataclass(frozen=True)
class LatticeSpec:
    """Sweep axes + schedule for one experiment lattice (the reference's
    fields; everything not named here comes from ``run_lattice``'s
    ``base_cfg``)."""

    policies: tuple[str, ...] = ("pofl",)
    noise_powers: tuple[float, ...] = (1e-11,)
    alphas: tuple[float, ...] = (0.1,)
    seeds: tuple[int, ...] = (0,)
    n_rounds: int = 100
    eval_every: int = 5
    algorithms: tuple[str, ...] = ("fedavg",)

    @property
    def n_cells(self) -> int:
        return (
            len(self.algorithms)
            * len(self.policies)
            * len(self.noise_powers)
            * len(self.alphas)
            * len(self.seeds)
        )


class LatticeRecords(NamedTuple):
    """Per-cell records, axes (algorithm, policy, noise, alpha, seed, ...).

    The algorithm axis leads (size 1 for one algorithm). ``loss``/``acc``
    are taken at ``eval_rounds`` (an empty E axis without an eval_fn).
    ``eval`` is an :class:`~repro_torch.sim.tasks.EvalRecord` of
    ``(A, P, Nn, Na, Ns, E)`` arrays when the eval_fn is a ``TaskEval``,
    else ``None``; ``health`` a :class:`~repro_torch.core.metrics.RoundHealth`
    of ``(A, P, Nn, Na, Ns, T)`` flags under ``on_nonfinite="skip"``, else
    ``None``; ``diag`` (ROADMAP queue A item 16) is always ``None``.
    """

    axes: dict               # axis name -> coordinate list
    e_com: np.ndarray        # (A, P, Nn, Na, Ns, T)
    e_var: np.ndarray        # (A, P, Nn, Na, Ns, T)
    grad_norm: np.ndarray    # (A, P, Nn, Na, Ns, T)
    n_scheduled: np.ndarray  # (A, P, Nn, Na, Ns, T)
    loss: np.ndarray         # (A, P, Nn, Na, Ns, E)
    acc: np.ndarray          # (A, P, Nn, Na, Ns, E)
    eval_rounds: np.ndarray  # (E,)
    diag: Any = None
    eval: Any = None         # tasks.EvalRecord of (A, P, Nn, Na, Ns, E), or None
    health: Any = None       # RoundHealth of (A, P, Nn, Na, Ns, T), or None

    def cell(self, **coords) -> dict:
        """Select one sub-array per field by axis coordinates, e.g.
        ``records.cell(policy="pofl", seed=0)``."""
        idx: list[Any] = []
        for name in ("algorithm", "policy", "noise_power", "alpha", "seed"):
            if name in coords:
                idx.append(self.axes[name].index(coords.pop(name)))
            else:
                idx.append(slice(None))
        if coords:
            raise ValueError(f"unknown axes {sorted(coords)}")
        sel = tuple(idx)
        return {f: getattr(self, f)[sel] for f in RECORD_SCALARS}


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue A item {item})")


def cell_axes(spec: LatticeSpec, algorithm_ids, policy_ids) -> dict:
    """The flat (B,) cell axes of ``spec`` over these algorithm and policy
    ids, in the reference's fused order (algorithm, then policy-major noise
    × alpha × seed), as :meth:`SimEngine.run_lattice_cells` takes them."""
    grid_al, grid_p, grid_n, grid_a, grid_s = np.meshgrid(
        np.asarray(algorithm_ids, np.int64),
        np.asarray(policy_ids, np.int64),
        np.asarray(spec.noise_powers, np.float32),
        np.asarray(spec.alphas, np.float32),
        np.asarray(spec.seeds, np.int64),
        indexing="ij",
    )
    return dict(noise_b=grid_n.ravel(), alpha_b=grid_a.ravel(), seed_b=grid_s.ravel(),
                policy_b=grid_p.ravel(), algorithm_b=grid_al.ravel())


def run_lattice(
    loss_fn: Callable,
    data: DeviceData,
    params0,
    spec: LatticeSpec,
    base_cfg: POFLConfig | None = None,
    eval_fn: Callable | None = None,
    channel_cfg: ChannelConfig | None = None,
    scenario: str = "static_rayleigh",
    scenario_params: dict | None = None,
    mesh=None,
    fuse_policies: bool = True,
    fuse_algorithms: bool = True,
    obs=None,
    device=None,
) -> LatticeRecords:
    """Run every cell of ``spec`` → :class:`LatticeRecords` (numpy, on the host).

    Args:
      eval_fn: ``params -> (loss, acc)``, run on each cell's params after
        round 0, every ``spec.eval_every`` rounds and the last round; a
        ``TaskEval`` also fills ``LatticeRecords.eval``.
      base_cfg: defaults for everything the spec doesn't sweep; its
        ``policy``/``noise_power``/``alpha``/``seed``/``local_algorithm``
        fields are overridden per cell. ``base_cfg.backend`` selects the
        aggregation of every cell (``pallas_fused``: one batch-kernel launch
        a round on the card) and ``base_cfg.local_steps`` the local SGD
        steps of every cell; ``base_cfg.on_nonfinite="skip"`` quarantines
        each cell's non-finite rounds and fills ``LatticeRecords.health``.
      scenario, scenario_params: the channel process
        (``sim.scenario.make_channel_process``) every cell runs under.
      fuse_policies: True runs all policies in one cell batch; False runs
        one sub-lattice a policy (a constant policy id), so a round launches
        the batch kernel once a policy.
      fuse_algorithms: True runs a multi-algorithm spec in one cell batch;
        False runs one sub-lattice an algorithm, each on the per-cell id
        dispatch of the fused batch (a constant algorithm id, the full
        AlgState). A one-algorithm spec keeps its static dispatch either way.
      device: where the lattice runs; the CUDA card by default (no card and
        no ``device``: it raises).

    Each sub-lattice draws from the same seeds' streams as the fused batch,
    so every cell consumes the same draws. ``mesh`` and ``obs`` are the
    reference's options that are not ported; they raise
    ``NotImplementedError`` naming their ROADMAP item.
    """
    base_cfg = base_cfg or POFLConfig(n_devices=data.n_devices)
    if mesh is not None:
        raise _unported("run_lattice over a mesh (cells or cells × model)", "12")
    if obs is not None:
        raise _unported("run_lattice(obs=...), the diagnostics taps", "6")
    algs = tuple(spec.algorithms)
    if not algs:
        raise ValueError("spec.algorithms must name at least one algorithm")
    alg_ids = [local_update.algorithm_id(a) for a in algs]
    traced_algs = len(algs) > 1
    cfg = dataclasses.replace(
        base_cfg, policy=FUSED_POLICY, n_devices=data.n_devices,
        local_algorithm=FUSED_ALGORITHM if traced_algs else algs[0],
    )

    t_ints = np.arange(spec.n_rounds, dtype=np.int32)
    if eval_fn is not None and spec.n_rounds:
        do_eval = (t_ints % spec.eval_every == 0) | (t_ints == spec.n_rounds - 1)
    else:
        do_eval = np.zeros(spec.n_rounds, bool)

    engine = SimEngine(
        loss_fn, data, cfg, channel_cfg=channel_cfg, scenario=scenario,
        scenario_params=scenario_params, eval_fn=eval_fn, device=device,
    )
    pol_ids = [scheduling.policy_id(p) for p in spec.policies]
    alg_groups = [alg_ids] if fuse_algorithms or not traced_algs else [[a] for a in alg_ids]
    pol_groups = [pol_ids] if fuse_policies else [[p] for p in pol_ids]
    grid_tail = (len(spec.noise_powers), len(spec.alphas), len(spec.seeds), spec.n_rounds)

    def sub_lattice(alg_group, pol_group) -> list[torch.Tensor]:
        """One cell batch → its record fields, each (a, p, Nn, Na, Ns, T)."""
        axes = cell_axes(spec, alg_group, pol_group)
        if not traced_algs:
            axes["algorithm_b"] = None
        recs = engine.run_lattice_cells(params0, t_ints.tolist(), do_eval.tolist(), **axes)
        fields = [getattr(recs, f) for f in RECORD_SCALARS]
        fields += [] if recs.eval is None else list(recs.eval)
        fields += [] if recs.health is None else list(recs.health)
        return [f.reshape(len(alg_group), len(pol_group), *grid_tail) for f in fields]

    blocks = [[sub_lattice(ag, pg) for pg in pol_groups] for ag in alg_groups]
    # the sub-lattices stacked on their axes, then the one device → host
    # transfer of the run
    by_alg = [[torch.cat(f, dim=1) for f in zip(*row)] for row in blocks]
    host = torch.stack([torch.cat(f, dim=0) for f in zip(*by_alg)]).cpu().numpy()
    fields = dict(zip(RECORD_SCALARS, host))
    for f in ("loss", "acc"):
        fields[f] = fields[f][..., do_eval]
    rest = list(host[len(RECORD_SCALARS):])
    ev = None
    if engine.task_eval is not None:
        ev = EvalRecord(*(a[..., do_eval] for a in rest[:len(EvalRecord._fields)]))
        rest = rest[len(EvalRecord._fields):]
    health = RoundHealth(*rest) if cfg.on_nonfinite == "skip" else None
    return LatticeRecords(
        axes={
            "algorithm": list(algs),
            "policy": list(spec.policies),
            "noise_power": list(spec.noise_powers),
            "alpha": list(spec.alphas),
            "seed": list(spec.seeds),
        },
        eval_rounds=t_ints[do_eval],
        eval=ev,
        health=health,
        **fields,
    )
