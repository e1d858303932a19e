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
``obs=ObsConfig(diagnostics=True)`` adds the per-round taps
(``LatticeRecords.diag``, a ``RoundDiagnostics`` of (A, P, Nn, Na, Ns, T)
arrays); every run is a ``lattice.sweep`` span and emits one ``lattice.run``
event per engine dispatch, and a run with the taps one
``lattice.diagnostics`` event of their per-round means, as the reference's
do (``repro_torch.obs``; what the events' fields mean in the port:
``repro_torch.sim.engine``).

``mesh`` spreads the cells over the ranks of a process group
(``torch.distributed``, one rank a device; ``sim.multihost``): a
``DeviceMesh`` with axes ``("cells",)`` or ``("cells", "model")``, an int
(:func:`make_cell_mesh`) or a ``(cells, model)`` pair
(:func:`make_cell_model_mesh`). Every rank makes the same call. The flat
cell axis of each (sub-)lattice is padded to a multiple of the cells axis
with repeats of its last cell, each cells rank runs its contiguous block
(its seeds' draw streams are the unsharded run's: a seed's draws do not
depend on which of its cells a rank holds), the records come to every
rank in one gather (``sim.multihost.gather_records``) and the repeats are
dropped, so every rank returns the same ``LatticeRecords``. A ``model``
axis of more than one rank also shards each cell's aggregation over D
(``core.pofl.ModelShard``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import local_update, scheduling
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.pofl import DeviceData, POFLConfig
from repro_torch.obs.config import ObsConfig
from repro_torch.obs.registry import metric_value
from repro_torch.obs.sink import emit
from repro_torch.obs.spans import span
from repro_torch.sim.engine import (
    FUSED_ALGORITHM, FUSED_POLICY, RECORD_SCALARS, RoundRecord, SimEngine, zip_records,
)
from repro_torch.sim.multihost import (
    LAUNCHER_HINT, axis_size, cell_model_mesh_over, cells_mesh_over, gather_records,
    mesh_spans_processes, shard_to_global,
)

_LOCAL_MESH_HINT = f"(one rank a device; {LAUNCHER_HINT})"


def make_cell_model_mesh(cells: int | None = None, model: int = 1):
    """A 2-D ``("cells", "model")`` mesh over the process group's first
    ``cells × model`` ranks, cells-major (``None``: every full group of
    ``model`` ranks).

    The cells axis splits the flattened lattice grid as the 1-D mesh does;
    a ``model`` axis of more than one rank also splits each cell's flat
    model dimension D for the aggregation (``core.pofl.ModelShard``). A
    single process is a one-rank group (made here if none exists); more
    ranks come from ``python -m repro_torch.launch.distributed``, and asking
    for more than the group holds raises ``ValueError``.
    """
    return cell_model_mesh_over(cells, model, hint=_LOCAL_MESH_HINT)


def make_cell_mesh(n_devices: int | None = None):
    """A 1-D ``("cells",)`` mesh over the process group's first
    ``n_devices`` ranks (``None``: every rank); one rank a device, so the
    reference's local devices are the group's ranks here (a single process
    is a one-rank mesh, the group made here if none exists)."""
    return cells_mesh_over(n_devices, hint=_LOCAL_MESH_HINT)


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
    ``None``; ``diag`` a :class:`~repro_torch.core.metrics.RoundDiagnostics`
    of ``(A, P, Nn, Na, Ns, T)`` taps under ``ObsConfig(diagnostics=True)``,
    else ``None``.
    """

    axes: dict               # axis name -> coordinate list
    e_com: np.ndarray        # (A, P, Nn, Na, Ns, T)
    e_var: np.ndarray        # (A, P, Nn, Na, Ns, T)
    grad_norm: np.ndarray    # (A, P, Nn, Na, Ns, T)
    n_scheduled: np.ndarray  # (A, P, Nn, Na, Ns, T)
    loss: np.ndarray         # (A, P, Nn, Na, Ns, E)
    acc: np.ndarray          # (A, P, Nn, Na, Ns, E)
    eval_rounds: np.ndarray  # (E,)
    diag: Any = None         # core.metrics.RoundDiagnostics of (A, P, Nn, Na, Ns, T), or None
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
    obs: ObsConfig | None = None,
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
      obs: ``ObsConfig(diagnostics=True)`` computes the per-round taps
        (:class:`~repro_torch.core.metrics.RoundDiagnostics`) in every cell
        and returns them as ``LatticeRecords.diag``; ``None``/default: the
        rounds issue the ops and give the records they did before obs
        existed. Every sweep also times itself (``span("lattice.sweep")``)
        and emits one ``lattice.run`` event per engine dispatch when
        ``REPRO_OBS_DIR`` is set.
      device: where the lattice runs; the CUDA card by default (no card and
        no ``device``: it raises).

      mesh: ``None``, a ``DeviceMesh`` with axes ``("cells",)`` or
        ``("cells", "model")``, an int (:func:`make_cell_mesh`) or a
        ``(cells, model)`` pair (:func:`make_cell_model_mesh`): every rank
        of it makes the same call, runs its block of the cells (module
        docstring) and returns the same records. The default ``device`` is
        then this rank's card.

    Each sub-lattice draws from the same seeds' streams as the fused batch,
    so every cell consumes the same draws.
    """
    base_cfg = base_cfg or POFLConfig(n_devices=data.n_devices)
    if isinstance(mesh, int) and not isinstance(mesh, bool):
        mesh = make_cell_mesh(mesh)
    elif isinstance(mesh, tuple):
        mesh = make_cell_model_mesh(*mesh)
    if mesh is not None and mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the lattice's mesh")
    n_shards = 1 if mesh is None else axis_size(mesh, "cells")
    algs = tuple(spec.algorithms)
    if not algs:
        raise ValueError("spec.algorithms must name at least one algorithm")
    alg_ids = [local_update.algorithm_id(a) for a in algs]
    traced_algs = len(algs) > 1
    cfg = dataclasses.replace(
        base_cfg, policy=FUSED_POLICY, n_devices=data.n_devices,
        local_algorithm=FUSED_ALGORITHM if traced_algs else algs[0],
    )
    do_eval, eval_rounds = eval_schedule(spec, eval_fn is not None)
    t_ints = np.arange(spec.n_rounds, dtype=np.int32)

    engine = SimEngine(
        loss_fn, data, cfg, channel_cfg=channel_cfg, scenario=scenario,
        scenario_params=scenario_params, eval_fn=eval_fn, device=device, obs=obs, mesh=mesh,
    )
    multihost = mesh_spans_processes(mesh)
    pol_ids = [scheduling.policy_id(p) for p in spec.policies]
    alg_groups = [alg_ids] if fuse_algorithms or not traced_algs else [[a] for a in alg_ids]
    pol_groups = [pol_ids] if fuse_policies else [[p] for p in pol_ids]
    grid_tail = (len(spec.noise_powers), len(spec.alphas), len(spec.seeds), spec.n_rounds)

    def sub_lattice(alg_group, pol_group) -> RoundRecord:
        """One cell batch → its records, each leaf (a, p, Nn, Na, Ns, T)
        (on the device; on a mesh, this rank's block run and every rank's
        gathered to the host), and its ``lattice.run`` event."""
        axes = cell_axes(spec, alg_group, pol_group)
        if not traced_algs:
            axes["algorithm_b"] = None
        n_cells = len(axes["seed_b"])
        if mesh is not None:  # repeats of the last cell, then this rank's block
            pad = (-n_cells) % n_shards
            axes = {k: None if v is None else
                    shard_to_global(np.concatenate([v, np.repeat(v[-1:], pad)]), mesh)
                    for k, v in axes.items()}
        warm, builds0 = metric_value("engine.lattice_runs") > 0, _nvcc_builds()
        recs = engine.run_lattice_cells(params0, t_ints.tolist(), do_eval.tolist(), **axes)
        which = {}
        if len(pol_groups) > 1:
            which["policy"] = spec.policies[pol_ids.index(pol_group[0])]
        if len(alg_groups) > 1:
            which["algorithm"] = algs[alg_ids.index(alg_group[0])]
        emit_run(spec, n_cells, len(alg_group), warm, _nvcc_builds() - builds0,
                 multihost=multihost, fused=fuse_policies, **which)
        if mesh is not None:
            recs = zip_records(lambda f: f[:n_cells],
                               gather_records(records_to_host(recs), mesh))
        return zip_records(lambda f: f.reshape(len(alg_group), len(pol_group), *grid_tail),
                           recs)

    with span("lattice.sweep", cells=spec.n_cells, fused=fuse_policies,
              policies=len(spec.policies), algorithms=len(algs), multihost=multihost):
        blocks = [[sub_lattice(ag, pg) for pg in pol_groups] for ag in alg_groups]
        # the sub-lattices stacked on their axes; unsharded, then the one
        # device → host transfer of the run
        by_alg = [zip_records(lambda *f: _cat(f, 1), *row) for row in blocks]
        grid = zip_records(lambda *f: _cat(f, 0), *by_alg)
        if mesh is None:
            grid = records_to_host(grid)
    if grid.diag is not None:
        emit_diagnostics(spec, grid.diag)
    return assemble_records(spec, grid, do_eval, eval_rounds)


def _cat(parts, dim: int):
    """Record leaves joined along ``dim``: device tensors, or the host
    arrays of a sharded run."""
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=dim)
    return np.concatenate(parts, axis=dim)


def eval_schedule(spec: LatticeSpec, has_eval: bool) -> tuple[np.ndarray, np.ndarray]:
    """``run_lattice``'s eval schedule → ``(do_eval (T,) bool, eval_rounds)``:
    round 0, every ``eval_every`` rounds and the last (none without an
    eval_fn)."""
    t_ints = np.arange(spec.n_rounds, dtype=np.int32)
    if has_eval and spec.n_rounds:
        do_eval = (t_ints % spec.eval_every == 0) | (t_ints == spec.n_rounds - 1)
    else:
        do_eval = np.zeros(spec.n_rounds, bool)
    return do_eval, t_ints[do_eval]


def _nvcc_builds() -> int:
    """The ``nvcc`` builds of kernels this process has made
    (``repro_torch.kernels.build``)."""
    return metric_value("span.kernels.nvcc.count")


def emit_run(spec: LatticeSpec, cells: int, algorithms: int, warm: bool, builds: int,
             multihost: bool = False, **fields) -> None:
    """One ``lattice.run`` event, the reference's fields: the port traces
    and compiles no program (``trace_delta`` and ``engine_compiles`` 0),
    and ``compile_delta`` is the kernels' ``nvcc`` builds during the call;
    ``multihost`` says the cells were spread over more than one rank."""
    emit("lattice", "lattice.run", cells=cells, n_rounds=spec.n_rounds, multihost=multihost,
         algorithms=algorithms, warm=warm, trace_delta=0, compile_delta=builds,
         engine_compiles=0, **fields)


def records_to_host(recs: RoundRecord) -> RoundRecord:
    """A record tree of device tensors of one shape → the same tree of
    numpy arrays, in one device → host transfer."""
    leaves: list = []
    zip_records(leaves.append, recs)
    host = iter(torch.stack(leaves).cpu().numpy())
    return zip_records(lambda _: next(host), recs)


def emit_diagnostics(spec: LatticeSpec, diag) -> None:
    """The ``lattice.diagnostics`` event: each tap's mean over the cells of
    a (…, T) ``RoundDiagnostics``, by round."""
    emit("diag", "lattice.diagnostics", cells=spec.n_cells, n_rounds=spec.n_rounds,
         taps={f: np.mean(a, axis=tuple(range(a.ndim - 1))).tolist()
               for f, a in diag._asdict().items()})


def assemble_records(spec: LatticeSpec, grid, do_eval: np.ndarray,
                     eval_rounds: np.ndarray) -> LatticeRecords:
    """A host ``RoundRecord`` whose leaves are (A, P, Nn, Na, Ns, T) arrays →
    :class:`LatticeRecords`: ``loss``/``acc`` and the ``eval`` subtree
    taken at the eval rounds."""
    fields = {f: getattr(grid, f) for f in RECORD_SCALARS}
    for f in ("loss", "acc"):
        fields[f] = fields[f][..., do_eval]
    ev = None if grid.eval is None else type(grid.eval)(*(a[..., do_eval] for a in grid.eval))
    return LatticeRecords(
        axes={
            "algorithm": list(spec.algorithms),
            "policy": list(spec.policies),
            "noise_power": list(spec.noise_powers),
            "alpha": list(spec.alphas),
            "seed": list(spec.seeds),
        },
        eval_rounds=eval_rounds,
        diag=grid.diag,
        eval=ev,
        health=grid.health,
        **fields,
    )


def fused_flat_grid(spec: LatticeSpec) -> tuple:
    """The policy-fused flat cell grid of ``spec`` as ``(noise, alpha, seed,
    policy_id, algorithm_id-or-None)`` (B,) arrays, in the order
    ``run_lattice`` runs the cells (algorithm-major, then policy-major,
    then noise × alpha × seed), so a flat index reshapes to the (A, P, Nn,
    Na, Ns) grid; ``algorithm_id`` is ``None`` for a one-algorithm spec
    (the static dispatch). ``sim.resilience`` shards THIS order."""
    axes = cell_axes(spec, [local_update.algorithm_id(a) for a in spec.algorithms],
                     [scheduling.policy_id(p) for p in spec.policies])
    return (axes["noise_b"], axes["alpha_b"], axes["seed_b"], axes["policy_b"],
            axes["algorithm_b"] if len(spec.algorithms) > 1 else None)


def assemble_flat_fused(spec: LatticeSpec, flat_records, do_eval: np.ndarray,
                        eval_rounds: np.ndarray) -> LatticeRecords:
    """A host ``RoundRecord`` of (B, T) arrays in :func:`fused_flat_grid`
    order (B = ``spec.n_cells``) → :class:`LatticeRecords`, as
    ``run_lattice``'s fused path assembles them."""
    shape = (len(spec.algorithms), len(spec.policies), len(spec.noise_powers),
             len(spec.alphas), len(spec.seeds), spec.n_rounds)
    return assemble_records(spec, zip_records(lambda a: np.asarray(a).reshape(shape),
                                              flat_records), do_eval, eval_rounds)
