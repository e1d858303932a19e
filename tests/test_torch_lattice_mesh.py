"""``run_lattice(mesh=...)`` of the port held against its unsharded run and
the reference's (CPU).

The lattices are small logreg ones (8 devices) on the reference's draws,
replayed per seed in both the test process and the spawned ranks
(``tests/_torch_mesh_worker.py``, 2 gloo ranks through the port's
launcher). Checked:

  * a one-rank mesh (``mesh=1`` and ``(1, 1)``, in this process) is
    bitwise the unsharded run;
  * 2 ranks over the cells (3 + 3 cells) give the unsharded port's records
    with decisions exact and floats within 1e-6 (bitwise where this was
    written; a rank's smaller cell batch may sum in another order on another
    CPU, so the test holds the tolerance); so do grids that do not split evenly (1, 3 and 5 seeds over 2 ranks,
    the cell axis padded with repeats of its last cell), the per-policy and
    per-algorithm loops, the taps, the quarantine and the scenario axes
    (dropout over Gauss–Markov, K = 2, FedAvg and SCAFFOLD);
  * a ``(1, 2)`` model mesh within 1e-5 (the reference's
    ``_assert_records_close`` of ``tests/test_lattice_2d.py``: decisions and
    accuracy exact, floats within 1e-5; the Eq. 5 statistics are partial
    sums reduced over the model ranks, another order of the sums);
  * the sharded port against the reference's unsharded ``run_lattice`` on
    the same draws within 1e-5, decisions exact (the reference pins its own
    sharded run to its unsharded one);
  * a seed's draws do not depend on how its cells are split: a block of a
    seed's cells gets bitwise the draws the whole grid gives those cells.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_parity import assert_records_match, lattice_case, launch_ranks

from repro_torch.core import pofl as tpofl
from repro_torch.sim import engine as tengine
from repro_torch.sim import multihost as tmh
from repro_torch.sim.lattice import cell_axes

SCENARIO = dict(scenario="dropout",
                scenario_params={"base": "gauss_markov", "corr": 0.9, "p_drop": 0.2})
# name: (spec keywords, config keywords, lattice_case keywords, run keywords, mesh);
# every eval a TaskEval, which goes to the ranks as a value
CASES = {
    "cells": (dict(policies=("pofl", "channel", "deterministic")), {},
              dict(task_eval=True), {}, 2),
    "model": (dict(policies=("pofl", "channel", "deterministic")), {},
              dict(task_eval=True), {}, (1, 2)),
    "seeds_1": (dict(policies=("pofl",)), {}, dict(seeds=(0,), task_eval=True), {}, 2),
    "seeds_3": (dict(policies=("pofl",)), {}, dict(seeds=(0, 1, 2), task_eval=True), {}, 2),
    "seeds_5": (dict(policies=("pofl",)), {}, dict(seeds=(0, 1, 2, 3, 4), task_eval=True), {},
                2),
    "scenario": (dict(policies=("pofl", "channel"), algorithms=("fedavg", "scaffold")),
                 dict(local_steps=2, on_nonfinite="skip"),
                 dict(task_eval=True, diagnostics=True, **SCENARIO), {}, 2),
    "scenario_loops": (dict(policies=("pofl", "channel"), algorithms=("fedavg", "scaffold")),
                       dict(local_steps=2, on_nonfinite="skip"),
                       dict(task_eval=True, diagnostics=True, **SCENARIO),
                       dict(fuse_policies=False, fuse_algorithms=False), 2),
}
# the cases also run by the reference, unsharded (the same lattice as their port run)
WITH_REFERENCE = ("cells", "scenario")


def _assert_records_close(got, want, rtol):
    """Decisions and accuracy exact, float fields within ``rtol`` of each
    value (the reference's ``_assert_records_close``, with the port's
    optional subtrees)."""
    assert got.axes == want.axes
    np.testing.assert_array_equal(got.eval_rounds, want.eval_rounds)
    for f in ("n_scheduled", "acc"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in ("e_com", "e_var", "grad_norm", "loss"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=rtol, atol=1e-12,
                                   err_msg=f)
    for sub in ("diag", "eval", "health"):
        a, b = getattr(got, sub), getattr(want, sub)
        assert (a is None) == (b is None), sub
        for fa, fb in zip(a or (), b or ()):
            np.testing.assert_allclose(fa, fb, rtol=rtol, atol=1e-12, err_msg=sub)


def _records_equal(a, b) -> bool:
    leaves = [(getattr(a, f), getattr(b, f)) for f in a._fields if f != "axes"]
    for x, y in leaves:
        if isinstance(x, tuple):
            leaves += list(zip(x, y))
        elif not (x is None and y is None) and not np.array_equal(x, y):
            return False
    return True


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's unsharded port run (and, for ``WITH_REFERENCE``, the
    reference's) in this process, and its sharded run over 2 spawned ranks
    on the same draws → {name: (sharded, unsharded port, reference)}."""
    unsharded, reference, inputs = {}, {}, {}
    for name, (spec_kw, cfg_kw, case_kw, run_kw, mesh) in CASES.items():
        with pytest.MonkeyPatch.context() as mp:
            case = lattice_case(mp, spec_kw, cfg_kw, **case_kw)
            drawn: dict = {}
            replayed = tengine.SimEngine.next_draws

            def record(self, stream, dim, replayed=replayed, drawn=drawn):
                out = replayed(self, stream, dim)
                seed, rnd = (int(x) for x in stream.rng)
                drawn.setdefault(seed, {})[rnd] = tuple(out[1])
                return out

            mp.setattr(tengine.SimEngine, "next_draws", record)
            unsharded[name] = case.port(**run_kw)
            if name in WITH_REFERENCE:
                reference[name] = case.reference(**run_kw)
        diag = case_kw.get("diagnostics")
        kw = dict(case.port_kw, **run_kw)
        if diag:
            from repro_torch.obs.config import ObsConfig

            kw["obs"] = ObsConfig(diagnostics=True)
        inputs[name] = {"kw": kw, "mesh": mesh,
                        "draws": {s: [rounds[r] for r in sorted(rounds)]
                                  for s, rounds in drawn.items()}}
    sharded = launch_ranks("lattice", 2, inputs, tmp_path_factory.mktemp("mesh"))
    return {name: (sharded[name], unsharded[name], reference.get(name)) for name in CASES}


@pytest.mark.parametrize("name", ["cells", "seeds_1", "seeds_3", "seeds_5", "scenario",
                                  "scenario_loops"])
def test_two_cell_ranks_give_the_unsharded_records(runs, name):
    got, want, _ = runs[name]
    _assert_records_close(got, want, rtol=1e-6)


def test_model_mesh_is_within_the_reference_tolerance_of_the_unsharded_run(runs):
    got, want, _ = runs["model"]
    _assert_records_close(got, want, rtol=1e-5)


@pytest.mark.parametrize("name", ["cells", "model", "scenario"])
def test_sharded_port_matches_the_reference_unsharded(runs, name):
    got = runs[name][0]
    want = runs["cells" if name == "model" else name][2]
    assert_records_match(got, want)


def test_sharded_loops_match_the_fused_grid(runs):
    """The per-policy and per-algorithm loops over 2 ranks against the
    fused grid over 2 ranks (the port's loops hold to its fused grid at
    1e-6 on the CPU)."""
    _assert_records_close(runs["scenario_loops"][0], runs["scenario"][0], rtol=1e-6)


@pytest.fixture
def one_rank():
    assert not dist.is_initialized()
    tmh.ensure_process_group(device="cpu")
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("mesh", [1, (1, 1)])
def test_one_rank_mesh_is_bitwise_the_unsharded_run(monkeypatch, one_rank, mesh):
    case = lattice_case(monkeypatch, dict(policies=("pofl", "importance")), {},
                        task_eval=True, diagnostics=True)
    want = case.port()
    got = case.port(mesh=mesh)
    assert _records_equal(got, want)
    assert got.axes == want.axes


def test_a_seeds_draws_do_not_depend_on_how_its_cells_are_split():
    """Each cell of a block (a rank's slice of the cell grid) gets bitwise
    the draws the whole grid's round gives it: the streams are per seed."""
    from repro_torch.sim.lattice import LatticeSpec
    from repro_torch.sim.tasks import make_model_task

    task = make_model_task("logreg", n_devices=6, n_train=60, n_test=12, device="cpu")
    cfg = tpofl.POFLConfig(n_devices=6, n_scheduled=2, policy=tpofl.FUSED_POLICY,
                           local_steps=2)
    spec = LatticeSpec(policies=("pofl", "channel", "importance"), seeds=(3, 9), n_rounds=2)
    engine = tengine.SimEngine(task.loss_fn, task.data, cfg, scenario="churn", device="cpu")
    axes = cell_axes(spec, [0], [0, 2, 1])
    axes["algorithm_b"] = None
    seen = []

    def capture(loss_fn, data, cfg, params_c, h_c, batch_idx_c, sched_c, z_c, *a, **k):
        seen.append((h_c, batch_idx_c, sched_c, z_c, k.get("avail_c")))
        return tpofl.round_algorithm_cells(loss_fn, data, cfg, params_c, h_c, batch_idx_c,
                                           sched_c, z_c, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine, "round_algorithm_cells", capture)
        full = engine.lattice_start(task.params0, **axes)
        for block in ([1, 4], [0, 2, 3], [5]):
            seen.clear()
            state, sub = full, engine.lattice_start(
                task.params0, **{k: None if v is None else v[block] for k, v in axes.items()})
            for t in range(spec.n_rounds):
                state, _ = engine.lattice_round(state, t, False)
                sub, _ = engine.lattice_round(sub, t, False)
                whole, part = seen[-2], seen[-1]
                for w, p in zip(whole, part):
                    assert torch.equal(w[block], p)
