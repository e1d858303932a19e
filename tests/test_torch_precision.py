"""The K-step state's precision helpers (``repro_torch.sim.precision``), on
the CPU: ``k_step_state`` computes what a lattice round stores as the new
FedDyn/SCAFFOLD state, ``state_errors`` reads exactly the fields the round
changes, and ``STATE_TOL`` parts an fp32 state from a bf16 one here too.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.core.local_update import ALGORITHM_IDS, AlgState
from repro_torch.core.pofl import POFLConfig
from repro_torch.core.scheduling import policy_id
from repro_torch.sim import precision
from repro_torch.sim.engine import FUSED_ALGORITHM, FUSED_POLICY, SimEngine
from repro_torch.sim.tasks import make_model_task

N = 6


def _setup(kind, scenario="dropout"):
    task = make_model_task(kind, n_devices=N, partition="dirichlet_sized", beta=0.4,
                           n_train=20 * N, n_test=8, seed=1, device="cpu")
    cfg = POFLConfig(n_devices=N, n_scheduled=3, batch_size=4, policy=FUSED_POLICY,
                     local_algorithm=FUSED_ALGORITHM, local_steps=2, fedprox_mu=0.1,
                     backend="pallas_fused")
    engine = SimEngine(task.loss_fn, task.data, cfg, device="cpu", scenario=scenario,
                       scenario_params=precision.SCENARIOS[scenario])
    gen = torch.Generator().manual_seed(5)
    alg0 = AlgState(*(1e-3 * torch.randn(len(ALGORITHM_IDS), N, task.dim, generator=gen)
                      for _ in AlgState._fields))
    return task, cfg, engine, alg0


@pytest.mark.parametrize("kind", ["logreg", "cnn"])
def test_k_step_state_is_the_state_a_lattice_round_stores(kind):
    task, cfg, engine, alg0 = _setup(kind)
    draws = next(engine.draws(0, task.dim))
    state = engine.lattice_start(
        task.params0, noise_b=[1e-10] * 4, alpha_b=[0.1] * 4, seed_b=[0] * 4,
        policy_b=[policy_id("pofl")] * 4, algorithm_b=list(ALGORITHM_IDS.values()))
    state = state._replace(alg=alg0, streams=[iter([tuple(draws)])])
    state, _ = engine.lattice_round(state, 1, False)
    got = precision.k_step_state(task, cfg, draws.batch_idx, 1, alg0, torch.float32, "cpu")
    for f_round, f_helper in zip(state.alg, got):
        assert torch.equal(f_round, f_helper)
    # the rows one a cell give the same state when every cell has the same rows
    per_cell = precision.k_step_state(task, cfg, draws.batch_idx.expand(4, -1, -1, -1), 1,
                                      alg0, torch.float32, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(per_cell, got))


def test_state_errors_reads_only_the_changed_fields():
    _, _, _, alg0 = _setup("logreg")
    assert precision.state_errors(alg0, alg0) == {"feddyn_h": 0.0, "scaffold_c": 0.0}
    moved = AlgState(h=alg0.h.clone(), c=alg0.c.clone())
    moved.h[ALGORITHM_IDS["fedavg"]] += 1.0     # a field no round changes: not read
    moved.c[ALGORITHM_IDS["feddyn"]] += 1.0
    assert precision.state_errors(moved, alg0) == {"feddyn_h": 0.0, "scaffold_c": 0.0}
    moved.h[ALGORITHM_IDS["feddyn"]] *= 1.5
    errs = precision.state_errors(moved, alg0)
    assert errs["feddyn_h"] == pytest.approx(0.5) and errs["scaffold_c"] == 0.0


@pytest.mark.parametrize("scenario", ["static_rayleigh", "churn"])
def test_state_tol_parts_fp32_from_bf16(scenario):
    task, cfg, engine, alg0 = _setup("cnn", scenario)
    rows = next(engine.draws(2, task.dim)).batch_idx
    want = precision.k_step_state(task, cfg, rows, 1, alg0, torch.float64, "cpu")
    fp32, bf16 = (precision.state_errors(
        precision.k_step_state(task, cfg, rows, 1, alg0, dtype, "cpu"), want)
        for dtype in (torch.float32, torch.bfloat16))
    assert max(fp32.values()) <= precision.STATE_TOL < min(bf16.values())
