"""The port's non-finite quarantine (``POFLConfig.on_nonfinite="skip"``)
held against the live reference on identical inputs and draws (CPU).

Per round (``round_algorithm`` with the reference's ``fault_round`` hook
firing or not, over FedAvg, FedDyn and SCAFFOLD), per run
(``SimEngine.run_with_history``) and per lattice (``run_lattice``, the
reference's draws replayed per seed). The runs use a toy task whose
gradient overflows fp32 on its own: the loss is ``mean(exp(x·w))`` over 16
features, 8 devices of 10 samples, 3 scheduled, batch 4, η0 = 0.1; at
σ_z² = 1e-6 the receiver noise (which scales with √V_g, so with the
gradient) drives some cells' ``exp`` past fp32 within 6 rounds, at 1e-10 no
cell leaves the finite range. Tolerance: finite floats within 1e-5 of the
reference relative to their scale, the positions of non-finite values, the
health flags, masks and |S| exactly equal.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    assert_close, cfg_to_torch, data_to_torch, jax_batch_rows, jax_engine_draws, jax_noise,
    jax_sched_draw, reference_task, replay_per_seed, t,
)
from jax.flatten_util import ravel_pytree as jax_ravel

from repro.core import pofl as jpofl
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.core.local_update import AlgState as JAlgState
from repro.sim import engine as jengine
from repro.sim import lattice as jlattice
from repro_torch.convert import params_from_jax
from repro_torch.core import pofl as tpofl
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.local_update import ALGORITHM_IDS
from repro_torch.core.local_update import AlgState as TAlgState
from repro_torch.core.metrics import RoundHealth
from repro_torch.flatten_util import ravel_pytree, tree_map
from repro_torch.sim import engine as tengine
from repro_torch.sim import lattice as tlattice
from repro_torch.sim.tasks import make_model_task

N, S = 8, 3

# -- one round ------------------------------------------------------------------

# (algorithm, K local steps): the stateless one and the two with a state
ALGS = [("fedavg", 1), ("feddyn", 2), ("scaffold", 2)]


@pytest.mark.parametrize("fault", ["fires", "idle", "propagates"])
@pytest.mark.parametrize("alg,k_steps", ALGS)
def test_round_quarantine_matches_reference(alg, k_steps, fault, monkeypatch):
    """``round_algorithm`` with ``fault_round`` set to this round (``fires``:
    the round is quarantined; ``propagates``: the same under "propagate",
    whose NaN reaches the params), or to another (``idle``), from a non-zero
    FedDyn/SCAFFOLD state."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    data, jparams, jloss, _, tloss, *_ = reference_task("logreg", N, per_device=8)
    jcfg = jpofl.POFLConfig(
        n_devices=N, n_scheduled=S, batch_size=2, backend="pallas_fused",
        local_algorithm=alg, local_steps=k_steps, noise_power=1e-10,
        on_nonfinite="propagate" if fault == "propagates" else "skip")
    dim = jax_ravel(jparams)[0].size
    d = next(jax_engine_draws(jcfg, JChannelConfig(n_devices=N, noise_power=1e-10),
                              data, dim, seed=2))
    k_batch, k_sched, k_noise = jax.random.split(jax.random.PRNGKey(5), 3)
    field = {"feddyn": "h", "scaffold": "c"}.get(alg)
    state0 = None if field is None else 0.01 * jax.random.normal(jax.random.PRNGKey(6),
                                                                 (N, dim))
    fault_round = 4 if fault == "idle" else 3
    want_params, want_state, want_m = jpofl.round_algorithm(
        jloss, data, jcfg, jparams, jnp.asarray(d.h.numpy()), k_batch, k_sched, k_noise,
        jnp.float32(3), alg_state=None if field is None else JAlgState(**{field: state0}),
        fault_round=jnp.int32(fault_round),
    )
    params0 = params_from_jax(jparams, device="cpu")
    tstate0 = None if field is None else TAlgState(**{field: t(state0)})
    got_params, got_state, got_m = tpofl.round_algorithm(
        tloss, data_to_torch(data), cfg_to_torch(jcfg), params0, d.h,
        jax_batch_rows(jcfg, data, k_batch), jax_sched_draw(jcfg, k_sched),
        jax_noise(k_noise, dim), 3, alg_state=tstate0, fault_round=fault_round,
    )
    flat, want_flat = ravel_pytree(got_params)[0], jax_ravel(want_params)[0]
    if fault == "propagates":
        assert got_m.health is None and want_m.health is None
        assert torch.isnan(flat).all() and bool(jnp.isnan(want_flat).all())
    else:
        assert float(got_m.health.nonfinite) == float(want_m.health.nonfinite) == (
            1.0 if fault == "fires" else 0.0)
        assert_close(flat, want_flat)
    if fault == "fires":  # held exactly: the round never happened for the model
        assert torch.equal(flat, ravel_pytree(params0)[0])
        if field is not None:
            assert torch.equal(getattr(got_state, field), getattr(tstate0, field))
    if field is not None and fault != "propagates":
        assert_close(getattr(got_state, field), getattr(want_state, field))
    assert got_m._fields == want_m._fields
    assert float(got_m.loss) == float(want_m.loss) == 0.0
    assert got_m.diag is None and want_m.diag is None
    assert float(got_m.n_scheduled) == float(want_m.n_scheduled)
    for f in ("e_com", "e_var", "a_scalar"):
        assert_close(getattr(got_m, f), getattr(want_m, f))
    if fault == "idle":
        assert_close(got_m.grad_norm, want_m.grad_norm)
    else:
        assert torch.isnan(got_m.grad_norm) and bool(jnp.isnan(want_m.grad_norm))


def test_cell_round_quarantines_only_the_poisoned_cell():
    """``round_algorithm_cells`` under "skip" with cell 1's ŷ poisoned: cell
    1 keeps its params and AlgState bitwise, the other cells are bitwise the
    unpoisoned round's, and only cell 1 is flagged; under "propagate" cell
    1's params go NaN."""
    task = make_model_task("logreg", n_devices=6, n_train=120, n_test=12, device="cpu")
    cfg = tpofl.POFLConfig(n_devices=6, n_scheduled=3, batch_size=4, local_steps=2,
                           backend="pallas_fused", policy=tengine.FUSED_POLICY,
                           local_algorithm=tengine.FUSED_ALGORITHM)
    engine = tengine.SimEngine(task.loss_fn, task.data, cfg, device="cpu")
    d = next(engine.draws(0, task.dim))
    cells = len(ALGORITHM_IDS)
    params = tree_map(lambda p: p.expand(cells, *p.shape).clone(), task.params0)
    gen = torch.Generator().manual_seed(1)
    state0 = TAlgState(*(1e-3 * torch.randn(cells, 6, task.dim, generator=gen)
                         for _ in TAlgState._fields))
    draws = [x.expand(cells, *x.shape) for x in d[:4]]

    def run(on_nonfinite, fault):
        return tpofl.round_algorithm_cells(
            task.loss_fn, task.data, dataclasses.replace(cfg, on_nonfinite=on_nonfinite),
            params, *draws, 2, torch.full((cells,), 1e-10), torch.full((cells,), 0.1),
            torch.zeros(cells, dtype=torch.int64), alg_state_c=state0,
            algorithm_id_c=torch.tensor(list(ALGORITHM_IDS.values())),
            fault_round_c=torch.tensor(fault))

    clean_p, clean_s, clean_m = run("skip", [-1] * cells)
    got_p, got_s, got_m = run("skip", [-1, 2, -1, -1])
    flat = {k: torch.stack([ravel_pytree(tree_map(lambda p, c=c: p[c], tree))[0]
                            for c in range(cells)])
            for k, tree in (("clean", clean_p), ("got", got_p), ("in", params))}
    assert torch.equal(got_m.health.nonfinite, torch.tensor([0.0, 1.0, 0.0, 0.0]))
    assert not clean_m.health.nonfinite.any()
    assert torch.equal(flat["got"][1], flat["in"][1])
    for f in TAlgState._fields:
        assert torch.equal(getattr(got_s, f)[1], getattr(state0, f)[1])
    for c in (0, 2, 3):
        assert torch.equal(flat["got"][c], flat["clean"][c])
        for f in TAlgState._fields:
            assert torch.equal(getattr(got_s, f)[c], getattr(clean_s, f)[c])
    assert torch.isnan(got_m.grad_norm[1]) and torch.isfinite(got_m.grad_norm[[0, 2, 3]]).all()
    prop_p, _, prop_m = run("propagate", [-1, 2, -1, -1])
    assert prop_m.health is None
    assert torch.isnan(ravel_pytree(tree_map(lambda p: p[1], prop_p))[0]).all()


def test_on_nonfinite_is_validated_everywhere():
    task = make_model_task("logreg", n_devices=4, n_train=40, n_test=8, device="cpu")
    cfg = tpofl.POFLConfig(n_devices=4, n_scheduled=2, on_nonfinite="explode")
    with pytest.raises(ValueError, match="on_nonfinite"):
        tengine.SimEngine(task.loss_fn, task.data, cfg, device="cpu")
    with pytest.raises(ValueError, match="on_nonfinite"):
        tlattice.run_lattice(task.loss_fn, task.data, task.params0,
                             tlattice.LatticeSpec(n_rounds=1), base_cfg=cfg, device="cpu")
    d = next(tengine.SimEngine(task.loss_fn, task.data, dataclasses.replace(
        cfg, on_nonfinite="skip"), device="cpu").draws(0, task.dim))
    with pytest.raises(ValueError, match="on_nonfinite"):
        tpofl.round_algorithm(task.loss_fn, task.data, cfg, task.params0, d.h, d.batch_idx,
                              d.sched, d.z, 0)


# -- runs that go non-finite on their own ------------------------------------------

TOY_M, TOY_D = 10, 16


def _toy_task():
    """The toy task of the module docstring → (reference data, params, jax
    loss, torch loss)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(N, TOY_M, TOY_D)) / np.sqrt(TOY_D)).astype(np.float32)
    data = jpofl.DeviceData(jnp.asarray(x), jnp.zeros((N, TOY_M), jnp.int32))

    def jloss(params, xb, yb):
        return jnp.mean(jnp.exp(xb @ params["w"]))

    def tloss(params, xb, yb):
        return torch.exp(xb @ params["w"]).mean()

    return data, {"w": jnp.zeros(TOY_D)}, jloss, tloss


def _assert_same_nonfinite_and_close(got, want):
    """Per cell: non-finite values at the same places, the finite ones within
    1e-5 of the reference relative to their scale."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    for idx in np.ndindex(want.shape[:-1]):
        keep = np.isfinite(want[idx])
        assert_close(got[idx][keep], want[idx][keep])


TOY_CFG = dict(n_devices=N, n_scheduled=S, batch_size=4, backend="pallas_fused")


@pytest.mark.parametrize("algorithms,k_steps", [(("fedavg",), 1), (("feddyn", "scaffold"), 2)])
def test_skip_lattice_matches_reference_where_cells_diverge(algorithms, k_steps, monkeypatch):
    """``run_lattice`` under "skip" on the toy task: 2 policies × σ_z² 1e-10
    and 1e-6 × 2 seeds, 6 rounds. Under "propagate" some cells go non-finite
    on their own and the rest stay finite; under "skip" records and
    ``health`` match the reference's, every cell that stayed finite is
    flagged in no round, and the rounds between flagged ones are finite."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    data, jparams, jloss, tloss = _toy_task()
    spec = dict(algorithms=algorithms, policies=("pofl", "channel"),
                noise_powers=(1e-10, 1e-6), alphas=(0.1,), seeds=(0, 1), n_rounds=6)
    jccfg = JChannelConfig(n_devices=N)
    out = {}
    for mode in ("propagate", "skip"):
        jcfg = jpofl.POFLConfig(local_steps=k_steps, on_nonfinite=mode, **TOY_CFG)
        want = jlattice.run_lattice(jloss, data, jparams, jlattice.LatticeSpec(**spec),
                                    base_cfg=jcfg, channel_cfg=jccfg)
        replay_per_seed(monkeypatch, jcfg, jccfg, data)
        got = tlattice.run_lattice(tloss, data_to_torch(data),
                                   params_from_jax(jparams, device="cpu"),
                                   tlattice.LatticeSpec(**spec), base_cfg=cfg_to_torch(jcfg),
                                   channel_cfg=ChannelConfig(n_devices=N), device="cpu")
        out[mode] = got, want
    (prop, prop_ref), (got, want) = out["propagate"], out["skip"]
    assert prop.health is None and prop_ref.health is None
    diverged = ~np.isfinite(prop_ref.grad_norm).all(axis=-1)
    assert diverged.any() and not diverged.all()
    assert isinstance(got.health, RoundHealth)
    np.testing.assert_array_equal(got.health.nonfinite, np.asarray(want.health.nonfinite))
    flagged = got.health.nonfinite == 1.0
    assert flagged.any(axis=-1).tolist() == diverged.tolist()
    for f in ("e_com", "e_var", "grad_norm"):
        _assert_same_nonfinite_and_close(getattr(got, f), getattr(want, f))
        assert np.isfinite(getattr(got, f)[~flagged]).all()  # between flagged rounds too
        _assert_same_nonfinite_and_close(getattr(prop, f), getattr(prop_ref, f))
    unflagged = ~flagged
    np.testing.assert_array_equal(got.n_scheduled[unflagged],
                                  np.asarray(want.n_scheduled)[unflagged])
    for f in ("e_com", "e_var", "grad_norm", "n_scheduled"):  # finite cells: unchanged
        np.testing.assert_array_equal(getattr(got, f)[~diverged],
                                      getattr(prop, f)[~diverged])


@pytest.mark.parametrize("alg,k_steps", [("fedavg", 1), ("feddyn", 2)])
def test_run_with_history_skip_matches_reference(alg, k_steps, monkeypatch):
    """``SimEngine.run_with_history`` under "skip" on the toy task's
    (``channel``, σ_z² 1e-6, seed 1) cell, 6 rounds (non-finite from round 2
    under "propagate"): the same rounds go non-finite,
    the params and the AlgState are held through them, and the final params
    match the reference's and are finite."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    data, jparams, jloss, tloss = _toy_task()
    jcfg = jpofl.POFLConfig(policy="channel", noise_power=1e-6, local_algorithm=alg,
                            local_steps=k_steps, on_nonfinite="skip", seed=1, **TOY_CFG)
    jccfg = JChannelConfig(n_devices=N, noise_power=1e-6)
    want_params, want = jengine.SimEngine(jloss, data, jcfg, channel_cfg=jccfg) \
        .run_with_history(jparams, 6)

    def replay(self, seed, dim):
        return jax_engine_draws(jcfg, jccfg, data, dim, seed)

    monkeypatch.setattr(tengine.SimEngine, "draws", replay)
    engine = tengine.SimEngine(tloss, data_to_torch(data), cfg_to_torch(jcfg),
                               channel_cfg=ChannelConfig(n_devices=N, noise_power=1e-6),
                               device="cpu")
    got_params, got = engine.run_with_history(params_from_jax(jparams, device="cpu"), 6)
    assert not np.isfinite(want.e_var).all()  # the cell does go non-finite
    for f in ("e_com", "e_var"):
        _assert_same_nonfinite_and_close(np.asarray([getattr(got, f)]),
                                         np.asarray([getattr(want, f)]))
    flat = ravel_pytree(got_params)[0]
    assert torch.isfinite(flat).all()
    assert_close(flat, jax_ravel(want_params)[0])


# -- "propagate" adds nothing ---------------------------------------------------------


def test_propagate_records_carry_no_health_and_skip_changes_no_finite_run():
    """Under "propagate" ``health`` is ``None`` on ``RoundMetrics``,
    ``RoundRecord`` and ``LatticeRecords``; on a run that stays finite
    "skip" changes no record bit and flags no round."""
    task = make_model_task("logreg", n_devices=6, n_train=60, n_test=12, device="cpu")
    spec = tlattice.LatticeSpec(policies=("pofl", "channel"), seeds=(0, 3), n_rounds=4,
                                eval_every=2)
    base = tpofl.POFLConfig(n_devices=6, n_scheduled=2, backend="pallas_fused")
    recs = {mode: tlattice.run_lattice(task.loss_fn, task.data, task.params0, spec,
                                       base_cfg=dataclasses.replace(base, on_nonfinite=mode),
                                       eval_fn=task.eval, device="cpu")
            for mode in ("propagate", "skip")}
    assert recs["propagate"].health is None and recs["propagate"].diag is None
    assert recs["skip"].health.nonfinite.shape == (1, 2, 1, 1, 2, 4)
    assert not recs["skip"].health.nonfinite.any()
    for f in ("e_com", "e_var", "grad_norm", "n_scheduled", "loss", "acc"):
        np.testing.assert_array_equal(getattr(recs["skip"], f), getattr(recs["propagate"], f))
    np.testing.assert_array_equal(recs["skip"].eval.acc, recs["propagate"].eval.acc)

    fused = dataclasses.replace(base, policy=tengine.FUSED_POLICY)
    engine = tengine.SimEngine(task.loss_fn, task.data, fused, device="cpu")
    rec = engine.run_lattice_cells(task.params0, [0, 1], [False, False], [1e-10] * 2,
                                   [0.1] * 2, [0, 1], [0, 2])
    assert rec.health is None and rec.diag is None
    d = next(engine.draws(0, task.dim))
    _, _, m = tpofl.round_algorithm(task.loss_fn, task.data, base, task.params0, d.h,
                                    d.batch_idx, d.sched, d.z, 0)
    assert m.health is None and m.diag is None and float(m.loss) == 0.0
    skip_engine = tengine.SimEngine(task.loss_fn, task.data,
                                    dataclasses.replace(fused, on_nonfinite="skip"),
                                    device="cpu")
    rec = skip_engine.run_lattice_cells(task.params0, [0, 1], [False, False], [1e-10] * 2,
                                        [0.1] * 2, [0, 1], [0, 2])
    assert rec.health.nonfinite.shape == (2, 2) and not rec.health.nonfinite.any()
