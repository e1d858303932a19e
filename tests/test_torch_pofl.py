"""The port's round stages, one whole round and short trajectories held
against the live reference on identical inputs and draws (CPU).

The reference's draws (engine key discipline, ``repro/sim/engine.py:12-15``)
are handed to the port as tensors: per stage and per round directly, and
for whole ``run_pofl`` trajectories by replacing the port engine's
:meth:`~repro_torch.sim.engine.SimEngine.draws`. ``pallas_fused`` runs the
reference's Pallas kernel in interpret mode. Tolerance: floats within 1e-5
of the reference relative to its scale; masks and |S| exactly equal.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    assert_close, cfg_to_torch, data_to_torch, jax_batch_idx, jax_batch_rows,
    jax_engine_draws, jax_noise, jax_sched_draw, reference_task, replay_draws, t,
)
from jax.flatten_util import ravel_pytree as jax_ravel

from repro.core import aircomp as jair
from repro.core import pofl as jpofl
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.core.local_update import AlgState as JAlgState
from repro.data.partition import partition_dirichlet_sized
from repro.data.synthetic import make_classification_dataset
from repro.models import small as jsmall
from repro.sim import engine as jengine
from repro.sim.tasks import TaskEval as JTaskEval
from repro_torch.convert import params_from_jax
from repro_torch.core import aircomp as tair
from repro_torch.core import pofl as tpofl
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.local_update import AlgState as TAlgState
from repro_torch.flatten_util import ravel_pytree
from repro_torch.models import small as tsmall
from repro_torch.sim import engine as tengine
from repro_torch.sim.tasks import TaskEval as TTaskEval
from repro_torch.sim.tasks import make_model_task

N, S = 8, 3


def _stage_inputs(seed=0, d=500):
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    g = 0.05 * jax.random.normal(ks[0], (N, d)) + 0.002
    ccfg = JChannelConfig(n_devices=N)
    from repro.sim.scenario import make_channel_process

    proc = make_channel_process("static_rayleigh", ccfg)
    _, h, _ = proc.step(proc.init(ks[1]), ks[2])
    return g, h, ks[3], ks[4]


SCHED_CASES = [
    (policy, sampler)
    for policy in ("pofl", "importance", "channel", "noisefree", "deterministic")
    for sampler in ("without_replacement", "topk", "bernoulli")
]


@pytest.mark.parametrize("policy,sampler", SCHED_CASES)
def test_scheduling_stage_matches_reference(policy, sampler):
    g, h, k_sched, _ = _stage_inputs(seed=1)
    jcfg = jpofl.POFLConfig(n_devices=N, n_scheduled=S, policy=policy, sampler=sampler)
    frac = jnp.full((N,), 1.0 / N)
    want_rho, want_mask = jpofl.scheduling_stage(
        jcfg, jair.local_stats(g), jnp.abs(h), frac, g.shape[1], 0.1, 1e-10, k_sched
    )
    got_rho, got_mask = tpofl.scheduling_stage(
        cfg_to_torch(jcfg), tair.local_stats(t(g)), t(h).abs(), t(frac), g.shape[1],
        0.1, 1e-10, jax_sched_draw(jcfg, k_sched),
    )
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert_close(got_rho, want_rho)


@pytest.mark.parametrize(
    "backend,physical", [("jnp", False), ("jnp", True), ("pallas_fused", False)]
)
@pytest.mark.parametrize("empty", [False, True])
def test_aggregation_stage_matches_reference(backend, physical, empty):
    g, h, k_sched, k_noise = _stage_inputs(seed=2)
    jcfg = jpofl.POFLConfig(n_devices=N, n_scheduled=S, backend=backend,
                            simulate_physical=physical)
    rho = jax.random.uniform(k_sched, (N,)) / N
    mask = (jnp.arange(N) % 3 == 0).astype(jnp.float32)
    if empty:
        rho, mask = jnp.zeros_like(rho), jnp.zeros_like(mask)
    want_y, want_e = jpofl.aggregation_stage(
        jcfg, g, rho, h, mask, k_noise, 1e-10, use_pallas="interpret"
    )
    got_y, got_e = tpofl.aggregation_stage(
        cfg_to_torch(jcfg), t(g), t(rho), t(h), t(mask), jax_noise(k_noise, g.shape[1]), 1e-10
    )
    assert bool(torch.isfinite(got_y).all()) == bool(jnp.isfinite(want_y).all())
    assert_close(got_y, want_y)
    assert_close(got_e, want_e)


def test_apply_update_stage_matches_reference():
    jparams = jsmall.init_cnn(jax.random.PRNGKey(0))
    y_hat = jax.random.normal(jax.random.PRNGKey(1), (258_634,))
    jcfg = jpofl.POFLConfig()
    want = jpofl.apply_update_stage(jcfg, jparams, y_hat, jnp.float32(7))
    got = tpofl.apply_update_stage(
        cfg_to_torch(jcfg), params_from_jax(jparams, device="cpu"), t(y_hat), 7
    )
    assert_close(ravel_pytree(got)[0], jax_ravel(want)[0])


@pytest.mark.parametrize("backend", ["jnp", "pallas_fused"])
@pytest.mark.parametrize("kind,policy", [("logreg", "pofl"), ("cnn", "channel")])
def test_one_round_matches_reference(backend, kind, policy, monkeypatch):
    """A whole round on both backends from one shared state and shared draws."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")  # the Pallas kernel, interpreted
    n = 4 if kind == "cnn" else N
    data, jparams, jloss, _, tloss, *_ = reference_task(kind, n, per_device=8)
    jcfg = jpofl.POFLConfig(n_devices=n, n_scheduled=2, batch_size=2, policy=policy,
                            backend=backend, noise_power=1e-10)
    dim = jax_ravel(jparams)[0].size
    draws = next(jax_engine_draws(jcfg, JChannelConfig(n_devices=n, noise_power=1e-10),
                                  data, dim, seed=3))
    key = jax.random.PRNGKey(9)
    k_batch, k_sched, k_noise = jax.random.split(key, 3)
    h = jnp.asarray(draws.h.numpy())
    # the per-call noise/alpha overrides (the lattice's axes) differ from cfg's
    want_params, _, want_m = jpofl.round_algorithm(
        jloss, data, jcfg, jparams, h, k_batch, k_sched, k_noise, jnp.float32(2),
        noise_power=3e-10, alpha=0.2,
    )
    got_params, got_state, got_m = tpofl.round_algorithm(
        tloss, data_to_torch(data), cfg_to_torch(jcfg),
        params_from_jax(jparams, device="cpu"), draws.h,
        jax_batch_idx(data, jcfg.batch_size, k_batch), jax_sched_draw(jcfg, k_sched),
        jax_noise(k_noise, dim), 2, noise_power=3e-10, alpha=0.2,
    )
    assert_close(ravel_pytree(got_params)[0], jax_ravel(want_params)[0])
    assert got_state is None
    assert float(got_m.n_scheduled) == float(want_m.n_scheduled)
    for f in ("e_com", "e_var", "grad_norm", "a_scalar"):
        assert_close(getattr(got_m, f), getattr(want_m, f))


AVAILS = {"drops": np.array([1, 0, 1, 1, 0, 0, 1, 0], np.float32),
          "one_left": np.eye(N, dtype=np.float32)[5], "none": np.zeros(N, np.float32)}


@pytest.mark.parametrize("avail", sorted(AVAILS))
@pytest.mark.parametrize("policy,sampler", SCHED_CASES)
def test_scheduling_stage_with_avail_matches_reference(policy, sampler, avail):
    """Unavailable devices get probability 0 and are never scheduled; with
    none available nothing is (the sentinels, zero weights)."""
    g, h, k_sched, _ = _stage_inputs(seed=4)
    jcfg = jpofl.POFLConfig(n_devices=N, n_scheduled=S, policy=policy, sampler=sampler)
    frac = jnp.full((N,), 1.0 / N)
    av = AVAILS[avail]
    want_rho, want_mask = jpofl.scheduling_stage(
        jcfg, jair.local_stats(g), jnp.abs(h), frac, g.shape[1], 0.1, 1e-10, k_sched,
        avail=jnp.asarray(av),
    )
    got_rho, got_mask = tpofl.scheduling_stage(
        cfg_to_torch(jcfg), tair.local_stats(t(g)), t(h).abs(), t(frac), g.shape[1],
        0.1, 1e-10, jax_sched_draw(jcfg, k_sched), avail=t(av),
    )
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert_close(got_rho, want_rho)
    assert not bool((got_mask * (1 - t(av))).any())


@pytest.mark.parametrize("backend,physical", [("jnp", False), ("jnp", True),
                                              ("pallas_fused", False)])
def test_round_with_every_device_dropped_matches_reference(backend, physical, monkeypatch):
    """No device available: nothing is scheduled, the fused path gets a zero
    ``coeff`` and ``a = inf``, ŷ = 0 and the params stay where they were,
    finite on both sides, from a non-zero K-step state."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    data, jparams, jloss, _, tloss, *_ = reference_task("logreg", N, per_device=8)
    jcfg = jpofl.POFLConfig(n_devices=N, n_scheduled=S, batch_size=2, backend=backend,
                            simulate_physical=physical, local_steps=2,
                            local_algorithm="scaffold", noise_power=1e-10)
    dim = jax_ravel(jparams)[0].size
    jccfg = JChannelConfig(n_devices=N, noise_power=1e-10)
    d = next(jax_engine_draws(jcfg, jccfg, data, dim, seed=1))
    k_batch, k_sched, k_noise = jax.random.split(jax.random.PRNGKey(2), 3)
    c0 = 0.01 * jax.random.normal(jax.random.PRNGKey(3), (N, dim))
    want_params, want_state, want_m = jpofl.round_algorithm(
        jloss, data, jcfg, jparams, jnp.asarray(d.h.numpy()), k_batch, k_sched, k_noise,
        jnp.float32(1), avail=jnp.zeros(N), alg_state=JAlgState(c=c0),
    )
    got_params, got_state, got_m = tpofl.round_algorithm(
        tloss, data_to_torch(data), cfg_to_torch(jcfg), params_from_jax(jparams, device="cpu"),
        d.h, jax_batch_rows(jcfg, data, k_batch), jax_sched_draw(jcfg, k_sched),
        jax_noise(k_noise, dim), 1, avail=torch.zeros(N), alg_state=TAlgState(c=t(c0)),
    )
    flat = ravel_pytree(got_params)[0]
    assert bool(torch.isfinite(flat).all())
    assert torch.equal(flat, ravel_pytree(params_from_jax(jparams, device="cpu"))[0])
    assert_close(flat, jax_ravel(want_params)[0])
    assert_close(got_state.c, want_state.c)  # the state moves on: availability gates scheduling only
    assert float(got_m.n_scheduled) == float(want_m.n_scheduled) == 0
    assert float(got_m.grad_norm) == float(want_m.grad_norm) == 0
    assert float(got_m.e_com) == float(want_m.e_com) == 0
    assert float(got_m.a_scalar) == float(want_m.a_scalar) == float("inf")
    assert_close(got_m.e_var, want_m.e_var)


@pytest.mark.parametrize(
    "scenario,params,alg,k_steps",
    [("churn", dict(p_depart=0.3, p_arrive=0.3), "feddyn", 2),
     ("dropout", dict(p_drop=0.4, base="gauss_markov", corr=0.9), "scaffold", 3),
     ("mobility", dict(speed=5.0), "fedprox", 2),
     ("gauss_markov", dict(corr=0.7), "fedavg", 1)],
)
def test_run_with_history_under_scenarios_matches_reference(scenario, params, alg, k_steps,
                                                             monkeypatch):
    """``SimEngine.run_with_history`` under a channel scenario and K local
    steps, fed the reference engine's draws (``h``, ``avail``, the K-way
    rows), follows the reference engine's run, logreg on Dirichlet-sized
    shards, ``pallas_fused``."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    _, jparams, jloss, jlogits, tloss, tlogits, x_te, y_te = reference_task("logreg", 8, 20)
    x, y = make_classification_dataset("mnist_like", 160, jax.random.PRNGKey(8))
    data = partition_dirichlet_sized(np.asarray(x), np.asarray(y), 8, beta=0.5, seed=3)
    jcfg = jpofl.POFLConfig(n_devices=8, n_scheduled=3, batch_size=2, noise_power=1e-10,
                            backend="pallas_fused", local_algorithm=alg, local_steps=k_steps,
                            fedprox_mu=0.2, feddyn_alpha=0.3, seed=6)
    jccfg = JChannelConfig(n_devices=8, noise_power=1e-10)
    want_params, want = jengine.SimEngine(
        jloss, data, jcfg, channel_cfg=jccfg, scenario=scenario, scenario_params=dict(params),
    ).run_with_history(jparams, 5, eval_fn=JTaskEval(jlogits, x_te, y_te, n_valid=50),
                       eval_every=2)

    replay_draws(monkeypatch, lambda seed, dim: jax_engine_draws(
        jcfg, jccfg, data, dim, seed, scenario, params))
    engine = tengine.SimEngine(tloss, data_to_torch(data), cfg_to_torch(jcfg),
                               channel_cfg=ChannelConfig(n_devices=8, noise_power=1e-10),
                               scenario=scenario, scenario_params=params, device="cpu")
    got_params, got = engine.run_with_history(
        params_from_jax(jparams, device="cpu"), 5, eval_every=2,
        eval_fn=TTaskEval(tlogits, t(x_te), t(y_te, torch.int64), n_valid=50))
    assert got.test_round == want.test_round
    assert got.test_acc == pytest.approx(want.test_acc, abs=1e-6)
    for f in ("loss", "e_com", "e_var"):
        assert_close(np.array(getattr(got, f)), np.array(getattr(want, f)))
    assert_close(ravel_pytree(got_params)[0], jax_ravel(want_params)[0])


@pytest.mark.parametrize(
    "kind,backend,n_devices,per_device,rounds",
    [("logreg", "pallas_fused", 10, 20, 6), ("logreg", "jnp", 10, 20, 6),
     ("cnn", "pallas_fused", 3, 4, 2)],
)
def test_run_pofl_trajectory_matches_reference(kind, backend, n_devices, per_device,
                                               rounds, monkeypatch):
    """``run_pofl`` end to end: the port fed the reference engine's draws
    follows the reference's trajectory (the CNN at narrow batch)."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    data, jparams, jloss, jlogits, tloss, tlogits, x_te, y_te = reference_task(
        kind, n_devices, per_device
    )
    jcfg = jpofl.POFLConfig(n_devices=n_devices, n_scheduled=3, batch_size=2,
                            noise_power=1e-10, backend=backend, seed=4)
    jccfg = JChannelConfig(n_devices=n_devices, noise_power=1e-10)
    want_params, want = jpofl.run_pofl(
        jloss, jparams, data, jcfg, rounds, channel_cfg=jccfg, eval_every=2,
        eval_fn=jsmall.make_eval_fn(jlogits, jloss, x_te, y_te),
    )

    replay_draws(monkeypatch, lambda seed, dim: jax_engine_draws(jcfg, jccfg, data, dim, seed))
    got_params, got = tpofl.run_pofl(
        tloss, params_from_jax(jparams, device="cpu"), data_to_torch(data),
        cfg_to_torch(jcfg), rounds, eval_every=2,
        eval_fn=tsmall.make_eval_fn(tlogits, tloss, t(x_te), t(y_te, torch.int64)),
        channel_cfg=ChannelConfig(n_devices=n_devices, noise_power=1e-10), device="cpu",
    )
    assert got.test_round == want.test_round
    assert got.test_acc == pytest.approx(want.test_acc, abs=1e-6)
    for f in ("loss", "e_com", "e_var"):
        assert_close(np.array(getattr(got, f)), np.array(getattr(want, f)))
    assert_close(ravel_pytree(got_params)[0], jax_ravel(want_params)[0])


def test_engine_draws_follow_the_key_discipline_shapes():
    task = make_model_task("logreg", n_devices=6, n_train=60, n_test=12, device="cpu")
    for sampler, shape in (("without_replacement", (2, 6)), ("topk", (6,)), ("bernoulli", (6,))):
        cfg = tpofl.POFLConfig(n_devices=6, n_scheduled=2, batch_size=3, sampler=sampler)
        engine = tengine.SimEngine(task.loss_fn, task.data, cfg, device="cpu")
        d0, d1 = (next(it) for it in [engine.draws(0, task.dim)] * 2)
        assert d0.h.dtype == torch.complex64 and d0.h.shape == (6,)
        assert d0.batch_idx.shape == (6, 3) and d0.sched.shape == shape
        assert d0.z.shape == (task.dim,) and not torch.equal(d0.z, d1.z)
        assert d0.avail.shape == (6,) and bool((d0.avail == 1).all())
        again = next(engine.draws(0, task.dim))
        assert torch.equal(again.z, d0.z) and torch.equal(again.h, d0.h)


def test_entry_points_need_a_card_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = make_model_task("logreg", n_devices=4, n_train=40, n_test=8, device="cpu")
    cfg = tpofl.POFLConfig(n_devices=4, n_scheduled=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_model_task("logreg", n_devices=4, n_train=40, n_test=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tengine.SimEngine(task.loss_fn, task.data, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpofl.run_pofl(task.loss_fn, task.params0, task.data, cfg, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"w": np.zeros(2)})


def test_engine_refuses_empty_devices():
    task = make_model_task("logreg", n_devices=4, n_train=40, n_test=8, device="cpu")
    data = task.data._replace(n_samples=torch.tensor([3, 0, 2, 1]))
    with pytest.raises(ValueError, match="n_samples >= 1"):
        tengine.SimEngine(task.loss_fn, data, tpofl.POFLConfig(n_devices=4), device="cpu")
