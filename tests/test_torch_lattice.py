"""The port's scenario lattice (``repro_torch.sim.lattice``) held against the
live reference on identical inputs and draws (CPU).

Per stage (the policy-id dispatch), per round (one cell-batched round from a
shared state against the reference's ``round_algorithm(policy_id=...)`` of
each cell) and per run (``run_lattice`` against the reference's
``run_lattice``, the reference's draws replayed per seed: under any channel
scenario, with the algorithm axis, K local steps and a ``TaskEval`` whose
``eval`` subtree is compared too). ``pallas_fused`` runs the reference's
Pallas kernels in interpret mode. Tolerance: floats within 1e-5 of the
reference relative to its scale (per cell), accuracy to 1e-6, masks, |S|
and correct counts exactly equal.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    RTOL, assert_close, assert_records_match, cfg_to_torch, data_to_torch, jax_batch_idx,
    jax_engine_draws, jax_noise, jax_sched_draw, reference_and_port_lattice, reference_task,
    replay_per_seed, t,
)
from jax.flatten_util import ravel_pytree as jax_ravel
from torch.func import vmap

from repro.core import aircomp as jair
from repro.core import pofl as jpofl
from repro.core import scheduling as jsched
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.models import small as jsmall
from repro.sim import engine as jengine
from repro.sim import lattice as jlattice
from repro.sim.scenario import make_channel_process
from repro_torch.convert import params_from_jax
from repro_torch.core import aircomp as tair
from repro_torch.core import pofl as tpofl
from repro_torch.core import scheduling as tsched
from repro_torch.core.channel import ChannelConfig
from repro_torch.flatten_util import ravel_pytree, tree_map
from repro_torch.models import small as tsmall
from repro_torch.sim import engine as tengine
from repro_torch.sim import lattice as tlattice
from repro_torch.sim.tasks import EvalRecord, make_model_task

N, S = 8, 3
ALL_POLICIES = jsched.POLICIES


def _stats_and_channel(seed=0, d=500, n=N):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    g = 0.05 * jax.random.normal(ks[0], (n, d)) + 0.002
    proc = make_channel_process("static_rayleigh", JChannelConfig(n_devices=n))
    _, h, _ = proc.step(proc.init(ks[1]), ks[2])
    return g, h, ks[3]


def test_policy_id_tables_match_reference():
    assert tsched.POLICIES == jsched.POLICIES
    assert tsched.POLICY_IDS == jsched.POLICY_IDS
    assert (tsched.NOISEFREE_ID, tsched.DETERMINISTIC_ID) == (
        jsched.NOISEFREE_ID, jsched.DETERMINISTIC_ID)
    assert [tsched.policy_id(p) for p in ALL_POLICIES] == [
        jsched.policy_id(p) for p in ALL_POLICIES]
    with pytest.raises(ValueError, match="unknown policy"):
        tsched.policy_id("nope")


# per-cell alpha and σ_z², float32 as the lattice carries them
ALPHAS = np.asarray([0.05, 0.1, 0.5], np.float32)
NOISES = np.asarray([1e-11, 1e-10, 1e-8], np.float32)


@pytest.mark.parametrize("pid", range(len(ALL_POLICIES)))
def test_scheduling_probs_by_id_matches_reference(pid):
    g, h, _ = _stats_and_channel(seed=pid)
    st = jair.local_stats(g)
    frac = jnp.full((N,), 1.0 / N)
    d = g.shape[1]
    want = jax.vmap(lambda a, s2: jsched.scheduling_probs_by_id(
        jnp.int32(pid), st.norm, st.var, jnp.abs(h), frac, d, a, 1.0, s2))(
        jnp.asarray(ALPHAS), jnp.asarray(NOISES))
    norm, var, h_abs, tfrac = t(st.norm), t(st.var), t(h).abs(), t(frac)
    got = vmap(lambda a, s2: tsched.scheduling_probs_by_id(
        torch.tensor(pid), norm, var, h_abs, tfrac, d, a, 1.0, s2))(t(ALPHAS), t(NOISES))
    assert_close(got, want)
    # the selected branch is exactly the string version's score
    string = vmap(lambda a, s2: tsched.scheduling_probs(
        ALL_POLICIES[pid], norm, var, h_abs, tfrac, d, a, 1.0, s2))(t(ALPHAS), t(NOISES))
    assert torch.equal(got, string)


def test_scheduling_probs_by_id_mixed_policies_per_cell():
    g, h, _ = _stats_and_channel(seed=11)
    st = jair.local_stats(g)
    frac = jnp.full((N,), 1.0 / N)
    ids = np.arange(len(ALL_POLICIES), dtype=np.int32)
    alphas = np.linspace(0.05, 0.5, len(ids)).astype(np.float32)
    noises = np.geomspace(1e-11, 1e-8, len(ids)).astype(np.float32)
    want = jax.vmap(lambda p, a, s2: jsched.scheduling_probs_by_id(
        p, st.norm, st.var, jnp.abs(h), frac, g.shape[1], a, 1.0, s2))(
        jnp.asarray(ids), jnp.asarray(alphas), jnp.asarray(noises))
    got = vmap(lambda p, a, s2: tsched.scheduling_probs_by_id(
        p, t(st.norm), t(st.var), t(h).abs(), t(frac), g.shape[1], a, 1.0, s2))(
        t(ids, torch.int64), t(alphas), t(noises))
    for c in range(len(ids)):
        assert_close(got[c], want[c])


SCHED_CASES = [(p, s) for p in ALL_POLICIES
               for s in ("without_replacement", "topk", "bernoulli")]


@pytest.mark.parametrize("policy,sampler", SCHED_CASES)
def test_policy_id_scheduling_stage_matches_reference(policy, sampler):
    g, h, k_sched = _stats_and_channel(seed=3)
    jcfg = jpofl.POFLConfig(n_devices=N, n_scheduled=S, policy=jengine.FUSED_POLICY,
                            sampler=sampler)
    frac = jnp.full((N,), 1.0 / N)
    pid = jsched.policy_id(policy)
    want_rho, want_mask = jpofl.scheduling_stage(
        jcfg, jair.local_stats(g), jnp.abs(h), frac, g.shape[1], jnp.float32(0.1),
        jnp.float32(1e-10), k_sched, policy_id=jnp.int32(pid),
    )
    got_rho, got_mask = tpofl.scheduling_stage(
        cfg_to_torch(jcfg), tair.local_stats(t(g)), t(h).abs(), t(frac), g.shape[1],
        torch.tensor(0.1), torch.tensor(1e-10), jax_sched_draw(jcfg, k_sched),
        policy_id=torch.tensor(pid),
    )
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert_close(got_rho, want_rho)


# (policy, σ_z², alpha) of the four cells of one round
ROUND_CELLS = [("pofl", 1e-10, 0.1), ("noisefree", 1e-9, 0.2),
               ("deterministic", 1e-10, 0.3), ("channel", 1e-8, 0.1)]


@pytest.mark.parametrize("kind,backend", [("logreg", "jnp"), ("logreg", "pallas_fused"),
                                          ("cnn", "pallas_fused")])
def test_cell_batched_round_matches_reference_per_cell(kind, backend, monkeypatch):
    """One round of four cells, each from its own state and draws, against
    the reference's ``round_algorithm(policy_id=...)`` of each cell."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    n = 4 if kind == "cnn" else N
    data, jparams0, jloss, _, tloss, *_ = reference_task(kind, n, per_device=8)
    jcfg = jpofl.POFLConfig(n_devices=n, n_scheduled=2, batch_size=2, backend=backend,
                            policy=jengine.FUSED_POLICY)
    flat0, unravel = jax_ravel(jparams0)
    dim = flat0.size
    jccfg = JChannelConfig(n_devices=n)
    want, jstates, draws = [], [], []
    for c, (policy, s2, alpha) in enumerate(ROUND_CELLS):
        jparams = unravel(flat0 * (1.0 + 0.1 * c))  # each cell its own state
        h = next(jax_engine_draws(jcfg, jccfg, data, dim, seed=c)).h
        k_batch, k_sched, k_noise = jax.random.split(jax.random.PRNGKey(10 + c), 3)
        want.append(jpofl.round_algorithm(
            jloss, data, jcfg, jparams, jnp.asarray(h.numpy()), k_batch, k_sched, k_noise,
            jnp.float32(2), noise_power=jnp.float32(s2), alpha=jnp.float32(alpha),
            policy_id=jnp.int32(jsched.policy_id(policy)),
        ))
        jstates.append(jparams)
        draws.append((h, jax_batch_idx(data, jcfg.batch_size, k_batch),
                      jax_sched_draw(jcfg, k_sched), jax_noise(k_noise, dim)))
    stack = [torch.stack(x) for x in zip(*draws)]
    got_params, _, got_m = tpofl.round_algorithm_cells(
        tloss, data_to_torch(data), cfg_to_torch(jcfg), _stack_tree(jstates), *stack, 2,
        torch.tensor([c[1] for c in ROUND_CELLS]), torch.tensor([c[2] for c in ROUND_CELLS]),
        torch.tensor([jsched.policy_id(c[0]) for c in ROUND_CELLS]),
    )
    for c, (want_params, _, want_m) in enumerate(want):
        cell = tree_map(lambda p, c=c: p[c], got_params)
        assert_close(ravel_pytree(cell)[0], jax_ravel(want_params)[0])
        assert float(got_m.n_scheduled[c]) == float(want_m.n_scheduled)
        for f in ("e_com", "e_var", "grad_norm", "a_scalar"):
            assert_close(getattr(got_m, f)[c], getattr(want_m, f))


def _stack_tree(trees):
    """Stack a list of the reference's param trees into one port tree with
    a leading cell axis."""
    ported = [params_from_jax(p, device="cpu") for p in trees]

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack(nodes)

    return stack(ported)


LOGREG_SPEC = dict(policies=ALL_POLICIES, noise_powers=(1e-10, 1e-8), alphas=(0.1, 0.3),
                   seeds=(0, 5), n_rounds=4, eval_every=2)


@pytest.mark.parametrize("backend,sampler", [("jnp", "without_replacement"),
                                             ("pallas_fused", "without_replacement"),
                                             ("jnp", "bernoulli")])
def test_run_lattice_logreg_matches_reference(backend, sampler, monkeypatch):
    """5 policies × 2 noise levels × 2 alphas × 2 seeds, 4 rounds."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    data, jparams, jloss, jlogits, tloss, tlogits, x_te, y_te = reference_task(
        "logreg", 10, per_device=20)
    jcfg = jpofl.POFLConfig(n_devices=10, n_scheduled=3, batch_size=2, backend=backend,
                            sampler=sampler)
    jccfg = JChannelConfig(n_devices=10)
    want = jlattice.run_lattice(
        jloss, data, jparams, jlattice.LatticeSpec(**LOGREG_SPEC), base_cfg=jcfg,
        eval_fn=jsmall.make_eval_fn(jlogits, jloss, x_te, y_te), channel_cfg=jccfg,
    )
    replay_per_seed(monkeypatch, jcfg, jccfg, data)
    got = tlattice.run_lattice(
        tloss, data_to_torch(data), params_from_jax(jparams, device="cpu"),
        tlattice.LatticeSpec(**LOGREG_SPEC), base_cfg=cfg_to_torch(jcfg),
        eval_fn=tsmall.make_eval_fn(tlogits, tloss, t(x_te), t(y_te, torch.int64)),
        channel_cfg=ChannelConfig(n_devices=10), device="cpu",
    )
    assert_records_match(got, want)


def test_run_lattice_narrow_cnn_matches_reference(monkeypatch):
    """The CNN at N=3, batch 2: 2 policies × 2 seeds, 2 rounds, the
    reference's batch kernel interpreted.

    Seed 4 is not used: there the reference's scanned lattice and its own
    eager ``round_algorithm`` of the same cell disagree by 9.6e-5 relative
    in round 1's e_com (an ill-conditioned point, ROADMAP queue C).
    ``test_reference_lattice_leaves_its_eager_chain_only_at_seed_4`` pins
    that, and the test after it holds the port's cell to the eager chain
    there.
    """
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    data, jparams, jloss, jlogits, tloss, tlogits, x_te, y_te = reference_task(
        "cnn", 3, per_device=4)
    spec = dict(policies=("pofl", "channel"), noise_powers=(1e-10,), alphas=(0.1,),
                seeds=(0, 1), n_rounds=2, eval_every=1)
    jcfg = jpofl.POFLConfig(n_devices=3, n_scheduled=2, batch_size=2,
                            backend="pallas_fused")
    jccfg = JChannelConfig(n_devices=3)
    want = jlattice.run_lattice(
        jloss, data, jparams, jlattice.LatticeSpec(**spec), base_cfg=jcfg,
        eval_fn=jsmall.make_eval_fn(jlogits, jloss, x_te, y_te), channel_cfg=jccfg,
    )
    replay_per_seed(monkeypatch, jcfg, jccfg, data)
    got = tlattice.run_lattice(
        tloss, data_to_torch(data), params_from_jax(jparams, device="cpu"),
        tlattice.LatticeSpec(**spec), base_cfg=cfg_to_torch(jcfg),
        eval_fn=tsmall.make_eval_fn(tlogits, tloss, t(x_te), t(y_te, torch.int64)),
        channel_cfg=ChannelConfig(n_devices=3), device="cpu",
    )
    assert_records_match(got, want)


NARROW_CNN_CFG = dict(n_devices=3, n_scheduled=2, batch_size=2, backend="pallas_fused")


def _reference_eager_pofl_chain(seed, data, jparams, jloss, n_rounds=2):
    """The reference's eager ``round_algorithm`` chain of the narrow CNN's
    (pofl, σ_z²=1e-10) cell, on the engine's key discipline → its metrics,
    round by round."""
    jcfg = jpofl.POFLConfig(policy="pofl", noise_power=1e-10, **NARROW_CNN_CFG)
    proc = make_channel_process("static_rayleigh", JChannelConfig(n_devices=3))
    k_chan_init, key = jax.random.split(jax.random.PRNGKey(seed))
    chan, params, out = proc.init(k_chan_init), jparams, []
    for r in range(n_rounds):
        key, k_round = jax.random.split(key)
        k_batch, k_chan, k_sched, k_noise = jax.random.split(k_round, 4)
        chan, h, _ = proc.step(chan, k_chan)
        params, _, m = jpofl.round_algorithm(
            jloss, data, jcfg, params, h, k_batch, k_sched, k_noise, jnp.float32(r),
            noise_power=jnp.float32(1e-10))
        out.append(m)
    return out


@functools.lru_cache(maxsize=1)
def _reference_narrow_cnn_lattice():
    """The reference's scanned narrow-CNN lattice at seeds 0, 1 and 4."""
    data, jparams, jloss, jlogits, *_, x_te, y_te = reference_task("cnn", 3, per_device=4)
    spec = jlattice.LatticeSpec(policies=("pofl", "channel"), noise_powers=(1e-10,),
                                alphas=(0.1,), seeds=(0, 1, 4), n_rounds=2, eval_every=1)
    recs = jlattice.run_lattice(
        jloss, data, jparams, spec, base_cfg=jpofl.POFLConfig(**NARROW_CNN_CFG),
        eval_fn=jsmall.make_eval_fn(jlogits, jloss, x_te, y_te),
        channel_cfg=JChannelConfig(n_devices=3),
    )
    return recs, (data, jparams, jloss)


@pytest.mark.parametrize("seed", [0, 1, 4])
def test_reference_lattice_leaves_its_eager_chain_only_at_seed_4(seed, monkeypatch):
    """Why the narrow-CNN lattice test runs seeds 0 and 1: the reference's
    scanned lattice follows its own eager ``round_algorithm`` chain of the
    (pofl) cell to 1e-5 there, and at seed 4 it does not (round 1's e_com
    differs by ~1e-4 relative: an ill-conditioned point, ROADMAP queue C)."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    recs, task = _reference_narrow_cnn_lattice()
    eager = _reference_eager_pofl_chain(seed, *task)
    cell = (0, 0, 0, 0, (0, 1, 4).index(seed))
    if seed != 4:
        for f in ("e_com", "e_var", "grad_norm", "n_scheduled"):
            assert_close(torch.tensor(np.asarray(getattr(recs, f))[cell]),
                         np.asarray([getattr(m, f) for m in eager]))
    else:
        lat = np.asarray(recs.e_com)[cell]
        want = np.asarray([m.e_com for m in eager])
        assert np.max(np.abs(lat - want)) > RTOL * np.max(np.abs(want))


def test_narrow_cnn_seed_4_follows_the_reference_round_by_round(monkeypatch):
    """The cell the narrow-CNN lattice test leaves out, (pofl, seed 4): the
    port's lattice cell against the reference's eager ``round_algorithm``
    chain of that cell, on the engine's key discipline (ROADMAP queue C)."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    data, jparams, jloss, _, tloss, *_ = reference_task("cnn", 3, per_device=4)
    want = _reference_eager_pofl_chain(4, data, jparams, jloss)
    jcfg = jpofl.POFLConfig(policy="pofl", noise_power=1e-10, **NARROW_CNN_CFG)
    jccfg = JChannelConfig(n_devices=3)
    replay_per_seed(monkeypatch, jcfg, jccfg, data)
    got = tlattice.run_lattice(
        tloss, data_to_torch(data), params_from_jax(jparams, device="cpu"),
        tlattice.LatticeSpec(policies=("pofl",), noise_powers=(1e-10,), seeds=(4,),
                             n_rounds=2),
        base_cfg=cfg_to_torch(jcfg), channel_cfg=ChannelConfig(n_devices=3), device="cpu",
    )
    cell = got.cell(policy="pofl", seed=4)
    for f in ("e_com", "e_var", "grad_norm", "n_scheduled"):
        assert_close(cell[f].ravel(), np.asarray([getattr(m, f) for m in want]))


@pytest.mark.parametrize("sampler", ["without_replacement", "topk"])
def test_lattice_cell_equals_run_pofl(sampler):
    """On the port's CPU path a lattice cell is the ``run_pofl`` run of its
    policy, σ_z², alpha and seed (both draw from that seed's stream)."""
    task = make_model_task("logreg", n_devices=8, n_train=160, n_test=40, device="cpu")
    spec = tlattice.LatticeSpec(policies=("pofl", "deterministic"), noise_powers=(1e-10,),
                                alphas=(0.2,), seeds=(1, 6), n_rounds=5, eval_every=2)
    base = tpofl.POFLConfig(n_devices=8, n_scheduled=3, batch_size=4, sampler=sampler,
                            backend="pallas_fused")
    recs = tlattice.run_lattice(task.loss_fn, task.data, task.params0, spec,
                                base_cfg=base, eval_fn=task.eval, device="cpu")
    for policy in spec.policies:
        for seed in spec.seeds:
            cfg = dataclasses.replace(base, policy=policy, seed=seed, noise_power=1e-10,
                                      alpha=0.2)
            _, hist = tpofl.run_pofl(task.loss_fn, task.params0, task.data, cfg,
                                     spec.n_rounds, eval_fn=task.eval, eval_every=2,
                                     device="cpu")
            cell = recs.cell(policy=policy, seed=seed)
            assert list(recs.eval_rounds) == hist.test_round
            np.testing.assert_allclose(cell["acc"].ravel(), hist.test_acc, atol=1e-6)
            for f, h in (("e_com", hist.e_com), ("e_var", hist.e_var),
                         ("loss", hist.loss)):
                assert_close(torch.tensor(cell[f].ravel()), np.asarray(h, np.float32))


def test_record_schema_and_cell():
    task = make_model_task("logreg", n_devices=6, n_train=60, n_test=12, device="cpu")
    spec = tlattice.LatticeSpec(policies=("pofl", "channel", "noisefree"),
                                noise_powers=(1e-10, 1e-9), alphas=(0.1,), seeds=(0, 2, 9),
                                n_rounds=5, eval_every=3)
    recs = tlattice.run_lattice(task.loss_fn, task.data, task.params0, spec,
                                base_cfg=tpofl.POFLConfig(n_devices=6, n_scheduled=2),
                                eval_fn=task.eval, device="cpu")
    assert tlattice.LatticeRecords._fields == jlattice.LatticeRecords._fields
    assert tengine.RoundRecord._fields == jengine.RoundRecord._fields
    assert [f.name for f in tlattice.LatticeSpec.__dataclass_fields__.values()] == [
        f.name for f in jlattice.LatticeSpec.__dataclass_fields__.values()]
    assert spec.n_cells == 18
    assert recs.axes == {"algorithm": ["fedavg"], "policy": ["pofl", "channel", "noisefree"],
                         "noise_power": [1e-10, 1e-9], "alpha": [0.1], "seed": [0, 2, 9]}
    np.testing.assert_array_equal(recs.eval_rounds, [0, 3, 4])
    for f in ("e_com", "e_var", "grad_norm", "n_scheduled"):
        assert getattr(recs, f).shape == (1, 3, 2, 1, 3, 5)
        assert getattr(recs, f).dtype == np.float32
    assert recs.loss.shape == recs.acc.shape == (1, 3, 2, 1, 3, 3)
    assert recs.diag is None and recs.health is None
    assert isinstance(recs.eval, EvalRecord) and recs.eval.acc.shape == recs.acc.shape
    np.testing.assert_array_equal(recs.eval.acc, recs.acc)
    np.testing.assert_array_equal(recs.eval.n_correct / np.float32(task.eval.n_valid),
                                  recs.acc)
    assert np.isfinite(recs.e_var).all() and (recs.n_scheduled == 2).all()
    assert (recs.e_com[:, 2] == 0).all()  # noisefree aggregates without noise
    cell = recs.cell(policy="channel", noise_power=1e-9, seed=2)
    assert cell["e_com"].shape == (1, 1, 5) and cell["acc"].shape == (1, 1, 3)
    np.testing.assert_array_equal(cell["e_var"], recs.e_var[:, 1, 1, :, 1])
    with pytest.raises(ValueError, match="unknown axes"):
        recs.cell(policy="pofl", colour="red")


def test_run_lattice_without_eval_has_empty_eval_axis():
    task = make_model_task("logreg", n_devices=4, n_train=40, n_test=8, device="cpu")
    spec = tlattice.LatticeSpec(policies=("pofl",), n_rounds=2, seeds=(0, 1))
    recs = tlattice.run_lattice(task.loss_fn, task.data, task.params0, spec,
                                base_cfg=tpofl.POFLConfig(n_devices=4, n_scheduled=2),
                                device="cpu")
    assert recs.eval_rounds.shape == (0,) and recs.acc.shape == (1, 1, 1, 1, 2, 0)


UNPORTED = {
    "mesh": (dict(mesh=2), "item 12"),
}


@pytest.mark.parametrize("option", sorted(UNPORTED))
def test_unported_options_raise_naming_their_roadmap_item(option):
    kw, item = UNPORTED[option]
    task = make_model_task("logreg", n_devices=4, n_train=40, n_test=8, device="cpu")
    kw = dict(kw)
    kw["base_cfg"] = tpofl.POFLConfig(n_devices=4, n_scheduled=2, **kw.get("base_cfg", {}))
    spec = tlattice.LatticeSpec(n_rounds=1)
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue A {item}"):
        tlattice.run_lattice(task.loss_fn, task.data, task.params0, spec, device="cpu",
                             **kw)


# what raised before the scenario slice, each alone: (spec, cfg, run_lattice kw)
FORMERLY_UNPORTED = {
    "algorithms": (dict(algorithms=("fedavg", "fedprox")), dict(fedprox_mu=0.5), {}),
    "local_steps": ({}, dict(local_steps=2), {}),
    "task_eval": ({}, {}, dict(task_eval=True)),
    "scenario": ({}, {}, dict(scenario="gauss_markov", scenario_params=dict(corr=0.8))),
    "obs": ({}, {}, dict(diagnostics=True)),
}


@pytest.mark.parametrize("option", sorted(FORMERLY_UNPORTED))
def test_formerly_unported_options_run_and_match_reference(option, monkeypatch):
    spec_kw, cfg_kw, kw = FORMERLY_UNPORTED[option]
    got, want = reference_and_port_lattice(
        monkeypatch, dict(policies=("pofl", "channel"), **spec_kw),
        dict(backend="pallas_fused", **cfg_kw), **kw)
    assert_records_match(got, want)


@pytest.mark.parametrize("backend", ["jnp", "pallas_fused"])
def test_run_lattice_scenario_axes_match_reference(backend, monkeypatch):
    """2 algorithms × 3 policies × 2 seeds, K = 2, ``dropout`` over
    ``gauss_markov``, a Dirichlet-sized logreg task and a ``TaskEval``:
    every record field and the ``eval`` subtree."""
    got, want = reference_and_port_lattice(
        monkeypatch,
        dict(algorithms=("feddyn", "scaffold"), policies=("pofl", "importance", "channel")),
        dict(backend=backend, local_steps=2, feddyn_alpha=0.2),
        scenario="dropout", scenario_params=dict(base="gauss_markov", corr=0.9, p_drop=0.6),
        task_eval=True, sized=True, n_rounds=4)
    assert_records_match(got, want)
    assert got.eval.acc.shape == (2, 3, 1, 1, 2, 3)
    assert (got.n_scheduled < 3).any()  # rounds with fewer than |S| available


@pytest.mark.parametrize(
    "alg,scenario,params",
    [("feddyn", "churn", dict(p_depart=0.3, p_arrive=0.3)),
     ("scaffold", "mobility", dict(speed=10.0)),
     ("fedprox", "dropout", dict(p_drop=0.9))],
)
def test_one_algorithm_lattice_under_each_scenario_matches_reference(alg, scenario, params,
                                                                     monkeypatch):
    """One algorithm: static dispatch, its own state only, K = 3, the
    Bernoulli sampler; under heavy dropout whole rounds go unscheduled."""
    got, want = reference_and_port_lattice(
        monkeypatch, dict(algorithms=(alg,), policies=("pofl", "deterministic")),
        dict(backend="pallas_fused", local_steps=3, fedprox_mu=0.3, sampler="bernoulli"),
        scenario=scenario, scenario_params=params, task_eval=True, n_rounds=4)
    assert_records_match(got, want)


def test_run_lattice_cells_needs_a_policy_fused_engine():
    task = make_model_task("logreg", n_devices=4, n_train=40, n_test=8, device="cpu")
    static = tengine.SimEngine(task.loss_fn, task.data,
                               tpofl.POFLConfig(n_devices=4, n_scheduled=2), device="cpu")
    with pytest.raises(ValueError, match="FUSED_POLICY"):
        static.run_lattice_cells(task.params0, [0], [False], [1e-10], [0.1], [0], [0])
    fused = tpofl.POFLConfig(n_devices=4, n_scheduled=2, policy=tengine.FUSED_POLICY)
    engine = tengine.SimEngine(task.loss_fn, task.data, fused, device="cpu")
    recs = engine.run_lattice_cells(task.params0, [0, 1], [False, False], [1e-10, 1e-9],
                                    [0.1, 0.1], [0, 0], [3, 3])
    assert recs.e_com.shape == (2, 2) and recs.e_com.device.type == "cpu"
    assert (recs.e_com == 0).all()  # noisefree: σ_z² = 0 in both cells


def test_port_imports_neither_jax_nor_the_reference():
    """Importing every module of the port loads no JAX and no ``repro``."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "new = {'repro_torch.obs.report', 'repro_torch.obs.profile',\n"
        "       'repro_torch.checkpoint.npz', 'repro_torch.sim.resilience'}\n"
        "assert new <= set(sys.modules), new - set(sys.modules)\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(src)}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 69  # every module of the port is imported (69 in all)
