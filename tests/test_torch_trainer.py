"""The port's ``POFLTrainer`` held against the live reference on the CPU.

Both sides run on the reference trainer's key discipline
(``repro/launch/train.py:73-75, 98, 111, 139, 157``): the port's trainer
takes its draws (the channel h, the sampler's Gumbel vectors, the probes,
the noise leaves) from ``_torch_parity.ReferenceTrainerDraws``, which
replays that stream, and its channel gains from the same key.

- Three rounds at n_fl = 4 (dense reduced config, sketch mode, 2 probes)
  against the reference's own ``POFLTrainer.train_round``,
  ``schedule_round`` and ``_round_stats`` run in-process over its
  functions (its ``sketch_device_stats`` and its train step composed as
  ``tests/test_torch_train_step.py`` composes it): coeffs, noise_amp,
  e_com, a, the loss and every parameter after each round.
- One round against the reference's own ``POFLTrainer`` on its 1 × 1 host
  mesh (jitted steps and all).
- ``stats_mode="loss"`` keeps the reference's never-refreshed unit stats,
  and ``python -m repro_torch.launch.train`` runs the example's loop.

The optimizer is ``sgd``: AdamW's first step is ill-conditioned at entries
where the noisy gradient lands near 0 (``tests/test_torch_train_step.py``
holds AdamW's step on its own gradients). Floats within 1e-5 of the
reference relative to their scale, ``n_scheduled`` exactly.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    ReferenceTrainerDraws, assert_close, auto_mesh, reference_trainer, torch_batch, train_batch,
    train_case,
)

from repro.core.channel import ChannelConfig as JChannelConfig
from repro.launch import train as jtrain
from repro.models.config import InputShape as JInputShape
from repro.optim import optimizers as jopt
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.channel import ChannelState
from repro_torch.flatten_util import tree_leaves
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.config import InputShape
from repro_torch.optim import optimizers as topt

SEQ, LR = 16, 0.05


def _port_trainer(tcfg, n_fl, b, tc, seed):
    """The port's trainer on the CPU whose draws replay the reference's
    stream from ``seed`` (its channel gains too)."""
    draws = ReferenceTrainerDraws(seed, JChannelConfig(
        n_devices=n_fl, tx_power=tc.tx_power, noise_power=tc.noise_power))
    trainer = ttrain.POFLTrainer(
        tcfg, InputShape("small_train", SEQ, b, "train"), make_host_mesh(1, n_fl, "cpu"),
        ttrain.TrainerConfig(**dataclasses.asdict(tc)), optimizer=topt.sgd(LR), draws=draws)
    trainer.channel = ChannelState(cfg=trainer.channel.cfg, gains=draws.gains())
    return trainer


def _recording(bundle, log):
    """A step bundle whose fn records (coeffs, noise_amp) before running."""
    def fn(params, opt_state, batch, coeffs, noise_amp, noise):
        log.append((np.asarray(coeffs), np.asarray(noise_amp)))
        return bundle.fn(params, opt_state, batch, coeffs, noise_amp, noise)
    return SimpleNamespace(fn=fn)


def _reference_in_process(jcfg, tc, n_fl, b, seed):
    """The reference's round methods over its own functions
    (``_torch_parity.reference_trainer``) with ``sgd``."""
    opt = jopt.sgd(LR)
    return reference_trainer(jcfg, tc, n_fl, b, seed, opt), opt


def _assert_round(got_diag, want_diag, got_log, want_log, got_p, want_p):
    for f in ("e_com", "a", "loss"):
        assert_close(got_diag[f], want_diag[f])
    (gc, gn), (wc, wn) = got_log, want_log
    assert_close(gc, wc)
    assert_close(gn, wn)
    assert float(got_diag["n_scheduled"]) == float((np.asarray(wc) > 0).sum())
    for g, w in zip(tree_leaves(got_p), jax.tree.leaves(want_p)):
        assert_close(g, w)


def test_three_rounds_at_four_fl_devices_match_the_reference_round():
    n_fl, b, seed = 4, 8, 3
    tc = jtrain.TrainerConfig(n_scheduled=2, noise_power=1e-10, stats_mode="sketch",
                              n_probes=2, dtype="float32", seed=seed)
    jcfg, tcfg, jp, _ = train_case("qwen2-0.5b", b=b, s=SEQ, seed=9)
    batches = [train_batch(jcfg, b=b, s=SEQ, seed=20 + r) for r in range(3)]
    trainer = _port_trainer(tcfg, n_fl, b, tc, seed)
    got_log = []
    trainer.train_bundle = _recording(trainer.train_bundle, got_log)
    ref, opt = _reference_in_process(jcfg, tc, n_fl, b, seed)
    want_log = []
    ref.train_bundle = _recording(ref.train_bundle, want_log)
    assert trainer.dim == ref.dim == tcfg.param_count()
    assert_close(trainer.channel.gains, ref.channel.gains)

    jp = jax.tree.map(jnp.asarray, jp)
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    ts, js = trainer.optimizer.init(tp), opt.init(jp)
    for r, batch in enumerate(batches):
        tp, ts, got = trainer.train_round(tp, ts, torch_batch(batch))
        jp, js, want = jtrain.POFLTrainer.train_round(
            ref, jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        _assert_round(got, want, got_log[r], want_log[r], tp, jp)
        assert float(got["n_scheduled"]) == 2


def test_one_round_matches_the_reference_trainer_on_its_host_mesh():
    b, seed = 4, 5
    tc = jtrain.TrainerConfig(n_scheduled=1, noise_power=1e-10, stats_mode="sketch",
                              n_probes=2, dtype="float32", seed=seed)
    jcfg, tcfg, jp, batch = train_case("qwen2-0.5b", b=b, s=SEQ, seed=11)
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    trainer = _port_trainer(tcfg, 1, b, tc, seed)
    got_log = []
    trainer.train_bundle = _recording(trainer.train_bundle, got_log)
    jtrainer = jtrain.POFLTrainer(jcfg, JInputShape("small_train", SEQ, b, "train"),
                                  auto_mesh(), tc, optimizer=jopt.sgd(LR))
    want_log = []
    jtrainer.train_bundle = _recording(jtrainer.train_bundle, want_log)
    jp = jax.tree.map(jnp.asarray, jp)
    js = jtrainer.optimizer.init(jp)
    tp, ts, got = trainer.train_round(tp, trainer.optimizer.init(tp), torch_batch(batch))
    jp, js, want = jtrainer.train_round(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
    _assert_round(got, want, got_log[0], want_log[0], tp, jp)


def test_loss_mode_keeps_the_reference_unit_stats_and_main_runs(capsys):
    """``stats_mode="loss"``: the reference never refreshes ``_loss_stats``,
    so every round schedules on mean 0, var 1, norm 1 (ROADMAP C); and the
    ``__main__`` loop at a CPU size."""
    jcfg, tcfg, jp, batch = train_case("qwen2-0.5b", b=4, s=SEQ, seed=12)
    tc = ttrain.TrainerConfig(n_scheduled=2, stats_mode="loss", dtype="float32")
    trainer = ttrain.POFLTrainer(tcfg, InputShape("t", SEQ, 4, "train"),
                                 make_host_mesh(1, 4, "cpu"), tc)
    assert trainer.stats_bundle is None
    params, opt_state = trainer.init_state(0)
    for _ in range(2):
        stats = trainer._round_stats(params, torch_batch(batch))
        assert stats.mean.tolist() == [0.0] * 4 and stats.norm.tolist() == [1.0] * 4
        params, opt_state, diag = trainer.train_round(params, opt_state, torch_batch(batch))
        assert np.isfinite(float(diag["loss"]))
    ttrain.main(["--device", "cpu", "--rounds", "3", "--layers", "1", "--dmodel", "64",
                 "--seq", "16", "--batch", "8"])
    out = capsys.readouterr().out
    assert "8 FL devices on cpu" in out and "loss:" in out


@pytest.mark.parametrize("policy", ["noisefree", "channel"])
def test_policies_schedule_as_the_reference_does(policy):
    """``schedule_round`` alone, from one set of stats, for a policy with
    no noise and one without importance."""
    n_fl, seed = 6, 2
    tc = jtrain.TrainerConfig(policy=policy, n_scheduled=3, noise_power=1e-10, seed=seed,
                              stats_mode="loss", dtype="float32")
    jcfg, tcfg, _, _ = train_case("qwen2-0.5b")
    trainer = _port_trainer(tcfg, n_fl, 6, tc, seed)
    ref, _ = _reference_in_process(jcfg, tc, n_fl, 6, seed)
    rng = np.random.default_rng(1)
    norm, var = (rng.uniform(0.1, 2.0, n_fl).astype(np.float32) for _ in range(2))
    from repro.core.aircomp import GradStats as JGradStats
    from repro_torch.core.aircomp import GradStats

    got = trainer.schedule_round(GradStats(torch.zeros(n_fl), torch.tensor(var),
                                           torch.tensor(norm)))
    want = jtrain.POFLTrainer.schedule_round(ref, JGradStats(jnp.zeros(n_fl), jnp.asarray(var),
                                                             jnp.asarray(norm)))
    for g, w in zip(got[:2], want[:2]):
        assert_close(g, w)
    for f in ("e_com", "a"):
        assert_close(got[2][f], want[2][f])
    if policy == "noisefree":
        assert float(got[1]) == 0.0
