"""The port's channel processes and data partitions (``repro_torch.sim.scenario``,
``repro_torch.data.partition``) held against the live reference (CPU).

Partitions are numpy-seeded on both sides, so every Dirichlet preset must
give the reference's shards bitwise. A channel process steps on the random
primitives the reference's ``step`` draws from its key
(``_torch_parity.jax_step_prims``), from the reference's own state, over
several rounds: ``h`` and the state within 1e-5 relative, ``avail`` exactly.
The laws of the port's own draws (``torch.Generator``) are checked as the
reference's ``tests/test_sim.py`` checks its own: Gauss–Markov's stationary
power and lag-1 correlation, churn's stationary online share and lag-1
autocorrelation, dropout's rate, mobility's cell.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, jax_step_prims, t, to_torch_tree

from repro.core.channel import ChannelConfig as JChannelConfig
from repro.data import partition as jpart
from repro.data.synthetic import make_classification_dataset as jax_dataset
from repro.sim import scenario as jscen
from repro_torch.core.channel import ChannelConfig
from repro_torch.data import partition as tpart
from repro_torch.sim import scenario as tscen


def test_registries_match_reference():
    assert tscen.CHANNEL_SCENARIOS == jscen.CHANNEL_SCENARIOS
    assert tscen.PARTITIONS == jscen.PARTITIONS
    for name in tscen.CHANNEL_SCENARIOS:
        got = tscen.make_channel_process(name, ChannelConfig(n_devices=4))
        want = jscen.make_channel_process(name, JChannelConfig(n_devices=4))
        assert type(got).__name__ == type(want).__name__
        assert got.can_drop == want.can_drop
    with pytest.raises(ValueError, match="unknown channel scenario"):
        tscen.make_channel_process("rician", ChannelConfig())
    with pytest.raises(ValueError, match="unknown partition"):
        tscen.make_partition("powerlaw", np.zeros((4, 2)), np.zeros(4), 2)


def _dataset(kind: str, n: int, seed: int = 2):
    x, y = jax_dataset(kind, n, jax.random.PRNGKey(seed))
    return np.asarray(x), np.asarray(y)


# (preset, kwargs): every Dirichlet preset, several concentrations
DIRICHLET_CASES = [
    ("dirichlet", dict(beta=0.3)),
    ("dirichlet", dict(beta=5.0)),
    ("dirichlet_sized", dict(beta=0.4)),
    ("dirichlet_sized", dict(beta=0.1, min_per_device=5)),
    ("dirichlet_mixed", dict(beta=0.3, beta_size=0.5)),
    ("dirichlet_mixed", dict(beta=2.0, beta_size=0.2, min_per_device=3)),
]


@pytest.mark.parametrize("kind", ["mnist_like", "cifar_like"])
@pytest.mark.parametrize("preset,kw", DIRICHLET_CASES)
def test_dirichlet_presets_match_reference_bitwise(preset, kw, kind):
    x, y = _dataset(kind, 300 if kind == "mnist_like" else 120)
    want = jscen.make_partition(preset, x, y, 12, seed=7, **kw)
    got = tscen.make_partition(preset, x, y, 12, seed=7, **kw)
    np.testing.assert_array_equal(got.features.numpy(), np.asarray(want.features))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    if want.n_samples is None:
        assert got.n_samples is None
    else:
        np.testing.assert_array_equal(got.n_samples.numpy(), np.asarray(want.n_samples))
        assert got.n_samples.dtype == torch.int64
    assert_close(got.data_frac, want.data_frac)


@pytest.mark.parametrize("beta,min_per", [(0.5, 1), (0.05, 4), (50.0, 1)])
def test_dirichlet_sizes_match_reference(beta, min_per):
    got = tpart.dirichlet_sizes(500, 30, beta=beta, min_per_device=min_per, seed=3)
    want = jpart.dirichlet_sizes(500, 30, beta=beta, min_per_device=min_per, seed=3)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 500 and got.min() >= min_per
    with pytest.raises(ValueError, match="cannot give"):
        tpart.dirichlet_sizes(10, 6, min_per_device=2)


# (scenario, params): every process, the droppers over each kind of base
PROCESS_CASES = [
    ("static_rayleigh", {}),
    ("gauss_markov", dict(corr=0.8)),
    ("mobility", dict(speed=3.0)),
    ("dropout", dict(p_drop=0.3)),
    ("dropout", dict(p_drop=0.5, base="gauss_markov", corr=0.95)),
    ("churn", dict(p_depart=0.3, p_arrive=0.4)),
    ("churn", dict(base="mobility", speed=8.0, p_depart=0.2, p_arrive=0.5, init_online=0.5)),
]


@pytest.mark.parametrize("scenario,params", PROCESS_CASES)
def test_process_steps_match_reference_on_its_draws(scenario, params):
    n = 16
    jproc = jscen.make_channel_process(scenario, JChannelConfig(n_devices=n), **dict(params))
    tproc = tscen.make_channel_process(scenario, ChannelConfig(n_devices=n), **dict(params))
    jstate = jproc.init(jax.random.PRNGKey(11))
    tstate = to_torch_tree(jstate)
    for k in jax.random.split(jax.random.PRNGKey(12), 6):
        jstate, jh, javail = jproc.step(jstate, k)
        tstate, th, tavail = tproc.step(tstate, jax_step_prims(jproc, k))
        assert th.dtype == torch.complex64 and tavail.dtype == torch.float32
        assert_close(torch.view_as_real(th), np.stack([np.real(jh), np.imag(jh)], -1))
        np.testing.assert_array_equal(tavail.numpy(), np.asarray(javail))
        for got, want in zip(jax.tree.leaves(tstate), jax.tree.leaves(jstate)):
            if torch.is_complex(got):
                got, want = torch.view_as_real(got), np.stack([np.real(want), np.imag(want)], -1)
            assert_close(got, want)


def test_bernoulli_is_a_uniform_below_p():
    """The identity the dropout and churn primitives rest on."""
    for i in range(50):
        k = jax.random.PRNGKey(i)
        for p in (0.05, 0.3, 0.9):
            np.testing.assert_array_equal(
                np.asarray(jax.random.bernoulli(k, p, (64,))),
                np.asarray(jax.random.uniform(k, (64,)) < p))


def test_mobility_reflection_takes_the_divisors_sign():
    """A walk far outside the cell, on both sides: ``jnp.mod`` is
    ``torch.remainder`` (``torch.fmod`` would leave the cell below d_min)."""
    cfg = ChannelConfig(n_devices=6)
    proc = tscen.make_channel_process("mobility", cfg, speed=1.0)
    dist = torch.tensor([10.0, 50.0, 30.0, 30.0, 11.0, 49.0])
    walk = torch.tensor([-75.0, 143.0, -260.0, 300.0, -0.5, 0.5])
    zeros = torch.zeros(6)
    (got,), _, _ = proc.step((dist,), (walk, zeros, zeros))
    want = jnp.asarray(dist.numpy()) + jnp.asarray(walk.numpy())
    lo, span = 10.0, 40.0
    want = lo + jnp.abs(jnp.mod(want - lo, 2.0 * span) - span)
    assert_close(got, want)
    assert bool(((got >= cfg.d_min) & (got <= cfg.d_max)).all())


def _rollout(proc, steps: int, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    state = proc.init(gen)
    hs, avails = [], []
    for _ in range(steps):
        state, h, avail = proc.step(state, proc.draw(gen))
        hs.append(h)
        avails.append(avail)
    return state, torch.stack(hs), torch.stack(avails)


def test_gauss_markov_law_on_torch_draws():
    """h_t stays CN(0, g_i) with lag-1 correlation ρ (the reference's
    ``test_gauss_markov_stationary_moments``, on the port's generator)."""
    proc = tscen.make_channel_process("gauss_markov", ChannelConfig(n_devices=6), corr=0.8)
    gains = proc.init(torch.Generator().manual_seed(0))[0]
    _, hs, avails = _rollout(proc, 4000)
    assert bool((avails == 1).all())
    power = (hs.abs() ** 2).mean(0)
    np.testing.assert_allclose(power.numpy(), gains.numpy(), rtol=0.15)
    assert hs.mean(0).abs().max() < 0.15 * gains.max().sqrt()
    rho_hat = (hs[1:] * hs[:-1].conj()).mean(0).real / power
    np.testing.assert_allclose(rho_hat.numpy(), 0.8, atol=0.1)


def test_churn_law_on_torch_draws():
    """Churn is a sticky chain: stationary share p_a/(p_a+p_d), lag-1
    autocorrelation 1 − p_a − p_d, multi-round outages."""
    p_dep, p_arr = 0.1, 0.3
    proc = tscen.make_channel_process("churn", ChannelConfig(n_devices=24),
                                      p_depart=p_dep, p_arrive=p_arr)
    _, _, avails = _rollout(proc, 3000, seed=2)
    av = avails.numpy()
    assert set(np.unique(av)) <= {0.0, 1.0}
    np.testing.assert_allclose(av.mean(), p_arr / (p_arr + p_dep), atol=0.04)
    centered = av - av.mean(axis=0)
    autocorr = float((centered[1:] * centered[:-1]).mean() / (centered**2).mean())
    np.testing.assert_allclose(autocorr, 1.0 - p_arr - p_dep, atol=0.08)
    runs = []
    for dev in range(av.shape[1]):
        off = av[:, dev] == 0
        edges = np.flatnonzero(np.diff(np.concatenate([[0], off, [0]])))
        runs.extend((edges[1::2] - edges[::2]).tolist())
    assert np.mean(runs) > 2.0  # E[offline sojourn] = 1/p_arrive ≈ 3.3


def test_churn_initial_share_and_base_untouched():
    """The initial presence follows ``init_online`` (the stationary share
    by default), and churn gates availability only: its fading is the
    base process's on the same primitives."""
    cfg = ChannelConfig(n_devices=4000)
    for kw, share in ((dict(p_depart=0.1, p_arrive=0.3), 0.75), (dict(init_online=0.2), 0.2)):
        proc = tscen.make_channel_process("churn", cfg, **kw)
        online0 = proc.init(torch.Generator().manual_seed(1))[1]
        np.testing.assert_allclose(online0.mean().item(), share, atol=0.03)
    proc = tscen.make_channel_process("churn", ChannelConfig(n_devices=8),
                                      base="gauss_markov", corr=0.9)
    base = dataclasses.replace(proc.base)
    gen = torch.Generator().manual_seed(4)
    state = proc.init(gen)
    prims = proc.draw(gen)
    _, h_c, _ = proc.step(state, prims)
    _, h_b, _ = base.step(state[0], prims[0])
    assert torch.equal(h_c, h_b)


def test_dropout_and_mobility_laws_on_torch_draws():
    proc = tscen.make_channel_process("dropout", ChannelConfig(n_devices=20), p_drop=0.3)
    _, _, avails = _rollout(proc, 2000, seed=3)
    np.testing.assert_allclose(avails.mean().item(), 0.7, atol=0.02)
    lag = ((avails[1:] - 0.7) * (avails[:-1] - 0.7)).mean() / avails.var()
    assert abs(lag.item()) < 0.05  # i.i.d. flicker, unlike churn
    cfg = ChannelConfig(n_devices=10)
    proc = tscen.make_channel_process("mobility", cfg, speed=15.0)
    (dist,), hs, avails = _rollout(proc, 500, seed=5)
    assert bool(((dist >= cfg.d_min) & (dist <= cfg.d_max)).all())
    assert bool(torch.isfinite(torch.view_as_real(hs)).all()) and bool((avails == 1).all())


def test_mobility_at_speed_zero_mirrors_the_cell_as_the_reference_does():
    """The reference's reflection maps d to d_min + d_max − d each round
    (a quirk kept: ROADMAP queue C); the port steps the same way."""
    jproc = jscen.make_channel_process("mobility", JChannelConfig(n_devices=5), speed=0.0)
    tproc = tscen.make_channel_process("mobility", ChannelConfig(n_devices=5), speed=0.0)
    dist = jnp.asarray([10.0, 20.0, 30.0, 45.0, 50.0])
    k = jax.random.PRNGKey(3)
    (want,), _, _ = jproc.step((dist,), k)
    (got,), _, _ = tproc.step((t(dist),), jax_step_prims(jproc, k))
    assert_close(got, want)
    np.testing.assert_allclose(np.asarray(want), 60.0 - np.asarray(dist))
