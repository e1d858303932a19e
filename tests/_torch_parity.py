"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

The port is held against the live JAX functions on identical inputs: arrays
cross as numpy, and every random draw is made in JAX with the reference
engine's key discipline (``repro/sim/engine.py:12-15``) and handed to both
packages as values.

A lattice is replayed per seed: every cell of seed s starts from
``PRNGKey(s)`` in the reference, so the port's one draw stream per distinct
seed (``SimEngine.draw_stream`` / ``SimEngine.next_draws``) is replaced by
:func:`jax_engine_draws` of that seed (a stream is then the pair (seed,
round) as a tensor, so a replayed run's carry is still tensors only and goes
through a checkpoint), with the policy-fused sampler input (a ``cfg`` whose policy is
``FUSED_POLICY``), under any channel scenario: the reference process's
``h`` and ``avail``, and the K-way split of the mini-batch key.

A channel process of the port computes its step from random primitives
given as tensors; :func:`jax_step_prims` gives the ones the reference's
``step`` consumes from its key, so both sides step on the same values.

:func:`lattice_case` builds one small logreg lattice for both packages,
the port's draws replayed per seed (:func:`replay_per_seed`), and
:func:`assert_records_match` holds two ``LatticeRecords`` to each other.

Tolerance: float outputs agree to 1e-5 relative to the scale of the
reference value (``atol = rtol · max|want|``), the cross-framework bound
of ROADMAP ground rule 5; decisions (masks, indices, counts) match exactly.
"""
from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import pofl as jpofl
from repro.core.channel import ChannelConfig as JChannelConfig
from repro.data.partition import partition_dirichlet_sized, partition_noniid_shards
from repro.data.synthetic import make_classification_dataset
from repro.models import small as jsmall
from repro.obs.config import ObsConfig as JObsConfig
from repro.sim import lattice as jlattice
from repro.sim import scenario as jscen
from repro.sim.engine import FUSED_POLICY
from repro.sim.scenario import make_channel_process
from repro.sim.tasks import TaskEval as JTaskEval
from repro_torch.convert import params_from_jax
from repro_torch.core import pofl as tpofl
from repro_torch.core.channel import ChannelConfig
from repro_torch.models import small as tsmall
from repro_torch.obs.config import ObsConfig
from repro_torch.sim import engine as tengine
from repro_torch.sim import lattice as tlattice
from repro_torch.sim.engine import RoundDraws
from repro_torch.sim.tasks import TaskEval as TTaskEval

# The tier-1 suite runs six pytest workers on one host next to the JAX
# tests, some of them timing-bound; torch's default intra-op pool (one
# thread per core in every worker) would oversubscribe the cores.
torch.set_num_threads(1)

RTOL = 1e-5


def t(x, dtype=None) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor (copied)."""
    return torch.tensor(np.asarray(x), dtype=dtype)


def assert_close(got, want, rtol: float = RTOL) -> None:
    """``got`` (tensor) within ``rtol`` of ``want`` relative to want's scale."""
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def data_to_torch(dd: jpofl.DeviceData) -> tpofl.DeviceData:
    return tpofl.DeviceData(
        features=t(dd.features, torch.float32),
        labels=t(dd.labels, torch.int64),
        n_samples=None if dd.n_samples is None else t(dd.n_samples, torch.int64),
    )


def cfg_to_torch(cfg: jpofl.POFLConfig) -> tpofl.POFLConfig:
    """The port's config with the reference's values (shared fields)."""
    names = {f.name for f in dataclasses.fields(tpofl.POFLConfig)}
    return tpofl.POFLConfig(
        **{k: v for k, v in dataclasses.asdict(cfg).items() if k in names}
    )


def jax_batch_idx(data: jpofl.DeviceData, batch_size: int, k_batch) -> torch.Tensor:
    """The rows ``repro.core.local_update.draw_minibatch`` draws from k_batch."""
    n, m = data.features.shape[:2]
    if data.n_samples is None:
        idx = jax.random.randint(k_batch, (n, batch_size), 0, m)
    else:
        ns = jnp.asarray(data.n_samples, jnp.int32)
        u = jax.random.uniform(k_batch, (n, batch_size))
        idx = jnp.minimum((u * ns[:, None].astype(u.dtype)).astype(jnp.int32), ns[:, None] - 1)
    return t(idx, torch.int64)


def jax_sched_draw(cfg: jpofl.POFLConfig, k_sched) -> torch.Tensor:
    """The sampler's input the reference consumes from k_sched: per-step
    Gumbel vectors of the sequential ``jax.random.categorical`` draws, the
    top-k Gumbel vector, or the Bernoulli uniforms.

    A policy-fused ``cfg`` (``FUSED_POLICY``: the policy is a per-cell id)
    with the Bernoulli sampler gives both inputs the reference's fused ``scheduling_stage`` consumes from the
    same k_sched — the sequential draw's Gumbel vectors, then the uniforms
    (``repro/core/pofl.py:404-410``) — as the port's (S+1, N) tensor.
    """
    n = cfg.n_devices
    keys = jax.random.split(k_sched, cfg.n_scheduled)
    gumbels = jnp.stack([jax.random.gumbel(k, (n,), jnp.float32) for k in keys])
    if cfg.policy == FUSED_POLICY and cfg.sampler == "bernoulli":
        uniforms = jax.random.uniform(k_sched, (n,))
        return t(jnp.concatenate([gumbels, uniforms[None]]))
    if cfg.policy != "deterministic" and cfg.sampler == "bernoulli":
        return t(jax.random.uniform(k_sched, (n,)))
    if cfg.sampler == "topk":
        return t(jax.random.gumbel(k_sched, (n,)))
    return t(gumbels)


def jax_noise(k_noise, dim: int) -> torch.Tensor:
    return t(jax.random.normal(k_noise, (dim,)))


def jax_batch_rows(cfg, data: jpofl.DeviceData, k_batch) -> torch.Tensor:
    """The rows of a round's K local steps: (N, B) from k_batch at K = 1,
    else (K, N, B) from its K-way split (``repro/core/local_update.py:289``)."""
    if cfg.local_steps == 1:
        return jax_batch_idx(data, cfg.batch_size, k_batch)
    return torch.stack([jax_batch_idx(data, cfg.batch_size, k)
                        for k in jax.random.split(k_batch, cfg.local_steps)])


def jax_engine_draws(cfg, channel_cfg, data: jpofl.DeviceData, dim: int, seed: int,
                     scenario: str = "static_rayleigh", scenario_params: dict | None = None):
    """The reference engine's draws for a run, round after round, as the
    port's :class:`RoundDraws` (``repro/sim/engine.py:12-15, 376-377``)."""
    proc = make_channel_process(scenario, channel_cfg, **dict(scenario_params or {}))
    key = jax.random.PRNGKey(seed)
    k_chan_init, key = jax.random.split(key)
    chan = proc.init(k_chan_init)
    while True:
        key, k_round = jax.random.split(key)
        k_batch, k_chan, k_sched, k_noise = jax.random.split(k_round, 4)
        chan, h, avail = proc.step(chan, k_chan)
        yield RoundDraws(
            h=t(h),
            batch_idx=jax_batch_rows(cfg, data, k_batch),
            sched=jax_sched_draw(cfg, k_sched),
            z=jax_noise(k_noise, dim),
            avail=t(avail),
        )


def _fading_prims(key, n: int) -> tuple:
    """``repro.core.channel.sample_channels``'s normals (re, im) from ``key``."""
    k_re, k_im = jax.random.split(key)
    return t(jax.random.normal(k_re, (n,))), t(jax.random.normal(k_im, (n,)))


def jax_step_prims(proc, key) -> tuple:
    """The random primitives the reference process ``proc``'s ``step``
    draws from ``key``, in the form the port's ``step`` takes them
    (``repro/sim/scenario.py:95-210``); a Bernoulli draw is its uniforms."""
    if isinstance(proc, (jscen.StaticRayleigh, jscen.GaussMarkov)):
        return _fading_prims(key, proc.cfg.n_devices)
    if isinstance(proc, jscen.Mobility):
        k_walk, k_fade = jax.random.split(key)
        n = proc.cfg.n_devices
        return (t(jax.random.normal(k_walk, (n,))),) + _fading_prims(k_fade, n)
    if isinstance(proc, (jscen.Dropout, jscen.Churn)):
        k_base, k_u = jax.random.split(key)
        n = proc.base.cfg.n_devices
        return jax_step_prims(proc.base, k_base), t(jax.random.uniform(k_u, (n,)))
    raise TypeError(f"no primitives for {type(proc).__name__}")


def to_torch_tree(tree):
    """A reference state (nested tuples of arrays) as the port's."""
    if isinstance(tree, tuple):
        return tuple(to_torch_tree(x) for x in tree)
    return t(tree)


def reference_task(kind: str, n_devices: int, per_device: int, seed: int = 0):
    """A small task of the reference's model, drawn in JAX: ``(data,
    params, jax loss, jax logits, port loss, port logits, x_test, y_test)``
    (64 test rows)."""
    k_tr, k_te, k_init = jax.random.split(jax.random.PRNGKey(seed), 3)
    ds = "mnist_like" if kind == "logreg" else "cifar_like"
    x, y = make_classification_dataset(ds, n_devices * per_device, k_tr)
    x_te, y_te = make_classification_dataset(ds, 64, k_te)
    data = partition_noniid_shards(np.asarray(x), np.asarray(y), n_devices, seed=seed)
    if kind == "logreg":
        return (data, jsmall.init_logreg(k_init), jsmall.logreg_loss, jsmall.logreg_logits,
                tsmall.logreg_loss, tsmall.logreg_logits, x_te, y_te)
    return (data, jsmall.init_cnn(k_init), jsmall.cnn_loss, jsmall.cnn_logits,
            tsmall.cnn_loss, tsmall.cnn_logits, x_te, y_te)


def replay_draws(monkeypatch, draws_of) -> None:
    """The port engine's draw streams become the iterators ``draws_of(seed,
    dim)`` gives: a stream is ``DrawStream(rng=tensor([seed, round]),
    chan=())`` and each round's draws are the iterator's for that seed and
    round (so a replayed carry is still tensors only)."""
    runs: dict = {}  # (seed, dim) -> (the draws so far, their iterator)

    def start(self, seed):
        return tengine.DrawStream(rng=torch.tensor([seed, 0]), chan=())

    def advance(self, stream, dim):
        seed, rnd = (int(x) for x in stream.rng)
        drawn, it = runs.setdefault((seed, dim), ([], draws_of(seed, dim)))
        while len(drawn) <= rnd:
            drawn.append(next(it))
        return tengine.DrawStream(rng=torch.tensor([seed, rnd + 1]), chan=()), drawn[rnd]

    monkeypatch.setattr(tengine.SimEngine, "draw_stream", start)
    monkeypatch.setattr(tengine.SimEngine, "next_draws", advance)


def replay_per_seed(monkeypatch, jcfg, jccfg, data, scenario="static_rayleigh",
                    scenario_params=None):
    """The port engine's per-seed draw streams become the reference's (the
    policy-fused sampler input)."""
    fused = dataclasses.replace(jcfg, policy=FUSED_POLICY)
    replay_draws(monkeypatch, lambda seed, dim: jax_engine_draws(
        fused, jccfg, data, dim, seed, scenario, scenario_params))


def assert_records_match(got, want, rtol: float = RTOL):
    """Two ``LatticeRecords`` agree: axes, eval rounds, |S|, correct counts,
    health flags and the diagnostics' eps clamps exactly, accuracy to 1e-6,
    every float field (and tap) per cell within ``rtol`` of its scale."""
    assert got.axes == {k: list(v) for k, v in want.axes.items()}
    np.testing.assert_array_equal(got.eval_rounds, want.eval_rounds)
    assert (got.eval is None) == (want.eval is None)
    if want.eval is not None:
        assert got.eval._fields == want.eval._fields
        np.testing.assert_array_equal(got.eval.n_correct, np.asarray(want.eval.n_correct))
        np.testing.assert_allclose(got.eval.acc, np.asarray(want.eval.acc), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got.eval.loss, got.loss)
        for idx in np.ndindex(want.eval.loss.shape[:-1]):
            assert_close(got.eval.loss[idx], np.asarray(want.eval.loss)[idx], rtol)
    assert (got.health is None) == (want.health is None)
    if want.health is not None:
        np.testing.assert_array_equal(got.health.nonfinite, np.asarray(want.health.nonfinite))
    np.testing.assert_array_equal(got.n_scheduled, np.asarray(want.n_scheduled))
    np.testing.assert_allclose(got.acc, np.asarray(want.acc), rtol=0, atol=1e-6)
    floats = [(getattr(got, f), getattr(want, f)) for f in ("e_com", "e_var", "grad_norm",
                                                             "loss")]
    assert (got.diag is None) == (want.diag is None)
    if want.diag is not None:
        assert got.diag._fields == want.diag._fields
        np.testing.assert_array_equal(got.diag.eps_clamps, np.asarray(want.diag.eps_clamps))
        floats += [(getattr(got.diag, f), getattr(want.diag, f))
                   for f in ("noise_eff", "sched_entropy", "grad_norm_spread")]
    for g_, w_ in floats:
        w_ = np.asarray(w_)
        assert g_.shape == w_.shape
        for idx in np.ndindex(w_.shape[:-1]):  # each cell at its own scale
            assert_close(g_[idx], w_[idx], rtol)


def lattice_case(monkeypatch, spec_kw, cfg_kw, n=8, per_device=10,
                 scenario="static_rayleigh", scenario_params=None, task_eval=False,
                 sized=False, seeds=(0, 5), n_rounds=3, diagnostics=False) -> SimpleNamespace:
    """One logreg lattice for both packages → ``reference(**kw)`` and
    ``port(**kw)``, each ``run_lattice`` with ``kw`` added (``diagnostics``:
    both with ``ObsConfig(diagnostics=True)``); the port's draws are the
    reference's, replayed per seed. ``spec``, ``cfg`` and ``data`` are the
    port's."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    data, jparams, jloss, jlogits, tloss, tlogits, x_te, y_te = reference_task(
        "logreg", n, per_device)
    if sized:  # Dirichlet-sized shards of the same samples: padded, n_samples
        x = np.asarray(data.features).reshape(n * per_device, -1)
        y = np.asarray(data.labels).reshape(-1)
        data = partition_dirichlet_sized(x, y, n, beta=0.4, seed=2)
    jcfg = jpofl.POFLConfig(n_devices=n, n_scheduled=3, batch_size=2, **cfg_kw)
    jccfg = JChannelConfig(n_devices=n)
    spec = dict(noise_powers=(1e-10,), alphas=(0.1,), seeds=seeds, n_rounds=n_rounds,
                eval_every=2, **spec_kw)
    if task_eval:
        jeval = JTaskEval(jlogits, x_te, y_te, n_valid=50)
        teval = TTaskEval(tlogits, t(x_te), t(y_te, torch.int64), n_valid=50)
    else:
        jeval = jsmall.make_eval_fn(jlogits, jloss, x_te, y_te)
        teval = tsmall.make_eval_fn(tlogits, tloss, t(x_te), t(y_te, torch.int64))
    replay_per_seed(monkeypatch, jcfg, jccfg, data, scenario, scenario_params)
    reference = functools.partial(
        jlattice.run_lattice, jloss, data, jparams, jlattice.LatticeSpec(**spec),
        base_cfg=jcfg, eval_fn=jeval, channel_cfg=jccfg, scenario=scenario,
        scenario_params=dict(scenario_params or {}),
        **({"obs": JObsConfig(diagnostics=True)} if diagnostics else {}))
    port_kw = dict(
        loss_fn=tloss, data=data_to_torch(data), params0=params_from_jax(jparams, device="cpu"),
        spec=tlattice.LatticeSpec(**spec), base_cfg=cfg_to_torch(jcfg), eval_fn=teval,
        channel_cfg=ChannelConfig(n_devices=n), scenario=scenario,
        scenario_params=scenario_params)
    port = functools.partial(
        tlattice.run_lattice, **port_kw, device="cpu",
        **({"obs": ObsConfig(diagnostics=True)} if diagnostics else {}))
    return SimpleNamespace(reference=reference, port=port, port_kw=port_kw)


def reference_and_port_lattice(monkeypatch, spec_kw, cfg_kw, **case_kw):
    """:func:`lattice_case`'s two runs → (port records, reference records)."""
    case = lattice_case(monkeypatch, spec_kw, cfg_kw, **case_kw)
    want = case.reference()
    return case.port(), want
