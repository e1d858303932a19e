"""The port's K-step local update (``repro_torch.core.local_update``) held
against the live reference on identical inputs and draws (CPU).

Every algorithm × K ∈ {1, 2, 3} on logreg and the narrow CNN, by static
(``cfg.local_algorithm``) and by per-cell id dispatch, from a non-zero
FedDyn/SCAFFOLD state: the upload Δ and the new state within 1e-5 of the
reference relative to its scale. The mini-batch rows are the reference's
(its K-way split of the batch key, ``_torch_parity.jax_batch_rows``). The
cell-batched stage is held to the reference cell by cell. Lemma 2
(unbiasedness of the Eq. 37 and Horvitz–Thompson aggregates of the K-step
deltas over the available devices) is checked in law on the port's own
draws, as ``tests/test_local_update.py`` checks the reference's.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, cfg_to_torch, data_to_torch, jax_batch_rows, t

from repro.core import local_update as jlu
from repro.core import pofl as jpofl
from repro.models import small as jsmall
from repro_torch.convert import params_from_jax
from repro_torch.core import local_update as tlu
from repro_torch.core import pofl as tpofl
from repro_torch.core import scheduling as tsched
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.numerics import safe_div
from repro_torch.flatten_util import tree_map
from repro_torch.models import small as tsmall
from repro_torch.sim.scenario import make_channel_process
from repro_torch.sim.tasks import make_model_task

ALGORITHMS = jlu.ALGORITHMS

# kind -> (init, jax loss, port loss, sample shape, devices, rows a device)
MODELS = {
    "logreg": (jsmall.init_logreg, jsmall.logreg_loss, tsmall.logreg_loss, (784,), 3, 6),
    "cnn": (jsmall.init_cnn, jsmall.cnn_loss, tsmall.cnn_loss, (32, 32, 3), 2, 4),
}


def test_id_tables_match_reference():
    assert tlu.ALGORITHMS == jlu.ALGORITHMS
    assert tlu.ALGORITHM_IDS == jlu.ALGORITHM_IDS
    assert tlu.STATELESS == jlu.STATELESS
    assert (tlu.FEDAVG_ID, tlu.FEDPROX_ID, tlu.FEDDYN_ID, tlu.SCAFFOLD_ID) == (
        jlu.FEDAVG_ID, jlu.FEDPROX_ID, jlu.FEDDYN_ID, jlu.SCAFFOLD_ID)
    assert [tlu.algorithm_id(a) for a in ALGORITHMS] == [jlu.algorithm_id(a) for a in ALGORITHMS]
    assert tlu.AlgState._fields == jlu.AlgState._fields
    with pytest.raises(ValueError, match="unknown local_algorithm"):
        tlu.algorithm_id("sgd")
    for alg in ALGORITHMS:
        for full in (False, True):
            got, want = tlu.init_state(alg, 3, 5, full=full), jlu.init_state(alg, 3, 5, full=full)
            if want is None:
                assert got is None
                continue
            for g_, w_ in zip(got, want):
                assert (g_ is None) == (w_ is None)
                if w_ is not None:
                    assert g_.shape == w_.shape and not g_.any()


def _setup(kind, seed=0, n_samples=None):
    init, jloss, tloss, shape, n, m = MODELS[kind]
    jparams = init(jax.random.PRNGKey(seed))
    kx, ky, kh, kc = jax.random.split(jax.random.PRNGKey(seed + 1), 4)
    data = jpofl.DeviceData(
        features=jax.random.normal(kx, (n, m) + shape),
        labels=jax.random.randint(ky, (n, m), 0, 10),
        n_samples=n_samples,
    )
    dim = jax.flatten_util.ravel_pytree(jparams)[0].size
    # a non-zero state, so every rule and both updates are exercised
    h = 0.01 * jax.random.normal(kh, (n, dim))
    c = 0.01 * jax.random.normal(kc, (n, dim))
    return jparams, jloss, tloss, data, h, c


def _states(alg, h, c, traced):
    """The reference's and the port's state for ``alg``'s dispatch."""
    if traced:
        fields = dict(h=h, c=c)
    else:
        fields = {"feddyn": dict(h=h), "scaffold": dict(c=c)}.get(alg)
    if fields is None:
        return None, None
    return jlu.AlgState(**fields), tlu.AlgState(**{k: t(v) for k, v in fields.items()})


def _assert_state_close(got, want):
    if want is None:
        assert got is None
        return
    for g_, w_ in zip(got, want):
        assert (g_ is None) == (w_ is None)
        if w_ is not None:
            assert_close(g_, w_)


@pytest.mark.parametrize("traced", [False, True], ids=["static", "traced"])
@pytest.mark.parametrize("k_steps", [1, 2, 3])
@pytest.mark.parametrize("alg", ALGORITHMS)
@pytest.mark.parametrize("kind", ["logreg", "cnn"])
def test_local_update_stage_matches_reference(kind, alg, k_steps, traced):
    jparams, jloss, tloss, data, h, c = _setup(kind)
    jcfg = jpofl.POFLConfig(
        n_devices=data.features.shape[0], batch_size=2, local_algorithm=alg,
        local_steps=k_steps, fedprox_mu=0.1, feddyn_alpha=0.2,
        local_lr=0.05 if kind == "cnn" else None,
    )
    k_batch = jax.random.PRNGKey(5)
    jstate, tstate = _states(alg, h, c, traced)
    want_delta, want_state = jlu.local_update_stage(
        jloss, data, jcfg, jparams, k_batch, jnp.float32(2), alg_state=jstate,
        algorithm_id=jnp.int32(jlu.algorithm_id(alg)) if traced else None,
    )
    got_delta, got_state = tlu.local_update_stage(
        tloss, data_to_torch(data), cfg_to_torch(jcfg), params_from_jax(jparams, device="cpu"),
        jax_batch_rows(jcfg, data, k_batch), 2, alg_state=tstate,
        algorithm_id=torch.tensor(tlu.algorithm_id(alg)) if traced else None,
    )
    assert_close(got_delta, want_delta)
    _assert_state_close(got_state, want_state)


@pytest.mark.parametrize("kind,k_steps", [("logreg", 1), ("logreg", 3), ("cnn", 2)])
def test_cells_stage_matches_reference_cell_by_cell(kind, k_steps):
    """Four cells, one an algorithm, each from its own params, state and
    rows (padded heterogeneous shards), against the reference's per-cell
    id dispatch."""
    n = MODELS[kind][4]
    ns = np.array([MODELS[kind][5], 2, 3][:n], np.int32)
    jparams, jloss, tloss, data, h, c = _setup(kind, seed=3, n_samples=ns)
    flat0, unravel = jax.flatten_util.ravel_pytree(jparams)
    jcfg = jpofl.POFLConfig(n_devices=n, batch_size=3, local_steps=k_steps,
                            local_algorithm=jlu.ALGORITHMS[0], fedprox_mu=0.3,
                            feddyn_alpha=0.1)
    want, rows, cells = [], [], []
    for cell, alg in enumerate(ALGORITHMS):
        p = unravel(flat0 * (1.0 + 0.1 * cell))
        st = jlu.AlgState(h=h * (cell + 1), c=c * (cell - 1))
        k_batch = jax.random.PRNGKey(20 + cell)
        want.append(jlu.local_update_stage(jloss, data, jcfg, p, k_batch, jnp.float32(1),
                                           alg_state=st,
                                           algorithm_id=jnp.int32(jlu.algorithm_id(alg))))
        rows.append(jax_batch_rows(jcfg, data, k_batch))
        cells.append((params_from_jax(p, device="cpu"), st))
    params_c = _stack([p for p, _ in cells])
    state_c = tlu.AlgState(h=torch.stack([t(s.h) for _, s in cells]),
                           c=torch.stack([t(s.c) for _, s in cells]))
    got_delta, got_state = tlu.local_update_stage_cells(
        tloss, data_to_torch(data), cfg_to_torch(jcfg), params_c, torch.stack(rows), 1,
        alg_state_c=state_c, algorithm_id_c=torch.arange(len(ALGORITHMS)),
    )
    for cell, (w_delta, w_state) in enumerate(want):
        assert_close(got_delta[cell], w_delta)
        assert_close(got_state.h[cell], w_state.h)
        assert_close(got_state.c[cell], w_state.c)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([tr[k] for tr in trees]) for k in trees[0]}
    return torch.stack(trees)


def test_static_cells_stage_carries_the_named_state():
    """A one-algorithm lattice dispatches statically: FedDyn's cells carry
    only ``h``, and each cell is the single-cell stage of its slice."""
    jparams, jloss, tloss, data, h, _ = _setup("logreg", seed=4)
    tdata = data_to_torch(data)
    cfg = tpofl.POFLConfig(n_devices=3, batch_size=2, local_algorithm="feddyn", local_steps=2)
    params = params_from_jax(jparams, device="cpu")
    params_c = tree_map(lambda p: torch.stack([p, 1.1 * p]), params)
    hs = torch.stack([t(h), -t(h)])
    rows = torch.randint(0, 6, (2, 2, 3, 2), generator=torch.Generator().manual_seed(0))
    delta, state = tlu.local_update_stage_cells(tloss, tdata, cfg, params_c, rows, 0,
                                                alg_state_c=tlu.AlgState(h=hs))
    assert state.c is None and state.h.shape == hs.shape
    for cell in range(2):
        one = tree_map(lambda p, cell=cell: p[cell], params_c)
        d1, s1 = tlu.local_update_stage(tloss, tdata, cfg, one, rows[cell], 0,
                                        alg_state=tlu.AlgState(h=hs[cell]))
        assert_close(delta[cell], d1.numpy())
        assert_close(state.h[cell], s1.h.numpy())


def test_dispatch_error_contracts():
    jparams, _, tloss, data, h, _ = _setup("logreg")
    tdata, params = data_to_torch(data), params_from_jax(jparams, device="cpu")
    rows = torch.zeros(2, 3, 2, dtype=torch.int64)
    cfg = tpofl.POFLConfig(n_devices=3, batch_size=2, local_steps=2)
    with pytest.raises(ValueError, match="unknown local_algorithm"):
        tlu.local_update_stage(tloss, tdata, dataclasses.replace(cfg, local_algorithm="sgd"),
                               params, rows, 0)
    for alg in ("feddyn", "scaffold"):
        with pytest.raises(ValueError, match="needs per-device AlgState"):
            tlu.local_update_stage(tloss, tdata, dataclasses.replace(cfg, local_algorithm=alg),
                                   params, rows, 0)
    with pytest.raises(ValueError, match="full=True"):
        tlu.local_update_stage(tloss, tdata, cfg, params, rows, 0,
                               alg_state=tlu.AlgState(h=t(h)), algorithm_id=torch.tensor(2))
    with pytest.raises(ValueError, match="local_steps must be >= 1"):
        tlu.local_update_stage(tloss, tdata, dataclasses.replace(cfg, local_steps=0),
                               params, rows, 0)
    with pytest.raises(ValueError, match="local_steps=3 takes mini-batch rows"):
        tlu.local_update_stage(tloss, tdata, dataclasses.replace(cfg, local_steps=3),
                               params, rows, 0)


def _lemma2(algorithm, policy, scenario, k_steps, seed):
    """Conditional on the realised availability, the Eq. 37 draw (|S| = 1,
    exact enumeration) and the Horvitz–Thompson variant (analytic mean)
    are unbiased for Σ_{i avail} (m_i/M)·Δ_i, Δ_i the port's K-step delta on
    its own draws (the reference's ``_check_lemma2``)."""
    task = make_model_task("logreg", n_devices=6, partition="dirichlet_sized", n_train=120,
                           n_test=32, seed=5, dim=16, device="cpu")
    n, dim = task.data.n_devices, task.dim
    gen = torch.Generator().manual_seed(seed)
    cfg = tpofl.POFLConfig(n_devices=n, n_scheduled=1, batch_size=4,
                           local_algorithm=algorithm, local_steps=k_steps, local_lr=0.05,
                           fedprox_mu=0.1, feddyn_alpha=0.2)
    rows = torch.stack([tlu.minibatch_indices(task.data, 4, gen) for _ in range(k_steps)])
    state = tlu.init_state(algorithm, n, dim)
    if state is not None:  # a non-zero state: the rules then differ from FedAvg's
        state = tlu.AlgState(*(None if f is None else 0.01 * torch.randn(n, dim, generator=gen)
                               for f in state))
    delta, _ = tlu.local_update_stage(task.loss_fn, task.data, cfg, task.params0,
                                      rows if k_steps > 1 else rows[0], 0, alg_state=state)
    delta = delta.double()
    assert delta.shape == (n, dim) and bool(torch.isfinite(delta).all())

    params = {"p_drop": 0.4} if scenario == "dropout" else {"p_depart": 0.3, "p_arrive": 0.3}
    proc = make_channel_process(scenario, ChannelConfig(n_devices=n), **params)
    chan = proc.init(gen)
    for _ in range(4):  # roll so the churn chain trends
        chan, h, avail = proc.step(chan, proc.draw(gen))

    frac = task.data.data_frac
    norms = torch.linalg.vector_norm(delta.float(), dim=1) + 1e-3
    probs = tsched.scheduling_probs(policy, norms, torch.ones(n), h.abs(), frac, dim, 0.1,
                                    1.0, 1e-9)
    probs_a = safe_div(probs * avail, (probs * avail).sum())
    target = ((avail * frac).double()[:, None] * delta).sum(0)
    if int(avail.sum()) == 0:
        assert bool((probs_a == 0).all())
        return
    est = torch.zeros(dim, dtype=torch.float64)
    for i in range(n):
        if float(probs_a[i]) == 0.0:
            continue  # unavailable: never drafted
        sched = tsched.Schedule(indices=torch.tensor([i], dtype=torch.int32),
                                step_probs=probs_a[i:i + 1],
                                mask=torch.zeros(n).index_fill(0, torch.tensor([i]), 1.0))
        rho = tsched.aggregation_weights(sched, probs_a, frac, 1)
        assert bool((rho * (1.0 - avail) == 0).all())
        est += float(probs_a[i]) * ((rho * sched.mask).double()[:, None] * delta).sum(0)
    np.testing.assert_allclose(est.numpy(), target.numpy(), rtol=1e-4, atol=1e-5)
    pi = tsched.bernoulli_inclusion_probs(probs_a, min(2, int(avail.sum())))
    rho_ht = tsched.bernoulli_weights(pi, frac)
    est_ht = ((avail * pi * rho_ht).double()[:, None] * delta).sum(0)
    np.testing.assert_allclose(est_ht.numpy(), target.numpy(), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("scenario,k_steps", [("dropout", 2), ("churn", 3)])
@pytest.mark.parametrize("policy", tsched.POLICIES)
@pytest.mark.parametrize("alg", ALGORITHMS)
def test_lemma2_unbiased_over_k_step_deltas(alg, policy, scenario, k_steps):
    _lemma2(alg, policy, scenario, k_steps, seed=7 + k_steps)
