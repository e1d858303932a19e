"""The port's models, local-update stage, data and tasks held against the
live reference functions on identical inputs (CPU).

Weights cross with ``repro_torch.convert.params_from_jax``; mini-batch rows
are drawn in JAX and handed to both sides. Tolerance: floats within 1e-5 of
the reference relative to its scale; partitions and shapes exactly equal.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, data_to_torch, jax_batch_idx, jax_batch_rows, t
from jax.flatten_util import ravel_pytree as jax_ravel

from repro.core import local_update as jlu
from repro.core import pofl as jpofl
from repro.data import partition as jpart
from repro.data.synthetic import make_classification_dataset as jax_dataset
from repro.models import small as jsmall
from repro_torch.convert import params_from_jax
from repro_torch.core import local_update as tlu
from repro_torch.core import pofl as tpofl
from repro_torch.data import partition as tpart
from repro_torch.data.synthetic import make_classification_dataset
from repro_torch.flatten_util import ravel_pytree
from repro_torch.models import small as tsmall
from repro_torch.sim.tasks import make_model_task

MODELS = {
    "logreg": (jsmall.init_logreg, jsmall.logreg_loss, jsmall.logreg_logits,
               tsmall.logreg_loss, tsmall.logreg_logits, (784,)),
    "cnn": (jsmall.init_cnn, jsmall.cnn_loss, jsmall.cnn_logits,
            tsmall.cnn_loss, tsmall.cnn_logits, (32, 32, 3)),
}


def _model(kind, seed=0):
    init, jloss, jlogits, tloss, tlogits, shape = MODELS[kind]
    jparams = init(jax.random.PRNGKey(seed))
    return jparams, params_from_jax(jparams, device="cpu"), jloss, jlogits, tloss, tlogits, shape


def _device_data(shape, n=3, m=6, seed=1, n_samples=None):
    kx, ky = jax.random.split(jax.random.PRNGKey(seed))
    return jpofl.DeviceData(
        features=jax.random.normal(kx, (n, m) + shape),
        labels=jax.random.randint(ky, (n, m), 0, 10),
        n_samples=n_samples,
    )


@pytest.mark.parametrize("kind", ["logreg", "cnn"])
def test_ravel_order_and_convert(kind):
    jparams, tparams, *_ = _model(kind)
    flat, unravel = ravel_pytree(tparams)
    want, _ = jax_ravel(jparams)
    assert flat.shape == want.shape == ({"logreg": 7850, "cnn": 258_634}[kind],)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    back = unravel(flat)
    for (k1, a), (k2, b) in zip(sorted(back.items()), sorted(tparams.items())):
        assert k1 == k2
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["logreg", "cnn"])
def test_logits_loss_and_eval_match_reference(kind):
    jparams, tparams, jloss, jlogits, tloss, tlogits, shape = _model(kind)
    dd = _device_data(shape, n=1, m=8)
    x, y = dd.features[0], dd.labels[0]
    assert_close(tlogits(tparams, t(x)), jlogits(jparams, x))
    assert_close(tloss(tparams, t(x), t(y, torch.int64)), jloss(jparams, x, y))
    jeval = jsmall.make_eval_fn(jlogits, jloss, x, y, n_valid=6)
    teval = tsmall.make_eval_fn(tlogits, tloss, t(x), t(y, torch.int64), n_valid=6)
    (jl, ja), (tl, ta) = jeval(jparams), teval(tparams)
    assert_close(tl, jl)
    assert float(ta) == float(ja)


@pytest.mark.parametrize("kind", ["logreg", "cnn"])
@pytest.mark.parametrize("hetero", [False, True])
def test_local_gradient_stage_matches_reference(kind, hetero):
    jparams, tparams, jloss, _, tloss, _, shape = _model(kind)
    jdata = _device_data(shape, n_samples=np.array([6, 2, 4], np.int32) if hetero else None)
    jcfg = jpofl.POFLConfig(n_devices=3, batch_size=2)
    k_batch = jax.random.PRNGKey(5)
    want = jlu.local_gradient_stage(jloss, jdata, jcfg, jparams, k_batch)
    idx = jax_batch_idx(jdata, jcfg.batch_size, k_batch)
    tcfg = tpofl.POFLConfig(n_devices=3, batch_size=2)
    got, state = tlu.local_update_stage(tloss, data_to_torch(jdata), tcfg, tparams, idx, 0)
    assert got.shape == want.shape and state is None
    assert_close(got, want)


def test_minibatch_indices_stay_in_the_valid_prefix():
    data = data_to_torch(_device_data((784,), n_samples=np.array([6, 1, 3], np.int32)))
    idx = tlu.minibatch_indices(data, 50, torch.Generator().manual_seed(0))
    assert idx.shape == (3, 50) and idx.dtype == torch.int64
    assert bool((idx >= 0).all()) and bool((idx < data.n_samples[:, None]).all())
    assert set(idx[0].tolist()) == set(range(6))


@pytest.mark.parametrize(
    "algorithm,steps", [("feddyn", 1), ("scaffold", 1), ("fedavg", 2), ("fedprox", 3)]
)
def test_local_algorithms_run_and_match_reference(algorithm, steps):
    """The configurations that raised before the K-step port now run their
    K steps from zero state and match the reference (the CNN; the full
    battery is ``tests/test_torch_local_update.py``)."""
    jparams, tparams, jloss, _, tloss, _, shape = _model("cnn")
    jdata = _device_data(shape, n_samples=np.array([6, 2, 4], np.int32))
    jcfg = jpofl.POFLConfig(n_devices=3, batch_size=2, local_algorithm=algorithm,
                            local_steps=steps, fedprox_mu=0.2, local_lr=0.05)
    k_batch = jax.random.PRNGKey(6)
    want, want_state = jlu.local_update_stage(
        jloss, jdata, jcfg, jparams, k_batch, 0.0,
        alg_state=jlu.init_state(algorithm, 3, 258_634))
    tcfg = tpofl.POFLConfig(n_devices=3, batch_size=2, local_algorithm=algorithm,
                            local_steps=steps, fedprox_mu=0.2, local_lr=0.05)
    got, got_state = tlu.local_update_stage(
        tloss, data_to_torch(jdata), tcfg, tparams, jax_batch_rows(jcfg, jdata, k_batch), 0,
        alg_state=tlu.init_state(algorithm, 3, 258_634))
    assert_close(got, want)
    for g_, w_ in zip(got_state or (), want_state or ()):
        assert (g_ is None) == (w_ is None)
        if w_ is not None:
            assert_close(g_, w_)
    with pytest.raises(ValueError, match="unknown local_algorithm"):
        tlu.local_update_stage(None, None, dataclasses.replace(tcfg, local_algorithm="sgd"),
                               None, torch.zeros((2, 2) if steps == 1 else (steps, 2, 2)), 0)


@pytest.mark.parametrize("name", ["shards", "iid"])
def test_partitions_match_reference_exactly(name):
    x, y = jax_dataset("mnist_like", 600, jax.random.PRNGKey(2))
    x, y = np.asarray(x), np.asarray(y)
    if name == "shards":
        want = jpart.partition_noniid_shards(x, y, 10, shards_per_device=2, seed=3)
        got = tpart.partition_noniid_shards(x, y, 10, shards_per_device=2, seed=3)
    else:
        want = jpart.partition_iid(x, y, 10, seed=3)
        got = tpart.partition_iid(x, y, 10, seed=3)
    np.testing.assert_array_equal(got.features.numpy(), np.asarray(want.features))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.n_samples is None and want.n_samples is None
    assert_close(got.data_frac, want.data_frac)


def test_synthetic_dataset_law():
    gen = torch.Generator().manual_seed(0)
    x, y = make_classification_dataset("mnist_like", 4000, gen)
    jx, jy = jax_dataset("mnist_like", 4000, jax.random.PRNGKey(0))
    assert x.shape == jx.shape and x.dtype == torch.float32 and y.dtype == torch.int64
    # same law, other draws: class-mean norms and the overall spread agree
    def law(x, y):
        x, y = np.asarray(x), np.asarray(y)
        norms = [np.linalg.norm(x[y == c].mean(0)) for c in range(10)]
        return np.mean(norms), x.std()
    np.testing.assert_allclose(law(x, y), law(jx, jy), rtol=0.05)
    img, lab = make_classification_dataset("cifar_like", 8, gen, channel_bias=0.5)
    assert img.shape == (8, 32, 32, 3) and lab.shape == (8,)


@pytest.mark.parametrize("kind,dim", [("logreg", 7850), ("cnn", 258_634)])
def test_make_model_task(kind, dim):
    task = make_model_task(kind, n_devices=4, n_train=64, n_test=16, device="cpu")
    assert task.dim == dim == task.ravel(task.params0).numel()
    assert task.data.features.shape[:2] == (4, 16)
    loss, acc = task.eval(task.params0)
    assert np.isfinite(float(loss)) and 0.0 <= float(acc) <= 1.0
    flat = task.ravel(task.params0)
    assert torch.equal(task.ravel(task.unravel(flat)), flat)
