"""The port's model-task eval (``repro_torch.sim.tasks``: ``TaskEval``,
``EvalRecord``, ``make_model_task``'s Dirichlet partitions) held against the
live reference on identical inputs (CPU).

``TaskEval.record`` on a padded test set: the loss within 1e-5 of the
reference relative to its scale, the correct count and the accuracy equal
(only the valid prefix counts, so ``acc == n_correct / n_valid``).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, t

from repro.models import small as jsmall
from repro.sim import tasks as jtasks
from repro_torch.convert import params_from_jax
from repro_torch.models import small as tsmall
from repro_torch.sim import tasks as ttasks

MODELS = {
    "logreg": (jsmall.init_logreg, jsmall.logreg_logits, tsmall.logreg_logits, (784,)),
    "cnn": (jsmall.init_cnn, jsmall.cnn_logits, tsmall.cnn_logits, (32, 32, 3)),
}


def test_record_schema_matches_reference():
    assert ttasks.EvalRecord._fields == jtasks.EvalRecord._fields
    assert ttasks.TASKS == jtasks.TASKS
    zero = ttasks.zero_eval_record()
    assert all(f.shape == () and f.dtype == torch.float32 and f.item() == 0 for f in zero)


# (rows in the set, n_valid, batch): padded sets, the batch cap, no padding
EVAL_CASES = [(40, 29, 1000), (40, 29, 17), (40, None, 1000), (12, 12, 5)]


@pytest.mark.parametrize("n_rows,n_valid,batch", EVAL_CASES)
@pytest.mark.parametrize("kind", ["logreg", "cnn"])
def test_task_eval_record_matches_reference_on_a_padded_set(kind, n_rows, n_valid, batch):
    init, jlogits, tlogits, shape = MODELS[kind]
    jparams = init(jax.random.PRNGKey(3))
    kx, ky = jax.random.split(jax.random.PRNGKey(4))
    x = jax.random.normal(kx, (n_rows,) + shape)
    y = jax.random.randint(ky, (n_rows,), 0, 10)
    # the padding: wrap the valid rows, as a sized shard is padded
    if n_valid is not None:
        x = x.at[n_valid:].set(x[: n_rows - n_valid])
        y = y.at[n_valid:].set((y[: n_rows - n_valid] + 1) % 10)
    want = jtasks.TaskEval(jlogits, x, y, n_valid=n_valid, batch=batch)
    got = ttasks.TaskEval(tlogits, t(x), t(y, torch.int64), n_valid=n_valid, batch=batch)
    assert got.n_valid == want.n_valid
    params = params_from_jax(jparams, device="cpu")
    w_rec, g_rec = want.record(jparams), got.record(params)
    assert_close(g_rec.loss, w_rec.loss)
    assert float(g_rec.n_correct) == float(w_rec.n_correct)
    assert float(g_rec.acc) == float(w_rec.acc) == np.float32(w_rec.n_correct) / np.float32(
        want.n_valid)
    assert all(f.dtype == torch.float32 and f.shape == () for f in g_rec)
    loss, acc = got(params)
    assert float(loss) == float(g_rec.loss) and float(acc) == float(g_rec.acc)


def test_task_eval_refuses_an_empty_or_oversized_prefix():
    x, y = torch.zeros(4, 784), torch.zeros(4, dtype=torch.int64)
    for n_valid in (0, 5):
        with pytest.raises(ValueError, match="n_valid must be in"):
            ttasks.TaskEval(tsmall.logreg_logits, x, y, n_valid=n_valid)


@pytest.mark.parametrize("partition", ["dirichlet", "dirichlet_sized", "dirichlet_mixed"])
def test_make_model_task_takes_the_dirichlet_partitions(partition):
    """``beta`` reaches the partition; the sized and mixed presets pad the
    shards (``n_samples``), and the task's eval is a ``TaskEval``."""
    task = ttasks.make_model_task("logreg", n_devices=6, partition=partition, n_train=120,
                                  n_test=32, beta=0.3, seed=2, device="cpu")
    assert isinstance(task.eval, ttasks.TaskEval) and task.eval.n_valid == 32
    data = task.data
    if partition == "dirichlet":
        assert data.n_samples is None and data.features.shape[:2] == (6, 20)
    else:
        ns = data.n_samples
        assert int(ns.sum()) == 120 and data.features.shape[1] == int(ns.max())
        np.testing.assert_allclose(data.data_frac.numpy(), ns.numpy() / 120, rtol=1e-6)
    rec = task.eval.record(task.params0)
    assert float(rec.acc) == np.float32(rec.n_correct) / np.float32(32)
    with pytest.raises(ValueError, match="unknown partition"):
        ttasks.make_model_task("logreg", partition="zipf", device="cpu")
