"""The paper's model tasks (port of ``repro.sim.tasks``).

:func:`make_model_task` bundles a model of ``models/small.py``, its
partitioned synthetic train shards, a test-set eval and the flat-D
bijection. ``ravel``/``unravel`` follow ``jax.flatten_util.ravel_pytree``'s
order (keys sorted, leaves row-major in the reference's layouts), so a flat
vector here lines up element for element with the reference's.

:class:`TaskEval` is the eval over a fixed test set: calling it gives the
``(loss, acc)`` pair every ``eval_fn`` seam takes, and :meth:`TaskEval.record`
the structured :class:`EvalRecord` (loss, accuracy and the correct count)
that the engine and the lattice stack into their ``eval`` subtree. Only the
valid prefix of a padded test set counts (``n_valid``), as only the valid
prefix of a padded shard is ever drawn.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.pofl import DeviceData
from repro_torch.data.synthetic import make_classification_dataset
from repro_torch.device import resolve_device
from repro_torch.flatten_util import ravel_pytree, tree_map
from repro_torch.models import small
from repro_torch.sim.scenario import PARTITIONS, make_partition

TASKS = ("logreg", "cnn")


class EvalRecord(NamedTuple):
    """One eval point: 0-d tensors for one set of params; (cells, rounds)
    in an engine record, (A, P, Nn, Na, Ns, E) on ``LatticeRecords.eval``.
    ``n_correct`` beside ``acc`` pins the denominator: a pad-row leak shows
    as ``acc != n_correct / n_valid``."""

    loss: torch.Tensor       # mean NLL over the valid test rows
    acc: torch.Tensor        # fraction of valid rows predicted correctly
    n_correct: torch.Tensor  # correct predictions among the valid rows


def zero_eval_record(shape=(), device=None) -> EvalRecord:
    """The record of a round that does not evaluate: all zeros, each field
    of ``shape`` (0-d by default; (cells,) in an engine's lattice round)."""
    return EvalRecord(*(torch.zeros(shape, device=device) for _ in EvalRecord._fields))


class TaskEval:
    """Pad-masked classification eval over a fixed test set.

    Args:
      logits_fn: ``(params, x) -> (B, n_classes)`` logits.
      x_test, y_test: the full (possibly padded) test tensors.
      n_valid: the number of true test rows (the valid prefix); ``None``
        means every row. The rows evaluated are the first
        ``min(n_valid, batch)``.
      batch: cap on the rows evaluated.

    Calling it gives ``(loss, acc)``; :meth:`record` the :class:`EvalRecord`.
    Nothing is read back to the host.
    """

    def __init__(self, logits_fn: Callable, x_test, y_test, n_valid: int | None = None,
                 batch: int = 1000):
        self.logits_fn = logits_fn
        self.x_test, self.y_test = x_test, y_test
        n_rows = int(y_test.shape[0])
        n_valid = n_rows if n_valid is None else int(n_valid)
        if not 0 < n_valid <= n_rows:
            raise ValueError(f"n_valid must be in [1, {n_rows}] (got {n_valid})")
        self.n_valid = min(n_valid, int(batch))

    @torch.no_grad()
    def record(self, params) -> EvalRecord:
        n = self.n_valid
        x, y = self.x_test[:n], self.y_test[:n]
        logits = self.logits_fn(params, x)
        logp = F.log_softmax(logits, dim=-1)
        loss = -logp.gather(-1, y[:, None]).mean()
        n_correct = (logits.argmax(dim=-1) == y).to(torch.float32).sum()
        # a tensor divisor: CUDA divides by a Python number as a product with
        # its reciprocal, which can miss n_correct / n by one ulp
        acc = n_correct / torch.full_like(n_correct, n)
        return EvalRecord(loss=loss.to(torch.float32), acc=acc, n_correct=n_correct)

    def __call__(self, params) -> tuple[torch.Tensor, torch.Tensor]:
        rec = self.record(params)
        return rec.loss, rec.acc


@dataclasses.dataclass(frozen=True, eq=False)
class ModelTask:
    """Everything one ``run_pofl`` call needs, plus the pytree ↔ flat-D bijection."""

    name: str                 # TASKS entry ("logreg" | "cnn")
    loss_fn: Callable         # (params, x, y) -> scalar mean NLL
    logits_fn: Callable       # (params, x) -> logits
    params0: Any              # nested-dict initial parameters
    data: DeviceData          # partitioned train shards
    eval: TaskEval            # pad-masked test-set eval
    dim: int                  # raveled flat model dimension D
    unravel: Callable         # flat (D,) -> params

    def ravel(self, params) -> torch.Tensor:
        """Params -> the engine's flat (D,) vector."""
        return ravel_pytree(params)[0]


def make_model_task(
    kind: str = "logreg",
    n_devices: int = 8,
    partition: str = "shards",
    n_train: int = 1024,
    n_test: int = 256,
    seed: int = 0,
    dim: int | None = None,
    beta: float = 0.4,
    classes_per_device: int = 2,
    channel_bias: float = 0.0,
    device=None,
) -> ModelTask:
    """Build a :class:`ModelTask` on ``device`` (the CUDA card by default).

    ``kind`` is ``"logreg"`` (MNIST-shaped, D=7850) or ``"cnn"``
    (CIFAR-shaped 4-conv CNN, D=258,634). ``dim`` overrides logreg's feature
    width; ``channel_bias`` gives the CNN a class signal that survives its
    global average pool. ``partition`` is any ``sim.scenario.PARTITIONS``
    name, ``beta`` the Dirichlet concentration of the ``dirichlet*`` ones
    (the sized and mixed presets pad the shards, ``DeviceData.n_samples``).
    Data and initial weights come from one ``torch.Generator`` seeded with
    ``seed``; the partition is numpy-seeded as in the reference.
    """
    if kind not in TASKS:
        raise ValueError(f"unknown task {kind!r}; known: {TASKS}")
    if dim is not None and kind == "cnn":
        raise ValueError("dim override only supported for the logreg task")
    if channel_bias and kind != "cnn":
        raise ValueError("channel_bias only applies to the cnn task")
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    ds = "mnist_like" if kind == "logreg" else "cifar_like"
    ds_kw: dict = {"dim": dim} if kind == "logreg" else {"channel_bias": channel_bias}
    x_tr, y_tr = make_classification_dataset(ds, n_train, gen, **ds_kw)
    x_te, y_te = make_classification_dataset(ds, n_test, gen, **ds_kw)
    if partition not in PARTITIONS:
        raise ValueError(f"unknown partition {partition!r}; known: {PARTITIONS}")
    part_kw: dict = {}
    if partition == "shards":
        part_kw["shards_per_device"] = classes_per_device
    elif partition.startswith("dirichlet"):
        part_kw["beta"] = beta
    data = make_partition(
        partition, x_tr.numpy(), y_tr.numpy(), n_devices, seed=seed, **part_kw
    ).to(device)

    if kind == "logreg":
        params0 = small.init_logreg(gen, dim=int(x_tr.shape[-1]))
        loss_fn, logits_fn = small.logreg_loss, small.logreg_logits
    else:
        params0 = small.init_cnn(gen)
        loss_fn, logits_fn = small.cnn_loss, small.cnn_logits
    params0 = tree_map(lambda p: p.to(device), params0)
    flat, unravel = ravel_pytree(params0)
    return ModelTask(
        name=kind,
        loss_fn=loss_fn,
        logits_fn=logits_fn,
        params0=params0,
        data=data,
        eval=TaskEval(logits_fn, x_te.to(device), y_te.to(device), batch=n_test),
        dim=int(flat.numel()),
        unravel=unravel,
    )
