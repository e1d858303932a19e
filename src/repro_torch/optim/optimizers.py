"""Optimizers as (init, update) pairs of plain functions over dicts of tensors.

Port of ``repro.optim.optimizers``. State tensors mirror the parameters'
shapes and device; ``step`` is a 0-d int32 tensor on the params' device, so
a learning-rate schedule is a function of a tensor and an update never
waits on the host. The pair stays functional (``update`` returns new
params and a new state, nothing is written in place), because the train
step and the tests compose it as the reference does.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.flatten_util import tree_leaves


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Any    # first moment (or momentum): a zeros tree like the params
    nu: Any    # second moment: a zeros tree (None for sgd)


class Optimizer(NamedTuple):
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any], tuple[Any, OptState]]


def tree_map_n(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (nested dicts of one structure)."""
    if isinstance(tree, dict):
        return {k: tree_map_n(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _zeros_like_tree(params):
    return tree_map_n(torch.zeros_like, params)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def _lr_fn(lr) -> Callable[[torch.Tensor], torch.Tensor]:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def sgd(lr: Callable[[torch.Tensor], torch.Tensor] | float, momentum: float = 0.0) -> Optimizer:
    """p ← p − η_t · m with m = momentum · m + g (m = g at momentum 0)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return OptState(step=_step0(params), mu=_zeros_like_tree(params), nu=None)

    def update(grads, state, params):
        eta = lr_fn(state.step)
        if momentum > 0.0:
            mu = tree_map_n(lambda m, g: momentum * m + g, state.mu, grads)
        else:
            mu = grads
        new_params = tree_map_n(lambda p, m: p - eta * m, params, mu)
        return new_params, OptState(step=state.step + 1,
                                    mu=mu if momentum > 0 else state.mu, nu=None)

    return Optimizer(init=init, update=update)


def adamw(
    lr: Callable[[torch.Tensor], torch.Tensor] | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    """AdamW with decoupled weight decay; η_t is read at the step before the
    increment, the bias corrections at the step after it."""
    lr_fn = _lr_fn(lr)

    def init(params):
        return OptState(step=_step0(params), mu=_zeros_like_tree(params),
                        nu=_zeros_like_tree(params))

    def update(grads, state, params):
        step = state.step + 1
        eta = lr_fn(state.step)
        mu = tree_map_n(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map_n(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def upd(p, m, v):
            mhat = m / bc1
            vhat = v / bc2
            return p - eta * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p)

        new_params = tree_map_n(upd, params, mu, nu)
        return new_params, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def paper_decay_schedule(lr0: float, decay: float = 0.95, lr_min: float = 1e-5):
    """Paper Sec. V-A: η^t = max(η0 · 0.95^t, 1e-5)."""

    def fn(step):
        return torch.clamp_min(lr0 * decay ** step.float(), lr_min)

    return fn


def cosine_schedule(lr0: float, total_steps: int, warmup: int = 0, lr_min: float = 0.0):
    """Linear warm-up over ``warmup`` steps, then a cosine from lr0 to
    lr_min at ``total_steps``."""

    def fn(step):
        step = step.float()
        warm = lr0 * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        cos = lr_min + 0.5 * (lr0 - lr_min) * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return fn
