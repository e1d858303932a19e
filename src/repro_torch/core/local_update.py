"""Local updates (port of ``repro.core.local_update``).

Each device runs ``cfg.local_steps`` (K) SGD steps on its own copy of the
weights and uploads the average effective gradient

    Δ_i = (1/K) Σ_k ĝ_i(w_i^k)   ==   (w^t − w_i^K) / (K · η_l)

which feeds the unchanged scheduling → AirComp → update chain. The
algorithms differ only in the effective gradient a step follows (w0 = w^t):

    fedavg    ĝ = g(w)
    fedprox   ĝ = g(w) + μ (w − w0)                   [μ = cfg.fedprox_mu]
    feddyn    ĝ = g(w) − h_i + α_d (w − w0);  h_i' = h_i − α_d (w_i^K − w0)
    scaffold  ĝ = g(w) − c_i + c̄;            c_i' = c_i − c̄ + Δ_i
                                              (c̄ = mean_i c_i)

``ALGORITHMS`` is the reference's append-only id table. With
``algorithm_id=None`` the algorithm is ``cfg.local_algorithm`` (static
dispatch), and ``fedavg``/``fedprox`` at K = 1 are exactly one plain
mini-batch gradient. With ``algorithm_id`` an integer tensor (one id a
cell in a lattice) every rule is computed from the same ``g`` and drift and
the id selects one by value, as it selects the state update; the
:class:`AlgState` then carries both ``h`` and ``c`` (``init_state(...,
full=True)``). The state stays on the device and nothing is read back.

The mini-batch rows come in as an index tensor: (N, B) at K = 1, (K, N, B)
otherwise (:func:`minibatch_indices` draws each (N, B) from a
``torch.Generator``), so the reference's draws can be fed in. Step 0 takes
every device's gradient at the shared weights w0; from step 1 on the
weights differ per device and the gradient is a ``vmap`` of ``grad`` over
(weights, features, labels) with the unravel inside. On a card every
gradient runs under cuDNN's deterministic algorithms
(``repro_torch.device.cudnn_deterministic``), so a run repeats bitwise.
:func:`local_update_stage_cells` is the same for every cell of a lattice
round at once (a leading cell axis on everything).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch
from torch.func import grad, vmap

from repro_torch.device import cudnn_deterministic
from repro_torch.flatten_util import ravel_batched, ravel_pytree, tree_map

# The reference's append-only id table: an algorithm's id is its index here.
ALGORITHMS = ("fedavg", "fedprox", "feddyn", "scaffold")
ALGORITHM_IDS = {name: i for i, name in enumerate(ALGORITHMS)}
FEDAVG_ID = ALGORITHM_IDS["fedavg"]
FEDPROX_ID = ALGORITHM_IDS["fedprox"]
FEDDYN_ID = ALGORITHM_IDS["feddyn"]
SCAFFOLD_ID = ALGORITHM_IDS["scaffold"]

# algorithms whose per-device state is empty
STATELESS = ("fedavg", "fedprox")


def algorithm_id(algorithm: str) -> int:
    """The integer id of a local-update algorithm (its index in ``ALGORITHMS``)."""
    if algorithm not in ALGORITHM_IDS:
        raise ValueError(f"unknown local_algorithm {algorithm!r}; choose from {ALGORITHMS}")
    return ALGORITHM_IDS[algorithm]


class AlgState(NamedTuple):
    """Per-device local-algorithm state carried across rounds."""

    h: Any = None  # FedDyn per-device drift h_i, (N, D) or None
    c: Any = None  # SCAFFOLD per-device control variate c_i, (N, D) or None


def init_state(
    local_algorithm: str, n_devices: int, dim: int, full: bool = False, device=None,
) -> AlgState | None:
    """Zero algorithm state for one cell: both fields under ``full`` (the
    per-cell id dispatch), else the named algorithm's field, or ``None``
    for a stateless algorithm."""
    def zeros():
        return torch.zeros(n_devices, dim, device=device)

    if full:
        return AlgState(h=zeros(), c=zeros())
    algorithm_id(local_algorithm)
    if local_algorithm == "feddyn":
        return AlgState(h=zeros())
    if local_algorithm == "scaffold":
        return AlgState(c=zeros())
    return None


def minibatch_indices(data, batch_size: int, generator: torch.Generator) -> torch.Tensor:
    """Per-device mini-batch rows (N, B) int64, drawn on the generator's device.

    Equal shards draw uniformly over all rows; padded heterogeneous shards
    (``data.n_samples``) over each device's valid prefix only. The engine
    checks once, at construction, that every device has a row.
    """
    n, m = data.n_devices, data.samples_per_device
    dev = generator.device
    if data.n_samples is None:
        return torch.randint(0, m, (n, batch_size), generator=generator, device=dev)
    ns = data.n_samples.to(device=dev)
    u = torch.rand(n, batch_size, generator=generator, device=dev)
    return torch.minimum((u * ns[:, None]).long(), ns[:, None].long() - 1)


def draw_minibatch(data, batch_idx: torch.Tensor):
    """Gather each device's mini-batch rows → (feats, labels), each leading
    (N, B); a (C, N, B) row draw (one per cell) gives (C, N, B) leads."""
    rows = torch.arange(data.n_devices, device=batch_idx.device)[:, None]
    return data.features[rows, batch_idx], data.labels[rows, batch_idx]


def _device_gradients(loss_fn: Callable, params, feats, labels) -> torch.Tensor:
    """vmap(grad) over the device axis at shared weights → flat (N, D)."""
    with cudnn_deterministic(feats.device):
        grads = vmap(grad(loss_fn), in_dims=(None, 0, 0))(params, feats, labels)
    return ravel_batched(grads)


def _device_gradients_at(loss_fn: Callable, unravel, w_flat, feats, labels) -> torch.Tensor:
    """Gradients at per-device flat weights (N, D) → (N, D): the weights
    have diverged (step ≥ 1), so the vmap carries a weight row per device."""
    def flat_loss(wf, x, y):
        return loss_fn(unravel(wf), x, y)

    with cudnn_deterministic(feats.device):
        return vmap(grad(flat_loss))(w_flat, feats, labels)


def local_gradient_stage(loss_fn: Callable, data, cfg, params, batch_idx) -> torch.Tensor:
    """Step 2 of Algorithm 1: one mini-batch gradient per device → (N, D)."""
    feats, labels = draw_minibatch(data, batch_idx)
    return _device_gradients(loss_fn, params, feats, labels)


def _local_steps(cfg, batch_idx: torch.Tensor, cells: bool) -> int:
    """K, checked against the rows' shape: (…, N, B) at K = 1, (…, K, N, B)
    otherwise (``…`` the cell axis)."""
    k = int(cfg.local_steps)
    if k < 1:
        raise ValueError(f"local_steps must be >= 1, got {k}")
    want = (3 if k == 1 else 4) if cells else (2 if k == 1 else 3)
    if batch_idx.dim() != want or (k > 1 and batch_idx.shape[-3] != k):
        raise ValueError(
            f"local_steps={k} takes mini-batch rows of {want} dims"
            f"{'' if k == 1 else f' with {k} steps'}, got {tuple(batch_idx.shape)}"
        )
    return k


def _check_state(name: str | None, alg_state) -> None:
    """The state a dispatch needs: every field for the per-cell id
    dispatch (``name`` None), the named algorithm's field otherwise."""
    if name is None:
        if alg_state is None or alg_state.h is None or alg_state.c is None:
            raise ValueError(
                "the per-cell algorithm dispatch computes every rule, so alg_state "
                "must carry all fields: init_state(..., full=True)"
            )
    elif name not in STATELESS and (
        alg_state is None or getattr(alg_state, "h" if name == "feddyn" else "c") is None
    ):
        raise ValueError(
            f"{name} needs per-device AlgState; run it through repro_torch.sim.SimEngine "
            "(init_state builds the state)"
        )


def _select(alg_id: torch.Tensor, rules) -> torch.Tensor:
    """The rule of ``alg_id`` by value: ``rules`` (in ``ALGORITHMS`` order)
    are computed one at a time and selected with ``torch.where``, so at most
    two of them are alive at once."""
    out = rules[-1]()
    for i in reversed(range(len(rules) - 1)):
        out = torch.where(alg_id == i, rules[i](), out)
    return out


def _k_steps(cfg, t, w0, gradient, k_steps: int, name: str | None, alg_id, alg_state):
    """The K local SGD steps from rows ``w0`` (…, N, D) → (Δ, state').

    ``gradient(k, w)`` is step k's stacked gradients at rows ``w`` (``None``
    at step 0: every row is w0). ``name`` is the static algorithm, or
    ``None`` with ``alg_id`` (broadcastable to the rows) for the per-cell
    dispatch.
    """
    lr_l = cfg.lr(t) if cfg.local_lr is None else cfg.local_lr
    mu, a_dyn = cfg.fedprox_mu, cfg.feddyn_alpha
    h = None if alg_state is None else alg_state.h
    c = None if alg_state is None else alg_state.c
    cbar = None if c is None else c.mean(dim=-2, keepdim=True)

    def effective(g, drift):
        rules = (
            lambda: g,                         # fedavg
            lambda: g + mu * drift,            # fedprox (proximal pull)
            lambda: g - h + a_dyn * drift,     # feddyn (dynamic regularizer)
            lambda: g - c + cbar,              # scaffold (control variates)
        )
        if name is not None:
            return rules[ALGORITHM_IDS[name]]()
        return _select(alg_id, rules)

    w, acc = w0, None
    for k in range(k_steps):
        g = gradient(k, None if k == 0 else w)
        ghat = effective(g, w - w0)
        del g
        w = w - lr_l * ghat
        acc = ghat if acc is None else acc + ghat
    delta = acc / k_steps
    drift_k = w - w0
    del w, acc

    if name == "feddyn":
        return delta, AlgState(h=h - a_dyn * drift_k, c=c)
    if name == "scaffold":
        return delta, AlgState(h=h, c=c - cbar + delta)
    if name is not None:
        return delta, alg_state
    return delta, AlgState(
        h=torch.where(alg_id == FEDDYN_ID, h - a_dyn * drift_k, h),
        c=torch.where(alg_id == SCAFFOLD_ID, c - cbar + delta, c),
    )


def _dispatch(cfg, alg_state, per_cell: bool) -> str | None:
    """The static algorithm name, or ``None`` for the per-cell id dispatch;
    checks the state it needs."""
    name = None
    if not per_cell:
        name = cfg.local_algorithm
        if name not in ALGORITHM_IDS:
            raise ValueError(f"unknown local_algorithm {name!r}; choose from {ALGORITHMS}")
    _check_state(name, alg_state)
    return name


def local_update_stage(
    loss_fn: Callable, data, cfg, params, batch_idx, t,
    alg_state: AlgState | None = None, algorithm_id: torch.Tensor | None = None,
) -> tuple[torch.Tensor, AlgState | None]:
    """Steps 2–2b: ``cfg.local_steps`` local SGD steps per device → (Δ, state').

    Δ is the (N, D) average effective gradient. ``batch_idx`` is (N, B) at
    K = 1 and (K, N, B) otherwise; ``t`` (the round) sets the local step
    size ``cfg.lr(t)`` unless ``cfg.local_lr`` is set. ``algorithm_id`` (a
    0-d integer tensor of ``ALGORITHM_IDS``) replaces
    ``cfg.local_algorithm``; ``alg_state`` then needs both fields.
    """
    k_steps = _local_steps(cfg, batch_idx, cells=False)
    name = _dispatch(cfg, alg_state, algorithm_id is not None)
    if k_steps == 1 and name in STATELESS:  # exactly one plain gradient
        return local_gradient_stage(loss_fn, data, cfg, params, batch_idx), alg_state
    steps = batch_idx[None] if k_steps == 1 else batch_idx
    flat0, unravel = ravel_pytree(params)
    w0 = flat0.expand(data.n_devices, flat0.numel())

    def gradient(k, w):
        feats, labels = draw_minibatch(data, steps[k])
        if w is None:
            return _device_gradients(loss_fn, params, feats, labels)
        return _device_gradients_at(loss_fn, unravel, w, feats, labels)

    return _k_steps(cfg, t, w0, gradient, k_steps, name, algorithm_id, alg_state)


def local_update_stage_cells(
    loss_fn: Callable, data, cfg, params_c, batch_idx_c, t,
    alg_state_c: AlgState | None = None, algorithm_id_c: torch.Tensor | None = None,
) -> tuple[torch.Tensor, AlgState | None]:
    """:func:`local_update_stage` for C cells at once → ((C, N, D), state').

    ``params_c`` has a leading cell axis on every leaf, ``batch_idx_c`` is
    (C, N, B) at K = 1 and (C, K, N, B) otherwise (each cell's rows from its
    own seed's draw), ``alg_state_c`` fields are (C, N, D) and
    ``algorithm_id_c`` is (C,). Cell c computes exactly
    :func:`local_update_stage` of its slice: the gradients are an outer
    ``vmap`` over cells, the rest the same arithmetic on the whole batch.
    """
    k_steps = _local_steps(cfg, batch_idx_c, cells=True)
    name = _dispatch(cfg, alg_state_c, algorithm_id_c is not None)
    shared = functools.partial(_device_gradients, loss_fn)
    if k_steps == 1 and name in STATELESS:
        feats, labels = draw_minibatch(data, batch_idx_c)
        return vmap(shared)(params_c, feats, labels), alg_state_c
    steps = batch_idx_c[:, None] if k_steps == 1 else batch_idx_c
    _, unravel = ravel_pytree(tree_map(lambda p: p[0], params_c))
    at = functools.partial(_device_gradients_at, loss_fn, unravel)
    flat0 = ravel_batched(params_c)
    w0 = flat0[:, None, :].expand(flat0.shape[0], data.n_devices, flat0.shape[1])

    def gradient(k, w):
        feats, labels = draw_minibatch(data, steps[:, k])
        if w is None:
            return vmap(shared)(params_c, feats, labels)
        return vmap(at)(w, feats, labels)

    alg_id = None if algorithm_id_c is None else algorithm_id_c[:, None, None]
    return _k_steps(cfg, t, w0, gradient, k_steps, name, alg_id, alg_state_c)
