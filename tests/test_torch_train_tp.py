"""Tensor-parallel training over the "model" ranks, its parts alone, on the CPU.

The model group's collectives as autograd Functions
(``models/layers.py``: ``copy_to_group``, ``sum_over_group``,
``max_over_group``, ``gather_from_group``): their forward, backward and
``torch.func.jvp`` against the one-process port, each rank's partners
scripted (:class:`ScriptedGroup`), so one rank runs at a time. Then the
split loss with the model ranks as threads of this process
(``tests/test_torch_serve_tp.py::ThreadRanks``) on each rank's TP blocks
(``launch/sharding.py::tp_pspecs``): the vocabulary-split ``chunked_ce``
and the whole ``model_loss`` with remat, tied and untied heads and a
target in the block that holds the pad columns, the loss and every
gradient block against the reference's on the same converted weights
(1e-5), and the per-example tangent, through forward-mode AD (whose dual
level, unlike ``torch.func.jvp``'s, the threads share), against the
one-process port's ``torch.func.jvp``. Reduced qwen2 at 2 layers, CE
chunks cut to 16 rows on both sides so three chunks run.

Besides: which master blocks a rank cuts from its compute blocks and which
it gathers over "model" (``launch/steps.py::master_grads``), the training
steps' refusal of model ranks that do not divide a split dimension, and
the layout a rank trains in (dense and SSM models split). The Mamba2
mixer's split alone is ``tests/test_torch_ssm_tp.py``; the rank runs
themselves (gloo, against the reference's ``train_round``) are
``tests/test_torch_train_ranks.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from _torch_parity import assert_close, perturbed_lm, train_configs
from test_torch_serve_tp import ThreadRanks, _tp_blocks

from repro.models import api as japi
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.flatten_util import tree_leaves, tree_map
from repro_torch.launch.mesh import RankMesh, ShapeMesh
from repro_torch.launch.sharding import NotDivisible, Sharding, params_pspecs, to_shardings
from repro_torch.launch.steps import (
    build_stats_step, build_train_step, compute_shardings, params_structs, tp_trains,
)
from repro_torch.models import api, transformer
from repro_torch.models import layers as L
from repro_torch.models.config import InputShape
from repro_torch.optim.optimizers import sgd

M = 2
CHUNK = 16  # CE rows a chunk on both sides: S = 40 gives three chunks, the last padded


class ScriptedGroup:
    """Rank ``rank`` of ``size`` whose partners' tensors are given: the
    k-th collective it runs takes ``script[k]``, every rank's tensor in
    rank order (its own replaced by what it passes)."""

    def __init__(self, rank: int, size: int, script: list):
        self.rank, self.size, self.script, self.calls = rank, size, list(script), 0

    def _every(self, x):
        every = list(self.script[self.calls])
        every[self.rank] = x
        self.calls += 1
        return every

    def group(self) -> L.ModelGroup:
        def all_sum(x):
            x.copy_(sum(self._every(x.clone())))

        def all_max(x):
            x.copy_(torch.stack(self._every(x.clone())).amax(dim=0))

        def all_gather(x, dim):
            return torch.cat(self._every(x), dim=dim)

        return L.ModelGroup(self.rank, self.size, all_max, all_sum, all_gather)


def _randn(*shape, seed):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def test_copy_to_group_sums_only_the_gradient():
    """f: the identity forward and tangent (no collective), the gradient
    summed over the group: each rank's column block of ``x @ W`` gives
    back the one-process gradient and tangent of x."""
    x, w, dy, tx = _randn(3, 8, seed=0), _randn(8, 6, seed=1), _randn(3, 6, seed=2), \
        _randn(3, 8, seed=3)
    xr = x.clone().requires_grad_()
    want_dx, = torch.autograd.grad(xr @ w, xr, dy)
    blocks = [slice(0, 3), slice(3, 6)]
    partials = [dy[:, b] @ w[:, b].T for b in blocks]
    for r, cols in enumerate(blocks):
        g = ScriptedGroup(r, M, [partials])
        xr = x.clone().requires_grad_()
        y = L.copy_to_group(xr, g.group())
        assert torch.equal(y, x) and g.calls == 0
        dx, = torch.autograd.grad(y @ w[:, cols], xr, dy[:, cols])
        assert g.calls == 1
        assert_close(dx, want_dx.numpy())
        silent = ScriptedGroup(r, M, [])
        _, t = torch.func.jvp(lambda v: L.copy_to_group(v, silent.group()) @ w[:, cols], (x,),
                              (tx,))
        assert torch.equal(t, tx @ w[:, cols]) and silent.calls == 0


def test_sum_over_group_sums_the_value_and_the_tangent_not_the_gradient():
    """g: the forward and the tangent summed over the group (two
    collectives under ``torch.func.jvp``: primal and tangent), the
    gradient the identity; the input left as it was."""
    parts = [_randn(4, 5, seed=10 + r) for r in range(M)]
    tangents = [_randn(4, 5, seed=20 + r) for r in range(M)]
    dy = _randn(4, 5, seed=30)
    for r in range(M):
        x = parts[r].clone().requires_grad_()
        g = ScriptedGroup(r, M, [parts])
        y = L.sum_over_group(x, g.group())
        assert torch.equal(x, parts[r])
        assert_close(y, (parts[0] + parts[1]).numpy())
        dx, = torch.autograd.grad(y, x, dy)
        assert torch.equal(dx, dy) and g.calls == 1
        g = ScriptedGroup(r, M, [parts, tangents])
        primal, t = torch.func.jvp(lambda v: L.sum_over_group(v, g.group()), (parts[r],),
                                   (tangents[r],))
        assert g.calls == 2
        assert_close(primal, (parts[0] + parts[1]).numpy())
        assert_close(t, (tangents[0] + tangents[1]).numpy())


def test_gather_from_group_takes_back_this_ranks_slice_of_the_gradient():
    """The gather: every rank's block concatenated in rank order, the
    tangents gathered alike, the gradient this rank's slice (each rank
    backpropagates the same replicated loss, so no reduce-scatter)."""
    parts = [_randn(2, 3, 4, seed=40 + r) for r in range(M)]
    tangents = [_randn(2, 3, 4, seed=50 + r) for r in range(M)]
    dy = _randn(2, 6, 4, seed=60)
    for r in range(M):
        x = parts[r].clone().requires_grad_()
        y = L.gather_from_group(x, 1, ScriptedGroup(r, M, [parts]).group())
        assert torch.equal(y, torch.cat(parts, dim=1))
        dx, = torch.autograd.grad(y, x, dy)
        assert torch.equal(dx, dy[:, 3 * r:3 * (r + 1)])
        g = ScriptedGroup(r, M, [parts, tangents])
        _, t = torch.func.jvp(lambda v: L.gather_from_group(v, 1, g.group()), (parts[r],),
                              (tangents[r],))
        assert torch.equal(t, torch.cat(tangents, dim=1))


def test_max_over_group_carries_no_derivative():
    """The softmax shift: the group's MAX, zero tangent and no gradient."""
    parts = [_randn(3, 1, seed=70 + r) for r in range(M)]
    for r in range(M):
        g = ScriptedGroup(r, M, [parts, parts])
        x = parts[r].clone().requires_grad_()
        y = L.max_over_group(x, g.group())
        assert torch.equal(y, torch.maximum(*parts)) and not y.requires_grad
        _, t = torch.func.jvp(lambda v: L.max_over_group(v, g.group()), (parts[r],),
                              (torch.ones(3, 1),))
        assert torch.equal(t, torch.zeros(3, 1))


def _case(tied: bool, seed: int = 0):
    """Reduced qwen2 at vocab 500 (padded to 512: the pad columns lie in
    rank 1's block), tied or not: (reference config, port config, the
    reference's weights perturbed, the same converted, tokens (2, 40)
    with targets in both blocks, one next to the pad, and the weights)."""
    jcfg, tcfg = train_configs("qwen2-0.5b", 2)
    jcfg, tcfg = (dataclasses.replace(c, vocab_size=500, tie_embeddings=tied)
                  for c in (jcfg, tcfg))
    assert tcfg.vocab_padded == 512
    jp = perturbed_lm(japi.model_init(jcfg, jax.random.PRNGKey(seed)), seed + 100)
    params = lm_params_from_jax(jax.tree.map(jnp.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 500, size=(2, 40))
    tokens[0, 7], tokens[1, 20], tokens[1, 21] = 499, 3, 256
    w = np.array([0.4, 1.6], np.float32)
    return jcfg, tcfg, jp, params, tokens, w


def _ranks_grads(tcfg, params, fn):
    """``fn(blocks, group)`` → a scalar on each thread rank's TP blocks:
    (its values, its gradient blocks in leaf order) by rank, the remat's
    checkpoints run without early stop as the train step runs them."""

    def rank(r, group):
        blocks = tree_map(lambda x: x.requires_grad_(), _tp_blocks(params, tcfg, M, r))
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            value = fn(blocks, group)
        return value.detach(), torch.autograd.grad(value.sum(), tree_leaves(blocks))

    return ThreadRanks(M).run(rank)


def _tp_leaf_blocks(tcfg):
    mesh = ShapeMesh(("data", "model"), (1, M))
    return mesh, tree_leaves(compute_shardings(tcfg, mesh, params_structs(tcfg)))


def _assert_grad_blocks(by_rank, want_tree, tcfg):
    mesh, shardings = _tp_leaf_blocks(tcfg)
    for r, (_, grads) in enumerate(by_rank):
        for g, w, sh in zip(grads, tree_leaves(want_tree), shardings, strict=True):
            assert tuple(g.shape) == sh.block_shape(w.shape)
            assert_close(g, w[sh.index({"data": 0, "model": r}, w.shape)].numpy())


@pytest.mark.parametrize("tied", [True, False])
def test_vocab_split_chunked_ce_and_its_gradients_match_the_reference(monkeypatch, tied):
    """Each rank's (B, 16, 256) logits chunks stay split: the per-example
    NLL on every rank, and the gradients of its head block and of the
    hidden input, against the reference's ``chunked_ce`` (1e-5)."""
    monkeypatch.setattr(transformer, "CE_CHUNK", CHUNK)
    monkeypatch.setattr(jtransformer, "CE_CHUNK", CHUNK)
    jcfg, tcfg, jp, params, tokens, w = _case(tied)
    x = np.asarray(_randn(2, 40, tcfg.d_model, seed=5))
    head = "embed" if tied else "lm_head"

    def ref(head_w, xx):
        p = {**jp, head: head_w}
        return (jtransformer.chunked_ce(p, jcfg, xx, jnp.asarray(tokens), jnp.float32)
                * jnp.asarray(w)).sum()

    per_example = jtransformer.chunked_ce(jp, jcfg, jnp.asarray(x), jnp.asarray(tokens),
                                          jnp.float32)
    d_head, d_x = jax.grad(ref, argnums=(0, 1))(jnp.asarray(jp[head]), jnp.asarray(x))
    d_head = np.asarray(d_head)  # the port keeps the reference's (V, d) and (d, V) layouts

    def rank(r, group):
        blocks = _tp_blocks(params, tcfg, M, r)
        blocks[head].requires_grad_()
        xr = torch.tensor(x).requires_grad_()
        pe = transformer.chunked_ce(blocks, tcfg, xr, torch.as_tensor(tokens), torch.float32,
                                    group=group)
        grads = torch.autograd.grad((pe * torch.as_tensor(w)).sum(), (blocks[head], xr))
        return pe.detach(), grads

    n = tcfg.vocab_padded // M
    for r, (pe, (g_head, g_x)) in enumerate(ThreadRanks(M).run(rank)):
        assert_close(pe, np.asarray(per_example))
        cols = slice(r * n, (r + 1) * n)
        assert_close(g_head, d_head[cols] if tied else d_head[:, cols])
        assert_close(g_x, np.asarray(d_x))


@pytest.mark.parametrize("tied", [True, False])
def test_split_model_loss_and_every_gradient_block_match_the_reference(monkeypatch, tied):
    """The weighted ``model_loss`` with remat on each rank's TP blocks:
    the loss on every rank and each gradient block (a tied ``embed``
    gathers the lookup's and the head's gradients on its vocabulary
    block) against the slices of ``jax.value_and_grad`` of the reference's
    on the same weights (1e-5)."""
    monkeypatch.setattr(transformer, "CE_CHUNK", CHUNK)
    monkeypatch.setattr(jtransformer, "CE_CHUNK", CHUNK)
    jcfg, tcfg, jp, params, tokens, w = _case(tied, seed=1)
    loss, grads = jax.value_and_grad(lambda p: japi.model_loss(
        p, jcfg, {"tokens": jnp.asarray(tokens)}, dtype=jnp.float32, remat=True,
        loss_weights=jnp.asarray(w))[0])(jax.tree.map(jnp.asarray, jp))
    by_rank = _ranks_grads(tcfg, params, lambda p, g: api.model_loss(
        p, tcfg, {"tokens": torch.as_tensor(tokens)}, remat=True,
        loss_weights=torch.as_tensor(w), group=g)[0])
    for value, _ in by_rank:
        assert_close(value, np.asarray(loss))
    _assert_grad_blocks(by_rank, lm_params_from_jax(grads, tcfg, device="cpu"), tcfg)


def test_split_per_example_tangent_matches_the_one_process_jvp(monkeypatch):
    """The sketch's pass: the per-example losses' tangent along a probe,
    each rank on its TP blocks of the weights and of the probe, against
    the one-process port's ``torch.func.jvp`` on the whole ones (1e-5)."""
    monkeypatch.setattr(transformer, "CE_CHUNK", CHUNK)
    _, tcfg, _, params, tokens, _ = _case(True, seed=2)
    probe = tree_map(lambda x: torch.randn(x.shape, generator=torch.Generator().manual_seed(9)),
                     params)
    batch = {"tokens": torch.as_tensor(tokens)}

    def per_example(p, group=None):
        return api.model_loss(p, tcfg, batch, reduce=False, group=group)[0]

    want_primal, want = torch.func.jvp(per_example, (params,), (probe,))

    def dual(node, tangent):
        if isinstance(node, dict):
            return {k: dual(node[k], tangent[k]) for k in node}
        return fwAD.make_dual(node, tangent)

    with fwAD.dual_level():
        def rank(r, group):
            blocks = dual(_tp_blocks(params, tcfg, M, r), _tp_blocks(probe, tcfg, M, r))
            out = fwAD.unpack_dual(per_example(blocks, group))
            return out.primal, out.tangent

        for primal, tangent in ThreadRanks(M).run(rank):
            assert_close(primal, want_primal.numpy())
            assert_close(tangent, want.numpy())


def test_master_blocks_come_from_the_compute_blocks_or_a_gather():
    """qwen2-0.5b over (1, 2) and (2, 2): a rank's compute block holds its
    master block, which it cuts, for every leaf but ``wo``, ``w_out`` (TP
    splits their rows, the spec their last dim) and the q, k and v biases
    (TP splits them, the spec keeps a layer's 896 or 128 values whole),
    which it gathers over "model"; the cut is the master block of the
    whole."""
    cfg = configs.base_config("qwen2-0.5b")
    structs = params_structs(cfg)
    names = ["/".join(p) for p in _paths(structs)]
    for sizes in ((1, 2), (2, 2)):
        mesh = ShapeMesh(("data", "model"), sizes)
        tp = tree_leaves(compute_shardings(cfg, mesh, structs))
        masters = tree_leaves(to_shardings(params_pspecs(structs, mesh), mesh))
        gathered = {n for n, t, s in zip(names, tp, masters) if not t.holds(s)}
        assert gathered == {"layers/attn/wo", "layers/mlp/w_out", "layers/attn/bq",
                            "layers/attn/bk", "layers/attn/bv"}, sizes
    whole = _randn(4, 8, 6, seed=80)
    for coords in ({"data": 0, "model": 1}, {"data": 1, "model": 0}):
        mesh = _PlacedMesh(("data", "model"), (2, 2), coords)
        tp, master = Sharding(mesh, (None, None, "model")), Sharding(mesh, (None, "data", "model"))
        assert tp.holds(master) and not master.holds(tp)
        block = whole[tp.index(coords, whole.shape)]
        assert torch.equal(tp.cut(master, block, whole.shape),
                           whole[master.index(coords, whole.shape)])


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], path + (k,))]
    return [path]


class _PlacedMesh(ShapeMesh):
    """A shape-only mesh that names the place of "this rank"."""

    def __init__(self, names, sizes, place):
        super().__init__(names, sizes)
        object.__setattr__(self, "place", place)

    def coordinates(self, rank=None):
        return dict(self.place)


def test_training_steps_refuse_model_ranks_that_do_not_divide():
    """3 model ranks divide neither reduced qwen2's 4 heads, 2 kv heads,
    d_ff 512 nor its vocab 512, and 4 not qwen2-0.5b's 14 heads and 2 kv
    heads: the train and stats steps over such ranks raise
    ``NotDivisible`` naming them, before any collective runs."""
    cfg = configs.reduced_config("qwen2-0.5b")
    shape = InputShape("t", 16, 12, "train")
    mesh = RankMesh(("data", "model"), (1, 3), device=torch.device("cpu"), n_fl=4)
    msg = "3 model ranks do not divide n_heads = 4, n_kv_heads = 2, d_ff = 512, vocab_padded = 512"
    with pytest.raises(NotDivisible, match=msg):
        build_train_step(cfg, shape, mesh, sgd(0.1), dtype=torch.float32, n_microbatches=1)
    with pytest.raises(NotDivisible, match=msg):
        build_stats_step(cfg, shape, mesh, dtype=torch.float32)
    base = configs.base_config("qwen2-0.5b")
    mesh4 = RankMesh(("data", "model"), (1, 4), device=torch.device("cpu"), n_fl=4)
    with pytest.raises(NotDivisible, match="n_heads = 14, n_kv_heads = 2$"):
        build_train_step(base, InputShape("t", 16, 8, "train"), mesh4, sgd(0.1),
                         n_microbatches=1)


def test_dense_and_ssm_models_over_model_ranks_train_split():
    """The rank steps split a dense and an SSM model over M > 1 model
    ranks; over one model rank, and every other family over any, they
    compute whole."""
    for arch in configs.ARCH_IDS:
        cfg = configs.reduced_config(arch)
        for sizes in ((2, 1), (1, 2), (2, 2)):
            mesh = ShapeMesh(("data", "model"), sizes)
            split = cfg.arch_type in ("dense", "ssm") and sizes[1] > 1
            assert tp_trains(cfg, mesh) == split, (arch, sizes)
            sh = tree_leaves(compute_shardings(cfg, mesh, params_structs(cfg)))
            assert all(s.replicated() for s in sh) == (not split)
    for arch in ("qwen2-0.5b", "mamba2-370m"):
        assert tp_trains(configs.base_config(arch), ShapeMesh(("data", "model"), (1, 2)))
