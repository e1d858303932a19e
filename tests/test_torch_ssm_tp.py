"""The Mamba2 mixer split by SSM heads over the "model" ranks, on the CPU.

Each model rank holds its TP blocks (``launch/sharding.py::tp_pspecs``):
its nh/M heads' z, x and dt columns of ``in_proj`` with the B and C
columns whole, its heads' x channels of ``conv_w`` and ``conv_b`` with the
B and C channels whole (both ``Segments`` dims), its heads' ``A_log``,
``dt_bias``, ``D``, the mixer norm's channels and ``out_proj``'s rows, and
the vocabulary blocks of ``embed`` and ``lm_head``. The ranks run as
threads of this process sharing a ``ModelGroup``
(``tests/test_torch_serve_tp.py::ThreadRanks``). Reduced mamba2 (2 layers,
d 256, 16 heads of 32, d_state 16, chunk 16, vocab 512) on (1, 2), its
weights the reference's ``model_init`` with the conv bias, the skip
weight D and every norm scale drawn from a seed and dt_bias as Mamba2
initialises it, inputs from numpy.

Held within 1e-5: the split's ``mamba2_fwd``, ``mamba2_decode`` (the conv
window split by channels and, where 4 ranks do not divide d_state 15's
channels, whole) and ``_mamba_layer_with_state`` (state and conv window
blocks) against one process and the reference; a prefill and one decode
step from it; the loss with remat and every gradient block against the
reference's ``jax.value_and_grad`` and the one-process port, the mixer
norm's scale and the B/C columns of ``in_proj``, ``conv_w`` and ``conv_b``
among them (the two places a split gradient must be summed over the
group); the per-example tangent against the one-process
``torch.func.jvp``. Besides: the TP blocks, a rank's served bytes, the
refusal of ranks that do not divide the heads or the vocabulary, which
master blocks a rank gathers, and the whole tensor from every rank's
segmented block.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from _torch_parity import assert_close, mamba2_dt, train_case
from test_torch_serve_tp import ThreadRanks, _tp_blocks
from test_torch_ssm import _perturbed
from test_torch_train_tp import _assert_grad_blocks, _ranks_grads

from repro.models import api as japi
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import configs
from repro_torch.convert import lm_params_from_jax
from repro_torch.flatten_util import tree_leaves, tree_map
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.launch.sharding import (
    NotDivisible, Segments, Sharding, params_pspecs, served_bytes, to_shardings, tp_pspecs,
)
from repro_torch.launch.steps import _whole_over_model, compute_shardings, params_structs
from repro_torch.models import api, transformer
from repro_torch.models import layers as L

M = 2
ARCH = "mamba2-370m"


def _case(seed: int = 0, b: int = 2, s: int = 32, **cfg_kw):
    """(reference config, port config, the reference's weights with the conv
    bias, D and every norm scale drawn and dt_bias as Mamba2 initialises
    it (at other dt biases fp32 Mamba2 is ill-conditioned, ROADMAP C), the
    same converted, numpy tokens (b, s))."""
    jcfg, tcfg, jp, batch = train_case(ARCH, b=b, s=s, seed=seed)
    jcfg, tcfg = (dataclasses.replace(c, **cfg_kw) for c in (jcfg, tcfg))
    if cfg_kw:
        jp = japi.model_init(jcfg, jax.random.PRNGKey(seed))
    jp = _perturbed(jax.tree.map(np.asarray, jp), seed + 300)
    mixer = jp["layers"]["mamba"]
    mixer["dt_bias"] = mamba2_dt(mixer["dt_bias"].shape, seed + 200)
    return jcfg, tcfg, jp, lm_params_from_jax(jp, tcfg, device="cpu"), batch["tokens"]


def _mixer(params, r=None, tcfg=None, m=M):
    """Layer 0's ``mamba`` leaves: whole, or rank r's TP blocks."""
    if r is not None:
        params = _tp_blocks(params, tcfg, m, r)
    return transformer.layer_params(params, 0)["mamba"]


def _randn(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _heads(x, r, dim, m=M):
    """Rank r's block of ``x`` along ``dim`` (its heads or channels)."""
    n = x.shape[dim] // m
    return x.narrow(dim, r * n, n)


def test_tp_blocks_are_a_ranks_heads_with_b_and_c_whole():
    """Rank r's blocks: its heads' z, x and dt columns of in_proj and the
    B, C columns whole; its x channels of conv_w and conv_b and the B, C
    channels whole; its heads' A_log, dt_bias, D, its channels of the
    mixer norm and those rows of out_proj; the vocabulary blocks; ln1 and
    the final norm whole."""
    _, tcfg, _, params, _ = _case()
    s = tcfg.ssm
    di, n, nh = s.d_inner(tcfg.d_model), s.d_state, s.n_heads(tcfg.d_model)
    w, h, v = di // M, nh // M, tcfg.vocab_padded // M
    lay = params["layers"]["mamba"]
    for r in range(M):
        got = _tp_blocks(params, tcfg, M, r)
        blk = got["layers"]["mamba"]
        cols = [*range(r * w, (r + 1) * w), *range(di + r * w, di + (r + 1) * w),
                *range(2 * di, 2 * di + 2 * n), *range(2 * di + 2 * n + r * h,
                                                       2 * di + 2 * n + (r + 1) * h)]
        assert torch.equal(blk["in_proj"], lay["in_proj"][..., cols])
        chans = [*range(r * w, (r + 1) * w), *range(di, di + 2 * n)]
        for name in ("conv_w", "conv_b"):
            assert torch.equal(blk[name], lay[name][..., chans])
        for name in ("A_log", "dt_bias", "D"):
            assert torch.equal(blk[name], lay[name][..., r * h:(r + 1) * h])
        assert torch.equal(blk["norm"]["scale"], lay["norm"]["scale"][..., r * w:(r + 1) * w])
        assert torch.equal(blk["out_proj"], lay["out_proj"][:, r * w:(r + 1) * w])
        assert torch.equal(got["embed"], params["embed"][r * v:(r + 1) * v])
        assert torch.equal(got["lm_head"], params["lm_head"][:, r * v:(r + 1) * v])
        assert torch.equal(got["layers"]["ln1"]["scale"], params["layers"]["ln1"]["scale"])
        assert torch.equal(got["final_norm"]["scale"], params["final_norm"]["scale"])


@pytest.mark.parametrize("arch", ["reduced", ARCH])
def test_served_bytes_are_the_split_leaves_share_plus_b_c_and_the_norms(arch):
    """A rank's bytes: 1/M of every split leaf but the B and C columns and
    channels, which it holds whole, and ln1 and the final norm whole (fp32:
    the norm scales, dt_bias and A_log). mamba2-370m on (1, 2):
    216,415,488 of 420,136,448 parameters, 0.515 of one process's bf16
    bytes."""
    cfg = configs.reduced_config(ARCH) if arch == "reduced" else configs.base_config(ARCH)
    structs = params_structs(cfg)
    mesh = ShapeMesh(("data", "model"), (1, M))
    tp = to_shardings(tp_pspecs(structs, cfg, mesh), mesh)
    s, d, n_l = cfg.ssm, cfg.d_model, cfg.n_layers
    di, n, nh, k = s.d_inner(d), s.d_state, s.n_heads(d), s.conv_kernel
    bc = n_l * (d * 2 * n + k * 2 * n + 2 * n)  # whole on every rank
    norms = d * (n_l + 1)                        # ln1, final_norm: whole, fp32
    fp32_split = n_l * (di + 2 * nh)             # the mixer norm, dt_bias, A_log
    total = sum(x.numel() for x in tree_leaves(structs))
    bf16_split = total - bc - norms - fp32_split
    want = 2 * (bf16_split // M + bc) + 4 * (norms + fp32_split // M)
    assert served_bytes(structs, tp, torch.bfloat16) == want
    if arch == ARCH:
        rank = bf16_split // M + bc + norms + fp32_split // M
        assert (rank, total) == (216_415_488, 420_136_448)
        data = ShapeMesh(("data", "model"), (2, 1))
        one = served_bytes(structs, to_shardings(tp_pspecs(structs, cfg, data), data),
                           torch.bfloat16)
        assert round(want / one, 3) == 0.515


def test_model_ranks_that_do_not_divide_the_heads_or_vocabulary_raise():
    """3 ranks divide neither reduced mamba2's 16 heads nor its vocabulary
    of 512; 64 ranks not mamba2-370m's 32 heads. The unused attention
    widths are not named."""
    cfg = configs.reduced_config(ARCH)
    with pytest.raises(NotDivisible, match="3 model ranks do not divide ssm.n_heads = 16, "
                                           "vocab_padded = 512$"):
        tp_pspecs(params_structs(cfg), cfg, ShapeMesh(("data", "model"), (1, 3)))
    base = configs.base_config(ARCH)
    with pytest.raises(NotDivisible, match="64 model ranks do not divide ssm.n_heads = 32$"):
        tp_pspecs(params_structs(base), base, ShapeMesh(("data", "model"), (1, 64)))


@pytest.mark.parametrize("s", [16, 48])
def test_mamba2_fwd_over_model_ranks_matches_one_process_and_the_reference(s):
    """Each rank's scan on its 8 of 16 heads, out_proj's rows summed over
    the group: one chunk and three."""
    jcfg, tcfg, jp, params, _ = _case(1)
    x = _randn(2, s, tcfg.d_model, seed=s)
    want = L.mamba2_fwd(_mixer(params), torch.tensor(x), tcfg)
    ref = jlayers.mamba2_fwd(jax.tree.map(lambda a: jnp.asarray(a[0]), jp["layers"]["mamba"]),
                             jnp.asarray(x), jcfg)
    assert_close(want, np.asarray(ref))
    outs = ThreadRanks(M).run(lambda r, g: L.mamba2_fwd(_mixer(params, r, tcfg),
                                                        torch.tensor(x), tcfg, group=g))
    for out in outs:
        assert_close(out, want.numpy())
        assert_close(out, np.asarray(ref))


@pytest.mark.parametrize("s", [16, 7])
def test_mamba_layer_with_state_over_model_ranks_gives_its_cache_blocks(s):
    """The layer's output on every rank; its final state's heads and its
    block of the conv window's channels (the last min(K − 1, S) inputs,
    re-laid over the group) against one process's and the reference's."""
    jcfg, tcfg, jp, params, _ = _case(2)
    x = _randn(2, s, tcfg.d_model, seed=s + 1)
    lp = transformer.layer_params(params, 0)
    want = transformer._mamba_layer_with_state(lp, torch.tensor(x), tcfg, torch.float32)
    jlp = jax.tree.map(lambda a: jnp.asarray(a[0]), jp["layers"])
    ref = jtransformer._mamba_layer_with_state(jlp, jnp.asarray(x), jcfg, jnp.float32)
    for g, w in zip(want, ref):
        assert_close(g, np.asarray(w))

    def rank(r, group):
        blocks = transformer.layer_params(_tp_blocks(params, tcfg, M, r), 0)
        return transformer._mamba_layer_with_state(blocks, torch.tensor(x), tcfg,
                                                   torch.float32, group)

    for r, (out, state, conv) in enumerate(ThreadRanks(M).run(rank)):
        assert_close(out, want[0].numpy())
        assert_close(state, _heads(want[1], r, 1).numpy())
        assert_close(conv, _heads(want[2], r, 2).numpy())
        assert conv.shape[1] == min(3, s)


@pytest.mark.parametrize("m,d_state", [(2, 16), (4, 15)])
def test_mamba2_decode_over_model_ranks_matches_one_process(m, d_state):
    """One step from a random state and conv window: the output on every
    rank, the new state's heads and the new window's block. 2 ranks split
    the window's 544 channels; 4 ranks do not split d_state 15's 542, so
    every rank holds the whole window (``cache_pspecs``)."""
    jcfg, tcfg, jp, params, _ = _case(3, **({} if d_state == 16 else {"ssm": dataclasses.replace(
        configs.reduced_config(ARCH).ssm, d_state=d_state)}))
    s = tcfg.ssm
    di, nh = s.d_inner(tcfg.d_model), s.n_heads(tcfg.d_model)
    x = torch.tensor(_randn(2, 1, tcfg.d_model, seed=4))
    state = torch.tensor(_randn(2, nh, s.d_state, s.head_dim, seed=5))
    conv = torch.tensor(_randn(2, s.conv_kernel - 1, di + 2 * s.d_state, seed=6))
    want = L.mamba2_decode(_mixer(params), x, tcfg, state, conv)
    ref = jlayers.mamba2_decode(jax.tree.map(lambda a: jnp.asarray(a[0]), jp["layers"]["mamba"]),
                                jnp.asarray(x.numpy()), jcfg, jnp.asarray(state.numpy()),
                                jnp.asarray(conv.numpy()))
    for g, w in zip(want, ref):
        assert_close(g, np.asarray(w))
    split = conv.shape[-1] % m == 0
    assert split == (m == 2)

    def rank(r, group):
        window = _heads(conv, r, 2, m) if split else conv
        return L.mamba2_decode(_mixer(params, r, tcfg, m), x, tcfg, _heads(state, r, 1, m),
                               window.clone(), torch.float32, group)

    for r, (out, st, cv) in enumerate(ThreadRanks(m).run(rank)):
        assert_close(out, want[0].numpy())
        assert_close(st, _heads(want[1], r, 1, m).numpy())
        assert_close(cv, (_heads(want[2], r, 2, m) if split else want[2]).numpy())


def test_one_decode_step_from_the_split_prefill_matches_one_process():
    """``prefill`` over the group (its logits' vocabulary block, its
    cache's blocks) and one ``decode_step`` from that cache: the logits'
    blocks, the greedy token and the updated blocks against one process's
    and the reference's."""
    jcfg, tcfg, jp, params, tokens = _case(4, b=2, s=32)
    tok = torch.as_tensor(tokens, dtype=torch.int64)
    logits, cache = transformer.prefill(params, tcfg, tok)
    nxt = logits[:, -1].argmax(-1, keepdim=True)
    step_logits, step_cache = transformer.decode_step(
        params, tcfg, nxt, type(cache)(*(c.clone() for c in cache)), 32)
    jlogits, jcache = japi.model_prefill(jax.tree.map(jnp.asarray, jp), jcfg,
                                         {"tokens": jnp.asarray(tokens)}, jnp.float32)
    assert_close(logits, np.asarray(jlogits))
    jstep, _ = japi.model_decode(jax.tree.map(jnp.asarray, jp), jcfg,
                                 jnp.asarray(nxt.numpy(), jnp.int32), jcache, jnp.asarray(32),
                                 jnp.float32)
    assert_close(step_logits, np.asarray(jstep))

    def rank(r, group):
        blocks = _tp_blocks(params, tcfg, M, r)
        lg, c = transformer.prefill(blocks, tcfg, tok, group=group)
        first = L.greedy(lg[:, -1], group)
        prefilled = type(c)(*(x.clone() for x in c))
        lg2, c2 = transformer.decode_step(blocks, tcfg, first, c, 32, group=group)
        return lg, prefilled, first, lg2, c2

    for r, (lg, c, first, lg2, c2) in enumerate(ThreadRanks(M).run(rank)):
        assert torch.equal(first, nxt)
        assert_close(lg, _heads(logits, r, 2).numpy())
        assert_close(lg2, _heads(step_logits, r, 2).numpy())
        for got, whole in ((c, cache), (c2, step_cache)):
            assert_close(got.state, _heads(whole.state, r, 2).numpy())
            assert_close(got.conv, _heads(whole.conv, r, 3).numpy())


def test_split_loss_and_every_gradient_block_match_the_reference():
    """The weighted ``model_loss`` with remat on each rank's TP blocks, its
    checkpoints run without early stop as the train step runs them: the
    loss on every rank and each gradient block against the slices of the
    reference's ``jax.value_and_grad`` and of the one-process port's."""
    jcfg, tcfg, jp, params, tokens = _case(5, b=2, s=32)
    w = np.array([0.4, 1.6], np.float32)
    loss, grads = jax.value_and_grad(lambda p: japi.model_loss(
        p, jcfg, {"tokens": jnp.asarray(tokens)}, dtype=jnp.float32, remat=True,
        loss_weights=jnp.asarray(w))[0])(jax.tree.map(jnp.asarray, jp))

    def fn(p, g=None):
        return api.model_loss(p, tcfg, {"tokens": torch.as_tensor(tokens)}, remat=True,
                              loss_weights=torch.as_tensor(w), group=g)[0]

    one = tree_map(lambda x: x.detach().requires_grad_(), params)
    one_grads = torch.autograd.grad(fn(one), tree_leaves(one))
    by_rank = _ranks_grads(tcfg, params, fn)
    for value, _ in by_rank:
        assert_close(value, np.asarray(loss))
    _assert_grad_blocks(by_rank, lm_params_from_jax(grads, tcfg, device="cpu"), tcfg)
    _assert_grad_blocks(by_rank, tree_map(lambda x: x, _unflat(params, one_grads)), tcfg)


def _unflat(like, leaves):
    from repro_torch.flatten_util import tree_unflatten

    return tree_unflatten(like, list(leaves))


def test_mixer_norm_and_b_c_weight_gradients_are_summed_over_the_group():
    """One layer's gradients of the mixer norm's scale (its statistic spans
    every rank's channels) and of the B, C columns of in_proj and channels
    of conv_w and conv_b (whole on every rank, each feeding only its heads)
    and of the input: the group's sums, equal to one process's on every
    rank."""
    _, tcfg, _, params, _ = _case(6)
    x = torch.tensor(_randn(2, 32, tcfg.d_model, seed=7))
    dy = torch.tensor(_randn(2, 32, tcfg.d_model, seed=8))
    s = tcfg.ssm
    di, n = s.d_inner(tcfg.d_model), s.d_state

    def grads(p, group=None, r=None):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), p)
        xr = x.clone().requires_grad_()
        out = L.mamba2_fwd(p, xr, tcfg, group=group)
        g = dict(zip(("x", "norm", "in_proj", "conv_w", "conv_b"), torch.autograd.grad(
            out, (xr, p["norm"]["scale"], p["in_proj"], p["conv_w"], p["conv_b"]), dy)))
        local_di = di // (1 if group is None else group.size)
        return {"x": g["x"], "norm": g["norm"],
                "in_proj_bc": g["in_proj"][..., 2 * local_di:2 * local_di + 2 * n],
                "conv_w_bc": g["conv_w"][..., local_di:], "conv_b_bc": g["conv_b"][local_di:]}

    want = grads(_mixer(params))
    for r, got in enumerate(ThreadRanks(M).run(lambda r, g: grads(_mixer(params, r, tcfg), g))):
        for name, g in got.items():
            full = _heads(want[name], r, -1) if name == "norm" else want[name]
            assert_close(g, full.numpy())


def test_split_per_example_tangent_matches_the_one_process_jvp():
    """The sketch's pass: the per-example losses' tangent along a probe,
    each rank on its TP blocks of the weights and of the probe, against
    the one-process port's ``torch.func.jvp`` (1e-5)."""
    _, tcfg, _, params, tokens = _case(7, b=2, s=32)
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


def test_master_blocks_of_the_mixer_are_gathered_and_rebuilt_whole():
    """mamba2-370m over (1, 2): a rank cuts the vocabulary blocks and the
    whole norms from its compute blocks and gathers every Mamba2 leaf over
    "model" (the segmented in_proj, conv_w and conv_b, the per-head leaves
    the spec keeps whole, out_proj split by rows where the spec splits
    columns); a segmented block gathered from every rank is the whole
    tensor again."""
    cfg = configs.base_config(ARCH)
    structs = params_structs(cfg)
    mesh = ShapeMesh(("data", "model"), (1, M))
    tp = tree_leaves(compute_shardings(cfg, mesh, structs))
    masters = tree_leaves(to_shardings(params_pspecs(structs, mesh), mesh))
    names = ["/".join(p) for p in _paths(structs)]
    gathered = {n for n, t, s in zip(names, tp, masters) if not t.holds(s)}
    assert gathered == {f"layers/mamba/{k}" for k in
                        ("in_proj", "conv_w", "conv_b", "A_log", "dt_bias", "D", "norm/scale",
                         "out_proj")}
    spec = (None, Segments(((6, "model"), (4, None), (2, "model"))))
    whole = torch.arange(3 * 12, dtype=torch.float32).reshape(3, 12)

    def rank(r, group):
        placed = _PlacedMesh(("data", "model"), (1, M), {"data": 0, "model": r})
        sh = Sharding(placed, spec)
        block = whole[sh.index(placed.coordinates(), whole.shape)]
        assert sh.block_shape(whole.shape) == tuple(block.shape) == (3, 8)
        return _whole_over_model(block, sh, whole.shape, group)

    for out in ThreadRanks(M).run(rank):
        assert torch.equal(out, whole)


def test_a_segmented_block_cut_from_a_whole_compute_block():
    """``Sharding.cut`` and ``holds`` with a segmented inner spec: a whole
    outer block holds it and cuts the index list; a segmented outer one
    does not hold a contiguous split."""
    whole = torch.arange(2 * 12, dtype=torch.float32).reshape(2, 12)
    seg = (None, Segments(((6, "model"), (4, None), (2, "model"))))
    for r in range(M):
        mesh = _PlacedMesh(("data", "model"), (1, M), {"data": 0, "model": r})
        outer, inner = Sharding(mesh, (None, None)), Sharding(mesh, seg)
        assert outer.holds(inner) and not inner.holds(Sharding(mesh, (None, "model")))
        assert inner.holds(Sharding(mesh, seg))
        want = whole[:, [*range(3 * r, 3 * r + 3), 6, 7, 8, 9, 10 + r]]
        assert torch.equal(outer.cut(inner, whole, whole.shape), want)


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


def test_model_init_draws_mamba2_dt_bias_on_request():
    """``dt_init="mamba2"`` sets every layer's dt_bias to Mamba2's draw
    (softplus of it log-uniform in [1e-3, 1e-1], numpy's generator from
    the seed, on the leaf's device) and leaves every other leaf as the
    reference's zeros init draws it; a dense model is untouched; an
    unknown option raises."""
    cfg = configs.reduced_config(ARCH)
    zeros = api.model_init(cfg, 3, "cpu")
    drawn = api.model_init(cfg, 3, "cpu", dt_init="mamba2")
    dt = torch.nn.functional.softplus(drawn["layers"]["mamba"]["dt_bias"].double())
    assert torch.equal(zeros["layers"]["mamba"]["dt_bias"], torch.zeros_like(dt).float())
    assert dt.shape == (cfg.n_layers, cfg.ssm.n_heads(cfg.d_model))
    assert bool(((dt > 1e-3 - 1e-9) & (dt < 1e-1 + 1e-9)).all())
    rng = np.random.default_rng(3)
    want = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), tuple(dt.shape)))
    np.testing.assert_allclose(dt.numpy(), want, rtol=1e-6)
    for (name, a), (_, b) in zip(_named(zeros), _named(drawn)):
        assert name == "dt_bias" or torch.equal(a, b)
    dense = configs.reduced_config("qwen2-0.5b")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        _named(api.model_init(dense, 1, "cpu")),
        _named(api.model_init(dense, 1, "cpu", dt_init="mamba2"))))
    with pytest.raises(ValueError, match="dt_init"):
        api.model_init(cfg, 3, "cpu", dt_init="ones")


def _named(tree, key=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k], k)]
    return [(key, tree)]
