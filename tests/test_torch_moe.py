"""The port's mixture-of-experts serving path held against the live reference on the CPU.

``moe_fwd`` routes tokens in groups of at most 1,024 with a per-group
capacity, drops what overflows and gathers the experts' outputs weighted by
the renormalised top-k gates. Its decisions are held exactly: the top-k
experts (``gate_idx``, the reference's captured from its ``jax.lax.top_k``
call), each (token, slot)'s position in its expert's buffer and which of
them are dropped (against a counting loop over the reference's choices),
ties included (an all-zero router makes every probability equal). Its
output and aux loss are fp32 within 1e-5 relative to the reference's scale
(``_torch_parity``), with and without drops, in a token count that 1,024
does not divide. The models are ``reduced_config("olmoe-1b-7b")`` (4
experts, top-2) and ``reduced_config("llama4-scout-17b-a16e")`` (4
experts, top-1, a shared expert, GQA 2:1): forward logits and aux,
prefill logits and KV cache, six greedy decode steps with tokens equal and
the reference's top-2 margin above the tolerance at every step, and
``Server.decode``. Weights come from the reference's ``model_init``, carried
over by ``repro_torch.convert.lm_params_from_jax``.

Over two gloo data ranks (one launch, job ``moe_ranks`` of
``tests/_torch_mesh_worker.py``) each rank routes its rows of the batch in
the whole batch's routing groups and is held to the reference's
``moe_fwd`` on one process over the whole batch: a group of 96 tokens
split between the ranks, a 1,000-token group split inside a 3,000-token
batch, and ranks holding whole groups of 550; the ranks' routes joined
(``layers.whole_route``) equal the reference's experts, positions and
drops exactly, with drops asserted; the outputs joined and the mean of the
ranks' aux and of its router gradient within 1e-5 of the reference's,
and of its row gradient within 1e-6 of the port's one process (which sits
up to 3.4e-5 from the reference's there, relative to its scale: the softmax
backward of a nearly cancelling gradient, ROADMAP C). A second
case trains through ``launch.steps._weighted_grads`` with two microbatches
(each routed over the ranks on its own), held to the reference's loss and
gradients of the same microbatches.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import RTOL, assert_close, launch_ranks, t
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import cache as jcache
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import cache as tcache
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.models.config import InputShape

ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e")
NEAR_TIE = 1e-6  # probabilities closer than this would make the top-k ill-defined


def _cfg(arch="olmoe-1b-7b", layers=2, **moe_kw):
    """``reduced_config(arch)`` with ``layers`` layers and ``moe_kw`` in its
    MoEConfig, on both sides."""
    return tuple(
        dataclasses.replace(c.reduced_config(arch), n_layers=layers,
                            moe=dataclasses.replace(c.reduced_config(arch).moe, **moe_kw))
        for c in (jconfigs, tconfigs))


# --------------------------------------------------------------------------
# moe_fwd: groups, capacity, decisions, output
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_tok", [1, 8, 1024, 1030, 2048, 2200, 3000, 16384, 17])
def test_group_size_and_capacity_match_reference(n_tok):
    """The largest divisor of n_tok that is at most 1,024 (1,030 → 515,
    2,200 → 550, a prime → 17), and ⌈gs·k/E·cf⌉ slots, at least k."""
    gs = tlayers._moe_group_size(n_tok)
    assert gs == jlayers._moe_group_size(n_tok) and n_tok % gs == 0 and gs <= 1024
    for cfg in (jconfigs.get_config("olmoe-1b-7b"), jconfigs.reduced_config("olmoe-1b-7b"),
                jconfigs.get_config("llama4-scout-17b-a16e")):
        for cf in (0.25, 1.25, 8.0):
            moe = dataclasses.replace(cfg.moe, capacity_factor=cf)
            assert tlayers.moe_capacity(gs, moe) == jlayers.moe_capacity(gs, moe)
    assert tlayers.MOE_GROUP_SIZE == jlayers.MOE_GROUP_SIZE == 1024


def _moe_params(cfg, seed, zero_router=False):
    p = jlayers.init_moe(jax.random.PRNGKey(seed), cfg)
    if zero_router:
        p = {**p, "router": jnp.zeros_like(p["router"])}
    return p, params_from_jax(p, device="cpu")


def _reference_moe(monkeypatch, jp, x, cfg):
    """The reference's ``moe_fwd`` → (out, aux, gate_idx (G, gs, k)), its
    top-k experts captured from its ``jax.lax.top_k`` call."""
    seen = []
    top_k = jax.lax.top_k

    def recording(probs, k):
        out = top_k(probs, k)
        seen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    out, aux = jlayers.moe_fwd(jp, jnp.asarray(x), cfg)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    assert len(seen) == 1
    return out, aux, seen[0]


def _positions(gate_idx, n_experts):
    """Each (token, slot)'s place in its expert's buffer, counted slot by
    slot over the group's tokens in order: (G, k, gs)."""
    n_groups, gs, k = gate_idx.shape
    pos = np.empty((n_groups, k, gs), np.int64)
    for g in range(n_groups):
        count = np.zeros(n_experts, np.int64)
        for kk in range(k):
            for tok in range(gs):
                e = gate_idx[g, tok, kk]
                pos[g, kk, tok] = count[e]
                count[e] += 1
    return pos


def _assert_no_near_tie(probs, k):
    """The k+1 largest probabilities of every token are pairwise more than
    NEAR_TIE apart, so the top-k (and its order) is well defined."""
    top = np.sort(np.asarray(probs.reshape(-1, probs.shape[-1])), axis=-1)[:, ::-1][:, :k + 1]
    assert np.diff(-top, axis=-1).min() > NEAR_TIE


@pytest.mark.parametrize("b,s,cf", [(2, 96, 8.0), (2, 96, 0.25), (2, 1100, 0.5)])
def test_moe_fwd_decisions_output_and_aux_match_reference(monkeypatch, b, s, cf):
    """cf 8 drops nothing; cf 0.25 drops about three quarters of the
    choices; 2 × 1,100 tokens route in 4 groups of 550 (1,024 does not
    divide 2,200) and drop some. The experts, positions and drops equal the
    reference's; the output and aux within 1e-5."""
    cfg, tcfg = _cfg(capacity_factor=cf)
    jp, tp = _moe_params(cfg, seed=s)
    x = np.random.default_rng(s).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    want, want_aux, want_idx = _reference_moe(monkeypatch, jp, x, cfg)
    got, aux = tlayers.moe_fwd(tp, t(x), tcfg)
    assert_close(got, want)
    assert_close(aux, want_aux)

    gs = jlayers._moe_group_size(b * s)
    r = tlayers.moe_route(tp, t(x).reshape(-1, gs, cfg.d_model), tcfg, torch.float32)
    _assert_no_near_tie(r.probs, cfg.moe.top_k)
    assert np.array_equal(r.gate_idx.numpy(), want_idx)
    pos = _positions(want_idx, cfg.moe.n_experts)
    cap = jlayers.moe_capacity(gs, cfg.moe)
    assert r.cap == cap and np.array_equal(r.pos.numpy(), pos)
    assert np.array_equal(r.within.numpy(), pos < cap)
    dropped = int((pos >= cap).sum())
    assert (dropped == 0) == (cf == 8.0), dropped


def test_all_equal_router_picks_the_lowest_experts_as_the_reference(monkeypatch):
    """A zero router makes every probability 1/E: the top-k is experts 0..k-1
    in order on both sides (jax.lax.top_k's lower index first on ties), so
    expert 0 takes every token's first choice and drops all past its
    capacity."""
    cfg, tcfg = _cfg(n_experts=4, top_k=2, capacity_factor=1.0)
    jp, tp = _moe_params(cfg, seed=1, zero_router=True)
    x = np.random.default_rng(2).standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    want, want_aux, want_idx = _reference_moe(monkeypatch, jp, x, cfg)
    got, aux = tlayers.moe_fwd(tp, t(x), tcfg)
    r = tlayers.moe_route(tp, t(x).reshape(1, 80, cfg.d_model), tcfg, torch.float32)
    assert (want_idx == np.arange(2)).all() and (r.gate_idx.numpy() == np.arange(2)).all()
    assert torch.equal(r.pos[0, 0], torch.arange(80)) and r.cap == 40
    assert int(r.within.sum()) == 80  # 40 a slot: expert 0, then expert 1
    assert_close(got, want)
    assert_close(aux, want_aux)


def test_moe_layer_with_a_shared_expert_matches_reference(monkeypatch):
    """llama4-scout's MoE (reduced): top-1 of 4 experts plus an always-on
    shared expert."""
    cfg, tcfg = _cfg("llama4-scout-17b-a16e")
    assert cfg.moe.n_shared_experts == 1 and cfg.moe.top_k == 1
    jp, tp = _moe_params(cfg, seed=4)
    assert set(tp["shared"]) == {"w_gate", "w_in", "w_out"}
    x = np.random.default_rng(5).standard_normal((3, 20, cfg.d_model)).astype(np.float32)
    want, want_aux, want_idx = _reference_moe(monkeypatch, jp, x, cfg)
    got, aux = tlayers.moe_fwd(tp, t(x), tcfg)
    assert_close(got, want)
    assert_close(aux, want_aux)
    r = tlayers.moe_route(tp, t(x).reshape(1, 60, cfg.d_model), tcfg, torch.float32)
    assert np.array_equal(r.gate_idx.numpy(), want_idx)


# --------------------------------------------------------------------------
# the model: forward, prefill, decode
# --------------------------------------------------------------------------


def _perturbed(tree, seed):
    """The tree with the norm scales set to seeded numpy values (a fresh
    init has ones there)."""
    rng = np.random.default_rng(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if key == "scale":
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return walk(tree)


def _model(cfg, tcfg, seed=0):
    jp = _perturbed(japi.model_init(cfg, jax.random.PRNGKey(seed)), seed + 100)
    return jax.tree.map(jnp.asarray, jp), lm_params_from_jax(jp, tcfg, device="cpu")


# the reference's decode step compiled once for all steps: called eagerly,
# its lax.scan takes the step's position as a constant and compiles anew
_jax_decode_step = jax.jit(jtransformer.decode_step, static_argnums=1)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _assert_margin(logits):
    """The reference's top-2 margin exceeds the tolerance in every row."""
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    assert margin.min() > RTOL * np.abs(top2).max(), margin.min()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_six_decode_steps_match_reference(arch):
    """Forward logits and the aux summed over the layers; prefill logits and
    the KV cache; six greedy decode steps on the padded cache (the decode's
    MoE routes the batch's 2 tokens as one group), tokens equal."""
    cfg, tcfg = _cfg(arch)
    jp, tp = _model(cfg, tcfg, seed=len(arch))
    s = 24
    toks = _tokens(cfg, 2, s, 1)
    want_logits, want_aux = jtransformer.forward(jp, cfg, jnp.asarray(toks))
    got_logits, aux = ttransformer.forward(tp, tcfg, t(toks, torch.int64))
    assert_close(got_logits, want_logits)
    assert_close(aux, want_aux)
    assert float(aux) > 0.0

    wl, wcache = jtransformer.prefill(jp, cfg, jnp.asarray(toks))
    gl, gcache = ttransformer.prefill(tp, tcfg, t(toks, torch.int64))
    assert isinstance(gcache, tcache.AttnCache)
    assert_close(gl, wl)
    for got, want in zip(gcache, wcache):
        assert_close(got, want)
    wcache = jcache.pad_cache(wcache, s + 6)
    gcache = tcache.pad_cache(gcache, s + 6)
    wtok = jnp.argmax(wl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    gtok = gl[:, -1].argmax(dim=-1, keepdim=True)
    _assert_margin(wl[:, -1])
    for i in range(6):
        assert np.array_equal(gtok.numpy(), np.asarray(wtok))
        wl, wcache = _jax_decode_step(jp, cfg, wtok, wcache, jnp.asarray(s + i))
        gl, gcache = ttransformer.decode_step(tp, tcfg, gtok, gcache, s + i)
        assert_close(gl, wl)
        _assert_margin(wl[:, -1])
        wtok = jnp.argmax(wl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        gtok = gl[:, -1].argmax(dim=-1, keepdim=True)
    assert np.array_equal(gtok.numpy(), np.asarray(wtok))
    for got, want in zip(gcache, wcache):
        assert_close(got, want)


# --------------------------------------------------------------------------
# serving, entry points and conversion
# --------------------------------------------------------------------------


def _auto_mesh():
    """A one-device mesh with Auto axes, as tests/test_torch_lm.py builds it."""
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def test_server_decode_matches_reference():
    """Prefill, ``pad_cache``, then ``Server.decode`` of 6 tokens on both
    sides: the same tokens and KV cache; the bf16 server keeps the norm
    scales fp32 and casts the router and experts."""
    cfg, tcfg = _cfg()
    jp, tp = _model(cfg, tcfg, seed=5)
    s, n = 16, 6
    toks = _tokens(cfg, 2, s, 22)
    shape = InputShape("serve", seq_len=s + n, global_batch=2, kind="decode")
    jsrv = jserve.Server(cfg, shape, _auto_mesh(), dtype=jnp.float32)
    tsrv = tserve.Server(tcfg, shape, "cpu", dtype=torch.float32)
    wl, wcache = japi.model_prefill(jp, cfg, {"tokens": jnp.asarray(toks)}, jnp.float32)
    first, gl, gcache = tsrv.prefill(tp, {"tokens": t(toks, torch.int64)})
    assert_close(gl, wl)
    assert np.array_equal(first.numpy(), np.asarray(jnp.argmax(wl[:, -1], -1)[:, None]))
    want, wcache = jsrv.decode(jsrv.load_params(jp), jnp.asarray(first.numpy(), jnp.int32),
                               jcache.pad_cache(wcache, s + n), start_t=s, n_tokens=n)
    got, gcache = tsrv.decode(tsrv.load_params(tp), first, tcache.pad_cache(gcache, s + n),
                              start_t=s, n_tokens=n)
    assert np.array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(gcache, wcache):
        assert_close(a, b)
    cast = tserve.Server(tcfg, shape, "cpu", dtype=torch.bfloat16).load_params(tp)
    m = cast["layers"]["moe"]
    assert m["router"].dtype == m["w_gate"].dtype == torch.bfloat16
    assert cast["layers"]["ln2"]["scale"].dtype == torch.float32


def test_moe_entry_points_need_a_card_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfg()
    shape = InputShape("s", seq_len=10, global_batch=2, kind="decode")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.model_init(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.init_cache(tcfg, 2, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.Server(tcfg, shape)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve_demo(tcfg, {"tokens": torch.zeros((2, 4), dtype=torch.int64)}, n_tokens=2)


def test_lm_params_from_jax_carries_a_moe_tree_and_checks_shapes():
    cfg, tcfg = _cfg()
    jp = japi.model_init(cfg, jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    assert tp["layers"]["moe"]["router"].shape == (2, 256, 4)
    assert tp["layers"]["moe"]["w_gate"].shape == (2, 4, 256, 128)
    with pytest.raises(ValueError, match="moe.router"):
        lm_params_from_jax(jp, dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, n_experts=8)), device="cpu")
    with pytest.raises(ValueError, match="moe.w_gate"):
        lm_params_from_jax(jp, dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, d_ff_expert=64)), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_model_has_the_reference_shapes(arch):
    cfg, tcfg = _cfg(arch)
    want = japi.model_init(cfg, jax.random.PRNGKey(0))
    got = tapi.model_init(tcfg, seed=0, device="cpu")
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert {p[0].key for p, _ in paths} == set(got)
    for path, leaf in paths:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32, path


# --------------------------------------------------------------------------
# over two data ranks: routing groups and the aux span the whole batch
# --------------------------------------------------------------------------

# name → (rows, tokens a row, capacity factor); each case drops choices
RANK_LAYERS = {
    "spans": (4, 24, 0.5),      # one group of 96 tokens, 48 on each rank
    "partial": (2, 1500, 0.5),  # groups of 1,000: rank 0 holds group 0 and half of group 1
    "whole": (2, 1100, 0.5),    # groups of 550: each rank holds two whole groups
}
MICRO = dict(n_fl=4, b=8, s=16, n_micro=2, cf=0.5)  # each microbatch: one group of 64 tokens


def _reference_moe_grads(jp, x, cfg):
    """The reference's ``moe_fwd`` → (out, aux, gate_idx (G, gs, k), the
    aux's gradient by the router and by x), its experts captured from its
    ``jax.lax.top_k`` call, all in one ``jax.jit``."""
    top_k = jax.lax.top_k

    def run(p, y):
        seen = []

        def recording(probs, k):
            out = top_k(probs, k)
            seen.append(out[1])
            return out

        jax.lax.top_k = recording
        try:
            out, aux = jlayers.moe_fwd(p, y, cfg)
        finally:
            jax.lax.top_k = top_k
        d_p, d_x = jax.grad(lambda q, z: jlayers.moe_fwd(q, z, cfg)[1], argnums=(0, 1))(p, y)
        return out, aux, seen[0], d_p["router"], d_x

    return tuple(np.asarray(v) for v in jax.jit(run)(jp, jnp.asarray(x)))


def _to_micro(x, n_fl, n_micro):
    """The reference train step's microbatches of a FL-device-major batch
    (``repro.launch.steps.build_train_step``'s ``to_micro``)."""
    per = x.shape[0] // n_fl
    x = x.reshape((n_fl, n_micro, per // n_micro) + x.shape[1:])
    return np.moveaxis(x, 1, 0).reshape((n_micro, x.shape[0] * per // n_micro) + x.shape[3:])


def _reference_micro(jcfg, jp, tokens, coeffs):
    """The reference's loss and gradients averaged over MICRO's
    microbatches, as its train step takes them."""
    w = np.repeat(coeffs * MICRO["n_fl"], MICRO["b"] // MICRO["n_fl"]).astype(np.float32)

    def loss_fn(p, mb, mw):
        return japi.model_loss(p, jcfg, {"tokens": mb}, jnp.float32, True, loss_weights=mw)[0]

    losses, grads = [], []
    step = jax.jit(jax.value_and_grad(loss_fn))
    for mb, mw in zip(_to_micro(tokens, MICRO["n_fl"], MICRO["n_micro"]),
                      _to_micro(w, MICRO["n_fl"], MICRO["n_micro"])):
        loss, g = step(jp, jnp.asarray(mb), jnp.asarray(mw))
        losses.append(loss)
        grads.append(g)
    return (sum(losses) / len(losses),
            jax.tree.map(lambda *g: sum(g) / len(g), *grads))


@pytest.fixture(scope="module")
def moe_ranks(tmp_path_factory):
    """Every case on two gloo data ranks (one launch), and the reference's
    results, which this process computes while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor

    layer_inp, layer_jax, one_process = {}, {}, {}
    for name, (b, s, cf) in RANK_LAYERS.items():
        cfg, tcfg = _cfg(capacity_factor=cf)
        jp, tp = _moe_params(cfg, seed=b * s)
        x = np.random.default_rng(s).standard_normal((b, s, cfg.d_model)).astype(np.float32)
        layer_inp[name] = {"cfg": tcfg, "params": tp, "x": t(x)}
        layer_jax[name] = (jp, x, cfg)
        rows = t(x).requires_grad_()
        one_process[name] = torch.autograd.grad(tlayers.moe_fwd(tp, rows, tcfg)[1], [rows])[0]
    jcfg, tcfg = _cfg(capacity_factor=MICRO["cf"])
    jp, tp = _model(jcfg, tcfg, seed=7)
    tokens = _tokens(jcfg, MICRO["b"], MICRO["s"], 3)
    coeffs = np.random.default_rng(4).uniform(0.1, 0.5, MICRO["n_fl"]).astype(np.float32)
    micro = {"micro": {"cfg": tcfg, "params": tp, "tokens": t(tokens, torch.int64),
                       "coeffs": t(coeffs), "n_fl": MICRO["n_fl"],
                       "n_micro": MICRO["n_micro"]}}
    with ThreadPoolExecutor(1) as pool:
        launched = pool.submit(launch_ranks, "moe_ranks", 2, {"layer": layer_inp, "micro": micro},
                               tmp_path_factory.mktemp("moe_ranks"))
        want = {name: _reference_moe_grads(*args) for name, args in layer_jax.items()}
        want["micro"] = _reference_micro(jcfg, jp, tokens, coeffs)
        got = launched.result()
    return got, want, tcfg, one_process


@pytest.mark.parametrize("name", list(RANK_LAYERS))
def test_moe_over_two_data_ranks_routes_as_one_process(moe_ranks, name):
    """The ranks' routes joined are the reference's over the whole batch:
    its experts, each (slot, token)'s position in the batch's group and the
    drops, at least one; each rank's route holds its own tokens (the
    capacity the batch's group's); the outputs joined, the mean of the
    ranks' aux and of its router gradient within 1e-5, its row gradient
    within 1e-6 of the port's one process."""
    got, want, _, one_process = moe_ranks
    ranks = got[name]
    out, aux, idx, d_router, d_x = want[name]
    b, s, cf = RANK_LAYERS[name]
    cfg, _ = _cfg(capacity_factor=cf)
    route = tlayers.whole_route([r["route"] for r in ranks])
    gs = jlayers._moe_group_size(b * s)
    pos = _positions(idx, cfg.moe.n_experts)
    cap = jlayers.moe_capacity(gs, cfg.moe)
    assert route.cap == cap and all(r["route"].cap == cap for r in ranks)
    assert np.array_equal(route.gate_idx.numpy(), idx)
    assert np.array_equal(route.pos.numpy(), pos)
    assert np.array_equal(route.within.numpy(), pos < cap)
    assert int((pos >= cap).sum()) > 0
    spans = (b // 2 * s) % gs != 0
    assert all(r["route"].gate_idx.shape[0] == (1 if spans else b // 2 * s // gs) for r in ranks)
    assert_close(torch.cat([r["out"] for r in ranks]), out)
    assert_close(sum(r["aux"] for r in ranks) / 2, aux)
    assert_close(sum(r["d_router"] for r in ranks) / 2, d_router)
    assert_close(torch.cat([r["d_x"] for r in ranks]) / 2, one_process[name], rtol=1e-6)
    assert_close(one_process[name], d_x, rtol=4e-5)  # the port's own distance (ROADMAP C)


def test_moe_over_two_data_ranks_trains_two_microbatches_as_one_process(moe_ranks):
    """Two microbatches of four FL devices over two data ranks, each routed
    over the ranks on its own: the mean of the ranks' weighted loss and of
    every gradient equals the reference's over the same microbatches
    (within 1e-5); each microbatch's group of 64 tokens spans the ranks and
    drops choices, and the remat's recompute routes as the forward did."""
    got, (loss, grads), tcfg = moe_ranks[0]["micro"], moe_ranks[1]["micro"], moe_ranks[2]
    assert_close(sum(r["loss"] for r in got) / 2, loss)
    want = jax.tree.leaves(lm_params_from_jax(grads, tcfg, device="cpu"))
    for i, w in enumerate(want):
        assert_close(sum(r["grads"][i] for r in got) / 2, w)
    n = tcfg.n_layers
    # a microbatch's layers forward, then the recompute's in the backward's order
    for r in got:
        assert len(r["routes"]) == MICRO["n_micro"] * 2 * n
    for i in range(MICRO["n_micro"] * 2 * n):
        route = tlayers.whole_route([r["routes"][i] for r in got])
        assert route.gate_idx.shape == (1, MICRO["b"] * MICRO["s"] // MICRO["n_micro"], 2)
        assert int((~route.within).sum()) > 0
        j = i % (2 * n)
        fwd = i - j + (j if j < n else 2 * n - 1 - j)
        fwd = tlayers.whole_route([r["routes"][fwd] for r in got])
        assert torch.equal(route.pos, fwd.pos) and torch.equal(route.gate_idx, fwd.gate_idx)
