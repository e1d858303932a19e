"""The port's Zamba2-style hybrid serving path held against the live reference on the CPU.

A Mamba2 stack with one shared attention + MLP block run before every
``attn_every``-th layer. The model is ``reduced_config("zamba2-2.7b")`` cut
to d 128 with 5 layers and ``attn_every`` 2, so the shared block runs 3
times and its last group is partial (layer 4 alone). Inputs come from numpy
with a seed; weights from the reference's ``model_init``, carried over by
``repro_torch.convert.lm_params_from_jax``, with the zero biases and unit
norm scales and skip weights of a fresh init replaced by seeded numpy values
so that they count. Every comparison is fp32 within 1e-5 relative to the
reference's scale (``_torch_parity``); greedy tokens match exactly, and at
every step the reference's top-2 logit margin is asserted to exceed that
tolerance, so the greedy choice is well defined.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import RTOL, assert_close, t
from jax.sharding import AxisType

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import cache as jcache
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import cache as tcache
from repro_torch.models import transformer as ttransformer
from repro_torch.models.config import InputShape

ARCH = "zamba2-2.7b"


def _cfg(layers=5, every=2, **kw):
    """reduced_config("zamba2-2.7b") at d 128 (4 heads of 32, MHA; 8 SSM
    heads of 32, d_state 16, chunk 16), ``layers`` layers, the shared block
    every ``every``, on both sides."""
    return tuple(
        dataclasses.replace(c.reduced_config(ARCH), n_layers=layers, d_model=128,
                            hybrid=dataclasses.replace(c.reduced_config(ARCH).hybrid,
                                                       attn_every=every), **kw)
        for c in (jconfigs, tconfigs))


def _perturbed(tree, seed):
    """The tree with the conv bias, dt bias, skip weight D and norm scales
    set to seeded numpy values (a fresh init has zeros and ones there)."""
    rng = np.random.default_rng(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if key in ("conv_b", "dt_bias"):
            return rng.standard_normal(a.shape).astype(np.float32) * 0.3
        if key in ("scale", "D"):
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return walk(tree)


def _model(cfg, tcfg, seed=0, mamba2_dt=False):
    """Both sides' weights. ``mamba2_dt`` draws every layer's dt_bias as
    Mamba2 initialises it (dt log-uniform in [1e-3, 1e-1], dt_bias its
    inverse softplus; ``tests/test_torch_ssm.py``): at d 2,560 the perturbed
    dt_bias (dt ≈ 0.7) makes fp32 Mamba2 ill-conditioned, as the reference's
    zero init does (ROADMAP queue C)."""
    jp = _perturbed(japi.model_init(cfg, jax.random.PRNGKey(seed)), seed + 100)
    if mamba2_dt:
        shape = jp["layers"]["mamba"]["dt_bias"].shape
        dt = np.exp(np.random.default_rng(seed + 200).uniform(np.log(1e-3), np.log(1e-1), shape))
        jp["layers"]["mamba"]["dt_bias"] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
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


def _assert_cache_close(got, want):
    """Every leaf of a HybridCache (SSM state, conv window, k, v, pos)."""
    assert isinstance(got, tcache.HybridCache)
    leaves = tcache.cache_leaves(got)
    wants = jax.tree.leaves(want)
    assert len(leaves) == len(wants) == 5
    for g, w in zip(leaves, wants):
        if g.is_floating_point():
            assert_close(g, w)
        else:
            assert np.array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# the cache
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layers,every", [(5, 2), (54, 6), (6, 6), (7, 3), (1, 6)])
def test_n_shared_invocations_and_init_cache_match_reference(layers, every):
    """⌈L / every⌉ invocations, the last group partial where every does not
    divide L; ``init_cache`` of both sides in shape, type and content."""
    cfg, tcfg = _cfg(layers, every)
    assert tcache.n_shared_invocations(tcfg) == jcache.n_shared_invocations(cfg)
    assert tcache.n_shared_invocations(tcfg) == -(-layers // every)
    want = japi.init_cache(cfg, 3, 40)
    got = tapi.init_cache(tcfg, 3, 40, device="cpu")
    assert isinstance(got.ssm, tcache.SSMCache) and isinstance(got.attn, tcache.AttnCache)
    for g, w in zip(tcache.cache_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_pad_cache_pads_the_attention_part_only():
    cfg, tcfg = _cfg()
    rng = np.random.default_rng(0)
    want = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype)
                        if a.dtype != jnp.int32 else jnp.arange(a.shape[0], dtype=jnp.int32),
                        japi.init_cache(cfg, 2, 12))
    got = tcache.HybridCache(ssm=tcache.SSMCache(*(t(x) for x in want.ssm)),
                             attn=tcache.AttnCache(*(t(x) for x in want.attn)))
    padded = tcache.pad_cache(got, 20)
    assert padded.ssm is got.ssm
    _assert_cache_close(padded, jcache.pad_cache(want, 20))
    assert padded.attn.k.shape[2] == 20 and (padded.attn.pos[12:] == -1).all()
    assert tcache.pad_cache(got, 12).attn is got.attn


# --------------------------------------------------------------------------
# the model: forward, prefill, decode
# --------------------------------------------------------------------------


def test_forward_prefill_and_six_decode_steps_match_reference():
    """5 layers, the shared block at layers 0, 2 and 4, a prompt of two
    chunks: forward logits, prefill logits and every HybridCache leaf, then
    six greedy decode steps (one position write a step, read by all three
    invocations), tokens equal, and the caches after them."""
    cfg, tcfg = _cfg()
    jp, tp = _model(cfg, tcfg, seed=1)
    s = 32
    toks = _tokens(cfg, 2, s, 2)
    want_logits, _ = jtransformer.forward(jp, cfg, jnp.asarray(toks))
    got_logits, aux = ttransformer.forward(tp, tcfg, t(toks, torch.int64))
    assert_close(got_logits, want_logits)
    assert float(aux) == 0.0

    wl, wcache = jtransformer.prefill(jp, cfg, jnp.asarray(toks))
    gl, gcache = ttransformer.prefill(tp, tcfg, t(toks, torch.int64))
    assert_close(gl, wl)
    _assert_cache_close(gcache, wcache)
    wcache = jcache.pad_cache(wcache, s + 6)
    gcache = tcache.pad_cache(gcache, s + 6)
    wtok = jnp.argmax(wl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    gtok = gl[:, -1].argmax(dim=-1, keepdim=True)
    _assert_margin(wl[:, -1])
    for i in range(6):
        assert np.array_equal(gtok.numpy(), np.asarray(wtok))
        wl, wcache = _jax_decode_step(jp, cfg, wtok, wcache, jnp.asarray(s + i))
        gl, out = ttransformer.decode_step(tp, tcfg, gtok, gcache, s + i)
        assert out is gcache  # updated in place
        assert_close(gl, wl)
        _assert_margin(wl[:, -1])
        wtok = jnp.argmax(wl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        gtok = gl[:, -1].argmax(dim=-1, keepdim=True)
    assert np.array_equal(gtok.numpy(), np.asarray(wtok))
    _assert_cache_close(gcache, wcache)


def test_one_invocation_at_full_width_matches_reference():
    """zamba2-2.7b's widths (d 2,560; 80 SSM heads of 64, d_state 64; the
    shared block's 32 heads of 80, MHA, d_ff 10,240) with 2 layers, so the
    shared block runs once, and the vocab cut to 512: the prefill of a
    64-token prompt (one chunk of 64) and one decode step.

    Not 256 tokens: under ``jit`` (its ``lax.scan`` body) the reference's
    RoPE frequencies sit 2–4 ulp from its eager ones, which the port's equal
    bitwise, so past position ~100 its roped k moves more than 1e-5 (1.4e-5
    at 255; ROADMAP queue C). ``test_torch_lm.py`` holds the port's RoPE to
    the eager reference at positions up to 2,044."""
    cfg, tcfg = (dataclasses.replace(c.get_config(ARCH), n_layers=2, vocab_size=512)
                 for c in (jconfigs, tconfigs))
    assert (cfg.d_model, cfg.ssm.n_heads(cfg.d_model), cfg.ssm.d_state, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.d_ff) == (2560, 80, 64, 32, 32, 80, 10240)
    jp, tp = _model(cfg, tcfg, seed=3, mamba2_dt=True)
    toks = _tokens(cfg, 1, 64, 4)
    wl, wcache = jtransformer.prefill(jp, cfg, jnp.asarray(toks))
    gl, gcache = ttransformer.prefill(tp, tcfg, t(toks, torch.int64))
    assert_close(gl, wl)
    _assert_cache_close(gcache, wcache)
    tok = np.asarray(jnp.argmax(wl[:, -1], axis=-1)[:, None], np.int32)
    wl, wcache = jtransformer.decode_step(jp, cfg, jnp.asarray(tok), wcache, jnp.asarray(64))
    gl, gcache = ttransformer.decode_step(tp, tcfg, t(tok, torch.int64), gcache, 64)
    assert_close(gl, wl)
    _assert_cache_close(gcache, wcache)


# --------------------------------------------------------------------------
# serving: serve_demo and Server.decode
# --------------------------------------------------------------------------


def _auto_mesh():
    """A one-device mesh with Auto axes, as tests/test_torch_lm.py builds it."""
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def test_serve_demo_matches_reference_unpadded_cache_quirk_included(monkeypatch):
    """Both decode from the unpadded prefill cache: from the first new token
    on, the shared block's slot t % S overwrites the oldest prompt slot."""
    def init(cfg, seed=0, device=None):
        return lm_params_from_jax(japi.model_init(cfg, jax.random.PRNGKey(seed)), cfg, device)
    monkeypatch.setattr(tapi, "model_init", init)
    cfg, tcfg = _cfg(layers=3)
    toks = _tokens(cfg, 2, 16, 21)
    want, _ = jserve.serve_demo(cfg, _auto_mesh(), {"tokens": jnp.asarray(toks)}, n_tokens=6,
                                dtype=jnp.float32, seed=3)
    got, stats = tserve.serve_demo(tcfg, {"tokens": t(toks, torch.int64)}, n_tokens=6,
                                   dtype=torch.float32, seed=3, device="cpu")
    assert got.shape == (2, 6) and np.array_equal(got.numpy(), np.asarray(want))
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


def test_server_decode_matches_reference_on_a_padded_cache():
    """Prefill, ``pad_cache``, then ``Server.decode`` of 6 tokens on both
    sides: the same tokens and every HybridCache leaf, positions 0..S+4."""
    cfg, tcfg = _cfg(layers=3)
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
    _assert_cache_close(gcache, wcache)
    assert np.array_equal(gcache.attn.pos.numpy(), np.r_[np.arange(s + n - 1), -1])


def test_server_keeps_the_fp32_leaves_of_both_blocks():
    """In bf16 the shared block's norm scales and Mamba2's A_log, dt_bias
    and norm scales stay fp32; every other leaf is cast once; a bf16
    prefill and decode give a bf16 HybridCache and finite logits."""
    cfg, tcfg = _cfg(layers=3)
    _, tp = _model(cfg, tcfg, seed=9)
    srv = tserve.Server(tcfg, InputShape("s", seq_len=40, global_batch=2, kind="decode"),
                        "cpu", dtype=torch.bfloat16)
    cast = srv.load_params(tp)
    sb, m = cast["shared_block"], cast["layers"]["mamba"]
    assert sb["attn"]["wq"].dtype == sb["mlp"]["w_in"].dtype == m["in_proj"].dtype == \
        torch.bfloat16
    assert sb["ln1"]["scale"].dtype == sb["ln2"]["scale"].dtype == m["A_log"].dtype == \
        m["dt_bias"].dtype == torch.float32
    toks = torch.tensor(_tokens(cfg, 2, 32, 10), dtype=torch.int64)
    first, logits, cache = srv.prefill(cast, {"tokens": toks})
    out, cache = srv.decode(cast, first, tcache.pad_cache(cache, 40), 32, 3)
    assert cache.attn.k.dtype == cache.ssm.state.dtype == torch.bfloat16
    assert out.shape == (2, 3) and torch.isfinite(logits[..., :cfg.vocab_size]).all()


# --------------------------------------------------------------------------
# entry points and conversion
# --------------------------------------------------------------------------


def test_hybrid_entry_points_need_a_card_or_an_explicit_device(monkeypatch):
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


def test_lm_params_from_jax_carries_a_hybrid_tree_and_checks_shapes():
    cfg, tcfg = _cfg()
    jp = japi.model_init(cfg, jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    assert tp["shared_block"]["attn"]["wq"].shape == (128, 128)
    assert tp["layers"]["mamba"]["in_proj"].shape == (5, 128, 2 * 256 + 2 * 16 + 8)
    with pytest.raises(ValueError, match="in_proj"):
        lm_params_from_jax(jp, dataclasses.replace(tcfg, n_layers=4), device="cpu")
    narrow = {**jp, "shared_block": {**jp["shared_block"], "attn": {
        **jp["shared_block"]["attn"], "wq": jp["shared_block"]["attn"]["wq"][:, :64]}}}
    with pytest.raises(ValueError, match="shared_block.attn.wq"):
        lm_params_from_jax(narrow, tcfg, device="cpu")


def test_port_init_model_has_the_reference_shapes():
    cfg, tcfg = _cfg()
    want = japi.model_init(cfg, jax.random.PRNGKey(0))
    got = tapi.model_init(tcfg, seed=0, device="cpu")
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert {p[0].key for p, _ in paths} == set(got)
    for path, leaf in paths:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32, path
