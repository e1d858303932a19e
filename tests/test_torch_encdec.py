"""The port's enc-dec (SeamlessM4T-style) serving path held against the live reference on the CPU.

A bidirectional encoder over precomputed frame embeddings, and a decoder
whose every layer attends causally over its tokens and then to the
encoder's output through its own cross-attention keys and values, which a
prefill computes once and the cache keeps. The model is
``reduced_config("seamless-m4t-large-v2")`` (2 encoder and 2 decoder
layers, d 256, 4 heads of 64, 16 frames) and, once, seamless's full width
(d 1,024, 16 heads, d_ff 8,192) at 1 + 1 layers on 48 frames: past position
~100 the reference's jitted RoPE sits 1.4e-5 off its eager one (ROADMAP
C9), and the encoder ropes its frames, so the frame and prompt positions
stay below 64. Inputs come from numpy with a seed; weights from the
reference's ``model_init``, carried over by
``repro_torch.convert.lm_params_from_jax``, with the zero biases and unit
norm scales of a fresh init replaced by seeded numpy values so that they
count. Every comparison is fp32 within 1e-5 relative to the reference's
scale (``_torch_parity``); greedy tokens match exactly, and at every step
the reference's top-2 logit margin is asserted to exceed that tolerance.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (assert_cache_match, assert_close, assert_margin, auto_mesh,
                           lm_embeddings, lm_tokens, perturbed_lm, t)

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import cache as jcache
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.flatten_util import tree_leaves
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import cache as tcache
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models.config import InputShape

ARCH = "seamless-m4t-large-v2"

# the reference's decode step compiled once for all steps: called eagerly,
# its lax.scan takes the step's position as a constant and compiles anew
_jax_decode_step = jax.jit(jencdec.decode_step_encdec, static_argnums=1)


def _cfg(**kw):
    """reduced_config(ARCH) on both sides, with ``kw`` replaced."""
    return tuple(dataclasses.replace(c.reduced_config(ARCH), **kw) for c in (jconfigs, tconfigs))


def _model(cfg, tcfg, seed=0):
    jp = perturbed_lm(japi.model_init(cfg, jax.random.PRNGKey(seed)), seed + 100)
    return jax.tree.map(jnp.asarray, jp), lm_params_from_jax(jp, tcfg, device="cpu")


# --------------------------------------------------------------------------
# attention with kv_override and without RoPE
# --------------------------------------------------------------------------


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("cross,use_rope,sq", [(True, False, 7), (True, True, 7),
                                               (True, False, 1), (False, False, 9),
                                               (False, True, 9)])
def test_attention_fwd_with_kv_override_or_without_rope_matches_reference(
        cross, use_rope, sq, qkv_bias):
    """Cross-attention (non-causal, no window, the given k and v; q roped
    only where ``use_rope``), one query as in a decode step, and
    un-roped self-attention, with and without QKV bias, and a window the
    cross-attention must ignore."""
    cfg, tcfg = _cfg(qkv_bias=qkv_bias, sliding_window=3)
    jp = perturbed_lm(jlayers.init_attention(jax.random.PRNGKey(1), cfg), 2)
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(sq + 10 * cross)
    x = rng.standard_normal((2, sq, cfg.d_model)).astype(np.float32)
    kw = dict(use_rope=use_rope, return_kv=True)
    jkw, tkw = dict(kw), dict(kw)
    if cross:
        ck, cv = (rng.standard_normal((2, 11, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
                  for _ in range(2))
        jkw["kv_override"] = (jnp.asarray(ck), jnp.asarray(cv))
        tkw["kv_override"] = (t(ck), t(cv))
    want, (wk, wv) = jlayers.attention_fwd(jp, jnp.asarray(x), cfg, **jkw)
    got, (gk, gv) = tlayers.attention_fwd(tp, t(x), tcfg, **tkw)
    assert_close(got, want)
    assert_close(gk, wk)
    assert_close(gv, wv)


def test_attention_fwd_at_given_positions_matches_reference():
    cfg, tcfg = _cfg()
    jp = perturbed_lm(jlayers.init_attention(jax.random.PRNGKey(3), cfg), 4)
    tp = params_from_jax(jp, device="cpu")
    x = np.random.default_rng(5).standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    pos = np.arange(6)[None, :] + np.array([[3], [40]])
    for causal in (True, False):
        want = jlayers.attention_fwd(jp, jnp.asarray(x), cfg, positions=jnp.asarray(pos),
                                     causal=causal)
        got = tlayers.attention_fwd(tp, t(x), tcfg, positions=t(pos), causal=causal)
        assert_close(got, want)


@pytest.mark.parametrize("use_rope", [False, True])
def test_attention_decode_with_and_without_rope_matches_reference(use_rope):
    cfg, tcfg = _cfg()
    jp = perturbed_lm(jlayers.init_attention(jax.random.PRNGKey(6), cfg), 7)
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(8)
    s_max, t_new = 8, 5
    ck, cv = (rng.standard_normal((2, s_max, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
              for _ in range(2))
    pos = np.where(np.arange(s_max) < t_new, np.arange(s_max), -1).astype(np.int32)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    want, (wk, wv, wpos) = jlayers.attention_decode(
        jp, jnp.asarray(x), cfg, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos),
        jnp.asarray(t_new, jnp.int32), use_rope=use_rope)
    got, (gk, gv, gpos) = tlayers.attention_decode(tp, t(x), tcfg, t(ck), t(cv), t(pos), t_new,
                                                   use_rope=use_rope)
    assert_close(got, want)
    assert_close(gk, wk)
    assert_close(gv, wv)
    assert np.array_equal(gpos.numpy(), np.asarray(wpos))


# --------------------------------------------------------------------------
# the encoder, the cross keys and values, the cache
# --------------------------------------------------------------------------


def test_encode_and_cross_kv_match_reference():
    """The encoder (non-causal, frames roped at 0..15) and every decoder
    layer's cross keys and values of its output."""
    cfg, tcfg = _cfg()
    jp, tp = _model(cfg, tcfg, seed=1)
    frames = lm_embeddings(cfg, 2, cfg.encdec.n_enc_frames, 2)
    want = jencdec.encode(jp, cfg, jnp.asarray(frames))
    got = tencdec.encode(tp, tcfg, t(frames))
    assert_close(got, want)
    for i in range(cfg.n_layers):
        jlp = jax.tree.map(lambda a, i=i: a[i], jp["layers"])
        tlp = {k: {n: v[i] for n, v in d.items()} for k, d in tp["layers"].items()}
        for g, w in zip(tencdec._cross_kv(tlp, got, tcfg, torch.float32),
                        jencdec._cross_kv(jlp, want, cfg, jnp.float32)):
            assert g.shape == (2, cfg.encdec.n_enc_frames, cfg.n_kv_heads, cfg.head_dim)
            assert_close(g, w)


@pytest.mark.parametrize("context", [4, 40])
def test_init_cache_and_pad_cache_match_reference(context):
    cfg, tcfg = _cfg()
    want = jcache.init_cache(cfg, 3, context)
    got = tcache.init_cache(tcfg, 3, context, device="cpu")
    assert isinstance(got, tcache.EncDecCache) and isinstance(got.self_attn, tcache.AttnCache)
    assert got._fields == want._fields == ("self_attn", "cross_k", "cross_v")
    assert_cache_match(got, want)
    assert got.cross_k.shape == (cfg.n_layers, 3, cfg.encdec.n_enc_frames, cfg.n_kv_heads,
                                 cfg.head_dim)
    for total in (context, context + 5):
        assert_cache_match(tcache.pad_cache(got, total), jcache.pad_cache(want, total))
    moved = tcache.cache_to(got, "cpu")
    assert type(moved) is tcache.EncDecCache and len(tcache.cache_leaves(moved)) == 5


# --------------------------------------------------------------------------
# the model: forward, prefill, decode
# --------------------------------------------------------------------------


def _prefill_and_decode(cfg, tcfg, b, s, n_frames, steps, seed):
    jp, tp = _model(cfg, tcfg, seed)
    toks = lm_tokens(cfg, b, s, seed + 1)
    frames = lm_embeddings(cfg, b, n_frames, seed + 2)
    jbatch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    tbatch = {"tokens": t(toks, torch.int64), "frames": t(frames)}
    assert_close(tencdec.forward_encdec(tp, tcfg, tbatch["tokens"], tbatch["frames"]),
                 jencdec.forward_encdec(jp, cfg, jbatch["tokens"], jbatch["frames"]))

    wl, wcache = japi.model_prefill(jp, cfg, jbatch)
    gl, gcache = tapi.model_prefill(tp, tcfg, tbatch)
    assert_close(gl, wl)
    assert_cache_match(gcache, wcache)
    wcache = jcache.pad_cache(wcache, s + steps)
    gcache = tcache.pad_cache(gcache, s + steps)
    wtok = jnp.argmax(wl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    gtok = gl[:, -1].argmax(dim=-1, keepdim=True)
    assert_margin(wl[:, -1])
    for i in range(steps):
        assert np.array_equal(gtok.numpy(), np.asarray(wtok))
        wl, wcache = _jax_decode_step(jp, cfg, wtok, wcache, jnp.asarray(s + i, jnp.int32))
        gl, gcache = tapi.model_decode(tp, tcfg, gtok, gcache, s + i)
        assert_close(gl, wl)
        assert_margin(wl[:, -1])
        wtok = jnp.argmax(wl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        gtok = gl[:, -1].argmax(dim=-1, keepdim=True)
    assert np.array_equal(gtok.numpy(), np.asarray(wtok))
    assert_cache_match(gcache, wcache)


def test_forward_prefill_and_five_decode_steps_match_reference():
    """The reduced config: 2 + 2 layers, MHA 4 heads of 64, 16 frames."""
    cfg, tcfg = _cfg()
    _prefill_and_decode(cfg, tcfg, b=2, s=9, n_frames=cfg.encdec.n_enc_frames, steps=5, seed=0)


def test_gqa_with_bias_and_a_padded_vocab_match_reference():
    """GQA 2:1 with QKV bias on every projection (the cross keys' bias
    too), 12 frames where the config says 16, a vocab off the 256 grid."""
    cfg, tcfg = _cfg(n_kv_heads=2, qkv_bias=True, vocab_size=500)
    _prefill_and_decode(cfg, tcfg, b=2, s=6, n_frames=12, steps=4, seed=3)


def test_one_layer_pair_at_full_width_matches_reference():
    """seamless's widths (d 1,024, 16 heads of 64, MHA, d_ff 8,192) with
    1 encoder and 1 decoder layer, 48 frames, a 12-token prompt and the
    vocab cut to 512, so the reference's CPU init and the test stay small."""
    cfg, tcfg = (dataclasses.replace(
        c.get_config(ARCH), n_layers=1, vocab_size=512,
        encdec=dataclasses.replace(c.get_config(ARCH).encdec, n_enc_layers=1))
        for c in (jconfigs, tconfigs))
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff) == (
        1024, 16, 16, 64, 8192)
    _prefill_and_decode(cfg, tcfg, b=2, s=12, n_frames=48, steps=2, seed=11)


def test_decode_step_launches_the_kernel_path_once_a_layer_for_cross_attention(monkeypatch):
    """A decode step sends each decoder layer's cross-attention, one query
    against the cached frames, to ``kernels.attention.ops.attention`` (the
    flash kernel on the card); its self-attention stays the plain decode."""
    cfg, tcfg = _cfg()
    _, tp = _model(cfg, tcfg, seed=4)
    batch = {"tokens": t(lm_tokens(cfg, 2, 5, 5), torch.int64),
             "frames": t(lm_embeddings(cfg, 2, 16, 6))}
    calls = []
    real = tlayers.attention

    def counting(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw["causal"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tlayers, "attention", counting)
    _, cache = tapi.model_prefill(tp, tcfg, batch)
    n_enc, n_dec = cfg.encdec.n_enc_layers, cfg.n_layers
    assert len(calls) == n_enc + 2 * n_dec
    assert [c[2] for c in calls] == [False] * n_enc + [True, False] * n_dec
    calls.clear()
    tapi.model_decode(tp, tcfg, batch["tokens"][:, :1], tcache.pad_cache(cache, 8), 5)
    assert calls == [((2, 1, cfg.n_heads, cfg.head_dim),
                      (2, 16, cfg.n_kv_heads, cfg.head_dim), False)] * n_dec


# --------------------------------------------------------------------------
# serving and conversion
# --------------------------------------------------------------------------


@pytest.fixture
def reference_weights(monkeypatch):
    """The port's ``model_init`` replaced by the reference's draws, so that
    both ``serve_demo``s serve the same weights."""
    def init(cfg, seed=0, device=None):
        return lm_params_from_jax(japi.model_init(cfg, jax.random.PRNGKey(seed)), cfg, device)
    monkeypatch.setattr(tapi, "model_init", init)


def test_serve_demo_matches_reference(reference_weights):
    """Both decode from the unpadded prefill cache from ``t = tokens``."""
    cfg, tcfg = _cfg()
    toks, frames = lm_tokens(cfg, 2, 8, 21), lm_embeddings(cfg, 2, 16, 22)
    want, _ = jserve.serve_demo(cfg, auto_mesh(), {"tokens": jnp.asarray(toks),
                                                   "frames": jnp.asarray(frames)},
                                n_tokens=6, dtype=jnp.float32, seed=3)
    got, stats = tserve.serve_demo(tcfg, {"tokens": t(toks, torch.int64), "frames": t(frames)},
                                   n_tokens=6, dtype=torch.float32, seed=3, device="cpu")
    assert got.shape == (2, 6) and np.array_equal(got.numpy(), np.asarray(want))
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


def test_server_decode_matches_reference_on_a_padded_cache():
    cfg, tcfg = _cfg()
    jp, tp = _model(cfg, tcfg, seed=5)
    s, n = 8, 6
    toks, frames = lm_tokens(cfg, 2, s, 23), lm_embeddings(cfg, 2, 16, 24)
    shape = InputShape("serve", seq_len=s + n, global_batch=2, kind="decode")
    jsrv = jserve.Server(cfg, shape, auto_mesh(), dtype=jnp.float32)
    tsrv = tserve.Server(tcfg, shape, "cpu", dtype=torch.float32)
    wl, wcache = japi.model_prefill(jp, cfg, {"tokens": jnp.asarray(toks),
                                              "frames": jnp.asarray(frames)})
    first, gl, gcache = tsrv.prefill(tp, {"tokens": t(toks, torch.int64), "frames": t(frames)})
    assert_close(gl, wl)
    want, wcache = jsrv.decode(jsrv.load_params(jp), jnp.asarray(first.numpy(), jnp.int32),
                               jcache.pad_cache(wcache, s + n), start_t=s, n_tokens=n)
    got, gcache = tsrv.decode(tsrv.load_params(tp), first, tcache.pad_cache(gcache, s + n),
                              start_t=s, n_tokens=n)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert_cache_match(gcache, wcache)
    assert np.array_equal(gcache.self_attn.pos.numpy(), np.r_[np.arange(s + n - 1), -1])


def test_lm_params_from_jax_keeps_the_encdec_tree_and_checks_shapes():
    cfg, tcfg = _cfg()
    jp = japi.model_init(cfg, jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    assert sorted(tp) == sorted(jp) == ["embed", "enc_layers", "enc_norm", "final_norm",
                                        "layers", "lm_head"]
    assert sorted(tp["layers"]) == ["cross_attn", "ln1", "ln2", "ln_x", "mlp", "self_attn"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        node = tp
        for key in path:
            node = node[key.key]
        assert np.array_equal(node.numpy(), np.asarray(leaf)), path
    for wrong in (dataclasses.replace(tcfg, n_layers=3),
                  dataclasses.replace(tcfg, encdec=dataclasses.replace(tcfg.encdec,
                                                                       n_enc_layers=3)),
                  dataclasses.replace(tcfg, n_kv_heads=2)):
        with pytest.raises(ValueError, match="expected"):
            lm_params_from_jax(jp, wrong, device="cpu")


def test_port_init_encdec_has_the_reference_shapes():
    cfg, tcfg = _cfg()
    want = japi.model_init(cfg, jax.random.PRNGKey(0))
    got = tapi.model_init(tcfg, seed=0, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(tree_leaves(got))
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32, path

