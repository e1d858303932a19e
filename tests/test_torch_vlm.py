"""The port's VLM (InternVL2 backbone) serving path held against the live reference on the CPU.

A dense decoder whose sequence starts with the patch embeddings projected
by ``vis_proj``: they take the first positions of the attention and of the
cache, and ``forward`` drops them from its logits. The model is
``reduced_config("internvl2-76b")`` (2 layers, d 256, GQA 4/2 heads of 64,
RoPE θ 5e5, 8 patches). Inputs come from numpy with a seed; weights from
the reference's ``model_init``, carried over by
``repro_torch.convert.lm_params_from_jax``, with the unit norm scales of a
fresh init replaced by seeded numpy values so that they count. Every
comparison is fp32 within 1e-5 relative to the reference's scale
(``_torch_parity``); greedy tokens match exactly, and at every step the
reference's top-2 logit margin is asserted to exceed that tolerance.

The reference's ``serve_demo`` starts the decode at ``t = tokens``, leaving
the patches out (ROADMAP C10): the port's does the same, and
``Server.decode`` is held to the reference's at that start and at ``t =
patches + tokens``.
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
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import cache as tcache
from repro_torch.models import transformer as ttransformer
from repro_torch.models.config import InputShape

ARCH = "internvl2-76b"

# the reference's decode step compiled once for all steps (see
# tests/test_torch_hybrid.py)
_jax_decode_step = jax.jit(jtransformer.decode_step, static_argnums=1)


def _cfg(**kw):
    """reduced_config(ARCH) on both sides, with ``kw`` replaced."""
    return tuple(dataclasses.replace(c.reduced_config(ARCH), **kw) for c in (jconfigs, tconfigs))


def _model(cfg, tcfg, seed=0):
    jp = perturbed_lm(japi.model_init(cfg, jax.random.PRNGKey(seed)), seed + 100)
    return jax.tree.map(jnp.asarray, jp), lm_params_from_jax(jp, tcfg, device="cpu")


def _batch(cfg, b, s, seed, n_patches=None):
    """(reference batch, port batch): ``s`` tokens and ``n_patches``
    (default the config's) patch embeddings."""
    toks = lm_tokens(cfg, b, s, seed)
    embeds = lm_embeddings(cfg, b, cfg.vlm.n_patches if n_patches is None else n_patches,
                           seed + 1)
    return ({"tokens": jnp.asarray(toks), "embeds": jnp.asarray(embeds)},
            {"tokens": t(toks, torch.int64), "embeds": t(embeds)})


def test_configs_reduce_as_the_reference_does():
    for arch, field, want in ((ARCH, "vlm", {"n_patches": 8}),
                              ("seamless-m4t-large-v2", "encdec",
                               {"n_enc_layers": 2, "n_enc_frames": 16})):
        got = dataclasses.asdict(getattr(tconfigs.reduced_config(arch), field))
        assert got == want == dataclasses.asdict(getattr(jconfigs.reduced_config(arch), field))


def test_embed_inputs_prepends_the_projected_patches():
    cfg, tcfg = _cfg()
    jp, tp = _model(cfg, tcfg, seed=1)
    jb, tb = _batch(cfg, 2, 5, 2)
    want = jtransformer.embed_inputs(jp, cfg, jb["tokens"], jb["embeds"], jnp.float32)
    got = ttransformer.embed_inputs(tp, tcfg, tb["tokens"], tb["embeds"], torch.float32)
    assert got.shape == (2, cfg.vlm.n_patches + 5, cfg.d_model)
    assert_close(got, want)
    assert torch.equal(got[:, cfg.vlm.n_patches:], tp["embed"][tb["tokens"]])
    with pytest.raises(ValueError, match="patch embeddings"):
        ttransformer.embed_inputs(tp, tcfg, tb["tokens"], None, torch.float32)
    dense = tconfigs.reduced_config("qwen2-0.5b")
    with pytest.raises(ValueError, match="tokens only"):
        ttransformer.embed_inputs(tp, dense, tb["tokens"], tb["embeds"], torch.float32)


@pytest.mark.parametrize("n_patches", [8, 3])
def test_forward_drops_the_patch_positions(n_patches):
    """Logits cover the token positions only, whatever the patch count."""
    cfg, tcfg = _cfg()
    jp, tp = _model(cfg, tcfg, seed=3)
    jb, tb = _batch(cfg, 2, 6, 4, n_patches)
    want, _ = jtransformer.forward(jp, cfg, jb["tokens"], jb["embeds"])
    got, aux = ttransformer.forward(tp, tcfg, tb["tokens"], tb["embeds"])
    assert got.shape == (2, 6, cfg.vocab_padded) and float(aux) == 0.0
    assert_close(got, want)


@pytest.mark.parametrize("context", [4, 40])
def test_init_cache_and_pad_cache_match_reference(context):
    cfg, tcfg = _cfg()
    want = jcache.init_cache(cfg, 2, context)
    got = tcache.init_cache(tcfg, 2, context, device="cpu")
    assert isinstance(got, tcache.AttnCache)
    assert_cache_match(got, want)
    assert_cache_match(tcache.pad_cache(got, context + 3), jcache.pad_cache(want, context + 3))


def test_prefill_and_five_decode_steps_match_reference():
    """The prompt's 8 patches and 9 tokens take positions 0..16; the decode
    goes on from t = 17 on a padded cache."""
    cfg, tcfg = _cfg()
    jp, tp = _model(cfg, tcfg, seed=0)
    s, steps, n_p = 9, 5, cfg.vlm.n_patches
    jb, tb = _batch(cfg, 2, s, 1)
    wl, wcache = japi.model_prefill(jp, cfg, jb)
    gl, gcache = tapi.model_prefill(tp, tcfg, tb)
    assert_close(gl, wl)
    assert_cache_match(gcache, wcache)
    assert np.array_equal(gcache.pos.numpy(), np.arange(n_p + s))
    total = n_p + s + steps
    wcache, gcache = jcache.pad_cache(wcache, total), tcache.pad_cache(gcache, total)
    wtok = jnp.argmax(wl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    gtok = gl[:, -1].argmax(dim=-1, keepdim=True)
    assert_margin(wl[:, -1])
    for i in range(steps):
        assert np.array_equal(gtok.numpy(), np.asarray(wtok))
        wl, wcache = _jax_decode_step(jp, cfg, wtok, wcache, jnp.asarray(n_p + s + i, jnp.int32))
        gl, gcache = tapi.model_decode(tp, tcfg, gtok, gcache, n_p + s + i)
        assert_close(gl, wl)
        assert_margin(wl[:, -1])
        wtok = jnp.argmax(wl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        gtok = gl[:, -1].argmax(dim=-1, keepdim=True)
    assert np.array_equal(gtok.numpy(), np.asarray(wtok))
    assert_cache_match(gcache, wcache)


# --------------------------------------------------------------------------
# serving: serve_demo (the decode-position quirk included) and Server
# --------------------------------------------------------------------------


@pytest.fixture
def reference_weights(monkeypatch):
    """The port's ``model_init`` replaced by the reference's draws, so that
    both ``serve_demo``s serve the same weights."""
    def init(cfg, seed=0, device=None):
        return lm_params_from_jax(japi.model_init(cfg, jax.random.PRNGKey(seed)), cfg, device)
    monkeypatch.setattr(tapi, "model_init", init)


def test_serve_demo_matches_reference_decode_position_quirk_included(reference_weights):
    """Both decode from the unpadded cache from ``t = tokens``: the first
    new token's position lies inside the prompt."""
    cfg, tcfg = _cfg()
    jb, tb = _batch(cfg, 2, 8, 21)
    want, _ = jserve.serve_demo(cfg, auto_mesh(), jb, n_tokens=6, dtype=jnp.float32, seed=3)
    got, stats = tserve.serve_demo(tcfg, tb, n_tokens=6, dtype=torch.float32, seed=3,
                                   device="cpu")
    assert got.shape == (2, 6) and np.array_equal(got.numpy(), np.asarray(want))
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


@pytest.mark.parametrize("quirk", [True, False])
def test_server_decode_matches_reference_from_either_start(quirk):
    """From ``t = tokens`` on the unpadded cache (``serve_demo``'s start:
    slot t overwrites the prompt's slot t and the later prompt positions
    are masked) and from ``t = patches + tokens`` on a padded cache (every
    prompt position kept): tokens and caches as the reference's
    ``Server.decode`` gives them."""
    cfg, tcfg = _cfg()
    jp, tp = _model(cfg, tcfg, seed=5)
    s, n, n_p = 8, 6, cfg.vlm.n_patches
    jb, tb = _batch(cfg, 2, s, 22)
    shape = InputShape("serve", seq_len=n_p + s + n, global_batch=2, kind="decode")
    jsrv = jserve.Server(cfg, shape, auto_mesh(), dtype=jnp.float32)
    tsrv = tserve.Server(tcfg, shape, "cpu", dtype=torch.float32)
    wl, wcache = japi.model_prefill(jp, cfg, jb)
    first, gl, gcache = tsrv.prefill(tp, tb)
    assert_close(gl, wl)
    start = s if quirk else n_p + s
    if not quirk:
        wcache, gcache = jcache.pad_cache(wcache, n_p + s + n), tcache.pad_cache(gcache,
                                                                                 n_p + s + n)
    want, wcache = jsrv.decode(jsrv.load_params(jp), jnp.asarray(first.numpy(), jnp.int32),
                               wcache, start_t=start, n_tokens=n)
    got, gcache = tsrv.decode(tsrv.load_params(tp), first, gcache, start_t=start, n_tokens=n)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert_cache_match(gcache, wcache)
    # the quirk rewrites slots s..s+n-2 with the positions they already held
    expect = np.arange(n_p + s) if quirk else np.r_[np.arange(n_p + s + n - 1), -1]
    assert np.array_equal(gcache.pos.numpy(), expect)


def test_server_counts_the_patches_against_its_capacity():
    cfg, tcfg = _cfg(n_layers=1)
    _, tp = _model(cfg, tcfg, seed=9)
    n_p = cfg.vlm.n_patches
    srv = tserve.Server(tcfg, InputShape("s", seq_len=n_p + 4, global_batch=2, kind="decode"),
                        "cpu", dtype=torch.float32)
    _, ok = _batch(cfg, 2, 4, 10)
    first, _, cache = srv.prefill(tp, ok)
    assert cache.k.shape[2] == n_p + 4
    _, too_long = _batch(cfg, 2, 5, 11)
    with pytest.raises(ValueError, match="beyond the server's shape"):
        srv.prefill(tp, too_long)


def test_lm_params_from_jax_keeps_vis_proj_and_checks_its_shape():
    cfg, tcfg = _cfg()
    jp = japi.model_init(cfg, jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    assert np.array_equal(tp["vis_proj"].numpy(), np.asarray(jp["vis_proj"]))
    assert sorted(tp) == sorted(jp)
    bad = dict(jp, vis_proj=np.zeros((cfg.d_model, cfg.d_model + 1), np.float32))
    with pytest.raises(ValueError, match="vis_proj.*expected"):
        lm_params_from_jax(bad, tcfg, device="cpu")
    got = tapi.model_init(tcfg, seed=0, device="cpu")
    assert got["vis_proj"].shape == (cfg.d_model, cfg.d_model) and sorted(got) == sorted(jp)
