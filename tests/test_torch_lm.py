"""The port's dense LM serving path held against the live reference on the CPU.

Inputs come from numpy with a seed; weights from the reference's
``model_init`` (or ``init_attention``/``init_mlp``), carried over by
``repro_torch.convert.lm_params_from_jax``, with the zero biases and unit
norm scales of a fresh init replaced by seeded numpy values so that they
count. Every comparison is fp32 within 1e-5 relative to the reference's
scale (``_torch_parity``) unless it says otherwise; greedy tokens match
exactly, and at every step the reference's top-2 logit margin is asserted
to exceed that tolerance, so the greedy choice is well defined.

The flash kernel's plain version is held to the reference's Pallas kernel in
interpret mode on the cases of ``tests/test_kernels.py`` (every row of the
output); the CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
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
from repro.kernels.attention.kernel import flash_attention as jax_flash
from repro.kernels.attention.ref import mha_ref as jax_mha_ref
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import cache as jcache
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.kernels.attention import kernel as tkernel
from repro_torch.kernels.attention import ops as tops
from repro_torch.kernels.attention.ref import flash_attention_ref, mha_ref
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.models import cache as tcache
from repro_torch.models import encdec as tencdec
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.models.config import INPUT_SHAPES, InputShape

# --------------------------------------------------------------------------
# the flash kernel's plain version and mha_ref
# --------------------------------------------------------------------------

# (b, sq, sk, h, kv, dh, block_q, block_k, causal, window, q_offset): the
# cases of tests/test_kernels.py (causal MHA, GQA 4:1, MQA with one q block;
# windows 16, 32, 100; non-causal sq < sk; a q_offset tail), and rows that
# see no key (a negative offset puts the first 32 rows before key 0)
FLASH_CASES = {
    "mha_causal": (2, 64, 64, 4, 4, 32, 16, 16, True, None, 0),
    "gqa_4_1": (1, 128, 128, 8, 2, 64, 32, 32, True, None, 0),
    "mqa_one_q_block": (2, 64, 64, 4, 1, 32, 64, 16, True, None, 0),
    "window_16": (1, 128, 128, 4, 2, 32, 32, 32, True, 16, 0),
    "window_32": (1, 128, 128, 4, 2, 32, 32, 32, True, 32, 0),
    "window_100": (1, 128, 128, 4, 2, 32, 32, 32, True, 100, 0),
    "non_causal": (2, 32, 64, 2, 2, 32, 32, 32, False, None, 0),
    "q_offset_tail": (1, 32, 128, 2, 2, 32, 32, 32, True, None, 96),
    "rows_see_no_key": (1, 64, 64, 4, 2, 32, 32, 32, True, None, -32),
}
# Both keep fp32 inside and round the output to bf16 once, so in bf16 they
# differ by at most one unit in the last place, 2^-7·|want|, element by element.
BF16_RTOL, BF16_ATOL = 2.0**-7, 1e-5


def _qkv(b, sq, sk, h, kv, dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, dh)).astype(dtype),
            rng.standard_normal((b, sk, kv, dh)).astype(dtype),
            rng.standard_normal((b, sk, kv, dh)).astype(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_plain_version_matches_pallas_kernel(case, dtype):
    b, sq, sk, h, kv, dh, bq, bk, causal, window, offset = FLASH_CASES[case]
    q, k, v = _qkv(b, sq, sk, h, kv, dh, seed=len(case))
    kw = dict(causal=causal, sliding_window=window, q_offset=offset)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want = jax_flash(*(jnp.asarray(x, jdt) for x in (q, k, v)), block_q=bq, block_k=bk,
                     interpret=True, **kw)
    got = flash_attention_ref(*(torch.tensor(x).to(tdt) for x in (q, k, v)), **kw)
    assert got.dtype == tdt and got.shape == (b, sq, h, dh)
    assert torch.isfinite(got).all()
    if dtype == "float32":
        assert_close(got, want)
    else:
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=BF16_RTOL, atol=BF16_ATOL)
    if offset < 0:  # both give exactly 0 on the rows that see no key
        assert not got[:, :-offset].any() and not np.asarray(want)[:, :-offset].any()


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_mha_ref_matches_reference_on_rows_that_see_a_key(case):
    b, sq, sk, h, kv, dh, _, _, causal, window, offset = FLASH_CASES[case]
    q, k, v = _qkv(b, sq, sk, h, kv, dh, seed=len(case) + 1)
    kw = dict(causal=causal, sliding_window=window, q_offset=offset)
    want = np.asarray(jax_mha_ref(*(jnp.asarray(x) for x in (q, k, v)), **kw))
    got = mha_ref(*(torch.tensor(x) for x in (q, k, v)), **kw)
    seen = max(0, -offset)  # rows before it see no key: NaN on both sides
    assert np.isnan(want[:, :seen]).all() and torch.isnan(got[:, :seen]).all()
    assert_close(got[:, seen:], want[:, seen:])
    # on those rows the kernel's plain version is the same function
    assert_close(flash_attention_ref(*(torch.tensor(x) for x in (q, k, v)), **kw)[:, seen:],
                 want[:, seen:])


def test_cpu_tensors_dispatch_to_plain_version():
    q, k, v = (torch.tensor(x) for x in _qkv(1, 40, 40, 4, 2, 16, seed=3))
    before = tkernel.launches
    got = tops.attention(q, k, v, causal=True, sliding_window=8)
    assert torch.equal(got, flash_attention_ref(q, k, v, causal=True, sliding_window=8))
    assert tkernel.launches == before  # the plain version launches nothing


def test_kernel_wrapper_refuses_cpu_tensors_and_building_waits_for_a_call():
    q, k, v = (torch.tensor(x) for x in _qkv(1, 8, 8, 2, 2, 16, seed=4))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.flash_attention(q, k, v)
    assert tkernel.build.cache_info().currsize == 0


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def _cfg(layers=3, **kw):
    """reduced_config("qwen2-0.5b") with ``layers`` layers, on both sides."""
    return tuple(dataclasses.replace(c.reduced_config("qwen2-0.5b"), n_layers=layers, **kw)
                 for c in (jconfigs, tconfigs))


def _perturbed(tree, seed):
    """The tree with every bias and norm scale set to seeded numpy values
    (a fresh init has zeros and ones there, which would test nothing)."""
    rng = np.random.default_rng(seed)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if key in ("bq", "bk", "bv"):
            return rng.standard_normal(a.shape).astype(np.float32) * 0.1
        if key == "scale":
            return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return walk(tree)


@pytest.mark.parametrize("offset,causal,window", [(0, True, None), (5, True, 3),
                                                  (-2, True, None), (0, False, 4)])
def test_attention_scores_mask_matches_reference(offset, causal, window):
    got = tlayers.attention_scores_mask(6, 9, offset, causal, window)
    want = jlayers.attention_scores_mask(6, 9, offset, causal, window)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    assert_close(tlayers.rmsnorm({"scale": t(scale)}, t(x), 1e-6),
                 jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6))
    pos = np.arange(5)[None, :] + np.array([[0], [2040]])
    for theta in (10000.0, 1e6):
        assert_close(tlayers.apply_rope(t(x), t(pos), theta),
                     jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("window", [None, 5])
def test_attention_fwd_and_mlp_match_reference(window):
    cfg, tcfg = _cfg(sliding_window=window)
    jp = _perturbed({"attn": jlayers.init_attention(jax.random.PRNGKey(1), cfg),
                     "mlp": jlayers.init_mlp(jax.random.PRNGKey(2), cfg.d_model, cfg.d_ff)}, 3)
    tp = params_from_jax(jp, device="cpu")
    x = np.random.default_rng(4).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    want, (wk, wv) = jlayers.attention_fwd(jp["attn"], jnp.asarray(x), cfg, return_kv=True)
    got, (gk, gv) = tlayers.attention_fwd(tp["attn"], t(x), tcfg, return_kv=True)
    assert_close(got, want)
    assert_close(gk, wk)
    assert_close(gv, wv)
    assert_close(tlayers.mlp_fwd(tp["mlp"], t(x)), jlayers.mlp_fwd(jp["mlp"], jnp.asarray(x)))


@pytest.mark.parametrize("t_new,window", [(5, None), (11, None), (11, 4)])
def test_attention_decode_matches_reference(t_new, window):
    """A cache of 8 slots: t=5 writes slot 5 of a half-filled cache; t=11
    wraps to slot 3 of a full ring (positions 4..11), with and without a
    window."""
    cfg, tcfg = _cfg(sliding_window=window)
    jp = _perturbed(jlayers.init_attention(jax.random.PRNGKey(5), cfg), 6)
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(t_new)
    s_max, kv, dh = 8, cfg.n_kv_heads, cfg.head_dim
    ck = rng.standard_normal((2, s_max, kv, dh)).astype(np.float32)
    cv = rng.standard_normal((2, s_max, kv, dh)).astype(np.float32)
    if t_new < s_max:
        pos = np.where(np.arange(s_max) < t_new, np.arange(s_max), -1).astype(np.int32)
    else:  # slot s holds the latest position ≡ s (mod 8) before t_new
        pos = np.array([p if p < t_new else p - s_max for p in range(8, 16)], np.int32)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    want, (wk, wv, wpos) = jlayers.attention_decode(
        jp, jnp.asarray(x), cfg, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos),
        jnp.asarray(t_new, jnp.int32))
    got, (gk, gv, gpos) = tlayers.attention_decode(tp, t(x), tcfg, t(ck), t(cv),
                                                   t(pos), t_new)
    assert_close(got, want)
    assert_close(gk, wk)
    assert_close(gv, wv)
    assert np.array_equal(gpos.numpy(), np.asarray(wpos))


# --------------------------------------------------------------------------
# the model: forward, prefill, decode
# --------------------------------------------------------------------------


def _model(cfg, tcfg, seed=0):
    jp = _perturbed(japi.model_init(cfg, jax.random.PRNGKey(seed)), seed + 100)
    return jax.tree.map(jnp.asarray, jp), lm_params_from_jax(jp, tcfg, device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _assert_margin(logits):
    """The reference's top-2 margin exceeds the tolerance in every row."""
    top2 = np.sort(np.asarray(logits, np.float64), axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    assert margin.min() > RTOL * np.abs(top2).max(), margin.min()
    return margin.min()


def _prefill_and_decode(cfg, tcfg, b, s, steps, seed):
    jp, tp = _model(cfg, tcfg, seed)
    toks = _tokens(cfg, b, s, seed + 1)
    want_logits, _ = jtransformer.forward(jp, cfg, jnp.asarray(toks))
    got_logits, aux = ttransformer.forward(tp, tcfg, t(toks, torch.int64))
    assert_close(got_logits, want_logits)
    assert float(aux) == 0.0

    wl, wcache = jtransformer.prefill(jp, cfg, jnp.asarray(toks))
    gl, gcache = ttransformer.prefill(tp, tcfg, t(toks, torch.int64))
    assert_close(gl, wl)
    for got, want in zip(gcache, wcache):
        assert_close(got, want)
    wcache = jcache.pad_cache(wcache, s + steps)
    gcache = tcache.pad_cache(gcache, s + steps)
    wtok = jnp.argmax(wl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    gtok = gl[:, -1].argmax(dim=-1, keepdim=True)
    margins = [_assert_margin(wl[:, -1])]
    for i in range(steps):
        assert np.array_equal(gtok.numpy(), np.asarray(wtok))
        wl, wcache = jtransformer.decode_step(jp, cfg, wtok, wcache, jnp.asarray(s + i))
        gl, gcache = ttransformer.decode_step(tp, tcfg, gtok, gcache, s + i)
        assert_close(gl, wl)
        margins.append(_assert_margin(wl[:, -1]))
        wtok = jnp.argmax(wl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        gtok = gl[:, -1].argmax(dim=-1, keepdim=True)
    assert np.array_equal(gtok.numpy(), np.asarray(wtok))
    for got, want in zip(gcache, wcache):
        assert_close(got, want)
    return margins


def test_forward_prefill_and_six_decode_steps_match_reference():
    """reduced_config("qwen2-0.5b") with 3 layers: GQA 2:1, QKV bias, tied
    embeddings, vocab 512 (pad columns none: 512 is a multiple of 256)."""
    cfg, tcfg = _cfg(layers=3)
    _prefill_and_decode(cfg, tcfg, b=2, s=9, steps=6, seed=0)


def test_padded_vocab_logits_match_reference():
    """A vocab off the 256 grid (500 → 512): pad columns are -1e30 on both
    sides and never win the argmax."""
    cfg, tcfg = _cfg(layers=2, vocab_size=500)
    jp, tp = _model(cfg, tcfg, seed=7)
    toks = _tokens(cfg, 2, 6, 8)
    got, _ = ttransformer.forward(tp, tcfg, t(toks, torch.int64))
    want, _ = jtransformer.forward(jp, cfg, jnp.asarray(toks))
    assert_close(got, want)
    assert (got[..., 500:] == -1e30).all() and int(got.argmax(-1).max()) < 500


def test_one_layer_at_full_width_matches_reference():
    """qwen2-0.5b's widths (d 896, 14 query / 2 kv heads of 64, d_ff 4,864,
    QKV bias, tied embeddings, rope θ 1e6) with one layer and the vocab cut
    to 512, so the reference's CPU init and the test stay small."""
    cfg, tcfg = (dataclasses.replace(c.get_config("qwen2-0.5b"), n_layers=1, vocab_size=512)
                 for c in (jconfigs, tconfigs))
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff) == (
        896, 14, 2, 64, 4864)
    _prefill_and_decode(cfg, tcfg, b=2, s=16, steps=2, seed=11)


# --------------------------------------------------------------------------
# serving: serve_demo (unpadded-cache quirk included) and the padded path
# --------------------------------------------------------------------------


def _auto_mesh():
    """A one-device mesh with Auto axes: the reference's serve step gathers
    the embedding under it (its default mesh's Explicit axes refuse that
    gather on this jax)."""
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


@pytest.fixture
def reference_weights(monkeypatch):
    """The port's ``model_init`` replaced by the reference's draws, so that
    both ``serve_demo``s serve the same weights."""
    def init(cfg, seed=0, device=None):
        return lm_params_from_jax(japi.model_init(cfg, jax.random.PRNGKey(seed)), cfg, device)
    monkeypatch.setattr(tapi, "model_init", init)


def test_serve_demo_matches_reference_unpadded_cache_quirk_included(reference_weights):
    """Both decode from the unpadded prefill cache: from the first new token
    on, slot t % S overwrites the oldest prompt slot."""
    cfg, tcfg = _cfg(layers=2)
    toks = _tokens(cfg, 2, 8, 21)
    want, _ = jserve.serve_demo(cfg, _auto_mesh(), {"tokens": jnp.asarray(toks)}, n_tokens=6,
                                dtype=jnp.float32, seed=3)
    got, stats = tserve.serve_demo(tcfg, {"tokens": t(toks, torch.int64)}, n_tokens=6,
                                   dtype=torch.float32, seed=3, device="cpu")
    assert got.shape == (2, 6) and np.array_equal(got.numpy(), np.asarray(want))
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


def test_server_decode_matches_reference_on_both_caches():
    """The padded path of ``examples/serve_decode.py`` and the unpadded one
    of ``serve_demo``: the same tokens and caches as the reference's
    ``Server.decode``; the unpadded ring has overwritten prompt slots, the
    padded cache keeps every position."""
    cfg, tcfg = _cfg(layers=2)
    jp, tp = _model(cfg, tcfg, seed=5)
    s, n = 8, 6
    toks = _tokens(cfg, 2, s, 22)
    shape = InputShape("serve", seq_len=s + n, global_batch=2, kind="decode")
    jsrv = jserve.Server(cfg, shape, _auto_mesh(), dtype=jnp.float32)
    tsrv = tserve.Server(tcfg, shape, "cpu", dtype=torch.float32)
    wl, wcache0 = japi.model_prefill(jp, cfg, {"tokens": jnp.asarray(toks)}, jnp.float32)
    first, gl, gcache0 = tsrv.prefill(tp, {"tokens": t(toks, torch.int64)})
    assert_close(gl, wl)
    assert np.array_equal(first.numpy(), np.asarray(jnp.argmax(wl[:, -1], -1)[:, None]))
    wfirst = jnp.asarray(first.numpy(), jnp.int32)
    for padded in (True, False):
        wc = jcache.pad_cache(wcache0, s + n) if padded else wcache0
        gc = tcache.pad_cache(gcache0, s + n) if padded else tcache.AttnCache(
            *(x.clone() for x in gcache0))
        want, wcache = jsrv.decode(jsrv.load_params(jp), wfirst, wc, start_t=s, n_tokens=n)
        got, gcache = tsrv.decode(tsrv.load_params(tp), first, gc, start_t=s, n_tokens=n)
        assert np.array_equal(got.numpy(), np.asarray(want)), padded
        for a, b in zip(gcache, wcache):
            assert_close(a, b)
        expect = (np.r_[np.arange(s + n - 1), -1] if padded
                  else np.r_[np.arange(s, s + n - 1), np.arange(n - 1, s)])
        assert np.array_equal(gcache.pos.numpy(), expect), (padded, gcache.pos)


def test_server_casts_params_once_and_checks_its_capacity():
    cfg, tcfg = _cfg(layers=1)
    _, tp = _model(cfg, tcfg, seed=9)
    srv = tserve.Server(tcfg, InputShape("s", seq_len=10, global_batch=2, kind="decode"),
                        "cpu", dtype=torch.bfloat16)
    cast = srv.load_params(tp)
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["layers"]["attn"]["wq"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="beyond the server's shape"):
        srv.prefill(cast, {"tokens": torch.zeros((3, 4), dtype=torch.int64)})
    with pytest.raises(ValueError, match="beyond the server's shape"):
        srv.decode(cast, torch.zeros((2, 1), dtype=torch.int64),
                   tcache.init_cache(tcfg, 2, 10, torch.bfloat16, "cpu"),
                   start_t=8, n_tokens=4)


# --------------------------------------------------------------------------
# configs, conversion and what is not ported
# --------------------------------------------------------------------------


def _fields(cfg):
    return dataclasses.asdict(cfg), cfg.head_dim, cfg.vocab_padded, cfg.param_count()


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_reference_field_by_field(arch):
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert _fields(tconfigs.get_config(arch)) == _fields(jconfigs.get_config(arch))
    assert _fields(tconfigs.reduced_config(arch)) == _fields(jconfigs.reduced_config(arch))
    for name in INPUT_SHAPES:
        assert tconfigs.supports_shape(arch, name) == jconfigs.supports_shape(arch, name)
        if arch in jconfigs.LONG_CONTEXT_SKIP and name == "long_500k":
            with pytest.raises(ValueError):
                jconfigs.get_config(arch, name)
            with pytest.raises(ValueError):
                tconfigs.get_config(arch, name)
            continue
        assert _fields(tconfigs.get_config(arch, name)) == _fields(
            jconfigs.get_config(arch, name))
    assert tconfigs.get_config("qwen2-0.5b", "long_500k").sliding_window == 8192


def test_lm_entry_points_need_a_card_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.reduced_config("qwen2-0.5b")
    shape = InputShape("s", seq_len=10, global_batch=2, kind="decode")
    tokens = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.model_init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.init_cache(cfg, 2, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.Server(cfg, shape)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve_demo(cfg, {"tokens": tokens}, n_tokens=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_jax(japi.model_init(jconfigs.reduced_config("qwen2-0.5b"),
                                           jax.random.PRNGKey(0)), cfg)
    # the generator's device is the parameters' device
    params = ttransformer.init_model(cfg, torch.Generator().manual_seed(0))
    assert params["embed"].device.type == "cpu"


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-76b"])
def test_encdec_and_vlm_families_init_cache_and_serve(arch):
    """The families of ROADMAP A14.5 (their parity with the reference:
    ``tests/test_torch_encdec.py``, ``tests/test_torch_vlm.py``):
    ``model_init``, ``init_cache``, ``Server`` and ``serve_demo`` on the CPU,
    with the frames or patches the family takes."""
    cfg = tconfigs.reduced_config(arch)
    params = tapi.model_init(cfg, device="cpu")
    assert ("enc_layers" in params) == (cfg.arch_type == "encdec")
    assert ("vis_proj" in params) == (cfg.arch_type == "vlm")
    cache = tcache.init_cache(cfg, 1, 4, device="cpu")
    assert isinstance(cache, tcache.EncDecCache if cfg.arch_type == "encdec"
                      else tcache.AttnCache)
    tserve.Server(cfg, INPUT_SHAPES["decode_32k"], "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(_tokens(cfg, 2, 16, 0), dtype=torch.int64)}
    n, key = ((cfg.encdec.n_enc_frames, "frames") if cfg.arch_type == "encdec"
              else (cfg.vlm.n_patches, "embeds"))
    batch[key] = torch.tensor(rng.standard_normal((2, n, cfg.d_model)), dtype=torch.float32)
    toks, _ = tserve.serve_demo(cfg, batch, n_tokens=3, device="cpu")
    assert toks.shape == (2, 3) and int(toks.max()) < cfg.vocab_size


def test_check_ported_refuses_an_unknown_family():
    cfg = dataclasses.replace(tconfigs.reduced_config("qwen2-0.5b"), arch_type="rnn")
    with pytest.raises(ValueError, match="unknown arch_type"):
        tapi.model_init(cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown arch_type"):
        tserve.Server(cfg, INPUT_SHAPES["decode_32k"], "cpu")


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "olmoe-1b-7b", "llama4-scout-17b-a16e"])
def test_hybrid_and_moe_families_init_cache_and_serve(arch):
    """The families of ROADMAP A14.3 and A14.4 (their parity with the
    reference: ``tests/test_torch_hybrid.py``, ``tests/test_torch_moe.py``):
    ``model_init``, ``init_cache``, ``Server`` and ``serve_demo`` on the CPU."""
    cfg = tconfigs.reduced_config(arch)
    params = tapi.model_init(cfg, device="cpu")
    assert ("shared_block" in params) == (cfg.arch_type == "hybrid")
    cache = tcache.init_cache(cfg, 1, 4, device="cpu")
    assert isinstance(cache, tcache.HybridCache if cfg.arch_type == "hybrid"
                      else tcache.AttnCache)
    tserve.Server(cfg, INPUT_SHAPES["decode_32k"], "cpu")
    tokens = torch.tensor(_tokens(cfg, 2, 16, 0), dtype=torch.int64)
    toks, _ = tserve.serve_demo(cfg, {"tokens": tokens}, n_tokens=3, device="cpu")
    assert toks.shape == (2, 3) and int(toks.max()) < cfg.vocab_size


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "seamless-m4t-large-v2"])
def test_training_entry_points_run_and_match_reference(arch):
    """``model_loss`` and the family's own loss (``lm_loss``,
    ``encdec_loss``) on the reference's weights and tokens: one value, the
    reference's (gradients: ``tests/test_torch_train_loss.py``)."""
    from _torch_parity import torch_batch, train_case

    jcfg, tcfg, jp, batch = train_case(arch)
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    tb = torch_batch(batch)
    want, _ = japi.model_loss(jax.tree.map(jnp.asarray, jp), jcfg,
                              {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = tapi.model_loss(tp, tcfg, tb)
    if tcfg.arch_type == "encdec":
        own, own_aux = tencdec.encdec_loss(tp, tcfg, tb["tokens"], tb["frames"])
    else:
        own, own_aux = ttransformer.lm_loss(tp, tcfg, tb["tokens"])
    assert torch.equal(got, own) and torch.equal(aux, own_aux)
    assert_close(got, want)


def test_lm_params_from_jax_keeps_the_layout_and_checks_shapes():
    cfg, tcfg = _cfg(layers=2)
    jp = japi.model_init(cfg, jax.random.PRNGKey(0))
    tp = lm_params_from_jax(jp, tcfg, device="cpu")
    assert tp["layers"]["attn"]["wq"].shape == (2, cfg.d_model, cfg.n_heads * cfg.head_dim)
    assert "lm_head" not in tp  # tied embeddings
    other = dataclasses.replace(tcfg, n_layers=3)
    with pytest.raises(ValueError, match="expected"):
        lm_params_from_jax(jp, other, device="cpu")


def test_port_init_model_has_the_reference_shapes():
    cfg, tcfg = _cfg(layers=2)
    want = japi.model_init(cfg, jax.random.PRNGKey(0))
    got = tapi.model_init(tcfg, seed=0, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32, path
