"""Encoder-decoder stack (SeamlessM4T-style speech-to-text backbone).

Port of ``repro.models.encdec``. The modality frontend (mel-spectrogram and
conformer feature extractor) is a stub, as in the reference: the encoder
consumes precomputed frame embeddings (B, n_frames, d_model).

Parameters keep the reference's tree: ``embed`` (vocab_padded, d),
``enc_layers`` (``ln1``, ``attn``, ``ln2``, ``mlp``, stacked over the
encoder's layers), ``layers`` (the decoder's ``ln1``, ``self_attn``,
``ln_x``, ``cross_attn``, ``ln2``, ``mlp``, stacked over its layers),
``enc_norm``, ``final_norm`` and ``lm_head`` (d, vocab_padded). A Python
loop over the layers takes the place of ``lax.scan``.

The encoder's self-attention is non-causal and ropes its frames at
positions 0..n_frames-1, as the reference's is. Each decoder layer attends
causally over its tokens, then to the encoder's output through its own
cross-attention keys and values (:func:`_cross_kv`, not roped): a prefill
computes them once and the :class:`~repro_torch.models.cache.EncDecCache`
keeps them for every decode step. Every attention call, the decode step's
single-query cross-attention included, goes through
:func:`repro_torch.models.layers.attention_fwd`, so on the card it is the
flash kernel; the decode step's self-attention against its cache is
:func:`~repro_torch.models.layers.attention_decode`, plain torch as in the
dense families.

Each layer's self-attention (the encoder's and the decoder's), its
cross-attention, its MLP and the logits run inside
``torch.profiler.record_function`` ranges ``lm.attention``,
``lm.cross_attention``, ``lm.mlp`` and ``lm.logits``.

:func:`encdec_loss` is the decoder's next-token cross entropy through
:func:`repro_torch.models.transformer.chunked_ce`; ``remat=True``
recomputes each decoder layer in the backward (the encoder is not
rematerialised, as in the reference).
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.models import layers as L
from repro_torch.models.cache import AttnCache, EncDecCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (chunked_ce, layer_params, logits_from_hidden,
                                            remat_call)


def init_encdec(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Random fp32 parameters drawn from ``gen`` (on ``device``, the
    generator's by default): the reference's shapes and scales, not its JAX
    draws."""
    device = gen.device if device is None else device
    d = cfg.d_model
    enc, dec = (cfg.encdec.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": L.dense_init(gen, (cfg.vocab_padded, d), scale=0.02, device=device),
        "enc_layers": {
            "ln1": L.init_rmsnorm(d, enc, device=device),
            "attn": L.init_attention(gen, cfg, enc, device=device),
            "ln2": L.init_rmsnorm(d, enc, device=device),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, enc, device=device),
        },
        "layers": {
            "ln1": L.init_rmsnorm(d, dec, device=device),
            "self_attn": L.init_attention(gen, cfg, dec, device=device),
            "ln_x": L.init_rmsnorm(d, dec, device=device),
            "cross_attn": L.init_attention(gen, cfg, dec, device=device),
            "ln2": L.init_rmsnorm(d, dec, device=device),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, dec, device=device),
        },
        "enc_norm": L.init_rmsnorm(d, device=device),
        "final_norm": L.init_rmsnorm(d, device=device),
        "lm_head": L.dense_init(gen, (d, cfg.vocab_padded), device=device),
    }


def encode(params, cfg: ModelConfig, frames: torch.Tensor, dtype=torch.float32):
    """Bidirectional encoder over precomputed frame embeddings (B, F, d) →
    (B, F, d) after ``enc_norm``."""
    x = frames.to(dtype)
    for i in range(cfg.encdec.n_enc_layers):
        lp = layer_params(params, i, "enc_layers")
        with record_function("lm.attention"):
            x = x + L.attention_fwd(lp["attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
                                    causal=False, dtype=dtype)
        with record_function("lm.mlp"):
            x = x + L.mlp_fwd(lp["mlp"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps), dtype)
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _cross_kv(lp, enc_out, cfg: ModelConfig, dtype):
    """A decoder layer's cross-attention keys and values of the encoder's
    output, (B, F, KV, dh) each, not roped."""
    ca = lp["cross_attn"]
    return (L._project(ca, enc_out, cfg, dtype, "k", cfg.n_kv_heads),
            L._project(ca, enc_out, cfg, dtype, "v", cfg.n_kv_heads))


def _cross_attention(lp, x, ckv, cfg: ModelConfig, dtype):
    with record_function("lm.cross_attention"):
        return L.attention_fwd(lp["cross_attn"], L.rmsnorm(lp["ln_x"], x, cfg.norm_eps), cfg,
                               kv_override=ckv, dtype=dtype, use_rope=False)


def _mlp(lp, x, cfg: ModelConfig, dtype):
    with record_function("lm.mlp"):
        return L.mlp_fwd(lp["mlp"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps), dtype)


def _decoder_layer(lp, x, enc_out, cfg: ModelConfig, dtype, return_kv: bool = False):
    """Self-attention, cross-attention to ``enc_out``, MLP → x, or (x,
    ((k, v), (cross_k, cross_v))) with ``return_kv`` (k roped)."""
    with record_function("lm.attention"):
        h = L.attention_fwd(lp["self_attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
                            dtype=dtype, return_kv=return_kv)
    if return_kv:
        h, kv = h
    x = x + h
    ckv = _cross_kv(lp, enc_out, cfg, dtype)
    x = x + _cross_attention(lp, x, ckv, cfg, dtype)
    x = x + _mlp(lp, x, cfg, dtype)
    if return_kv:
        return x, (kv, ckv)
    return x


def _decoder_hidden(params, cfg: ModelConfig, tokens, frames, dtype, remat: bool):
    enc_out = encode(params, cfg, frames, dtype)
    x = params["embed"].to(dtype)[tokens]
    for i in range(cfg.n_layers):
        x = remat_call(remat, params, lambda x, e, i=i: _decoder_layer(
            layer_params(params, i), x, e, cfg, dtype), x, enc_out)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward_encdec(params, cfg: ModelConfig, tokens: torch.Tensor, frames: torch.Tensor,
                   dtype=torch.float32, remat: bool = False):
    """Full-sequence decoder logits (B, S, vocab_padded)."""
    x = _decoder_hidden(params, cfg, tokens, frames, dtype, remat)
    return logits_from_hidden(params, cfg, x, dtype)


def encdec_loss(params, cfg: ModelConfig, tokens, frames, dtype=torch.float32,
                remat: bool = False, loss_weights=None, aux_coeff: float = 0.0,
                reduce: bool = True, logits_sharding=None):
    """The decoder's next-token cross entropy → (loss, aux = 0): the mean of
    the per-example losses (times ``loss_weights``), or with
    ``reduce=False`` the per-example vector (B,). An enc-dec model has no
    aux loss, so ``aux_coeff`` adds nothing."""
    del aux_coeff
    x = _decoder_hidden(params, cfg, tokens, frames, dtype, remat)
    per_example = chunked_ce(params, cfg, x, tokens, dtype, logits_sharding)
    if loss_weights is not None:
        per_example = per_example * loss_weights
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if not reduce:
        return per_example, zero
    return per_example.mean(), zero


def prefill_encdec(params, cfg: ModelConfig, tokens: torch.Tensor, frames: torch.Tensor,
                   dtype=torch.float32):
    """Encode the frames, run the decoder over the prompt, build the decode
    cache → (last-position logits (B, 1, vocab_padded), EncDecCache). The
    cache holds every decoder layer's roped k and v, (L, B, S, KV, dh), with
    ``pos = arange(S)``, and its cross keys and values, (L, B, F, KV, dh),
    all in ``dtype``."""
    enc_out = encode(params, cfg, frames, dtype)
    x = params["embed"].to(dtype)[tokens]
    b, s, _ = x.shape
    kv, dh, n = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    ks, vs = (torch.empty((n, b, s, kv, dh), dtype=x.dtype, device=x.device) for _ in range(2))
    cks, cvs = (torch.empty((n, b, enc_out.shape[1], kv, dh), dtype=x.dtype, device=x.device)
                for _ in range(2))
    for i in range(n):
        x, ((ks[i], vs[i]), (cks[i], cvs[i])) = _decoder_layer(
            layer_params(params, i), x, enc_out, cfg, dtype, return_kv=True)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache = EncDecCache(
        self_attn=AttnCache(k=ks, v=vs, pos=torch.arange(s, dtype=torch.int32, device=x.device)),
        cross_k=cks, cross_v=cvs)
    return logits_from_hidden(params, cfg, x[:, -1:, :], dtype), cache


def decode_step_encdec(params, cfg: ModelConfig, token: torch.Tensor, cache: EncDecCache,
                       t: int, dtype=torch.float32):
    """One serve step: consume one token (B, 1) at absolute position ``t``,
    write its k, v and position into slot ``t % S_max`` of every decoder
    layer's self-attention cache **in place**, attend to the cached cross
    keys and values (one query a call) → (logits (B, 1, vocab_padded),
    cache)."""
    x = params["embed"].to(dtype)[token]
    t = int(t)
    sa = cache.self_attn
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        with record_function("lm.attention"):
            h, _ = L.attention_decode(lp["self_attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps),
                                      cfg, sa.k[i], sa.v[i], sa.pos, t, dtype=dtype)
        x = x + h
        x = x + _cross_attention(lp, x, (cache.cross_k[i], cache.cross_v[i]), cfg, dtype)
        x = x + _mlp(lp, x, cfg, dtype)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x, dtype), cache
