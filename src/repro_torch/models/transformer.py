"""Decoder-only model stack of the dense family.

Port of the dense branches of ``repro.models.transformer``. Parameters keep
the reference's tree: ``embed`` (vocab_padded, d), ``layers`` with every
leaf stacked over the L layers (``layers["attn"]["wq"]`` is (L, d, h·dh)),
``final_norm`` and, untied, ``lm_head`` (d, vocab_padded). A Python loop
over the layers takes the place of ``lax.scan``; layer ``i``'s parameters
are views into the stacked leaves.

Public entry points:
  init_model(cfg, gen, device)               -> params
  forward(params, cfg, tokens, ...)          -> (logits, aux)
  prefill(params, cfg, tokens, ...)          -> (logits, cache)
  decode_step(params, cfg, token, cache, t)  -> (logits, cache)

Each layer's attention, MLP and the logits run inside
``torch.profiler.record_function`` ranges ``lm.attention``, ``lm.mlp`` and
``lm.logits``. ``lm_loss`` and ``chunked_ce`` are training and wait for
ROADMAP queue A 14.6; other families raise naming their item.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.models import layers as L
from repro_torch.models.cache import AttnCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import check_dense

# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def init_model(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Random fp32 parameters drawn from ``gen`` (on ``device``, which must
    be the generator's device and is by default): the reference's shapes and
    scales, not its JAX draws."""
    check_dense(cfg)
    device = gen.device if device is None else device
    lead = (cfg.n_layers,)
    d = cfg.d_model
    params = {
        "embed": L.dense_init(gen, (cfg.vocab_padded, d), scale=0.02, device=device),
        "layers": {
            "ln1": L.init_rmsnorm(d, lead, device=device),
            "attn": L.init_attention(gen, cfg, lead, device=device),
            "ln2": L.init_rmsnorm(d, lead, device=device),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, lead, device=device),
        },
        "final_norm": L.init_rmsnorm(d, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (d, cfg.vocab_padded), device=device)
    return params


def layer_params(params, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    def pick(node):
        return {k: pick(v) for k, v in node.items()} if isinstance(node, dict) else node[i]
    return pick(params["layers"])


# --------------------------------------------------------------------------
# full-sequence forward (prefill)
# --------------------------------------------------------------------------


def _layer_fwd(cfg: ModelConfig, lp, x, dtype, return_kv: bool = False):
    with record_function("lm.attention"):
        h = L.attention_fwd(lp["attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
                            dtype=dtype, return_kv=return_kv)
    if return_kv:
        h, kv = h
    x = x + h
    with record_function("lm.mlp"):
        x = x + L.mlp_fwd(lp["mlp"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps), dtype)
    return (x, kv) if return_kv else x


def embed_inputs(params, cfg: ModelConfig, tokens, embeds, dtype):
    """Token embedding (the dense family takes no patch embeddings)."""
    check_dense(cfg)
    if embeds is not None:
        raise ValueError("the dense family takes tokens only")
    return params["embed"].to(dtype)[tokens]


def backbone(params, cfg: ModelConfig, x, dtype):
    """The layer stack. x: (B, S, D) -> (B, S, D), aux (0 for dense)."""
    for i in range(cfg.n_layers):
        x = _layer_fwd(cfg, layer_params(params, i), x, dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def logits_from_hidden(params, cfg: ModelConfig, x, dtype):
    """x @ head; the tied head is ``embed.T``; pad columns are -1e30."""
    with record_function("lm.logits"):
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = x @ head.to(dtype)
        if cfg.vocab_padded != cfg.vocab_size:
            logits[..., cfg.vocab_size:].fill_(L.NEG_INF)
        return logits


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None, dtype=torch.float32):
    """Full-sequence logits (B, S, vocab_padded) and aux."""
    x = embed_inputs(params, cfg, tokens, embeds, dtype)
    x, aux = backbone(params, cfg, x, dtype)
    return logits_from_hidden(params, cfg, x, dtype), aux


def lm_loss(*args, **kwargs):
    raise NotImplementedError(
        "lm_loss is training: ROADMAP queue A 14.6 (LM PO-FL training)")


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None, dtype=torch.float32):
    """Run the full prompt, build the decode cache, return last-pos logits.

    The cache holds every layer's roped k and v, (L, B, S, KV, dh) in
    ``dtype``, with ``pos = arange(S)``.
    """
    b, s = tokens.shape
    x = embed_inputs(params, cfg, tokens, embeds, dtype)
    kv_dims = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    ks = torch.empty(kv_dims, dtype=x.dtype, device=x.device)
    vs = torch.empty(kv_dims, dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        x, (k, v) = _layer_fwd(cfg, layer_params(params, i), x, dtype, return_kv=True)
        ks[i], vs[i] = k, v
    cache = AttnCache(k=ks, v=vs, pos=torch.arange(s, dtype=torch.int32, device=x.device))
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x[:, -1:, :], dtype), cache


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache: AttnCache, t: int,
                dtype=torch.float32):
    """One serve step: consume one token (B, 1) at absolute position ``t``,
    write its k, v and position into slot ``t % S_max`` of ``cache`` **in
    place** (the first layer writes the position every layer then reads),
    and return (logits (B, 1, vocab_padded), cache)."""
    check_dense(cfg)
    x = params["embed"].to(dtype)[token]
    t = int(t)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        with record_function("lm.attention"):
            h, _ = L.attention_decode(lp["attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
                                      cache.k[i], cache.v[i], cache.pos, t, dtype=dtype)
        x = x + h
        with record_function("lm.mlp"):
            x = x + L.mlp_fwd(lp["mlp"], L.rmsnorm(lp["ln2"], x, cfg.norm_eps), dtype)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x, dtype), cache
