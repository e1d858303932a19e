"""Decoder-only model stacks of the dense and SSM families.

Port of the dense and ssm branches of ``repro.models.transformer``.
Parameters keep the reference's tree: ``embed`` (vocab_padded, d),
``layers`` with every leaf stacked over the L layers
(``layers["attn"]["wq"]`` is (L, d, h·dh), ``layers["mamba"]["in_proj"]``
(L, d, 2·di + 2n + nh)), ``final_norm`` and, untied, ``lm_head`` (d,
vocab_padded). A dense layer is ``ln1``, ``attn``, ``ln2``, ``mlp``; an
ssm layer ``ln1`` and ``mamba`` (no MLP). A Python loop over the layers
takes the place of ``lax.scan``; layer ``i``'s parameters are views into
the stacked leaves.

Public entry points:
  init_model(cfg, gen, device)               -> params
  forward(params, cfg, tokens, ...)          -> (logits, aux)
  prefill(params, cfg, tokens, ...)          -> (logits, cache)
  decode_step(params, cfg, token, cache, t)  -> (logits, cache)

Each layer's attention, MLP, Mamba2 mixer and the logits run inside
``torch.profiler.record_function`` ranges ``lm.attention``, ``lm.mlp``,
``lm.mamba`` and ``lm.logits``. ``lm_loss`` and ``chunked_ce`` are
training and wait for ROADMAP queue A 14.6; other families raise naming
their item.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from repro_torch.models import layers as L
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import cumsum
from repro_torch.models.cache import AttnCache, SSMCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import check_ported

# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def init_model(cfg: ModelConfig, gen: torch.Generator, device=None) -> dict:
    """Random fp32 parameters drawn from ``gen`` (on ``device``, which must
    be the generator's device and is by default): the reference's shapes and
    scales, not its JAX draws."""
    check_ported(cfg)
    device = gen.device if device is None else device
    lead = (cfg.n_layers,)
    d = cfg.d_model
    embed = L.dense_init(gen, (cfg.vocab_padded, d), scale=0.02, device=device)
    if cfg.arch_type == "ssm":
        layers = {"ln1": L.init_rmsnorm(d, lead, device=device),
                  "mamba": L.init_mamba2(gen, cfg, lead, device=device)}
    else:
        layers = {
            "ln1": L.init_rmsnorm(d, lead, device=device),
            "attn": L.init_attention(gen, cfg, lead, device=device),
            "ln2": L.init_rmsnorm(d, lead, device=device),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, lead, device=device),
        }
    params = {
        "embed": embed,
        "layers": layers,
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
    if cfg.arch_type == "ssm":
        with record_function("lm.mamba"):
            return x + L.mamba2_fwd(lp["mamba"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
                                    dtype)
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
    """Token embedding (the dense and ssm families take no patch embeddings)."""
    check_ported(cfg)
    if embeds is not None:
        raise ValueError(f"the {cfg.arch_type} family takes tokens only")
    return params["embed"].to(dtype)[tokens]


def backbone(params, cfg: ModelConfig, x, dtype):
    """The layer stack. x: (B, S, D) -> (B, S, D), aux (0 for dense and ssm)."""
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

    A dense cache holds every layer's roped k and v, (L, B, S, KV, dh) in
    ``dtype``, with ``pos = arange(S)``; an ssm cache every layer's final
    state and conv window (:func:`_ssm_prefill`).
    """
    b, s = tokens.shape
    x = embed_inputs(params, cfg, tokens, embeds, dtype)
    if cfg.arch_type == "ssm":
        x, cache = _ssm_prefill(params, cfg, x, dtype)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return logits_from_hidden(params, cfg, x[:, -1:, :], dtype), cache
    kv_dims = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    ks = torch.empty(kv_dims, dtype=x.dtype, device=x.device)
    vs = torch.empty(kv_dims, dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        x, (k, v) = _layer_fwd(cfg, layer_params(params, i), x, dtype, return_kv=True)
        ks[i], vs[i] = k, v
    cache = AttnCache(k=ks, v=vs, pos=torch.arange(s, dtype=torch.int32, device=x.device))
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x[:, -1:, :], dtype), cache


def _mamba_layer_with_state(lp, x, cfg: ModelConfig, dtype):
    """Full-sequence Mamba2 layer (residual included) that also returns
    (ssm_state (B, H, N, P), conv_state (B, K-1, di+2n)).

    The scan runs in chunks of ``min(cfg.ssm.chunk_size, S)``, as in the
    reference, which therefore needs S ≤ chunk_size or a multiple of it
    (``ValueError`` otherwise). The final state is the reference's replay,
    ``Σ_t exp(La_S − La_t) B_t ⊗ xdt_t`` in ``dtype`` (``transformer.py:
    334-337``), not the kernel's carried fp32 state; the conv state is the
    last K-1 inputs of the conv.
    """
    s_cfg = cfg.ssm
    di, nh, n = s_cfg.d_inner(cfg.d_model), s_cfg.n_heads(cfg.d_model), s_cfg.d_state
    mp = lp["mamba"]
    h_in = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    z, xbc, dt = L._split_mamba_proj(h_in @ mp["in_proj"].to(dtype), di, n, nh)
    conv_state = xbc[:, -(s_cfg.conv_kernel - 1):, :]
    xh, xdt, la, B, C = L.mamba_inputs(mp, xbc, dt, cfg, dtype)

    y = ssd(xdt, la, B, C, chunk=min(s_cfg.chunk_size, x.shape[1]))

    La = cumsum(la, dim=1)  # (B, S, H), in the reference's order
    seg = torch.exp(La[:, -1:, :] - La)  # decay from t to the sequence's end
    final_state = torch.einsum("bsh,bsn,bshp->bhnp", seg.to(dtype), B, xdt)
    return x + L.mamba_out(mp, y, xh, z, cfg, dtype), final_state, conv_state


def _ssm_prefill(params, cfg: ModelConfig, x, dtype):
    """Every layer through :func:`_mamba_layer_with_state`: → (x, SSMCache)
    with the states stacked over the layers in x's type."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    nh, n, k = s_cfg.n_heads(d), s_cfg.d_state, s_cfg.conv_kernel
    states = torch.empty((cfg.n_layers, b, nh, n, s_cfg.head_dim), dtype=x.dtype,
                         device=x.device)
    convs = torch.empty((cfg.n_layers, b, min(k - 1, s), s_cfg.d_inner(d) + 2 * n),
                        dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        with record_function("lm.mamba"):
            x, states[i], convs[i] = _mamba_layer_with_state(layer_params(params, i), x, cfg,
                                                             dtype)
    return x, SSMCache(state=states, conv=convs)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache, t: int,
                dtype=torch.float32):
    """One serve step: consume one token (B, 1) at absolute position ``t``,
    update ``cache`` **in place** and return (logits (B, 1, vocab_padded),
    cache). A dense step writes the token's k, v and position into slot
    ``t % S_max`` (the first layer writes the position every layer then
    reads); an ssm step overwrites each layer's state and conv window."""
    check_ported(cfg)
    x = params["embed"].to(dtype)[token]
    if cfg.arch_type == "ssm":
        return _ssm_decode(params, cfg, x, cache, dtype)
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


def _ssm_decode(params, cfg: ModelConfig, x, cache: SSMCache, dtype):
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        with record_function("lm.mamba"):
            h, st, cv = L.mamba2_decode(lp["mamba"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
                                        cache.state[i], cache.conv[i], dtype)
            cache.state[i].copy_(st)
            cache.conv[i].copy_(cv)
        x = x + h
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x, dtype), cache
