"""Decoder-only model stacks: the dense, moe, ssm, hybrid and vlm families.

Port of ``repro.models.transformer``. Parameters keep
the reference's tree: ``embed`` (vocab_padded, d), ``layers`` with every
leaf stacked over the L layers (``layers["attn"]["wq"]`` is (L, d, h·dh),
``layers["moe"]["w_gate"]`` (L, E, d, f), ``layers["mamba"]["in_proj"]``
(L, d, 2·di + 2n + nh)), ``final_norm``, untied ``lm_head`` (d,
vocab_padded), in a hybrid one unstacked ``shared_block`` and in a vlm
``vis_proj`` (d, d). A dense or vlm layer is ``ln1``, ``attn``, ``ln2``,
``mlp``; a moe layer has ``moe`` in
place of ``mlp``; an ssm or hybrid layer is ``ln1`` and ``mamba`` (no MLP).
The hybrid (Zamba2) runs its shared block, ``ln1``, ``attn``, ``ln2`` and
``mlp`` with one set of weights, before every layer whose index is a
multiple of ``hybrid.attn_every``. A vlm is a dense stack whose sequence
starts with the patch embeddings projected by ``vis_proj``
(:func:`embed_inputs`): they take positions 0..n_patches-1 of the
attention and the cache, and ``forward`` drops them from its logits. A
Python loop over the layers takes the
place of ``lax.scan`` (and a Python ``if`` on the index the place of the
hybrid's ``lax.cond``); layer ``i``'s parameters are views into the
stacked leaves.

Public entry points:
  init_model(cfg, gen, device)               -> params
  forward(params, cfg, tokens, ...)          -> (logits, aux)   (train / prefill)
  lm_loss(params, cfg, tokens, ...)          -> (loss, aux)
  prefill(params, cfg, tokens, ...)          -> (logits, cache)
  decode_step(params, cfg, token, cache, t)  -> (logits, cache)

Over the model ranks of a mesh (a ``layers.ModelGroup``) a dense or SSM
model's loss, prefill and decode step run tensor-parallel on the rank's TP
blocks: the embedding looks up the rank's vocabulary block
(``layers.embed_lookup``), each layer's attention and MLP compute the
rank's heads and columns, each Mamba2 mixer its SSM heads
(``layers.mamba2_fwd``), and the logits are the rank's vocabulary block
(:func:`logits_from_hidden`), which the loss keeps split (:func:`chunked_ce`). The group's collectives
carry their backward and tangent rules (``layers.copy_to_group`` and its
kin), so :func:`lm_loss` over a group trains and takes ``torch.func.jvp``.
Over the data ranks (a ``layers.DataGroup``, the ``data`` keyword) each
rank holds its rows of the batch, and a MoE layer routes them in the whole
batch's routing groups with the batch's load-balance loss
(``layers.moe_fwd``); every other layer is row-wise and ignores it.

Each layer's attention, MLP, MoE, Mamba2 mixer and the logits run inside
``torch.profiler.record_function`` ranges ``lm.attention``, ``lm.mlp``,
``lm.moe``, ``lm.mamba`` and ``lm.logits`` (the shared block's attention
and MLP in ``lm.attention`` and ``lm.mlp``). The enc-dec family is
``repro_torch.models.encdec``.

Training (:func:`lm_loss`) differentiates through all of it with
``torch.autograd`` (``loss.backward()`` or ``torch.autograd.grad``) and
``torch.func.jvp``; the kernels' own ``autograd.Function`` s give the flash
and SSD kernels their backward and tangent rules. ``remat=True`` recomputes
each layer in the backward (``torch.utils.checkpoint``, non-reentrant, as
the reference's ``jax.checkpoint`` of the scan body): the values are the
same, only the memory a backward holds differs. ``torch.func.grad`` does not
take a checkpoint (it refuses saved-tensor hooks), so a gradient is taken
with ``torch.autograd``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.flatten_util import tree_leaves
from repro_torch.models import layers as L
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import cumsum
from repro_torch.models.cache import (
    AttnCache, HybridCache, SSMCache, n_shared_invocations, pad_cache, slot_block,
)
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
    if cfg.arch_type in ("ssm", "hybrid"):
        layers = {"ln1": L.init_rmsnorm(d, lead, device=device),
                  "mamba": L.init_mamba2(gen, cfg, lead, device=device)}
    else:
        layers = _init_block(gen, cfg, lead, device)
    params = {
        "embed": embed,
        "layers": layers,
        "final_norm": L.init_rmsnorm(d, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(gen, (d, cfg.vocab_padded), device=device)
    if cfg.arch_type == "hybrid":
        params["shared_block"] = _init_block(gen, cfg, (), device, mlp=True)
    if cfg.arch_type == "vlm":
        params["vis_proj"] = L.dense_init(gen, (d, d), device=device)
    return params


def _init_block(gen, cfg: ModelConfig, lead: tuple, device, mlp: bool = False) -> dict:
    """``ln1``, ``attn``, ``ln2`` and the MLP, or a moe config's MoE unless
    ``mlp`` (the hybrid's shared block is a dense block)."""
    d = cfg.d_model
    block = {"ln1": L.init_rmsnorm(d, lead, device=device),
             "attn": L.init_attention(gen, cfg, lead, device=device),
             "ln2": L.init_rmsnorm(d, lead, device=device)}
    if cfg.arch_type == "moe" and not mlp:
        block["moe"] = L.init_moe(gen, cfg, lead, device=device)
    else:
        block["mlp"] = L.init_mlp(gen, d, cfg.d_ff, lead, device=device)
    return block


def layer_params(params, i: int, stack: str = "layers") -> dict:
    """Layer ``i``'s parameters: views into the leaves stacked under
    ``stack`` (an enc-dec model's encoder is ``"enc_layers"``)."""
    def pick(node):
        return {k: pick(v) for k, v in node.items()} if isinstance(node, dict) else node[i]
    return pick(params[stack])


# --------------------------------------------------------------------------
# full-sequence forward (prefill)
# --------------------------------------------------------------------------


def _block_fwd(cfg: ModelConfig, lp, x, dtype, return_kv: bool = False,
               group: L.ModelGroup | None = None, data: L.DataGroup | None = None,
               want_aux: bool = True):
    """Attention then the MLP, or the MoE where ``lp`` has one: a dense or
    moe layer, and the hybrid's shared block → (x, aux or None, (k, v) or
    None); (k, v) are the roped keys and values when ``return_kv``. Over a
    model ``group`` (a dense layer) on this rank's TP blocks, (k, v) this
    rank's kv heads. ``data`` and ``want_aux``: the MoE's data ranks and
    whether the caller takes its aux (``layers.moe_fwd``)."""
    with record_function("lm.attention"):
        h = L.attention_fwd(lp["attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
                            dtype=dtype, return_kv=return_kv, group=group)
    kv = None
    if return_kv:
        h, kv = h
    x = x + h
    h_in = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if "moe" in lp:
        with record_function("lm.moe"):
            h, aux = L.moe_fwd(lp["moe"], h_in, cfg, dtype, data, want_aux)
        return x + h, aux, kv
    with record_function("lm.mlp"):
        return x + L.mlp_fwd(lp["mlp"], h_in, dtype, group), None, kv


def _layer_fwd(cfg: ModelConfig, params, i: int, x, dtype, group: L.ModelGroup | None = None,
               data: L.DataGroup | None = None, want_aux: bool = True):
    """Layer ``i`` of the stack → (x, aux or None). A hybrid runs its shared
    block first when ``i % attn_every == 0``. ``group``: a dense or SSM
    layer's model ranks, ``params`` this rank's TP blocks; ``data``,
    ``want_aux``: a MoE layer's (:func:`_block_fwd`)."""
    lp = layer_params(params, i)
    if cfg.arch_type not in ("ssm", "hybrid"):
        x, aux, _ = _block_fwd(cfg, lp, x, dtype, group=group, data=data, want_aux=want_aux)
        return x, aux
    if cfg.arch_type == "hybrid" and i % cfg.hybrid.attn_every == 0:
        x, _, _ = _block_fwd(cfg, params["shared_block"], x, dtype)
    with record_function("lm.mamba"):
        return x + L.mamba2_fwd(lp["mamba"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
                                dtype, group=group), None


def embed_inputs(params, cfg: ModelConfig, tokens, embeds, dtype,
                 group: L.ModelGroup | None = None):
    """Token embedding; a vlm prepends its patch embeddings (B, n_patches,
    d) projected by ``vis_proj``. The other families take tokens only.
    Over a model ``group`` ``embed`` is this rank's vocabulary block
    (``layers.embed_lookup``)."""
    check_ported(cfg)
    x = L.embed_lookup(params["embed"], tokens, dtype, group)
    if cfg.arch_type != "vlm":
        if embeds is not None:
            raise ValueError(f"the {cfg.arch_type} family takes tokens only")
        return x
    if embeds is None:
        raise ValueError("the vlm family needs patch embeddings")
    return torch.cat([embeds.to(dtype) @ params["vis_proj"].to(dtype), x], dim=1)


def remat_call(remat: bool, params, fn, *args):
    """``fn(*args)``, recomputed in the backward (a non-reentrant
    ``torch.utils.checkpoint``) when ``remat`` and a backward can reach the
    call: grad mode on and ``params`` or an input requiring grad. Otherwise
    (inference, or ``torch.func.jvp``'s forward mode, whose wrapped inputs
    some torch versions' checkpoint refuses) a plain call: the same values,
    and nothing is saved for a backward either way."""
    if remat and torch.is_grad_enabled() and (
            any(a.requires_grad for a in args if isinstance(a, torch.Tensor))
            or any(leaf.requires_grad for leaf in tree_leaves(params))):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def backbone(params, cfg: ModelConfig, x, dtype, remat: bool = False,
             group: L.ModelGroup | None = None, data: L.DataGroup | None = None,
             want_aux: bool = True):
    """The layer stack. x: (B, S, D) -> (B, S, D), aux: the MoE layers' aux
    losses summed in layer order (fp32; 0 for the other families, and over
    ``data`` without ``want_aux``). ``remat`` recomputes each layer in the
    backward (with its collectives over ``group``, a dense or SSM model's
    model ranks, and over ``data``, a MoE model's data ranks)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = remat_call(remat, params,
                          lambda x, i=i: _layer_fwd(cfg, params, i, x, dtype, group, data,
                                                    want_aux), x)
        if a is not None:
            aux = aux + a
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def logits_from_hidden(params, cfg: ModelConfig, x, dtype,
                       group: L.ModelGroup | None = None):
    """x @ head; the tied head is ``embed.T``; pad columns are -1e30. Over
    a model ``group`` the head is this rank's vocabulary block and so are
    the logits (the pad columns on the rank that holds them); x enters the
    head through ``layers.copy_to_group``."""
    with record_function("lm.logits"):
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = L.copy_to_group(x, group) @ head.to(dtype)
        first = cfg.vocab_size - (0 if group is None else group.rank * logits.shape[-1])
        if first < logits.shape[-1]:  # this block holds pad columns
            logits[..., max(first, 0):].fill_(L.NEG_INF)
        return logits


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None, dtype=torch.float32,
            remat: bool = False):
    """Full-sequence logits (B, S, vocab_padded) and aux; a vlm's cover its
    token positions only."""
    x = embed_inputs(params, cfg, tokens, embeds, dtype)
    x, aux = backbone(params, cfg, x, dtype, remat)
    if cfg.arch_type == "vlm":
        x = x[:, embeds.shape[1]:, :]
    return logits_from_hidden(params, cfg, x, dtype), aux


CE_CHUNK = 1024  # sequence-chunked cross entropy: (B, CHUNK, V) logits live,
                 # never the full (B, S, V) (at a vocab of 150k–256k the full
                 # logits of a long batch would not fit)


def _chunk_nll(params, cfg: ModelConfig, xc, tc, vc, dtype,
               group: L.ModelGroup | None = None):
    """One chunk's summed NLL a row: xc (B, CHUNK, D), targets tc, valid vc.

    Over a model ``group`` the (B, CHUNK, V/M) fp32 logits stay this
    rank's vocabulary block: the row maximum is the group's MAX
    (``layers.max_over_group``, no derivative: the log-sum-exp does not
    depend on its shift), the sum of exponentials and the target's logit
    (taken on the rank whose block holds it, 0 elsewhere) the group's SUM
    (``layers.sum_over_group``); NLL = m + log Σ exp(l − m) − l_target."""
    logits = logits_from_hidden(params, cfg, xc, dtype, group).float()
    if group is None:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, tc[..., None])[..., 0]
        return (nll * vc).sum(dim=-1)
    n = logits.shape[-1]
    m = L.max_over_group(logits.amax(dim=-1, keepdim=True), group)
    sum_exp = L.sum_over_group(torch.exp(logits - m).sum(dim=-1), group)
    local = tc - group.rank * n
    inside = (local >= 0) & (local < n)
    target = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    target = L.sum_over_group(target.masked_fill(~inside, 0.0), group)
    nll = torch.log(sum_exp) + m[..., 0] - target
    return (nll * vc).sum(dim=-1)


def chunked_ce(params, cfg: ModelConfig, x, tokens, dtype, logits_sharding=None,
               group: L.ModelGroup | None = None):
    """Per-example mean NLL of next-token prediction → (B,) fp32, from the
    final hidden x (B, S, D) and tokens (B, S).

    The S − 1 predicting positions are padded to a multiple of
    ``min(CE_CHUNK, S − 1)`` and the pad masked; each (B, CHUNK, V) chunk of
    logits goes through an fp32 ``log_softmax`` and is recomputed in the
    backward (a checkpoint a chunk, as the reference's ``jax.checkpoint``
    of its scan body, wherever a backward can reach it: :func:`remat_call`),
    and the rows' sums are added chunk after chunk.
    ``logits_sharding`` is accepted and ignored: the port splits the
    vocabulary by ``group`` instead, the model ranks a dense or SSM model is split
    over (``params`` this rank's TP blocks), where each chunk's logits
    stay this rank's vocabulary block (:func:`_chunk_nll`).
    """
    del logits_sharding
    b, s, d = x.shape
    s1 = s - 1
    chunk = min(CE_CHUNK, s1)
    nc = -(-s1 // chunk)
    pad = nc * chunk - s1
    x_in = torch.nn.functional.pad(x[:, :-1], (0, 0, 0, pad))
    tgt = torch.nn.functional.pad(tokens[:, 1:], (0, pad))
    valid = torch.nn.functional.pad(torch.ones((b, s1), device=x.device), (0, pad))
    acc = torch.zeros((b,), dtype=torch.float32, device=x.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        acc = acc + remat_call(True, params, _chunk_nll, params, cfg, x_in[:, sl], tgt[:, sl],
                               valid[:, sl], dtype, group)
    return acc / s1


def lm_loss(params, cfg: ModelConfig, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None, dtype=torch.float32,
            remat: bool = False, loss_weights: Optional[torch.Tensor] = None,
            aux_coeff: float = 0.01, reduce: bool = True, logits_sharding=None,
            group: L.ModelGroup | None = None, data: L.DataGroup | None = None):
    """Next-token cross entropy (+ the MoE aux) → (loss, aux).

    ``loss_weights`` (B,) weighs each example: the hook the PO-FL trainer
    reweighs its FL devices by. The loss is ``mean(per_example ·
    loss_weights) + aux_coeff · aux``; ``reduce=False`` returns the
    per-example vector (B,) instead (the per-FL-device statistics passes).
    A vlm's patch positions predict nothing: they are dropped before the
    CE. ``logits_sharding`` is ignored (:func:`chunked_ce`). ``group``: the
    model ranks a dense or SSM model is split over, ``params`` this rank's TP
    blocks (a tied ``embed``'s lookup and head add their gradients on the
    same vocabulary block); the loss is the whole batch's on every rank.
    ``data``: the data ranks a MoE model's rows are split over, ``tokens``
    this rank's rows; the loss and aux are then this rank's shares, whose
    mean over the data ranks is the batch's (``layers.moe_fwd``), and with
    ``reduce=False`` the aux is not taken (0).
    """
    x = embed_inputs(params, cfg, tokens, embeds, dtype, group)
    x, aux = backbone(params, cfg, x, dtype, remat, group, data, want_aux=reduce)
    if cfg.arch_type == "vlm":
        x = x[:, embeds.shape[1]:, :]
    per_example = chunked_ce(params, cfg, x, tokens, dtype, logits_sharding, group)
    if loss_weights is not None:
        per_example = per_example * loss_weights
    if not reduce:
        return per_example, aux
    return per_example.mean() + aux_coeff * aux, aux


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None, dtype=torch.float32,
            group: L.ModelGroup | None = None, pad_to: int | None = None,
            data: L.DataGroup | None = None):
    """Run the full prompt, build the decode cache, return last-pos logits.

    A dense, vlm or moe cache holds every layer's roped k and v, (L, B, S,
    KV, dh) in ``dtype``, with ``pos = arange(S)`` (a vlm's S counts its
    patches first; the MoE aux is dropped); an
    ssm cache every layer's final state and conv window
    (:func:`_ssm_prefill`); a hybrid cache both (:func:`_hybrid_prefill`).
    ``pad_to`` grows the cache to that many slots (``cache.pad_cache``).

    Over a model ``group`` (a dense or SSM model on this rank's TP blocks)
    the logits are this rank's vocabulary block, and the cache is this
    rank's block of it by ``cache_pspecs``: a dense model's every kv head,
    this rank's slots of the padded cache where the sequence splits
    (:func:`_kv_rank_block`), its positions whole; an SSM model's state of
    the rank's heads and its block of the conv window's channels
    (``layers.conv_block``). Over ``data`` (a MoE model's data ranks)
    ``tokens`` are this rank's rows, routed in the whole batch's groups.
    """
    x = embed_inputs(params, cfg, tokens, embeds, dtype, group)
    if cfg.arch_type == "ssm":
        x, cache = _ssm_prefill(params, cfg, x, dtype, group=group)
    elif cfg.arch_type == "hybrid":
        x, cache = _hybrid_prefill(params, cfg, x, dtype)
    elif group is not None:
        x, cache = _dense_prefill_over(group, params, cfg, x, dtype, max(pad_to or 0, x.shape[1]))
    else:
        ks, vs = _empty_kv(cfg, cfg.n_layers, x)
        for i in range(cfg.n_layers):
            x, _, (ks[i], vs[i]) = _block_fwd(cfg, layer_params(params, i), x, dtype,
                                              return_kv=True, data=data, want_aux=False)
        cache = AttnCache(k=ks, v=vs, pos=_positions(x))
    if pad_to is not None and group is None:
        cache = pad_cache(cache, pad_to)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x[:, -1:, :], dtype, group), cache


def _dense_prefill_over(group: L.ModelGroup, params, cfg: ModelConfig, x, dtype,
                        n_slots: int):
    """The dense layers over a model group on this rank's TP blocks → (x,
    this rank's block of an ``n_slots`` cache): each layer's k and v of this
    rank's kv heads for every position are laid out as ``cache_pspecs``
    asks, every kv head for this rank's slots (:func:`_kv_rank_block`)."""
    b, s, _ = x.shape
    lo, hi = slot_block(n_slots, group.rank, group.size)
    dims = (cfg.n_layers, b, hi - lo, cfg.n_kv_heads, cfg.head_dim)
    ks = torch.zeros(dims, dtype=x.dtype, device=x.device)
    vs = torch.zeros(dims, dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        x, _, kv = _block_fwd(cfg, layer_params(params, i), x, dtype, return_kv=True,
                              group=group)
        _kv_rank_block(group, kv, lo, hi, ks[i], vs[i])
    pos = torch.full((n_slots,), -1, dtype=torch.int32, device=x.device)
    pos[:s] = _positions(x)
    return x, AttnCache(k=ks, v=vs, pos=pos)


def _kv_rank_block(group: L.ModelGroup, kv, lo: int, hi: int, k_out, v_out) -> None:
    """Re-lay one layer's (k, v) of this rank's kv heads, (B, S, KV/M, dh)
    each, into its cache block: the group gathers every kv head (one
    all-gather of k and v stacked) and the rank keeps its slots ``[lo,
    hi)`` of the positions, written into ``k_out`` and ``v_out`` (B, hi −
    lo, KV, dh; the slots past the prompt stay empty)."""
    every = L.gather_from_group(torch.stack(kv), 3, group)  # (2, B, S, KV, dh)
    n = max(0, min(hi, every.shape[2]) - lo)
    k_out[:, :n] = every[0, :, lo:lo + n]
    v_out[:, :n] = every[1, :, lo:lo + n]


def _mamba_layer_with_state(lp, x, cfg: ModelConfig, dtype,
                            group: L.ModelGroup | None = None):
    """Full-sequence Mamba2 layer (residual included) that also returns
    (ssm_state (B, H, N, P), conv_state (B, K-1, di+2n)); over a model
    ``group`` on this rank's TP blocks, the state of its heads and its
    block of the conv window (``layers.conv_block``).

    The scan runs in chunks of ``min(cfg.ssm.chunk_size, S)``, as in the
    reference, which therefore needs S ≤ chunk_size or a multiple of it
    (``ValueError`` otherwise). The final state is the reference's replay,
    ``Σ_t exp(La_S − La_t) B_t ⊗ xdt_t`` in ``dtype`` (``transformer.py:
    334-337``), not the kernel's carried fp32 state; the conv state is the
    last K-1 inputs of the conv.
    """
    s_cfg = cfg.ssm
    mp = lp["mamba"]
    h_in = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
    z, xbc, dt = L._mamba_proj(mp, h_in, cfg, dtype, group)
    conv_state = L.conv_block(xbc[:, -(s_cfg.conv_kernel - 1):, :], cfg, group)
    xh, xdt, la, B, C = L.mamba_inputs(mp, xbc, dt, cfg, dtype, group)

    y = ssd(xdt, la, B, C, chunk=min(s_cfg.chunk_size, x.shape[1]))

    La = cumsum(la, dim=1)  # (B, S, H), in the reference's order
    seg = torch.exp(La[:, -1:, :] - La)  # decay from t to the sequence's end
    final_state = torch.einsum("bsh,bsn,bshp->bhnp", seg.to(dtype), B, xdt)
    return x + L.mamba_out(mp, y, xh, z, cfg, dtype, group), final_state, conv_state


def _empty_kv(cfg: ModelConfig, n: int, x) -> tuple[torch.Tensor, torch.Tensor]:
    """Uninitialised k and v caches (n, B, S, KV, dh) in x's type; a prefill
    writes every slot."""
    dims = (n, x.shape[0], x.shape[1], cfg.n_kv_heads, cfg.head_dim)
    return (torch.empty(dims, dtype=x.dtype, device=x.device),
            torch.empty(dims, dtype=x.dtype, device=x.device))


def _positions(x) -> torch.Tensor:
    """A prefill cache's slot positions: arange(S), int32."""
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)


def _ssm_prefill(params, cfg: ModelConfig, x, dtype, shared=None,
                 group: L.ModelGroup | None = None):
    """Every layer through :func:`_mamba_layer_with_state`: → (x, SSMCache)
    with the states stacked over the layers in x's type (over a model
    ``group``, this rank's blocks of them). ``shared(i, x)``, if given,
    runs before layer ``i`` and returns the new x (the hybrid's shared
    block)."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    ways = 1 if group is None else group.size
    nh, n, k = s_cfg.n_heads(d) // ways, s_cfg.d_state, s_cfg.conv_kernel
    states = torch.empty((cfg.n_layers, b, nh, n, s_cfg.head_dim), dtype=x.dtype,
                         device=x.device)
    convs = torch.empty((cfg.n_layers, b, min(k - 1, s), L.conv_channels(cfg, group)),
                        dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        if shared is not None:
            x = shared(i, x)
        with record_function("lm.mamba"):
            x, states[i], convs[i] = _mamba_layer_with_state(layer_params(params, i), x, cfg,
                                                             dtype, group)
    return x, SSMCache(state=states, conv=convs)


def _hybrid_prefill(params, cfg: ModelConfig, x, dtype):
    """The Mamba2 stack of :func:`_ssm_prefill` with the shared block before
    every ``attn_every``-th layer: invocation ``i // attn_every`` writes its
    roped k and v into its slot of an (n_shared_invocations, B, S, KV, dh)
    cache (the reference's select of ``write · k + (1 − write) · old`` is a
    plain write here) → (x, HybridCache)."""
    every = cfg.hybrid.attn_every
    ks, vs = _empty_kv(cfg, n_shared_invocations(cfg), x)

    def shared(i, x):
        if i % every:
            return x
        x, _, (ks[i // every], vs[i // every]) = _block_fwd(cfg, params["shared_block"], x,
                                                            dtype, return_kv=True)
        return x

    x, ssm = _ssm_prefill(params, cfg, x, dtype, shared)
    return x, HybridCache(ssm=ssm, attn=AttnCache(k=ks, v=vs, pos=_positions(x)))


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache, t: int,
                dtype=torch.float32, group: L.ModelGroup | None = None,
                data: L.DataGroup | None = None):
    """One serve step: consume one token (B, 1) at absolute position ``t``,
    update ``cache`` **in place** and return (logits (B, 1, vocab_padded),
    cache). A dense, vlm or moe step writes the token's k, v and position into
    slot ``t % S_max`` of every layer's cache (each layer writes the same
    position, which every layer then reads); an ssm step overwrites each
    layer's state and conv window; a hybrid step does both, its shared
    block's invocation ``i // attn_every`` on that invocation's KV cache.
    ``group``: the model ranks a dense or SSM model is split over, on this
    rank's TP blocks, a dense model's KV cache split by sequence where
    ``cache_pspecs`` splits it (:func:`repro_torch.models.layers.attention_decode`),
    an SSM model's state by heads and its conv window by channels
    (``layers.mamba2_decode``); the logits are then this rank's vocabulary
    block. ``None`` on one card. ``data``:
    the data ranks a MoE model's rows are split over, its tokens routed in
    the whole batch's groups."""
    check_ported(cfg)
    x = L.embed_lookup(params["embed"], token, dtype, group)
    t = int(t)
    if cfg.arch_type == "ssm":
        x = _ssm_decode(params, cfg, x, cache, dtype, group=group)
    elif cfg.arch_type == "hybrid":
        every = cfg.hybrid.attn_every
        kv = cache.attn

        def shared(i, x):
            if i % every:
                return x
            return _block_decode(cfg, params["shared_block"], x, kv.k[i // every],
                                 kv.v[i // every], kv.pos, t, dtype)

        x = _ssm_decode(params, cfg, x, cache.ssm, dtype, shared)
    else:
        for i in range(cfg.n_layers):
            x = _block_decode(cfg, layer_params(params, i), x, cache.k[i], cache.v[i],
                              cache.pos, t, dtype, group, data)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits_from_hidden(params, cfg, x, dtype, group), cache


def _block_decode(cfg: ModelConfig, lp, x, cache_k, cache_v, cache_pos, t: int, dtype,
                  group: L.ModelGroup | None = None, data: L.DataGroup | None = None):
    """:func:`_block_fwd` for one token against a KV cache, written in place."""
    with record_function("lm.attention"):
        h, _ = L.attention_decode(lp["attn"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
                                  cache_k, cache_v, cache_pos, t, dtype=dtype, group=group)
    x = x + h
    h_in = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if "moe" in lp:
        with record_function("lm.moe"):
            return x + L.moe_fwd(lp["moe"], h_in, cfg, dtype, data, want_aux=False)[0]
    with record_function("lm.mlp"):
        return x + L.mlp_fwd(lp["mlp"], h_in, dtype, group)


def _ssm_decode(params, cfg: ModelConfig, x, cache: SSMCache, dtype, shared=None,
                group: L.ModelGroup | None = None):
    """Every Mamba2 layer's step, its state and conv window overwritten in
    place; ``shared(i, x)`` as in :func:`_ssm_prefill`; ``group`` as in
    :func:`decode_step`."""
    for i in range(cfg.n_layers):
        if shared is not None:
            x = shared(i, x)
        lp = layer_params(params, i)
        with record_function("lm.mamba"):
            h, st, cv = L.mamba2_decode(lp["mamba"], L.rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
                                        cache.state[i], cache.conv[i], dtype, group)
            cache.state[i].copy_(st)
            cache.conv[i].copy_(cv)
        x = x + h
    return x
