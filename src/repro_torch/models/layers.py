"""Layer primitives of every family: norms, RoPE, GQA attention (self- and
cross-attention), SwiGLU, capacity-based MoE, Mamba2.

Port of ``repro.models.layers`` but its activation-sharding registry. Every layer
is an (``init_<layer>``, ``<layer>_fwd``) pair of plain functions over dicts
of tensors in the reference's layouts (``x @ w`` with ``w`` as (d_in,
d_out)). Matmul-heavy ops take a ``dtype`` for the compute precision;
parameters may be fp32 and are cast at use, as in the reference.

Full-sequence attention (:func:`attention_fwd`: causal or not, and the
enc-dec decoder's cross-attention, at any query count down to the single
token of a decode step) goes through
:func:`repro_torch.kernels.attention.ops.attention`: on a CUDA tensor that
is the hand-written flash kernel, on a CPU tensor its plain version. Where
the reference computes it in jnp (``_attention_core``), the two agree on
every row it produces: causal self-attention always lets a query see key 0,
a window always holds the diagonal and a non-causal call sees every key, so
no row is fully masked. The kernel keeps the probabilities in fp32 for the PV product,
where ``_attention_core`` rounds them to ``dtype`` first. Single-token
decode attention (:func:`attention_decode`) stays plain torch, as it stays
outside any Pallas kernel in the reference.

Over the model ranks of a mesh (a :class:`ModelGroup`) a dense model is
split tensor-parallel: each rank holds its heads' columns of ``wq``,
``wk``, ``wv`` and their rows of ``wo``, its columns of the MLP's
``w_gate`` and ``w_in`` and those rows of ``w_out``, and its vocabulary
block of ``embed`` (``launch/sharding.py::tp_pspecs``). :func:`attention_fwd`
and :func:`mlp_fwd` compute this rank's heads and columns, and sum the
row-split products over the group (:func:`row_split_matmul`);
:func:`embed_lookup` looks up the tokens of its vocabulary block and sums
the group's rows; :func:`greedy` combines the group's vocabulary blocks
into the greedy token. A decode step (:func:`attention_decode`) gathers
every rank's new q, k and v heads, and where the KV cache is split by
sequence over the group each rank attends over its slots and the group
combines the partial softmaxes (flash-decoding).

The group's collectives on the split layers' path are
``torch.autograd.Function`` s with a backward and a tangent rule (the
Megatron pair), so the split layers train and ``torch.func.jvp`` goes
through them: :func:`copy_to_group` (forward the identity, backward a SUM
over the group) before every column-split product, :func:`sum_over_group`
(forward a SUM, backward the identity, the tangent summed) after every
row-split one and the vocabulary-split lookup, :func:`max_over_group`
(a MAX that carries no derivative) and :func:`gather_from_group` (forward
an all-gather, backward this rank's slice: every rank backpropagates its
own copy of the same replicated loss).

The full-sequence Mamba2 scan (:func:`mamba2_fwd`) goes through
:func:`repro_torch.kernels.ssd.ops.ssd` the same way, where the reference
calls its jnp ``ssd_chunked`` (which is :func:`ssd_chunked`, the kernel's
plain version). The single-token step (:func:`mamba2_decode`) stays plain
torch, op for op: it rounds the state to ``dtype`` every step, as the
reference does. Over a model group the mixer splits by SSM heads (its TP
blocks: the heads' z, x and dt columns of ``in_proj`` and x channels of
the conv, B and C whole on every rank): each rank scans its nh/M heads,
the gated norm's statistic is the group's SUM of the ranks' sums of
squares, ``out_proj``'s rows are summed (:func:`row_split_matmul`), the B
and C weight slices enter through :func:`copy_to_group` (each rank's
gradient of them is a part), and the conv window, cached as the spec's
block of its channels, is gathered a step (:func:`_decode_window`).

The MoE layer (:func:`moe_fwd`) stays plain torch as it stays outside any
Pallas kernel in the reference: its routing (:func:`moe_route`) and the
scatter, expert products and gather of its dispatch, with static shapes and
no device→host sync. Over the data ranks of a mesh (a :class:`DataGroup`)
each rank routes its rows in the whole batch's routing groups, as one
process routes the batch: where a group spans ranks they gather each
other's top-k experts, and the load-balance loss takes the batch's
first-choice counts (one SUM a layer).

Not ported here: the activation-sharding registry (``constrain``,
``constrain_tree``; it has no counterpart on one card).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.attention.ops import attention
from repro_torch.kernels.attention.ref import (  # noqa: F401  (the reference has the mask here)
    NEG_INF,
    attention_scores_mask,
)
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_chunked_ref as ssd_chunked  # noqa: F401
from repro_torch.models.config import ModelConfig

PORTED_ARCH = ("dense", "ssm", "hybrid", "moe", "encdec", "vlm")


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for an ``arch_type`` no family has (every family
    of the configs is ported: ``PORTED_ARCH``)."""
    if cfg.arch_type not in PORTED_ARCH:
        raise ValueError(f"{cfg.name}: unknown arch_type {cfg.arch_type!r}")


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    """Normal(0, scale²) fp32, scale 1/√fan_in by default (``fan_in`` is
    ``shape[-2]``, as in the reference)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=gen, device=device) * scale


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def init_rmsnorm(d: int, lead: tuple = (), device=None):
    return {"scale": torch.ones((*lead, d), device=device)}


def rmsnorm(params, x, eps: float = 1e-5):
    """fp32 inside, cast back to x's type."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# RoPE (split halves, not interleaved)
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs   # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]          # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA, optional bias / sliding window)
# --------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (), device=None):
    """``lead`` prefixes every leaf's shape: (L,) gives the stacked layers."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (*lead, d, h * dh), device=device),
        "wk": dense_init(gen, (*lead, d, kv * dh), device=device),
        "wv": dense_init(gen, (*lead, d, kv * dh), device=device),
        "wo": dense_init(gen, (*lead, h * dh, d), device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, h * dh), device=device)
        p["bk"] = torch.zeros((*lead, kv * dh), device=device)
        p["bv"] = torch.zeros((*lead, kv * dh), device=device)
    return p


def _project(params, x, cfg: ModelConfig, dtype, name: str, heads: int):
    """``x @ w<name>`` (+ ``b<name>`` with ``qkv_bias``) as (B, S, heads, dh)."""
    y = x @ params["w" + name].to(dtype)
    if cfg.qkv_bias:
        y = y + params["b" + name].to(dtype)
    return y.reshape(*x.shape[:2], heads, cfg.head_dim)


def _qkv(params, x, cfg: ModelConfig, dtype, group: Optional[ModelGroup] = None):
    """q, k, v of the heads ``params`` hold: all of them, or over ``group``
    this rank's blocks (H/M query and KV/M kv heads), ``x`` entering them
    through :func:`copy_to_group`."""
    ways = _ways(group)
    x = copy_to_group(x, group)
    return (_project(params, x, cfg, dtype, "q", cfg.n_heads // ways),
            _project(params, x, cfg, dtype, "k", cfg.n_kv_heads // ways),
            _project(params, x, cfg, dtype, "v", cfg.n_kv_heads // ways))


class ModelGroup(NamedTuple):
    """The model ranks of one data group: this rank's place and their
    count, the group's in-place all-reduces of a tensor by MAX and by SUM,
    and ``all_gather(x, dim)``, every rank's ``x`` concatenated along
    ``dim`` in rank order (each counted by the mesh that runs it). The
    rank steps build it (``launch/steps.py::model_group``); ``None`` is one
    card, or one model rank a group. The layers call them through the
    autograd Functions below, never on a tensor autograd saved."""

    rank: int
    size: int
    all_max: Callable[[torch.Tensor], None]
    all_sum: Callable[[torch.Tensor], None]
    all_gather: Callable[[torch.Tensor, int], torch.Tensor]


def _ways(group: Optional[ModelGroup]) -> int:
    return 1 if group is None else group.size


def _summed(x: torch.Tensor, group: ModelGroup) -> torch.Tensor:
    """The group's SUM of ``x`` in a fresh contiguous tensor (``x`` left as
    it is)."""
    out = x.clone(memory_format=torch.contiguous_format)
    group.all_sum(out)
    return out


class _CopyToGroup(torch.autograd.Function):
    """"f": the identity forward and tangent, the gradient summed over the
    group (each rank's column block adds its part of it)."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)  # a view: forward-mode AD then takes the tangent's view

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None

    @staticmethod
    def jvp(ctx, tangent, _):
        return tangent.view_as(tangent)


class _SumOverGroup(torch.autograd.Function):
    """"g": the group's SUM forward and tangent, the identity gradient
    (every rank holds the same replicated result and its gradient)."""

    @staticmethod
    def forward(x, group):
        return _summed(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return grad, None

    @staticmethod
    def jvp(ctx, tangent, _):
        return _summed(tangent, ctx.group)


class _MaxOverGroup(torch.autograd.Function):
    """The group's MAX, with no derivative (a softmax's shift)."""

    @staticmethod
    def forward(x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        group.all_max(out)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, grad):
        return None, None

    @staticmethod
    def jvp(ctx, tangent, _):
        return torch.zeros_like(tangent)


class _GatherFromGroup(torch.autograd.Function):
    """Every rank's block concatenated along ``dim``: the tangents gathered
    the same way, the gradient this rank's slice of it (each rank
    backpropagates its own copy of the same replicated loss, so this is
    not a reduce-scatter)."""

    @staticmethod
    def forward(x, dim, group):
        return group.all_gather(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, ctx.dim, ctx.group = inputs
        ctx.n = x.shape[ctx.dim]

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n), None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        return ctx.group.all_gather(tangent, ctx.dim)


def copy_to_group(x: torch.Tensor, group: Optional[ModelGroup]) -> torch.Tensor:
    """``x`` entering this rank's column block of a product split over
    ``group`` (:class:`_CopyToGroup`); ``x`` itself without a group."""
    return x if group is None else _CopyToGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group: Optional[ModelGroup]) -> torch.Tensor:
    """The group's SUM of every rank's ``x`` (:class:`_SumOverGroup`)."""
    return x if group is None else _SumOverGroup.apply(x, group)


def max_over_group(x: torch.Tensor, group: ModelGroup) -> torch.Tensor:
    """The group's MAX of every rank's ``x``, carrying no derivative."""
    return _MaxOverGroup.apply(x.detach(), group)


def gather_from_group(x: torch.Tensor, dim: int, group: ModelGroup) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order
    (:class:`_GatherFromGroup`)."""
    return _GatherFromGroup.apply(x, dim, group)


class _Fp32Accumulate(torch.autograd.Function):
    """``a @ w`` of bf16 CUDA matrices as the GEMM's fp32 accumulator
    (``mm``'s ``out_dtype``, which has no derivative): the gradients are
    the two bf16 GEMMs of the backward, each accumulated in fp32 and
    rounded once to its operand's type, and the tangent is the product
    rule's two GEMMs summed in fp32."""

    @staticmethod
    def forward(a, w):
        return torch.mm(a, w, out_dtype=torch.float32)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        a, w = ctx.saved_tensors
        grad = grad.to(a.dtype)
        da = torch.mm(grad, w.T, out_dtype=torch.float32).to(a.dtype)
        dw = torch.mm(a.T, grad, out_dtype=torch.float32).to(w.dtype)
        return da, dw

    @staticmethod
    def jvp(ctx, ta, tw):
        a, w = ctx.saved_tensors
        out = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float32, device=a.device)
        if ta is not None:
            out = out + torch.mm(ta, w, out_dtype=torch.float32)
        if tw is not None:
            out = out + torch.mm(a, tw, out_dtype=torch.float32)
        return out


def row_split_matmul(a: torch.Tensor, w: torch.Tensor, dtype,
                     group: Optional[ModelGroup]) -> torch.Tensor:
    """``a @ w`` in ``dtype`` where ``a``'s columns and ``w``'s rows are
    this rank's block of a product split over ``group`` (``None``: the
    whole product). Each rank's partial sum is taken in fp32 and the
    group's SUM of them (:func:`sum_over_group`) rounded to ``dtype``
    once, as one GEMM over the whole inner dim rounds its fp32 accumulator
    once: a partial rounded to bf16 before the sum would add a rounding per
    rank. On the card a bf16 product stays on the tensor cores and only
    its accumulator is returned, in fp32 (:class:`_Fp32Accumulate`);
    elsewhere it is taken in fp32 from the same values (a product of two
    bf16 numbers is exact in fp32)."""
    if group is None:
        return a @ w.to(dtype)
    w = w.to(dtype)
    if a.is_cuda and dtype == torch.bfloat16:
        part = _Fp32Accumulate.apply(a.reshape(-1, a.shape[-1]), w).reshape(
            *a.shape[:-1], w.shape[-1])
    else:
        part = a.float() @ w.float()
    return sum_over_group(part, group).to(dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dtype,
                 group: Optional[ModelGroup] = None) -> torch.Tensor:
    """``table[tokens]`` in ``dtype``. Over ``group`` the table is this
    rank's vocabulary block (rows ``[r·V/M, (r+1)·V/M)``): a token outside
    it gives a row of zeros, and the group's SUM gives every rank the whole
    lookup, exactly (each row is one rank's, the others add zeros)."""
    table = table.to(dtype)
    if group is None:
        return table[tokens]
    n = table.shape[0]
    local = tokens - group.rank * n
    outside = (local < 0) | (local >= n)
    return sum_over_group(table[local.clamp(0, n - 1)].masked_fill(outside[..., None], 0),
                          group)


def greedy(logits: torch.Tensor, group: Optional[ModelGroup] = None) -> torch.Tensor:
    """The greedy token (..., 1) of last-dim logits. Over ``group`` the
    logits are this rank's vocabulary block: each rank takes its block's
    max and first arg-max, the group gathers the (value, global index)
    pairs, and the largest value wins, on a tie the lowest index, as
    ``argmax`` over the whole row does."""
    idx = logits.argmax(dim=-1, keepdim=True)
    if group is None:
        return idx
    val = logits.gather(-1, idx).double()
    pair = torch.cat([val, (idx + group.rank * logits.shape[-1]).double()], dim=-1)
    pairs = group.all_gather(pair[None], 0)  # (M, ..., 2), the ranks in vocabulary order
    vals = pairs[..., 0]
    first = (vals == vals.amax(dim=0)).int().argmax(dim=0, keepdim=True)  # the lowest rank
    return pairs[..., 1].gather(0, first)[0, ..., None].long()


def attention_fwd(params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: Optional[torch.Tensor] = None, causal: bool = True,
                  kv_override: Optional[tuple] = None, return_kv: bool = False,
                  dtype=torch.float32, use_rope: bool = True,
                  group: Optional[ModelGroup] = None):
    """Full-sequence attention (prefill; cross-attention also in decode).

    The core is :func:`~repro_torch.kernels.attention.ops.attention` with
    ``q_offset=0``. ``positions`` (default 0..S-1) are the RoPE positions,
    applied to q and k unless ``use_rope`` is false. ``kv_override`` is a
    cross-attention's (k, v), (B, S_kv, KV, dh): the call is then non-causal
    with no window, and k and v are taken as given (the reference also
    projects x to k and v there and discards them; the port skips that).
    Otherwise the call is ``causal`` with ``cfg.sliding_window``.
    ``return_kv`` also returns the k and v the call attended to.

    Over a model ``group`` ``params`` are this rank's TP blocks: the call
    runs over its H/M query and KV/M kv heads, and the output projection
    (its rows of ``wo``) is summed over the group
    (:func:`row_split_matmul`); the k and v returned are this rank's heads.
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if kv_override is None:
        q, k, v = _qkv(params, x, cfg, dtype, group)
        if use_rope:
            k = apply_rope(k, positions, cfg.rope_theta)
        window = cfg.sliding_window
    else:
        q = _project(params, x, cfg, dtype, "q", cfg.n_heads)
        k, v = kv_override
        causal, window = False, None
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    out = attention(q, k, v, causal=causal, sliding_window=window, q_offset=0)
    out = row_split_matmul(out.reshape(b, s, -1), params["wo"], dtype, group)
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(params, x: torch.Tensor, cfg: ModelConfig, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_pos: torch.Tensor, t: int, *,
                     dtype=torch.float32, use_rope: bool = True,
                     group: Optional[ModelGroup] = None):
    """Single-token decode against a (possibly ring-buffer) KV cache.

    x is (B, 1, D); cache_k and cache_v are (B, S_max, KV, dh); cache_pos is
    (S_max,), the absolute position stored in each slot (-1 empty); ``t`` is
    the new token's absolute position, at which q and k are roped unless
    ``use_rope`` is false. The new k, v and position are
    written into slot ``t % S_max`` **in place** (the reference returns
    updated copies; in place saves copying the cache each step). Returns
    ``(out, (cache_k, cache_v, cache_pos))``.

    Over a model ``group`` ``params`` are this rank's TP blocks: the rank
    projects its heads of the new q, k and v and ropes them, the group
    gathers every head (:func:`_gather_heads`), the attention runs over
    every head, and this rank's heads of its output go through its rows of
    ``wo``, summed over the group (:func:`row_split_matmul`). Where the
    group splits the cache by sequence, cache_k and cache_v are this rank's
    slots ``[r·S_max/m, (r + 1)·S_max/m)`` and cache_pos is whole: see
    :func:`_attend_slice`. Where the cache is whole on every rank (one
    card, or a sequence the group does not split), the one-card code runs.
    """
    b = x.shape[0]
    h, kv_heads, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rep = h // kv_heads
    s_max = cache_k.shape[1]
    q, k_new, v_new = _qkv(params, x, cfg, dtype, group)
    pos = torch.full((1, 1), t, device=x.device)
    if use_rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    if group is not None:
        q, k_new, v_new = _gather_heads(q, k_new, v_new, group)
    if group is not None and s_max != cache_pos.shape[0]:
        out = _attend_slice(q, k_new, v_new, cache_k, cache_v, cache_pos, t, cfg, group,
                            dtype).to(dtype)
    else:
        slot = t % s_max  # ring buffer (= t when S_max > t)
        cache_k[:, slot] = k_new[:, 0]
        cache_v[:, slot] = v_new[:, 0]
        cache_pos[slot].fill_(t)  # a fill kernel: assigning a Python int would sync on a host copy

        # validity: slot written, causal, within window
        valid = _valid_slots(cache_pos, t, cfg)

        q = q.reshape(b, 1, kv_heads, rep, dh)
        scores = torch.einsum("bqgrd,bkgd->bgrqk", q, cache_k) / math.sqrt(dh)
        scores = scores.masked_fill(~valid, NEG_INF)
        probs = torch.softmax(scores.float(), dim=-1).to(dtype)
        out = torch.einsum("bgrqk,bkgd->bqgrd", probs, cache_v).reshape(b, 1, h * dh)
    if group is not None:  # this rank's heads
        width = h * dh // group.size
        out = out[..., group.rank * width:(group.rank + 1) * width]
    return row_split_matmul(out, params["wo"], dtype, group), (cache_k, cache_v, cache_pos)


def _gather_heads(q, k, v, group: ModelGroup):
    """Every rank's heads of one token's q, k and v, (B, 1, heads/M, dh)
    each → (B, 1, heads, dh) each in head order: one gather over the group
    of the three side by side."""
    b, _, hq, dh = q.shape
    hk = k.shape[2]
    every = gather_from_group(torch.cat([q, k, v], dim=2), 2, group)
    every = every.reshape(b, 1, group.size, hq + 2 * hk, dh)

    def heads(lo, n):
        return every[:, :, :, lo:lo + n].reshape(b, 1, group.size * n, dh)

    return heads(0, hq), heads(hq, hk), heads(hq + hk, hk)


def _valid_slots(cache_pos: torch.Tensor, t: int, cfg: ModelConfig) -> torch.Tensor:
    """The slots a query at ``t`` attends to: written, causal, within the
    sliding window."""
    valid = (cache_pos >= 0) & (cache_pos <= t)
    if cfg.sliding_window is not None:
        valid = valid & (cache_pos > t - cfg.sliding_window)
    return valid


def _attend_slice(q, k_new, v_new, cache_k, cache_v, cache_pos, t: int, cfg: ModelConfig,
                  seq: ModelGroup, dtype) -> torch.Tensor:
    """One query's attention, every head, over a cache split by sequence
    over the model group ``seq``:
    → (B, 1, H·dh) in fp32, the same on every rank of the group.

    The global slot ``t % S_max`` (the ring slot, so the ring wraps across
    the ranks) takes the new k and v on the rank that owns it; every rank
    writes the position into the whole ``cache_pos`` it holds, so the
    replicas stay equal. The scores over this rank's valid slots are the
    one-card code's; the group's MAX of their row maxima gives m, a SUM of
    each rank's l_r = Σ exp(s − m) gives l, and each rank's probabilities
    exp(s − m) / l, rounded to ``dtype`` as the one-card code rounds its
    softmax, weigh its values in fp32: a SUM of those o_r gives o, cast
    once to ``dtype`` by the caller. (Rounding none of them, one
    all-reduce of [l_r, o_r] rescaled by exp(m_r − m), rounds every
    probability otherwise than the one-card code, and over a full-depth
    bf16 model that sits several times the bf16 limit from it: PERF.md §6,
    serving over ranks.) A slice with no valid slot has its row maximum NEG_INF (finite)
    and its numerators masked to 0, so it adds nothing and no
    exp(−inf − (−inf)) is taken; the owner of slot ``t % S_max`` always
    holds a valid slot, so m is finite.
    """
    b = q.shape[0]
    kv_heads, dh = cfg.n_kv_heads, cfg.head_dim
    rep = cfg.n_heads // kv_heads
    s_loc = cache_k.shape[1]
    lo = seq.rank * s_loc
    slot = t % cache_pos.shape[0]
    if lo <= slot < lo + s_loc:
        cache_k[:, slot - lo] = k_new[:, 0]
        cache_v[:, slot - lo] = v_new[:, 0]
    cache_pos[slot].fill_(t)
    valid = _valid_slots(cache_pos[lo:lo + s_loc], t, cfg)

    q = q.reshape(b, 1, kv_heads, rep, dh)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", q, cache_k) / math.sqrt(dh)
    scores = scores.masked_fill(~valid, NEG_INF).float()
    m = scores.amax(dim=-1, keepdim=True)  # (B, KV, rep, 1, 1)
    seq.all_max(m)
    e = torch.exp(scores - m).masked_fill(~valid, 0.0)
    l = e.sum(dim=-1, keepdim=True)
    seq.all_sum(l)
    probs = (e / l).to(dtype).float()
    o = torch.einsum("bgrqk,bkgd->bgrqd", probs, cache_v.float())
    seq.all_sum(o)
    return o.permute(0, 3, 1, 2, 4).reshape(b, 1, kv_heads * rep * dh)


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, d_ff: int, lead: tuple = (), device=None):
    return {
        "w_gate": dense_init(gen, (*lead, d, d_ff), device=device),
        "w_in": dense_init(gen, (*lead, d, d_ff), device=device),
        "w_out": dense_init(gen, (*lead, d_ff, d), device=device),
    }


def mlp_fwd(params, x, dtype=torch.float32, group: Optional[ModelGroup] = None):
    """SwiGLU; over a model ``group`` on this rank's columns of ``w_gate``
    and ``w_in`` (``x`` entering them through :func:`copy_to_group`) and
    those rows of ``w_out``, summed over the group."""
    x = copy_to_group(x, group)
    g = F.silu(x @ params["w_gate"].to(dtype))
    u = x @ params["w_in"].to(dtype)
    return row_split_matmul(g * u, params["w_out"], dtype, group)


# --------------------------------------------------------------------------
# Mixture of Experts (capacity-based GShard dispatch)
# --------------------------------------------------------------------------


def init_moe(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (), device=None):
    """The router (d, E) at scale 0.02, the experts' SwiGLU stacked over E
    (``w_gate``, ``w_in`` (E, d, f), ``w_out`` (E, f, d)) and, with
    ``n_shared_experts``, an always-on shared MLP of width f · n_shared."""
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_ff_expert, moe.n_experts
    p = {
        "router": dense_init(gen, (*lead, d, e), scale=0.02, device=device),
        "w_gate": dense_init(gen, (*lead, e, d, f), device=device),
        "w_in": dense_init(gen, (*lead, e, d, f), device=device),
        "w_out": dense_init(gen, (*lead, e, f, d), device=device),
    }
    if moe.n_shared_experts:
        p["shared"] = init_mlp(gen, d, f * moe.n_shared_experts, lead, device=device)
    return p


def moe_capacity(n_tokens: int, moe) -> int:
    """Slots an expert has in a group of ``n_tokens``: ⌈n·k/E·cf⌉, at least k."""
    cap = int(math.ceil(n_tokens * moe.top_k / moe.n_experts * moe.capacity_factor))
    return max(cap, moe.top_k)


MOE_GROUP_SIZE = 1024  # routing-group size (GShard "G"); capacity is per group


def _moe_group_size(n_tok: int) -> int:
    """The largest divisor of ``n_tok`` that is at most MOE_GROUP_SIZE."""
    gs = min(MOE_GROUP_SIZE, n_tok)
    while n_tok % gs:
        gs -= 1
    return gs


class MoERoute(NamedTuple):
    """The routing decisions of one :func:`moe_fwd` call over G groups of n
    tokens: the fp32 router probabilities (G, n, E), the top-k gates
    renormalised (G, n, k) and their experts (G, n, k), each (token, slot)'s
    position in its expert's buffer (G, k, n; slot-major), whether that
    position is below the capacity (G, k, n; the others are dropped), and
    the capacity. Over data ranks a rank's route holds its own tokens: in
    the batch's routing groups where they hold whole groups, else as one
    row of n tokens (G = 1) at their positions in the batch's groups;
    :func:`whole_route` joins the ranks' routes into the batch's."""

    probs: torch.Tensor
    gate_vals: torch.Tensor
    gate_idx: torch.Tensor
    pos: torch.Tensor
    within: torch.Tensor
    cap: int


class DataGroup(NamedTuple):
    """The data ranks whose rows make up one batch: this rank's place and
    their count, the group's in-place SUM of a tensor and ``all_gather(x,
    dim)``, every rank's ``x`` concatenated along ``dim`` in rank order
    (each counted by the mesh that runs it; ``launch/steps.py::data_group``).
    A MoE layer routes its rank's tokens in the whole batch's groups over
    it (:func:`moe_fwd`); ``None`` is one card, or one data rank."""

    rank: int
    size: int
    all_sum: Callable[[torch.Tensor], None]
    all_gather: Callable[[torch.Tensor, int], torch.Tensor]


class _NoDerivative(torch.autograd.Function):
    """``fn(x)`` (a collective over a group, on a fresh tensor), carrying no
    derivative: no gradient and no tangent."""

    @staticmethod
    def forward(x, fn):
        return fn(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, grad):
        return None, None

    @staticmethod
    def jvp(ctx, tangent, _):
        return None


def _summed_over_data(x: torch.Tensor, data: DataGroup) -> torch.Tensor:
    """The data group's SUM of every rank's ``x``, no derivative."""
    def run(y):
        out = y.clone(memory_format=torch.contiguous_format)
        data.all_sum(out)
        return out
    return _NoDerivative.apply(x.detach(), run)


def _gathered_over_data(x: torch.Tensor, data: DataGroup, dim: int) -> torch.Tensor:
    """Every data rank's ``x`` concatenated along ``dim``, no derivative."""
    return _NoDerivative.apply(x.detach(), lambda y: data.all_gather(y, dim))


def _slot_positions(e_tok: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each (slot, token)'s place in its expert's buffer, e_tok (G, k·n) the
    experts of a group's choices slot-major: a cumulative count a group."""
    onehot = (e_tok[..., None] == torch.arange(n_experts, device=e_tok.device)).to(torch.int32)
    return onehot.cumsum(1).gather(2, e_tok[..., None])[..., 0] - 1  # ≥ 0


def moe_route(params, xt: torch.Tensor, cfg: ModelConfig, dtype,
              data: Optional[DataGroup] = None) -> MoERoute:
    """Route the tokens of xt (G, n, d) as the reference does
    (``layers.py:375-405``): the router's logits in ``dtype`` then fp32, the
    softmax, the top k (ties to the lower expert, as ``jax.lax.top_k``: a
    stable descending sort over E), renormalised; positions by a cumulative
    count over the k·gs (slot, token) pairs of a group, slot outer, so
    every slot-0 choice of a group ranks before any slot-1 choice.

    Without ``data`` xt's G rows are the groups. Over the data ranks
    ``data`` the groups are the whole batch's, gs = ``_moe_group_size(R ·
    G · n)`` tokens (the ranks' tokens in rank order): where n = gs xt
    holds whole groups and routes as one process does; otherwise xt is this
    rank's tokens as one row (G = 1), every rank's top-k experts are
    gathered over ``data`` ((k, n) int32 a rank, no derivative), the
    positions counted over the whole batch's groups, and this rank's kept."""
    moe = cfg.moe
    n_groups, n, _ = xt.shape
    e, k = moe.n_experts, moe.top_k
    gs = n if data is None else _moe_group_size(data.size * n_groups * n)
    cap = moe_capacity(gs, moe)
    logits = (xt @ params["router"].to(dtype)).float()  # (G, n, E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :k], idx[..., :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    e_tok = gate_idx.transpose(1, 2)  # (G, k, n), slot-major
    if n == gs:
        pos = _slot_positions(e_tok.reshape(n_groups, k * n), e).reshape(n_groups, k, n)
    else:
        if n_groups != 1:
            raise ValueError(f"{n_groups} rows of {n} tokens are not groups of {gs}")
        every = _gathered_over_data(e_tok[0].to(torch.int32), data, 1)  # (k, R·n)
        whole = every.reshape(k, -1, gs).transpose(0, 1)                 # (Gw, k, gs)
        pos = _slot_positions(whole.reshape(-1, k * gs).long(), e).reshape(-1, k, gs)
        pos = pos.transpose(0, 1).reshape(k, -1)[None, :, data.rank * n:(data.rank + 1) * n]
    return MoERoute(probs, gate_vals, gate_idx, pos, pos < cap, cap)


def whole_route(parts: list) -> MoERoute:
    """The whole batch's route of one MoE layer from its data ranks'
    routes (``parts``, in rank order; :class:`MoERoute`): the tokens joined
    in rank order and laid out in the batch's groups, as one process over
    the whole batch routes them."""
    def tokens(x, slot_major):  # (G, n, ·) or (G, k, n) → (G·n, ·)
        x = x.transpose(1, 2) if slot_major else x
        return x.reshape(-1, x.shape[-1])
    fields = [torch.cat([tokens(getattr(p, f), f in ("pos", "within")) for p in parts])
              for f in ("probs", "gate_vals", "gate_idx", "pos", "within")]
    gs = _moe_group_size(fields[0].shape[0])

    def groups(x, slot_major):
        x = x.reshape(-1, gs, x.shape[-1])
        return x.transpose(1, 2) if slot_major else x

    return MoERoute(*(groups(x, i >= 3) for i, x in enumerate(fields)), parts[0].cap)


def moe_fwd(params, x, cfg: ModelConfig, dtype=torch.float32,
            data: Optional[DataGroup] = None, want_aux: bool = True):
    """Capacity-limited top-k MoE with scatter/gather dispatch → (out (B, S,
    D), aux). x: (B, S, D).

    Tokens are routed in groups of :func:`_moe_group_size` (≤
    MOE_GROUP_SIZE) with a capacity of :func:`moe_capacity` a group and
    expert (:func:`moe_route`). Dispatch copies each kept (token, slot) into
    its expert's row of one (E, G, cap + 1, D) buffer in one out-of-place
    ``index_copy`` (each kept row is written once, no atomic add; out of
    place, so ``torch.func.jvp`` takes it); a dropped one goes to row
    ``cap`` as zeros, so that row reads back as 0, as the reference's
    ``mode="drop"`` scatter and ``fill_value=0`` gather make it. The
    experts' SwiGLU is three batched products over E; the output sums each
    token's slots in k order, each weighted by its gate (0 when dropped),
    then adds the shared expert.
    ``aux`` is the Switch load-balance loss, E · Σ_e (share of tokens whose
    first choice is e) · (mean probability of e), over all tokens.

    Over the data ranks ``data`` x is this rank's rows of the batch, in
    rank order (FL-device-major, as ``batch_pspecs`` lays them out): the
    tokens route in the whole batch's groups (:func:`moe_route`), and the
    rank's buffer holds its own tokens at their positions there, G the
    groups they touch (a token's expert output depends on its own row
    alone, so no token crosses ranks). The aux is this rank's share,
    E · Σ_e (the batch's first-choice share of e: one SUM of the E counts
    over ``data``, no derivative) · (this rank's mean probability of e):
    with equal token counts a rank, the mean over the data ranks of it is
    the batch's aux in value and gradient. With ``want_aux`` false (a pass
    that drops the aux) that SUM is not taken and the aux is ``None``.
    """
    moe = cfg.moe
    b, s, d = x.shape
    n_tok = b * s
    e, k = moe.n_experts, moe.top_k
    gs = _moe_group_size(_ways(data) * n_tok)
    lo = 0 if data is None else data.rank * n_tok  # this rank's first token in the batch
    xt = x.reshape(n_tok // gs, gs, d) if n_tok % gs == 0 else x.reshape(1, n_tok, d)
    r = moe_route(params, xt, cfg, dtype, data)
    for tap in getattr(_ROUTE_TAPS, "lists", ()):
        tap.append(r)
    cap, rows = r.cap, r.cap + 1

    first = (r.gate_idx[..., 0].reshape(-1, 1) == torch.arange(e, device=x.device)).float()
    frac_probs = r.probs.reshape(-1, e).mean(0)
    if data is None:
        aux = e * (first.mean(0) * frac_probs).sum()
    elif want_aux:
        aux = e * (_summed_over_data(first.sum(0), data) / (data.size * n_tok)
                   * frac_probs).sum()
    else:
        aux = None

    # flat row of each (slot, token) in the (E, G, cap + 1) buffer, G the
    # groups this rank's tokens touch
    n_groups = (lo + n_tok - 1) // gs - lo // gs + 1
    group = ((torch.arange(n_tok, device=x.device) + lo) // gs - lo // gs) * rows
    pos = r.pos.transpose(0, 1).reshape(k, n_tok)  # a slot's positions in the tokens' order
    within = r.within.transpose(0, 1).reshape(k, n_tok)
    row = (r.gate_idx.reshape(n_tok, k).T * (n_groups * rows) + group
           + torch.where(within, pos, cap))  # (k, n_tok)
    within = within[..., None]
    # a dropped copy carries 0, so every write to row cap is a 0 and their
    # order does not matter
    src = torch.where(within, x.reshape(1, n_tok, d), 0.0)
    buf = torch.zeros((e * n_groups * rows, d), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, row.reshape(k * n_tok), src.reshape(k * n_tok, d))

    xe = buf.view(e, n_groups * rows, d)
    g = F.silu(torch.bmm(xe, params["w_gate"].to(dtype)))
    u = torch.bmm(xe, params["w_in"].to(dtype))
    ye = torch.bmm(g * u, params["w_out"].to(dtype)).view(e * n_groups * rows, d)

    gv = (r.gate_vals.reshape(n_tok, k).T[..., None] * within).to(dtype)  # (k, n_tok, 1)
    out = torch.zeros((n_tok, d), dtype=x.dtype, device=x.device)
    for kk in range(k):
        out = out + ye.index_select(0, row[kk]) * gv[kk]
    out = out.reshape(b, s, d)
    if moe.n_shared_experts:
        out = out + mlp_fwd(params["shared"], x, dtype)
    return out, aux


_ROUTE_TAPS = threading.local()  # .lists: the lists recorded_routes fills, by thread


@contextlib.contextmanager
def recorded_routes():
    """→ a list that gets every :class:`MoERoute` :func:`moe_fwd` takes in
    this thread while the context is open, in call order (as they are, on
    their device: no copy, no wait)."""
    seen: list = []
    if not hasattr(_ROUTE_TAPS, "lists"):
        _ROUTE_TAPS.lists = []
    _ROUTE_TAPS.lists.append(seen)
    try:
        yield seen
    finally:
        _ROUTE_TAPS.lists.remove(seen)


# --------------------------------------------------------------------------
# Mamba2 (SSD: state-space duality, arXiv:2405.21060)
# --------------------------------------------------------------------------


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (), device=None):
    """in_proj → [z (di), x (di), B (n), C (n), dt (nh)]: one B/C group."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh, n = s.d_inner(d), s.n_heads(d), s.d_state
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, device=device))
    return {
        "in_proj": dense_init(gen, (*lead, d, 2 * di + 2 * n + nh), device=device),
        "conv_w": dense_init(gen, (*lead, s.conv_kernel, di + 2 * n), scale=0.5, device=device),
        "conv_b": torch.zeros((*lead, di + 2 * n), device=device),
        "A_log": a_log.expand(*lead, nh).clone(),
        "dt_bias": torch.zeros((*lead, nh), device=device),
        "D": torch.ones((*lead, nh), device=device),
        "norm": init_rmsnorm(di, lead, device=device),
        "out_proj": dense_init(gen, (*lead, di, d), device=device),
    }


def _split_mamba_proj(zxbcdt, di: int, n: int, nh: int):
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:]


def _mamba_dims(cfg: ModelConfig, group: Optional[ModelGroup]) -> tuple[int, int, int]:
    """(di, nh, n) of the heads a rank computes: every head, or over
    ``group`` its nh/M heads and their di/M channels; n whole."""
    s, ways = cfg.ssm, _ways(group)
    return s.d_inner(cfg.d_model) // ways, s.n_heads(cfg.d_model) // ways, s.d_state


def _shared_bc(w: torch.Tensor, lo: int, n: int, group: Optional[ModelGroup]) -> torch.Tensor:
    """``w`` with its B and C columns ``[lo, lo + 2n)`` entering through
    :func:`copy_to_group`: whole on every rank of ``group`` but feeding only
    the rank's heads, so each rank's gradient of them is a part, summed
    over the group (dL/dB itself is not summed: the input's
    ``copy_to_group`` already sums what flows back through it)."""
    if group is None:
        return w
    return torch.cat([w[..., :lo], copy_to_group(w[..., lo:lo + 2 * n], group),
                      w[..., lo + 2 * n:]], dim=-1)


def _mamba_proj(params, x, cfg: ModelConfig, dtype, group: Optional[ModelGroup] = None):
    """``x @ in_proj`` split into z, xBC, dt of the rank's heads; over
    ``group`` x enters through :func:`copy_to_group` and the B, C columns
    through :func:`_shared_bc`."""
    di, nh, n = _mamba_dims(cfg, group)
    w = _shared_bc(params["in_proj"].to(dtype), 2 * di, n, group)
    return _split_mamba_proj(copy_to_group(x, group) @ w, di, n, nh)


def causal_conv1d(xbc, w, b):
    """Depthwise causal conv over the sequence dim, xbc (B, S, C), w (K, C):
    ``Σ_i pad[:, i:i+S] · w[i]`` over the left-padded input (no flip)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return out + b


def _conv_weights(params, cfg: ModelConfig, dtype, group: Optional[ModelGroup]):
    """``conv_w`` and ``conv_b`` in ``dtype``, their B and C channels through
    :func:`_shared_bc` over ``group``."""
    di, _, n = _mamba_dims(cfg, group)
    return (_shared_bc(params["conv_w"].to(dtype), di, n, group),
            _shared_bc(params["conv_b"].to(dtype), di, n, group))


def mamba_inputs(params, xbc, dt, cfg: ModelConfig, dtype, group: Optional[ModelGroup] = None):
    """The scan's inputs from the conv's input xbc and the raw dt:
    ``(xh (B, S, nh, P), xdt, la (B, S, nh) fp32, B, C)``. dt is
    ``softplus(dt + dt_bias)`` in fp32, la = −exp(A_log)·dt in fp32, and
    ``xdt = xh · dt`` in ``dtype`` (``layers.py:548-556``). Over ``group``
    the rank's heads."""
    di, nh, n = _mamba_dims(cfg, group)
    xbc = F.silu(causal_conv1d(xbc, *_conv_weights(params, cfg, dtype, group)))
    xin, B, C = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + params["dt_bias"])
    la = -torch.exp(params["A_log"])[None, None, :] * dt
    xh = xin.reshape(*xin.shape[:-1], nh, cfg.ssm.head_dim)
    xdt = xh * dt[..., None].to(dtype)
    return xh, xdt, la.float(), B, C


def _gated_rmsnorm(scale, y, eps: float, width: int, group: Optional[ModelGroup]):
    """rmsnorm of y over its ``width`` channels, fp32 inside. Over
    ``group`` y holds the rank's channels: the statistic is the group's SUM
    of each rank's sum of squares, and so is its gradient, since every
    rank's output depends on it (``copy_to_group(sum_over_group(·))``: a
    SUM forward and backward, the tangent summed)."""
    if group is None:
        return rmsnorm({"scale": scale}, y, eps)
    y32 = y.float()
    ss = copy_to_group(sum_over_group((y32 * y32).sum(dim=-1, keepdim=True), group), group)
    return (y32 * torch.rsqrt(ss / width + eps) * scale).to(y.dtype)


def mamba_out(params, y, xh, z, cfg: ModelConfig, dtype, group: Optional[ModelGroup] = None):
    """``rmsnorm(y + D·xh) · silu(z) @ out_proj``: the reference's gated norm
    order (norm first, then the gate). Over ``group`` the rank's channels,
    the norm's statistic over every rank's (:func:`_gated_rmsnorm`) and
    ``out_proj``'s rows summed over the group (:func:`row_split_matmul`)."""
    di = cfg.ssm.d_inner(cfg.d_model)
    y = y + params["D"].to(dtype)[..., :, None] * xh
    y = y.reshape(*y.shape[:-2], di // _ways(group))
    y = _gated_rmsnorm(params["norm"]["scale"], y, cfg.norm_eps, di, group) * F.silu(z)
    return row_split_matmul(y, params["out_proj"], dtype, group)


def mamba2_fwd(params, x, cfg: ModelConfig, dtype=torch.float32, chunk: Optional[int] = None,
               group: Optional[ModelGroup] = None):
    """Full-sequence Mamba2 block (prefill). x: (B, S, D); the scan runs in
    chunks of ``chunk`` (``cfg.ssm.chunk_size`` by default), which must
    divide S. Over a model ``group`` ``params`` are this rank's TP blocks
    (``launch/sharding.py::tp_pspecs``) and the scan runs on its nh/M
    heads."""
    z, xbc, dt = _mamba_proj(params, x, cfg, dtype, group)
    xh, xdt, la, B, C = mamba_inputs(params, xbc, dt, cfg, dtype, group)
    y = ssd(xdt, la, B, C, chunk=chunk or cfg.ssm.chunk_size)
    return mamba_out(params, y, xh, z, cfg, dtype, group)


def conv_channels(cfg: ModelConfig, group: Optional[ModelGroup]) -> int:
    """The conv window's channels a rank caches: its block of the di + 2n
    where the group splits them evenly (``launch/sharding.py::cache_pspecs``),
    else all of them."""
    c = cfg.ssm.d_inner(cfg.d_model) + 2 * cfg.ssm.d_state
    return c // _ways(group) if c % _ways(group) == 0 else c


def conv_block(xbc_tail, cfg: ModelConfig, group: Optional[ModelGroup]):
    """The conv cache's block (:func:`conv_channels`) from a rank's last
    K−1 conv inputs ``xbc_tail`` (B, K−1, di/M + 2n), its heads' x channels
    then B and C: the group gathers every rank's x channels (one gather).
    Without a group, ``xbc_tail`` itself."""
    if group is None:
        return xbc_tail
    di, _, n = _mamba_dims(cfg, group)
    whole = torch.cat([gather_from_group(xbc_tail[..., :di], 2, group), xbc_tail[..., di:]], -1)
    return _channel_block(whole, cfg, group)


def _channel_block(whole, cfg: ModelConfig, group: ModelGroup):
    """The rank's block (:func:`conv_channels`) of a whole conv window's
    channels (last dim)."""
    n = conv_channels(cfg, group)
    return whole[..., group.rank * n:(group.rank + 1) * n] if n < whole.shape[-1] else whole


def _decode_window(conv_state, xbc, cfg: ModelConfig, group: Optional[ModelGroup]):
    """→ (the conv's K inputs of the rank's channels, the new conv cache
    block): the cached K−1 rows then the new token's. Over ``group`` the
    cache holds the rank's block of the channels (:func:`conv_block`) and
    xbc its heads' x channels and B, C: one gather of every rank's cache
    block and new x channels side by side makes the whole window, of which
    the rank takes its channels and its cache block."""
    if group is None:
        window = torch.cat([conv_state, xbc], dim=1)
        return window, window[:, 1:]
    di, _, n = _mamba_dims(cfg, group)
    b, k1, c = conv_state.shape
    whole_c = di * group.size + 2 * n
    split = c < whole_c
    payload = xbc[..., :di].reshape(b, 1, di)
    if split:
        payload = torch.cat([conv_state.reshape(b, 1, k1 * c), payload], dim=-1)
    every = gather_from_group(payload, 1, group)  # (B, M, ·), in rank order
    old = (every[..., :k1 * c].reshape(b, group.size, k1, c).transpose(1, 2)
           .reshape(b, k1, whole_c) if split else conv_state)
    x_new = every[..., -di:].reshape(b, 1, di * group.size)
    window = torch.cat([old, torch.cat([x_new, xbc[..., di:]], dim=-1)], dim=1)
    mine = torch.cat([window[..., group.rank * di:(group.rank + 1) * di],
                      window[..., whole_c - 2 * n:]], dim=-1)
    return mine, _channel_block(window[:, 1:], cfg, group)


def mamba2_decode(params, x, cfg: ModelConfig, ssm_state, conv_state, dtype=torch.float32,
                  group: Optional[ModelGroup] = None):
    """Single-token recurrent step. x: (B, 1, D); ssm_state (B, H, N, P);
    conv_state (B, K-1, di+2n). Returns (out, new_state, new_conv_state),
    new tensors; the state is updated in ``dtype`` (with the decay cast to
    it first), as in the reference. Over a model ``group`` ``params`` are
    this rank's TP blocks, ssm_state its heads and conv_state its block of
    the window's channels (:func:`_decode_window`)."""
    di, nh, n = _mamba_dims(cfg, group)
    z, xbc, dt = _mamba_proj(params, x, cfg, dtype, group)  # (B,1,·)

    window, new_conv_state = _decode_window(conv_state, xbc, cfg, group)
    conv_w, conv_b = _conv_weights(params, cfg, dtype, group)
    conv_out = torch.einsum("bkc,kc->bc", window, conv_w) + conv_b
    xbc1 = F.silu(conv_out)[:, None, :]

    xin = xbc1[..., :di]
    B = xbc1[:, 0, di:di + n]  # (B, n)
    C = xbc1[:, 0, di + n:]

    dt = F.softplus(dt[:, 0].float() + params["dt_bias"])  # (B, nh)
    a = torch.exp(-torch.exp(params["A_log"])[None] * dt)  # (B, nh)
    xh = xin[:, 0].reshape(-1, nh, cfg.ssm.head_dim)
    xdt = xh * dt[..., None].to(dtype)

    new_state = a[..., None, None].to(dtype) * ssm_state + torch.einsum("bn,bhp->bhnp", B, xdt)
    y = torch.einsum("bn,bhnp->bhp", C, new_state)
    out = mamba_out(params, y[:, None], xh[:, None], z, cfg, dtype, group)
    return out, new_state, new_conv_state
