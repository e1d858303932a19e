"""Decode caches: the KV cache of attention layers (full or ring-buffer),
the recurrent state of SSM layers, the hybrid's pair of them, and the
enc-dec decoder's self-attention cache beside its fixed cross-attention
keys and values.

Port of ``repro.models.cache``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import check_ported


class AttnCache(NamedTuple):
    k: torch.Tensor    # (L, B, S_cache, KV, dh)
    v: torch.Tensor    # (L, B, S_cache, KV, dh)
    pos: torch.Tensor  # (S_cache,) absolute position per slot, -1 = empty


class SSMCache(NamedTuple):
    state: torch.Tensor  # (L, B, H, N, P)
    conv: torch.Tensor   # (L, B, K-1, di+2n): the last K-1 inputs of the conv


class HybridCache(NamedTuple):
    ssm: SSMCache    # every Mamba2 layer's state and conv window
    attn: AttnCache  # leading dim = n_shared_invocations: one KV cache an invocation


class EncDecCache(NamedTuple):
    self_attn: AttnCache    # decoder self-attention cache
    cross_k: torch.Tensor   # (L, B, S_enc, KV, dh): encoder keys (fixed, not roped)
    cross_v: torch.Tensor


def cache_leaves(cache) -> list[torch.Tensor]:
    """The tensors of a cache, nested caches flattened in field order."""
    if isinstance(cache, tuple):
        return [leaf for c in cache for leaf in cache_leaves(c)]
    return [cache]


def cache_to(cache, device):
    """The cache with every tensor on ``device`` (the same tensors if they
    are there already), its type and nesting kept."""
    if isinstance(cache, tuple):
        return type(cache)(*(cache_to(c, device) for c in cache))
    return cache.to(device)


def seq_splits(n_slots: int, ways: int) -> bool:
    """Whether a cache of ``n_slots`` splits its sequence ``ways`` ways over
    "model" (``launch.sharding.cache_pspecs``): evenly, one slot a rank at
    least."""
    return n_slots % ways == 0 and n_slots >= ways


def slot_block(n_slots: int, rank: int, ways: int) -> tuple[int, int]:
    """The slots ``[lo, hi)`` that place ``rank`` of ``ways`` model ranks
    holds of a cache of ``n_slots``: its block where the sequence splits
    (:func:`seq_splits`), else every slot."""
    if not seq_splits(n_slots, ways):
        return 0, n_slots
    n = n_slots // ways
    return rank * n, (rank + 1) * n


def cache_seq_len(cfg: ModelConfig, context_len: int) -> int:
    """Ring-buffer caches only keep the window."""
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, context_len)
    return context_len


def init_attn_cache(cfg: ModelConfig, batch: int, context_len: int,
                    n_layers: Optional[int] = None, dtype=torch.float32,
                    device=None) -> AttnCache:
    """An empty cache on ``device`` (``resolve_device``: the card unless the
    caller names another)."""
    device = resolve_device(device)
    n = n_layers if n_layers is not None else cfg.n_layers
    s = cache_seq_len(cfg, context_len)
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    return AttnCache(
        k=torch.zeros((n, batch, s, kv, dh), dtype=dtype, device=device),
        v=torch.zeros((n, batch, s, kv, dh), dtype=dtype, device=device),
        pos=torch.full((s,), -1, dtype=torch.int32, device=device),
    )


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None) -> SSMCache:
    """A zero state on ``device`` (``resolve_device``), O(1) in the context."""
    device = resolve_device(device)
    s, d = cfg.ssm, cfg.d_model
    return SSMCache(
        state=torch.zeros((cfg.n_layers, batch, s.n_heads(d), s.d_state, s.head_dim),
                          dtype=dtype, device=device),
        conv=torch.zeros((cfg.n_layers, batch, s.conv_kernel - 1, s.d_inner(d) + 2 * s.d_state),
                         dtype=dtype, device=device),
    )


def n_shared_invocations(cfg: ModelConfig) -> int:
    """How often a hybrid runs its shared block: ⌈L / attn_every⌉ (layers
    0, every, 2·every, …; the last group may be partial)."""
    return (cfg.n_layers + cfg.hybrid.attn_every - 1) // cfg.hybrid.attn_every


def pad_cache(cache, total_len: int):
    """Grow a prefill-sized cache to decode capacity ``total_len``: an
    attention cache's sequence dim gains empty slots (zeros, pos = -1); an
    SSM state is O(1) and comes back unchanged; a hybrid cache pads its
    attention part only, an enc-dec cache its self-attention part only."""
    if isinstance(cache, SSMCache):
        return cache
    if isinstance(cache, HybridCache):
        return HybridCache(ssm=cache.ssm, attn=pad_cache(cache.attn, total_len))
    if isinstance(cache, EncDecCache):
        return EncDecCache(self_attn=pad_cache(cache.self_attn, total_len),
                           cross_k=cache.cross_k, cross_v=cache.cross_v)
    extra = total_len - cache.k.shape[2]
    if extra <= 0:
        return cache
    pad = (0, 0, 0, 0, 0, extra)  # (dh, KV, S) from the last dim back
    return AttnCache(
        k=torch.nn.functional.pad(cache.k, pad),
        v=torch.nn.functional.pad(cache.v, pad),
        pos=torch.nn.functional.pad(cache.pos, (0, extra), value=-1),
    )


def init_cache(cfg: ModelConfig, batch: int, context_len: int, dtype=torch.float32,
               device=None):
    """An empty decode cache of ``cfg``'s family on ``device``
    (``resolve_device``): an ``SSMCache`` (ssm), a ``HybridCache`` whose
    attention part has one KV cache a shared-block invocation (hybrid), an
    ``EncDecCache`` whose cross keys and values hold ``encdec.n_enc_frames``
    frames (encdec), else an ``AttnCache`` (dense, moe, vlm: a VLM's
    positions count its patches)."""
    check_ported(cfg)
    if cfg.arch_type == "ssm":
        return init_ssm_cache(cfg, batch, dtype=dtype, device=device)
    if cfg.arch_type == "hybrid":
        return HybridCache(
            ssm=init_ssm_cache(cfg, batch, dtype=dtype, device=device),
            attn=init_attn_cache(cfg, batch, context_len, n_layers=n_shared_invocations(cfg),
                                 dtype=dtype, device=device),
        )
    if cfg.arch_type == "encdec":
        dims = (cfg.n_layers, batch, cfg.encdec.n_enc_frames, cfg.n_kv_heads, cfg.head_dim)
        dev = resolve_device(device)
        return EncDecCache(
            self_attn=init_attn_cache(cfg, batch, context_len, dtype=dtype, device=dev),
            cross_k=torch.zeros(dims, dtype=dtype, device=dev),
            cross_v=torch.zeros(dims, dtype=dtype, device=dev),
        )
    return init_attn_cache(cfg, batch, context_len, dtype=dtype, device=device)
