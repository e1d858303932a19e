"""Decode caches: the KV cache of attention layers (full or ring-buffer) and
the recurrent state of SSM layers.

Port of the attention and SSM parts of ``repro.models.cache``. The hybrid
and enc-dec caches wait for their families (``init_cache`` raises naming
the ROADMAP item).
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


def pad_cache(cache, total_len: int):
    """Grow a prefill-sized cache to decode capacity ``total_len``: an
    attention cache's sequence dim gains empty slots (zeros, pos = -1); an
    SSM state is O(1) and comes back unchanged."""
    if isinstance(cache, SSMCache):
        return cache
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
    check_ported(cfg)
    if cfg.arch_type == "ssm":
        return init_ssm_cache(cfg, batch, dtype=dtype, device=device)
    return init_attn_cache(cfg, batch, context_len, dtype=dtype, device=device)
