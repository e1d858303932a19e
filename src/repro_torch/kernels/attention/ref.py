"""Plain PyTorch versions of attention: the JAX oracle and the kernel's own.

Two functions, one semantics each:

- :func:`mha_ref` ports ``repro.kernels.attention.ref.mha_ref``: masked
  softmax with ``-inf``, probabilities rounded to q's type before the PV
  product, so a query row that sees no key gives NaN.
- :func:`flash_attention_ref` is the plain version of the flash kernel
  (``repro/kernels/attention/kernel.py:33-100``): fp32 scores of
  ``q·scale`` against k, masked to ``-1e30``, ``p = where(mask, exp(s − m),
  0)``, fp32 PV, and ``acc / l`` with ``l = 1`` where ``l == 0``
  (``safe_l``), so a row that sees no key gives 0. The output is in q's
  type. It is the CPU path of :func:`repro_torch.kernels.attention.ops.attention`
  and the oracle the CUDA kernel is held to.

Shapes: q (b, sq, h, dh), k and v (b, sk, kv, dh); query head ``hi``
reads kv head ``hi // (h // kv)`` (GQA). Query row i sits at absolute
position ``i + q_offset`` and sees key j when ``j ≤ i + q_offset``
(causal) and ``j > i + q_offset − window`` (sliding window).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_scores_mask(s_q: int, s_k: int, q_offset: int = 0, causal: bool = True,
                          sliding_window: Optional[int] = None, device=None) -> torch.Tensor:
    """(s_q, s_k) boolean mask; True = attend. q position i_abs = i + q_offset.

    Port of ``repro.models.layers.attention_scores_mask``, the mask of both
    plain versions here (``repro_torch.models.layers`` re-exports it)."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    kj = torch.arange(s_k, device=device)[None, :]
    m = torch.ones((s_q, s_k), dtype=torch.bool, device=device)
    if causal:
        m = m & (kj <= qi)
    if sliding_window is not None:
        m = m & (kj > qi - sliding_window)
    return m


def _grouped(q, k):
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    return q.reshape(b, sq, kv, h // kv, dh)


def mha_ref(q, k, v, *, causal: bool = True, sliding_window: Optional[int] = None,
            q_offset: int = 0) -> torch.Tensor:
    """Returns (b, sq, h, dh): softmax attention with ``-inf`` masking."""
    b, sq, h, dh = q.shape
    qg = _grouped(q, k)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) / math.sqrt(dh)
    mask = attention_scores_mask(sq, k.shape[1], q_offset, causal, sliding_window, q.device)
    scores = scores.masked_fill(~mask, -math.inf)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v)
    return out.reshape(b, sq, h, dh)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        sliding_window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Returns (b, sq, h, dh) in q's type; the flash kernel's semantics."""
    b, sq, h, dh = q.shape
    qg = _grouped(q.float() * (1.0 / math.sqrt(dh)), k)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float())
    mask = attention_scores_mask(sq, k.shape[1], q_offset, causal, sliding_window, q.device)
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgrqk,bkgd->bgrqd", p, v.float())
    out = acc / torch.where(l > 0, l, 1.0)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).to(q.dtype)
