"""Public op: attention, dispatched by the device of ``q``.

A CPU tensor (or a meta one: shapes only, as the dry run counts FLOPs)
goes to the kernel's plain PyTorch version, which autograd
and ``torch.func.jvp`` differentiate as they find it; a CUDA tensor goes to
the hand-written kernel through
:data:`~repro_torch.kernels.attention.autograd.FlashAttention`, whose
backward and jvp are the plain version's, or the call raises. The
reference's ``use_pallas="auto"`` has no counterpart: nothing can quietly
choose the plain version on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.attention.autograd import FlashAttention
from repro_torch.kernels.attention.ref import flash_attention_ref


def attention(q, k, v, *, causal: bool = True, sliding_window: Optional[int] = None,
              q_offset: int = 0) -> torch.Tensor:
    """softmax(q kᵀ/√dh) v over the visible keys → (b, sq, h, dh) in q's type."""
    if q.device.type in ("cpu", "meta"):  # meta: shapes only (the dry run)
        return flash_attention_ref(q, k, v, causal=causal, sliding_window=sliding_window,
                                   q_offset=q_offset)
    if q.device.type == "cuda":
        return FlashAttention.apply(q, k, v, causal, sliding_window, q_offset)
    raise ValueError(f"attention: no path for device {q.device}")
