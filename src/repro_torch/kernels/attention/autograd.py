"""Attention's gradient and tangent rules around a forward that has none.

The flash kernel writes its result through ``ctypes`` into a fresh tensor,
so autograd sees no operation: a ``loss.backward()`` through it would give
q, k and v no gradient at all, and ``torch.func.jvp`` could not unwrap its
inputs to a data pointer. :func:`attention_function` wraps a forward in a
``torch.autograd.Function`` (the ``setup_context`` form, which
``torch.func.jvp`` accepts) whose primal is that forward's and whose rules
go through the plain version, :func:`~repro_torch.kernels.attention.ref.flash_attention_ref`:

- ``backward`` recomputes the plain version under ``torch.enable_grad``
  and returns dq, dk and dv, in query chunks of ``BACKWARD_Q_CHUNK`` rows
  (each chunk's (B, H, chunk, S_k) scores, never the whole (S_q, S_k)
  matrix, as the reference's ``_attention_core`` chunks its queries);
- ``jvp`` is ``torch.func.jvp`` of the plain version.

The reference has no backward kernel: it trains through XLA's autodiff of
its jnp ``attention_fwd`` (``repro/models/layers.py:213``). So a plain
backward is its faithful counterpart; a hand-written backward kernel is
later speed work (ROADMAP queue B). :data:`FlashAttention` is the Function
over the CUDA kernel, the one :func:`repro_torch.kernels.attention.ops.attention`
applies on a CUDA tensor; a test builds the same Function over the plain
version to hold its rules on the CPU.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.kernels.attention.kernel import flash_attention
from repro_torch.kernels.attention.ref import flash_attention_ref

BACKWARD_Q_CHUNK = 1024


def _plain_grads(q, k, v, dout, causal, window, q_offset):
    """dq, dk, dv of the plain version at (q, k, v) along ``dout``, a chunk
    of BACKWARD_Q_CHUNK query rows at a time (dk and dv summed over the
    chunks in fp32, then rounded to their type once)."""
    k_ = k.detach().requires_grad_()
    v_ = v.detach().requires_grad_()
    dqs, dk, dv = [], 0.0, 0.0
    for start in range(0, q.shape[1], BACKWARD_Q_CHUNK):
        rows = slice(start, start + BACKWARD_Q_CHUNK)
        q_ = q[:, rows].detach().requires_grad_()
        out = flash_attention_ref(q_, k_, v_, causal=causal, sliding_window=window,
                                  q_offset=q_offset + start)
        dq_c, dk_c, dv_c = torch.autograd.grad(out, (q_, k_, v_), dout[:, rows])
        dqs.append(dq_c)
        dk, dv = dk + dk_c.float(), dv + dv_c.float()
    return torch.cat(dqs, dim=1), dk.to(k.dtype), dv.to(v.dtype)


def attention_function(forward: Callable) -> type[torch.autograd.Function]:
    """A ``torch.autograd.Function`` whose primal is ``forward(q, k, v, *,
    causal, sliding_window, q_offset)`` and whose backward and jvp are the
    plain version's (module docstring). ``apply(q, k, v, causal,
    sliding_window, q_offset)``."""

    class Attention(torch.autograd.Function):
        @staticmethod
        def forward(q, k, v, causal, sliding_window, q_offset):
            return forward(q, k, v, causal=causal, sliding_window=sliding_window,
                           q_offset=q_offset)

        @staticmethod
        def setup_context(ctx, inputs, output):
            q, k, v, ctx.causal, ctx.window, ctx.q_offset = inputs
            ctx.save_for_backward(q, k, v)
            ctx.save_for_forward(q, k, v)

        @staticmethod
        def backward(ctx, dout):
            q, k, v = ctx.saved_tensors
            with torch.enable_grad():
                dq, dk, dv = _plain_grads(q, k, v, dout, ctx.causal, ctx.window, ctx.q_offset)
            return dq, dk, dv, None, None, None

        @staticmethod
        def jvp(ctx, tq, tk, tv, *_):
            q, k, v = ctx.saved_tensors
            tangents = tuple(torch.zeros_like(x) if t is None else t
                             for x, t in zip((q, k, v), (tq, tk, tv)))
            plain = functools.partial(flash_attention_ref, causal=ctx.causal,
                                      sliding_window=ctx.window, q_offset=ctx.q_offset)
            return torch.func.jvp(plain, (q, k, v), tangents)[1]

    Attention.__name__ = Attention.__qualname__ = f"Attention[{forward.__name__}]"
    return Attention


FlashAttention = attention_function(flash_attention)
