"""The SSD scan's gradient and tangent rules around a forward that has none.

The SSD kernel writes its result through ``ctypes`` into a fresh tensor,
so autograd sees no operation there (a backward would give the Mamba2
projections no gradient through the scan) and ``torch.func.jvp`` could not
unwrap its inputs to a data pointer. :func:`ssd_function` wraps a forward
in a ``torch.autograd.Function`` (the ``setup_context`` form, which
``torch.func.jvp`` accepts) whose primal is that forward's and whose
``backward`` and ``jvp`` go through the plain version,
:func:`~repro_torch.kernels.ssd.ref.ssd_chunked_ref`: the backward
recomputes it under ``torch.enable_grad``, the jvp is ``torch.func.jvp``
of it. In bf16 the primal stays the three-stage kernel.

The reference has no backward kernel: it trains through XLA's autodiff of
its jnp ``ssd_chunked`` (``repro/models/layers.py:479``), so a plain
backward is the faithful counterpart, and a hand-written one is later speed
work (ROADMAP queue B). :data:`SSDScan` is the Function over the CUDA
kernel, the one :func:`repro_torch.kernels.ssd.ops.ssd` applies on a CUDA
tensor; a test builds the same Function over the plain version to hold its
rules on the CPU.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.kernels.ssd.kernel import ssd_scan
from repro_torch.kernels.ssd.ref import ssd_chunked_ref


def ssd_function(forward: Callable) -> type[torch.autograd.Function]:
    """A ``torch.autograd.Function`` whose primal is ``forward(xdt, la, B,
    C, *, chunk)`` and whose backward and jvp are the plain version's
    (module docstring). ``apply(xdt, la, B, C, chunk)``."""

    class SSD(torch.autograd.Function):
        @staticmethod
        def forward(xdt, la, B, C, chunk):
            return forward(xdt, la, B, C, chunk=chunk)

        @staticmethod
        def setup_context(ctx, inputs, output):
            *tensors, ctx.chunk = inputs
            ctx.save_for_backward(*tensors)
            ctx.save_for_forward(*tensors)

        @staticmethod
        def backward(ctx, dy):
            inputs = tuple(x.detach().requires_grad_() for x in ctx.saved_tensors)
            with torch.enable_grad():
                y = ssd_chunked_ref(*inputs, ctx.chunk)
                grads = torch.autograd.grad(y, inputs, dy)
            return (*grads, None)

        @staticmethod
        def jvp(ctx, *tangents):
            inputs = ctx.saved_tensors
            tangents = tuple(torch.zeros_like(x) if t is None else t
                             for x, t in zip(inputs, tangents))
            plain = functools.partial(ssd_chunked_ref, chunk=ctx.chunk)
            return torch.func.jvp(plain, inputs, tangents)[1]

    SSD.__name__ = SSD.__qualname__ = f"SSD[{forward.__name__}]"
    return SSD


SSDScan = ssd_function(ssd_scan)
