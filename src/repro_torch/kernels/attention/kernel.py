"""Flash attention on Hopper: build, bind and launch the CUDA kernel.

Replaces the TPU kernel ``src/repro/kernels/attention/kernel.py:103``
``flash_attention`` (body ``_flash_kernel``, ``:33``). The source,
``csrc/flash_attention.cu``, says what bounds the kernel and how its design
meets it: one block per (batch, head, 64-row q tile) walks the kv tiles the
causal and window limits leave, with the online softmax in fp32. bfloat16
runs on the tensor cores (``mma.sync``, P split into two bf16 halves so the
bf16 check holds), float32 on the CUDA cores; the dtype picks the kernel and
neither stands in for the other. It is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface at first use
(``repro_torch.kernels.build``) and bound with ``ctypes``. Importing this
module builds nothing.

Unlike the TPU kernel it takes any ``sq`` and ``sk`` (the ragged edge is
masked in the kernel; the TPU's divisibility asserts were a tiling choice),
any ``dh`` that is a multiple of 8 up to 128, a runtime ``q_offset``, and
strided views with unit stride along ``dh``. In bfloat16 each operand must
start on a 16-byte boundary, with batch, sequence and head strides that are
multiples of 8 elements: the kernel copies 16 bytes at a time
(``cp.async``). The wrapper refuses anything else; it never copies to
realign.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import (NVCC_FLAGS, BuildInfo, build_library, cp_async_aligned,
                                       load_library)

_SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches since the last reset, counted in :func:`flash_attention` right
# where a launch succeeded, and nowhere else.
launches = 0


@functools.cache
def build() -> BuildInfo:
    """Compile ``csrc/flash_attention.cu`` (once per source and flags)."""
    return build_library(_SOURCE, NVCC_FLAGS)


@functools.cache
def _library() -> ctypes.CDLL:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return load_library(build(), {
        "flash_attention_fwd": (
            [p, p, p, p, i, ll, ll, ll, i, i, i, *([ll] * 12), i, ll, ll, ctypes.c_float, p], i),
        "flash_attention_error_string": ([i], ctypes.c_char_p),
    })


def _check(q, k, v, sliding_window) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            raise ValueError(f"flash_attention launches on CUDA tensors only ({name})")
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} must share q's device and dtype")
        if x.dim() != 4 or x.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be 4-d with unit stride along dh")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes float32 and bfloat16, not {q.dtype}")
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if not cp_async_aligned(x):
                raise ValueError(
                    f"flash_attention: bf16 {name} must start on a 16-byte boundary with "
                    f"batch, sequence and head strides that are multiples of 8 elements; "
                    f"it starts {x.data_ptr() % 16} bytes past one, strides {x.stride()[:3]}")
    b, sq, h, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not match as (b, sq, h, dh), (b, sk, kv, dh)")
    sk, kv = k.shape[1], k.shape[2]
    if min(b, sq, sk, h, kv) < 1 or h % kv != 0:
        raise ValueError(f"flash_attention: empty operand or h {h} not a multiple of kv {kv}")
    if dh % 8 != 0 or not 8 <= dh <= 128:
        raise ValueError(f"flash_attention takes dh a multiple of 8 up to 128, not {dh}")
    if b > 65535 or h > 65535:
        raise ValueError(f"flash_attention: batch {b} or heads {h} above the grid's 65,535")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"flash_attention: sliding_window must be ≥ 1, got {sliding_window}")


def flash_attention(q, k, v, *, causal: bool = True, sliding_window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors → (b, sq, h, dh) in q's type.

    q is (b, sq, h, dh), k and v (b, sk, kv, dh), all float32 or all
    bfloat16 on one card, any strides with unit stride along dh. Query row
    i sits at absolute position ``i + q_offset``.
    """
    global launches
    _check(q, k, v, sliding_window)
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            b, sq, sk, h, kv, dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal), int(sliding_window or 0), int(q_offset),
            1.0 / math.sqrt(dh), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention launch failed: {lib.flash_attention_error_string(err).decode()}")
    launches += 1
    return out
