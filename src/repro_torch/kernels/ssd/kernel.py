"""Mamba2 SSD chunked scan on Hopper: build, bind and launch the CUDA kernel.

Replaces the TPU kernel ``src/repro/kernels/ssd/kernel.py:65``
``ssd_pallas`` (body ``_ssd_kernel``, ``:28``). The source,
``csrc/ssd.cu``, says what bounds the call and how its designs meet it.
bfloat16 runs on the tensor cores (``mma.sync``) as the state-passing
split, three kernels that one C call issues: the chunk states into an fp32
workspace that this wrapper allocates, a pass over the chunks that turns
them into the states entering each chunk, and the outputs, with C Bᵀ
formed once per (batch, chunk, q tile, group of 8 heads); each fp32
operand goes in as bf16 hi + lo so the bf16 check holds. float32 runs on
the CUDA cores, one block per (batch, head) walking the chunks in order.
The dtype picks the design and neither stands in for the other. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use (``repro_torch.kernels.build``) and bound with
``ctypes``. Importing this module builds nothing.

It takes what the TPU kernel takes (``s % chunk == 0``, la in fp32, xdt,
B and C in one type: fp32 or bf16), with chunk up to 256, p up to 64,
n up to 128, and strided views with unit stride along p and n (B and C
are slices of the model's fused projection). In bfloat16 xdt, B and C
must start on a 16-byte boundary, with batch, sequence (and head) strides
that are multiples of 8 elements: the kernels copy 16 bytes at a time
(``cp.async``). The wrapper refuses anything else; it never copies to
realign.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import (NVCC_FLAGS, BuildInfo, build_library, cp_async_aligned,
                                       load_library)

_SOURCE = Path(__file__).parent / "csrc" / "ssd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_P, MAX_N = 256, 64, 128

# Launches since the last reset, counted in :func:`ssd_scan` right where a
# launch succeeded, and nowhere else.
launches = 0


@functools.cache
def build() -> BuildInfo:
    """Compile ``csrc/ssd.cu`` (once per source and flags)."""
    return build_library(_SOURCE, NVCC_FLAGS)


@functools.cache
def _library() -> ctypes.CDLL:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    return load_library(build(), {
        "ssd_fwd": ([p, p, p, p, p, p, p, ll, i, ll, ll, i, i, i, i, *([ll] * 13), p], i),
        "ssd_error_string": ([i], ctypes.c_char_p),
    })


def workspace_numel(b: int, s: int, h: int, p: int, n: int, chunk: int) -> int:
    """fp32 elements of the bf16 path's workspace: one (np, PP) state per
    (batch, chunk, head), n rounded up to a multiple of 16 and p to 32 or 64."""
    return b * (s // chunk) * h * (-(-n // 16) * 16) * (32 if p <= 32 else 64)


def _check(xdt, la, B, C, chunk) -> None:
    for name, x in (("xdt", xdt), ("la", la), ("B", B), ("C", C)):
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            raise ValueError(f"ssd_scan launches on CUDA tensors only ({name})")
        if x.device != xdt.device:
            raise ValueError(f"ssd_scan: {name} must be on xdt's device")
    if xdt.dtype not in _DTYPES or B.dtype != xdt.dtype or C.dtype != xdt.dtype:
        raise ValueError(f"ssd_scan takes xdt, B and C all float32 or all bfloat16, not "
                         f"{xdt.dtype}, {B.dtype}, {C.dtype}")
    if la.dtype != torch.float32:
        raise ValueError(f"ssd_scan takes la in float32, not {la.dtype}")
    if xdt.dim() != 4 or la.dim() != 3 or B.dim() != 3 or C.dim() != 3:
        raise ValueError("ssd_scan: xdt is (b, s, h, p), la (b, s, h), B and C (b, s, n)")
    b, s, h, p = xdt.shape
    n = B.shape[2]
    if la.shape != (b, s, h) or B.shape != (b, s, n) or C.shape != (b, s, n):
        raise ValueError(f"ssd_scan: xdt {tuple(xdt.shape)}, la {tuple(la.shape)}, "
                         f"B {tuple(B.shape)} and C {tuple(C.shape)} do not match")
    if xdt.stride(3) != 1 or B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("ssd_scan: xdt, B and C need unit stride along p and n")
    if min(b, s, h) < 1 or b > 65535 or not 1 <= p <= MAX_P or not 1 <= n <= MAX_N:
        raise ValueError(f"ssd_scan takes 1 ≤ b ≤ 65,535, p ≤ {MAX_P} and n ≤ {MAX_N}, "
                         f"not b {b}, s {s}, h {h}, p {p}, n {n}")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk != 0:
        raise ValueError(f"ssd_scan: chunk {chunk} must divide the sequence length {s} "
                         f"and be at most {MAX_CHUNK}")
    if xdt.dtype == torch.bfloat16:
        for name, x in (("xdt", xdt), ("B", B), ("C", C)):
            if not cp_async_aligned(x):
                raise ValueError(
                    f"ssd_scan: bf16 {name} must start on a 16-byte boundary with strides "
                    f"that are multiples of 8 elements; it starts {x.data_ptr() % 16} bytes "
                    f"past one, strides {x.stride()}")
        if h > 65535:
            raise ValueError(f"ssd_scan: {h} heads above the grid's 65,535")


def ssd_scan(xdt, la, B, C, *, chunk: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors → y (b, s, h, p) in xdt's type.

    xdt is (b, s, h, p), la (b, s, h) fp32, B and C (b, s, n), xdt, B and C
    all float32 or all bfloat16 on one card; ``s % chunk == 0``. In bf16
    the call also holds a transient fp32 workspace of
    :func:`workspace_numel` elements (67 MB at the mamba2-370m prefill).
    """
    global launches
    _check(xdt, la, B, C, chunk)
    b, s, h, p = xdt.shape
    n = B.shape[2]
    y = torch.empty((b, s, h, p), dtype=xdt.dtype, device=xdt.device)
    ws = la_last = None
    if xdt.dtype == torch.bfloat16:
        ws = torch.empty(workspace_numel(b, s, h, p, n, chunk), dtype=torch.float32,
                         device=xdt.device)
        la_last = torch.empty((b, s // chunk, h), dtype=torch.float32, device=xdt.device)
    lib = _library()
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = lib.ssd_fwd(
            xdt.data_ptr(), la.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if la_last is None else la_last.data_ptr(), 0 if ws is None else ws.numel(),
            _DTYPES[xdt.dtype], b, s, h, p, n, chunk, *xdt.stride()[:3], *la.stride(),
            *B.stride()[:2], *C.stride()[:2], *y.stride()[:3], stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: {lib.ssd_error_string(err).decode()}")
    launches += 1
    return y
