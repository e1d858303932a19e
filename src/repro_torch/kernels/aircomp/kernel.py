"""Fused AirComp aggregation on Hopper: build, bind and launch the CUDA kernel.

Replaces the TPU kernels ``src/repro/kernels/aircomp/kernel.py:132``
``aircomp_fused`` (one round) and ``:82`` ``aircomp_fused_batch`` (every
cell of a lattice round at once). Both entries live in one source,
``csrc/aircomp.cu`` (its header says what bounds the kernel and how the
design meets it): the trial axis is the grid's second dimension and one
round is the batch of one trial. The launch geometry and the rows a thread
loads at once are chosen here, by :func:`launch_geometry`, so the CPU tests
check them. The source is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use, under ``build/``
beside this file, and bound with ``ctypes``. Importing this module builds
nothing, so the CPU tests import it without ``nvcc``
(``repro_torch.kernels.build`` holds the build, shared by every kernel).

``g`` and ``z`` may be float32 or bfloat16 (both the same), as the TPU
kernel takes them: the kernel sums in float32 and stores ŷ in g's type
(entries ``*_f32`` and ``*_bf16``, one body). Unlike the TPU kernel,
nothing is padded: the TPU's 128-lane tile was a
layout choice. The scalars M_g, V_g and a stay on the device (0-d tensors
for a round, (B,) for a batch), so a round never waits on the host to
launch the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import NVCC_FLAGS, BuildInfo, build_library, load_library

_SOURCE = Path(__file__).parent / "csrc" / "aircomp.cu"

SMS = 132            # streaming multiprocessors of the H100
MAX_THREADS = 256    # a block's threads at most: the kernel's kMaxThreads
MAX_GRID_Y = 65_535  # trials beyond it loop inside a block

# Launches since the last reset, one counter per entry, each counted only
# in its wrapper, right where the launch succeeded: ``launches`` for
# :func:`aircomp_fused`, ``batch_launches`` for :func:`aircomp_fused_batch`.
launches = 0
batch_launches = 0

# the entries' suffix for each type g, z and ŷ may have
_ENTRY_TYPE = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def build() -> BuildInfo:
    """Compile ``csrc/aircomp.cu`` (once per source and flags) and return it."""
    return build_library(_SOURCE, NVCC_FLAGS)


@functools.cache
def _library() -> ctypes.CDLL:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    one = [p, ll, p, p, p, p, p, p, i, ll, i, i, i, i, p]
    batch = [p, ll, ll, p, p, ll, p, p, p, p, ll, ll, i, ll, i, i, i, i, i, p]
    return load_library(build(), {
        **{f"aircomp_fused_{t}": (one, i) for t in _ENTRY_TYPE.values()},
        **{f"aircomp_fused_batch_{t}": (batch, i) for t in _ENTRY_TYPE.values()},
        "aircomp_error_string": ([i], ctypes.c_char_p),
    })


def _vector_width(d: int, strides, *tensors: torch.Tensor) -> int:
    """Widest load (elements) that keeps every row, trial and pointer aligned."""
    for vec in (4, 2):
        if d % vec == 0 and all(s % vec == 0 for s in strides) and all(
            t.data_ptr() % (t.element_size() * vec) == 0 for t in tensors
        ):
            return vec
    return 1


def launch_geometry(trials: int, d: int, vec: int) -> tuple[int, int, int, int]:
    """``(threads, rows, blocks_x, blocks_y)`` of one launch over ``trials`` × D.

    A thread owns ``vec`` consecutive elements of D (``d % vec == 0``), so
    blocks_x × threads threads cover the D / vec column groups; grid y holds
    the trials, at most 65,535 (a block loops over the rest). A block has
    256 threads unless the grid would then hold fewer than two blocks an SM:
    then 128, then 64. A thread loads its device rows in groups of ``rows``,
    8, or 16 where even 64-thread blocks leave the grid short of two blocks
    an SM: registers are then plentiful, and a group of 16 (two in flight)
    puts every row of up to 32 devices in flight at once.
    """
    groups = d // vec
    blocks_y = min(trials, MAX_GRID_Y)
    for threads in (MAX_THREADS, 128, 64):
        blocks_x = -(-groups // threads)
        if blocks_x * blocks_y >= 2 * SMS:
            return threads, 8, blocks_x, blocks_y
    return threads, 16, blocks_x, blocks_y


def _check_operands(name: str, g: torch.Tensor, operands) -> None:
    """``g`` and ``z`` float32 or bfloat16, both the same; ``coeff`` and the
    scalars float32; all on ``g``'s card."""
    if g.dtype not in _ENTRY_TYPE:
        raise ValueError(f"{name}: g and z must be float32 or bfloat16, got {g.dtype}")
    for arg, t in operands:
        dtype = g.dtype if arg in ("g", "z") else torch.float32
        if not isinstance(t, torch.Tensor) or t.device != g.device or t.dtype != dtype:
            raise ValueError(f"{name}: {arg} must be a {dtype} tensor on {g.device}")
    if g.device.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors only")


def _raise_on_error(name: str, lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.aircomp_error_string(err).decode()}")


def aircomp_fused(g, coeff, m_g, v_g, a, z) -> torch.Tensor:
    """Launch the fused Eq. 5→8 kernel on CUDA tensors → ŷ (D,) in g's type.

    ``g`` is (N, D) float32 or bfloat16 with unit stride along D (any row
    stride); ``z`` (D,) is contiguous and of g's type; ``coeff`` (N,) is
    contiguous float32; ``m_g``, ``v_g`` and ``a`` are 0-d float32 tensors
    on the same card.
    """
    global launches
    _check_operands("aircomp_fused", g, (("g", g), ("coeff", coeff), ("z", z),
                                         ("m_g", m_g), ("v_g", v_g), ("a", a)))
    if g.dim() != 2:
        raise ValueError(f"aircomp_fused: g must be (N, D), got {tuple(g.shape)}")
    n, d = g.shape
    scalars = (m_g, v_g, a)
    if g.stride(1) != 1 or not (coeff.is_contiguous() and z.is_contiguous()):
        raise ValueError("aircomp_fused: g needs unit stride along D, coeff and z contiguity")
    if coeff.shape != (n,) or z.shape != (d,) or any(s.dim() != 0 for s in scalars):
        raise ValueError(
            f"aircomp_fused: shapes g {tuple(g.shape)}, coeff {tuple(coeff.shape)}, "
            f"z {tuple(z.shape)} and 0-d scalars expected"
        )
    out = torch.empty(d, dtype=g.dtype, device=g.device)
    ld = g.stride(0)
    vec = _vector_width(d, (ld,), g, z, out)
    threads, rows, blocks_x, _ = launch_geometry(1, d, vec)
    lib = _library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = getattr(lib, f"aircomp_fused_{_ENTRY_TYPE[g.dtype]}")(
            g.data_ptr(), ld, coeff.data_ptr(), z.data_ptr(), m_g.data_ptr(),
            v_g.data_ptr(), a.data_ptr(), out.data_ptr(), n, d, vec, rows, threads,
            blocks_x, stream,
        )
    _raise_on_error("aircomp_fused", lib, err)
    launches += 1
    return out


def aircomp_fused_batch(g, coeff, m_g, v_g, a, z) -> torch.Tensor:
    """Launch the trial-batched fused Eq. 5→8 kernel → ŷ (B, D) in g's type.

    ``g`` is (B, N, D) float32 or bfloat16 with unit stride along D (any row
    and trial stride: a strided view is read in place); ``z`` is (B, D) of
    g's type with unit stride along D; ``coeff`` (B, N) and the scalars
    ``m_g``, ``v_g``, ``a`` (B,) are contiguous float32, each trial with its
    own values. One launch serves every trial.
    """
    global batch_launches
    _check_operands("aircomp_fused_batch", g, (
        ("g", g), ("coeff", coeff), ("z", z), ("m_g", m_g), ("v_g", v_g), ("a", a)))
    if g.dim() != 3:
        raise ValueError(f"aircomp_fused_batch: g must be (B, N, D), got {tuple(g.shape)}")
    bt, n, d = g.shape
    scalars = (m_g, v_g, a)
    if coeff.shape != (bt, n) or z.shape != (bt, d) or any(s.shape != (bt,) for s in scalars):
        raise ValueError(
            f"aircomp_fused_batch: shapes g {tuple(g.shape)}, coeff {tuple(coeff.shape)}, "
            f"z {tuple(z.shape)}, scalars {[tuple(s.shape) for s in scalars]}; "
            f"expected coeff ({bt}, {n}), z ({bt}, {d}) and ({bt},) scalars"
        )
    if bt == 0 or n == 0 or d == 0:
        raise ValueError(f"aircomp_fused_batch: empty operand g {tuple(g.shape)}")
    if g.stride(2) != 1 or z.stride(1) != 1 or not coeff.is_contiguous() or any(
        not s.is_contiguous() for s in scalars
    ):
        raise ValueError(
            "aircomp_fused_batch: g and z need unit stride along D; coeff and the "
            "scalars must be contiguous"
        )
    out = torch.empty(bt, d, dtype=g.dtype, device=g.device)
    # a stride over an axis of length 1 is never stepped: pass 0
    g_trial = g.stride(0) if bt > 1 else 0
    g_row = g.stride(1) if n > 1 else 0
    z_trial = z.stride(0) if bt > 1 else 0
    vec = _vector_width(d, (g_trial, g_row, z_trial), g, z, out)
    threads, rows, blocks_x, blocks_y = launch_geometry(bt, d, vec)
    lib = _library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = getattr(lib, f"aircomp_fused_batch_{_ENTRY_TYPE[g.dtype]}")(
            g.data_ptr(), g_trial, g_row, coeff.data_ptr(), z.data_ptr(), z_trial,
            m_g.data_ptr(), v_g.data_ptr(), a.data_ptr(), out.data_ptr(), d, bt, n, d,
            vec, rows, threads, blocks_x, blocks_y, stream,
        )
    _raise_on_error("aircomp_fused_batch", lib, err)
    batch_launches += 1
    return out
