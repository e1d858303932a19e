"""Inputs of the aircomp kernel's checks, shared by ``chip_smoke.py`` and
the card tests (``tests/test_torch_cuda.py``): one list of cases and one
maker for each entry (one round, and trial-batched). A case's seed is its
index in its list, so new cases are appended.

Limits against the plain version run in float32 on the same inputs
(:func:`limit`): a float32 case within ``1e-5·max(1, max|ref|)`` (the sum
order); a bfloat16 case (g and z in bf16, ŷ stored in bf16) element by
element within ``2^-8·|ref| + 1e-5·max(1, max|ref|)``, as kernels 3 and 4
are held: both sides sum the same bf16 inputs in float32, so they differ by
the one bf16 rounding of ŷ, at most ``2^-8`` of a value, plus the float32
sum order.
"""
from __future__ import annotations

import math

import torch

F32_TOL = 1e-5
BF16_REL = 2.0**-8


def limit(want: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The per-element limit of a case of ``dtype`` whose float32 plain
    version gave ``want``."""
    absolute = F32_TOL * max(1.0, want.abs().max().item())
    if dtype == torch.float32:
        return torch.full_like(want, absolute)
    return BF16_REL * want.abs() + absolute


# name: (N, D, empty, row_stride, dtype). The two main-path shapes, D off
# any block multiple and below one block, N=1, each load width (D % 4 == 0,
# D % 2 == 0, odd D), a strided g, the empty schedule, and device counts the
# kernel's groups of 8 rows must get right: 31 (a masked tail group), 100
# and 257 (a few hundred devices, as in FL); then bf16 g and z (``*_bf16``)
# at both main-path shapes, each load width, a strided g, the empty
# schedule and N = 31.
CHECK_CASES = {
    "cnn": (30, 258_634, False, None, torch.float32),
    "logreg": (30, 7850, False, None, torch.float32),
    "d_off_block": (5, 1000, False, None, torch.float32),
    "d_below_block": (3, 100, False, None, torch.float32),
    "n_1": (1, 4096, False, None, torch.float32),
    "d_odd": (7, 1001, False, None, torch.float32),
    "d_mult_4": (30, 8192, False, None, torch.float32),
    "strided_rows": (4, 1000, False, 1200, torch.float32),
    "empty_schedule": (30, 258_634, True, None, torch.float32),
    "n_31": (31, 7850, False, None, torch.float32),
    "n_100": (100, 1001, False, None, torch.float32),
    "n_257": (257, 4096, False, None, torch.float32),
    "cnn_bf16": (30, 258_634, False, None, torch.bfloat16),
    "logreg_bf16": (30, 7850, False, None, torch.bfloat16),
    "d_odd_bf16": (7, 1001, False, None, torch.bfloat16),
    "d_mult_4_bf16": (30, 8192, False, None, torch.bfloat16),
    "strided_rows_bf16": (4, 1000, False, 1200, torch.bfloat16),
    "empty_schedule_bf16": (30, 258_634, True, None, torch.bfloat16),
    "n_31_bf16": (31, 7850, False, None, torch.bfloat16),
}


def round_inputs(n, d, dev, seed=0, empty=False, row_stride=None, dtype=torch.float32):
    """``(g, coeff, m_g, v_g, a, z)`` of ``aircomp_fused``: gradient-like g
    (n, d) (a view of rows ``row_stride`` wide, if given), coeff = mask·ρ, z
    and the 0-d scalars; ``empty`` schedules nobody (a = inf, coeff = 0).
    g and z are drawn in float32 and cast to ``dtype``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randn(n, row_stride or d, generator=gen, device=dev) * 0.05 + 0.01
    g = rows.to(dtype)[:, :d]
    coeff = torch.rand(n, generator=gen, device=dev)
    coeff = coeff * (torch.rand(n, generator=gen, device=dev) > 0.3)
    z = torch.randn(d, generator=gen, device=dev)
    m_g, v_g, a = (torch.rand((), generator=gen, device=dev) + 0.1 for _ in range(3))
    if empty:  # nothing scheduled: a = min over the empty set = inf, coeff = 0
        coeff = torch.zeros_like(coeff)
        m_g, a = torch.zeros((), device=dev), torch.full((), math.inf, device=dev)
    return g, coeff, m_g, v_g, a, z.to(dtype)


# name: (B, N, D, empty_trial, strided, dtype). The CNN lattice's shape (15
# cells of D=258,634), logreg's lattice (30 cells), odd D, D below one block, one
# trial, D % 4 == 0, a trial-strided view, an empty schedule in one trial,
# N = 31, 100 and 257 as above, and the scenario lattices' shapes: the CNN's
# 24 cells and the example's logreg at N = 20 (a masked last row group);
# then the lattice loops' sub-lattices: the CNN lattice one policy at a time
# (3 cells) and the CNN scenario lattice one algorithm at a time (6 cells);
# then bf16 g and z (``*_bf16``) at both lattices' shapes, odd D, a
# trial-strided view, an empty trial and N = 31. Every trial has its own
# scalars.
BATCH_CHECK_CASES = {
    "cnn_lattice": (15, 30, 258_634, None, False, torch.float32),
    "logreg_lattice": (30, 30, 7850, None, False, torch.float32),
    "d_odd": (4, 7, 1001, None, False, torch.float32),
    "d_below_block": (3, 3, 100, None, False, torch.float32),
    "b_1": (1, 30, 7850, None, False, torch.float32),
    "d_mult_4": (3, 30, 8192, None, False, torch.float32),
    "trial_strided": (6, 5, 1000, None, True, torch.float32),
    "empty_schedule_trial": (5, 30, 258_634, 2, False, torch.float32),
    "n_31": (3, 31, 7850, None, False, torch.float32),
    "n_100": (2, 100, 1001, None, False, torch.float32),
    "n_257": (2, 257, 4096, None, False, torch.float32),
    "cnn_scenario_lattice": (24, 30, 258_634, None, False, torch.float32),
    "logreg_example_lattice": (24, 20, 7850, None, False, torch.float32),
    "cnn_lattice_per_policy": (3, 30, 258_634, None, False, torch.float32),
    "cnn_scenario_lattice_per_algorithm": (6, 30, 258_634, None, False, torch.float32),
    "cnn_lattice_bf16": (15, 30, 258_634, None, False, torch.bfloat16),
    "logreg_lattice_bf16": (30, 30, 7850, None, False, torch.bfloat16),
    "d_odd_bf16": (4, 7, 1001, None, False, torch.bfloat16),
    "trial_strided_bf16": (6, 5, 1000, None, True, torch.bfloat16),
    "empty_schedule_trial_bf16": (5, 30, 258_634, 2, False, torch.bfloat16),
    "n_31_bf16": (3, 31, 7850, None, False, torch.bfloat16),
}


def batch_inputs(b, n, d, dev, seed=0, empty_trial=None, strided=False,
                 dtype=torch.float32):
    """``(g, coeff, m_g, v_g, a, z)`` of ``aircomp_fused_batch``, every trial
    with its own g, coeff, z and scalars; ``strided`` makes g and z
    trial-strided views of larger tensors (every other trial, rows wider
    than D); ``empty_trial`` schedules nobody (a = inf, coeff = 0). g and z
    are drawn in float32 and cast to ``dtype``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    step, width = (2, d + 6) if strided else (1, d)
    g = torch.randn(b * step, n, width, generator=gen, device=dev) * 0.05 + 0.01
    g = g.to(dtype)[::step, :, :d]
    z = torch.randn(b * step, width, generator=gen, device=dev).to(dtype)[::step, :d]
    coeff = torch.rand(b, n, generator=gen, device=dev)
    coeff = coeff * (torch.rand(b, n, generator=gen, device=dev) > 0.3)
    m_g, v_g, a = (torch.rand(b, generator=gen, device=dev) + 0.1 for _ in range(3))
    if empty_trial is not None:
        coeff[empty_trial] = 0.0
        m_g[empty_trial] = 0.0
        a[empty_trial] = math.inf
    return g, coeff, m_g, v_g, a, z
