"""Inputs of the batch kernel's checks, shared by ``chip_smoke.py`` and the
card tests (``tests/test_torch_cuda.py``): one list of cases, one maker."""
from __future__ import annotations

import math

import torch

# name: (B, N, D, empty_trial, strided). The CNN lattice's shape (15 cells of
# D=258,634), logreg's lattice (30 cells), odd D, D below one block, one
# trial, D % 4 == 0, a trial-strided view and an empty schedule in one
# trial; every trial has its own scalars.
BATCH_CHECK_CASES = {
    "cnn_lattice": (15, 30, 258_634, None, False),
    "logreg_lattice": (30, 30, 7850, None, False),
    "d_odd": (4, 7, 1001, None, False),
    "d_below_block": (3, 3, 100, None, False),
    "b_1": (1, 30, 7850, None, False),
    "d_mult_4": (3, 30, 8192, None, False),
    "trial_strided": (6, 5, 1000, None, True),
    "empty_schedule_trial": (5, 30, 258_634, 2, False),
}


def batch_inputs(b, n, d, dev, seed=0, empty_trial=None, strided=False):
    """``(g, coeff, m_g, v_g, a, z)`` of ``aircomp_fused_batch``, every trial
    with its own g, coeff, z and scalars; ``strided`` makes g and z
    trial-strided views of larger tensors (every other trial, rows wider
    than D); ``empty_trial`` schedules nobody (a = inf, coeff = 0)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    step, width = (2, d + 6) if strided else (1, d)
    g = torch.randn(b * step, n, width, generator=gen, device=dev) * 0.05 + 0.01
    g = g[::step, :, :d]
    z = torch.randn(b * step, width, generator=gen, device=dev)[::step, :d]
    coeff = torch.rand(b, n, generator=gen, device=dev)
    coeff = coeff * (torch.rand(b, n, generator=gen, device=dev) > 0.3)
    m_g, v_g, a = (torch.rand(b, generator=gen, device=dev) + 0.1 for _ in range(3))
    if empty_trial is not None:
        coeff[empty_trial] = 0.0
        m_g[empty_trial] = 0.0
        a[empty_trial] = math.inf
    return g, coeff, m_g, v_g, a, z
