"""The port's aircomp kernel module on the CPU: its plain versions (one
round, and trial-batched) against the reference's Pallas kernels (interpret
mode) and oracles, the dispatch, and the CUDA kernel's launch geometry.

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Tolerance: 1e-5 relative to the output's scale (``_torch_parity``).
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_close, t

from repro.kernels.aircomp import ops as jops
from repro.kernels.aircomp.ref import aircomp_fused_batch_ref as jax_batch_ref
from repro.kernels.aircomp.ref import aircomp_fused_ref as jax_ref
from repro_torch.kernels.aircomp import kernel as tkernel
from repro_torch.kernels.aircomp import ops as tops
from repro_torch.kernels.aircomp.cases import BF16_REL, limit
from repro_torch.kernels.aircomp.ref import aircomp_fused_batch_ref, aircomp_fused_ref


def _inputs(n, d, seed, empty=False):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    g = jax.random.normal(ks[0], (n, d))
    coeff = jax.random.uniform(ks[1], (n,)) * (jax.random.uniform(ks[2], (n,)) > 0.3)
    z = jax.random.normal(ks[3], (d,))
    m_g, v_g, a = jnp.float32(0.13), jnp.float32(0.7), jnp.float32(2.4)
    if empty:  # nothing scheduled: a = min over the empty set = inf, coeff = 0
        coeff, m_g, a = jnp.zeros((n,)), jnp.float32(0.0), jnp.float32(jnp.inf)
    return g, coeff, m_g, v_g, a, z


# D on and off the TPU's 128-lane grid, below one tile, and the two
# main-path widths (logreg D=7850; the CNN's 258,634 runs on the card)
@pytest.mark.parametrize(
    "n,d,empty",
    [(4, 512, False), (30, 1024, False), (7, 700, False), (1, 512, False),
     (6, 100, False), (6, 981, False), (5, 2 * 512 + 17, False),
     (30, 7850, False), (30, 7850, True), (3, 100, True)],
)
def test_plain_version_matches_reference_kernel(n, d, empty):
    g, coeff, m_g, v_g, a, z = _inputs(n, d, seed=n * 1000 + d, empty=empty)
    want_kernel = jops.aircomp_aggregate_fused(
        g, coeff, m_g, v_g, a, z, use_pallas="interpret"
    )
    want_ref = jax_ref(g, coeff, m_g, v_g, a, z)
    got = aircomp_fused_ref(t(g), t(coeff), t(m_g), t(v_g), t(a), t(z))
    assert got.shape == (d,) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert_close(got, want_kernel)
    assert_close(got, want_ref)


def test_cpu_tensors_dispatch_to_plain_version():
    g, coeff, m_g, v_g, a, z = (t(x) for x in _inputs(5, 300, seed=7))
    before = tkernel.launches
    got = tops.aircomp_aggregate_fused(g, coeff, m_g, v_g, a, z)
    assert torch.equal(got, aircomp_fused_ref(g, coeff, m_g, v_g, a, z))
    assert tkernel.launches == before  # the plain version launches nothing


def test_kernel_wrapper_refuses_cpu_tensors():
    g, coeff, m_g, v_g, a, z = (t(x) for x in _inputs(5, 300, seed=8))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.aircomp_fused(g, coeff, m_g, v_g, a, z)


def test_importing_the_kernel_module_builds_nothing():
    assert tkernel.build.cache_info().currsize == 0
    assert tkernel.NVCC_FLAGS[0] == "-gencode=arch=compute_90a,code=sm_90a"


def _batch_inputs(b, n, d, seed, empty_trial=None):
    """Every trial with its own g, coeff, z and scalars; ``empty_trial``
    schedules nobody (a = inf, coeff = 0)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 7)
    g = jax.random.normal(ks[0], (b, n, d))
    coeff = jax.random.uniform(ks[1], (b, n)) * (jax.random.uniform(ks[2], (b, n)) > 0.3)
    z = jax.random.normal(ks[3], (b, d))
    m_g = jax.random.uniform(ks[4], (b,)) - 0.5
    v_g = jax.random.uniform(ks[5], (b,)) + 0.1
    a = jax.random.uniform(ks[6], (b,)) * 3 + 0.5
    if empty_trial is not None:
        coeff = coeff.at[empty_trial].set(0.0)
        m_g = m_g.at[empty_trial].set(0.0)
        a = a.at[empty_trial].set(jnp.inf)
    return g, coeff, m_g, v_g, a, z


# D off the TPU's 512 tile, below one 128-lane row, one trial, a trial with
# an empty schedule, and logreg's width
@pytest.mark.parametrize(
    "b,n,d,empty_trial",
    [(3, 4, 700, None), (2, 5, 100, None), (1, 6, 512, None), (1, 3, 981, 0),
     (4, 5, 2 * 512 + 17, 2), (3, 30, 7850, 1)],
)
def test_batch_plain_version_matches_reference_kernel(b, n, d, empty_trial):
    args = _batch_inputs(b, n, d, seed=b * 100 + d, empty_trial=empty_trial)
    want_kernel = jops.aircomp_aggregate_fused_batch(*args, use_pallas="interpret")
    want_ref = jax_batch_ref(*args)
    got = aircomp_fused_batch_ref(*(t(x) for x in args))
    assert got.shape == (b, d) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    for c in range(b):  # each trial at its own scale
        assert_close(got[c], want_kernel[c])
        assert_close(got[c], want_ref[c])


def test_batch_plain_version_is_the_single_one_per_trial():
    """Trial c of the batch is the one-round plain version on trial c's
    inputs, so no trial reads another's scalars."""
    args = [t(x) for x in _batch_inputs(4, 6, 333, seed=5, empty_trial=3)]
    got = aircomp_fused_batch_ref(*args)
    for c in range(4):
        assert torch.equal(got[c], aircomp_fused_ref(*(x[c] for x in args)))


def test_cpu_tensors_dispatch_batch_to_plain_version():
    args = [t(x) for x in _batch_inputs(3, 5, 300, seed=9)]
    before = (tkernel.launches, tkernel.batch_launches)
    got = tops.aircomp_aggregate_fused_batch(*args)
    assert torch.equal(got, aircomp_fused_batch_ref(*args))
    assert (tkernel.launches, tkernel.batch_launches) == before


def test_batch_kernel_wrapper_refuses_cpu_tensors():
    args = [t(x) for x in _batch_inputs(2, 5, 300, seed=10)]
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.aircomp_fused_batch(*args)


# (trials, D, vec): both main shapes of each entry (one CNN or logreg round,
# the CNN lattice's 15 cells and logreg's 30), D below one block, odd D,
# each load width, trials past grid y, and the smallest launch
GEOMETRY_SHAPES = [
    (1, 258_634, 2), (1, 7850, 2), (15, 258_634, 2), (30, 7850, 2),
    (3, 100, 4), (1, 100, 1), (4, 1001, 1), (1, 1001, 1), (3, 8192, 4), (1, 4096, 4),
    (70_000, 1000, 2), (1, 1, 1),
]


@pytest.mark.parametrize("trials,d,vec", GEOMETRY_SHAPES)
def test_launch_geometry_owns_every_column_group_once(trials, d, vec):
    """Model the kernel's indexing: thread x of block (bx, by) owns elements
    [c·vec, c·vec + vec) of D, c = bx·threads + x, if c·vec < D, for trials
    by, by + grid y, ... below ``trials``."""
    threads, rows, blocks_x, blocks_y = tkernel.launch_geometry(trials, d, vec)
    assert threads % 32 == 0 and 32 <= threads <= min(1024, tkernel.MAX_THREADS)
    assert rows in (8, 16)  # the kernel's instances
    assert 1 <= blocks_y <= min(trials, 65_535)
    col = np.arange(blocks_x * threads)
    live = col[col * vec < d]
    owned = (live[:, None] * vec + np.arange(vec)).ravel()
    assert np.array_equal(np.sort(owned), np.arange(d))  # each once, none past D
    assert blocks_x * threads - live.size < threads  # no block lies wholly past D
    trial_owned = np.concatenate([np.arange(y, trials, blocks_y) for y in range(blocks_y)])
    assert np.array_equal(np.sort(trial_owned), np.arange(trials))


def test_launch_geometry_fills_the_card_at_the_round_shapes():
    """A single CNN trial launches at least two blocks an SM, 8 rows a group
    (the register budget of four 256-thread blocks an SM); a single logreg
    trial (3,925 column pairs) at least 60 blocks, not 256-thread blocks'
    16, with all 30 rows in flight (groups of 16); the lattices' grids are
    full with 256 threads."""
    threads, rows, blocks_x, _ = tkernel.launch_geometry(1, 258_634, 2)
    assert (threads, rows, blocks_x >= 2 * tkernel.SMS) == (256, 8, True)
    threads, rows, blocks_x, _ = tkernel.launch_geometry(1, 7850, 2)
    assert (threads, rows) == (64, 16) and blocks_x >= 60
    assert tkernel.launch_geometry(30, 7850, 2) == (256, 8, 16, 30)
    assert tkernel.launch_geometry(15, 258_634, 2) == (256, 8, 506, 15)


def test_launch_geometry_stays_within_the_kernel_launch_bounds():
    src = (Path(tkernel.__file__).parent / "csrc" / "aircomp.cu").read_text()
    assert f"constexpr int kMaxThreads = {tkernel.MAX_THREADS};" in src
    assert f"constexpr long long kMaxGridY = {tkernel.MAX_GRID_Y};" in src
    for vec in (1, 2, 4):
        for rows in (8, 16):
            assert f"case {vec * 100 + rows}: launch<T, {vec}, {rows}>" in src


# -- bfloat16 g and z (the reference kernels' other dtype) --------------------


def _within(got: torch.Tensor, want, times: float = 1.0) -> None:
    """``got`` (bf16) within ``times`` the bf16 limit of ``cases.limit``
    of ``want`` (float32), element by element."""
    want = t(want, torch.float32)
    err = (got.float() - want).abs()
    assert bool((err <= times * limit(want, torch.bfloat16)).all()), float(err.max())


@pytest.mark.parametrize("n,d,empty", [(4, 512, False), (30, 1024, False), (7, 700, False),
                                       (1, 512, False), (30, 7850, False), (30, 7850, True)])
def test_bf16_plain_version_matches_reference(n, d, empty):
    """bf16 g and z: the port's plain version sums in float32 and stores ŷ
    in bf16, as the reference's kernel does (``kernel.py:56-62``): within
    one bf16 rounding (2^-8·|ref| + 1e-5·max(1, max|ref|)) of the
    reference's oracle in float32 on the same bf16 inputs, and within two
    of the reference's Pallas kernel (interpret mode), which rounds once
    from its own float32 sum."""
    g, coeff, m_g, v_g, a, z = _inputs(n, d, seed=n * 1000 + d + 1, empty=empty)
    g, z = g.astype(jnp.bfloat16), z.astype(jnp.bfloat16)
    want_kernel = jops.aircomp_aggregate_fused(g, coeff, m_g, v_g, a, z,
                                               use_pallas="interpret")
    want_ref = jax_ref(g.astype(jnp.float32), coeff, m_g, v_g, a, z.astype(jnp.float32))
    got = aircomp_fused_ref(t(g.astype(jnp.float32)).bfloat16(), t(coeff), t(m_g), t(v_g),
                            t(a), t(z.astype(jnp.float32)).bfloat16())
    assert got.dtype == torch.bfloat16 and want_kernel.dtype == jnp.bfloat16
    assert torch.isfinite(got.float()).all()
    _within(got, want_ref)
    _within(got, np.asarray(want_kernel, np.float32), times=2.0)


@pytest.mark.parametrize("b,n,d,empty_trial", [(3, 4, 700, None), (2, 30, 7850, 1),
                                               (4, 5, 2 * 512 + 17, 2)])
def test_bf16_batch_plain_version_matches_reference(b, n, d, empty_trial):
    g, coeff, m_g, v_g, a, z = _batch_inputs(b, n, d, seed=b * 100 + d + 1,
                                             empty_trial=empty_trial)
    g, z = g.astype(jnp.bfloat16), z.astype(jnp.bfloat16)
    want_kernel = jops.aircomp_aggregate_fused_batch(g, coeff, m_g, v_g, a, z,
                                                     use_pallas="interpret")
    want_ref = jax_batch_ref(g.astype(jnp.float32), coeff, m_g, v_g, a,
                             z.astype(jnp.float32))
    got = aircomp_fused_batch_ref(t(g.astype(jnp.float32)).bfloat16(), t(coeff), t(m_g),
                                  t(v_g), t(a), t(z.astype(jnp.float32)).bfloat16())
    assert got.shape == (b, d) and got.dtype == torch.bfloat16
    for c in range(b):  # each trial at its own scale
        _within(got[c], np.asarray(want_ref)[c])
        _within(got[c], np.asarray(want_kernel, np.float32)[c], times=2.0)


def test_bf16_limit_is_one_output_rounding():
    """The bf16 limit holds a float32 value against itself rounded to bf16
    once, with no room for a second rounding at the bottom of a binade."""
    x = torch.tensor([1.0 + 2.0**-8 + 2.0**-10, 3.0, -1.5 - 2.0**-9, 1e-3], dtype=torch.float32)
    rounded = x.bfloat16().float()
    assert bool(((rounded - x).abs() <= limit(x, torch.bfloat16)).all())
    assert BF16_REL * 1.0 < 2.0**-7  # one bf16 step at 1.0 exceeds the limit


def test_kernel_wrappers_refuse_other_types():
    """The wrappers take g and z in float32 or bfloat16, both the same, and
    coeff and the scalars in float32; the check runs before any launch."""
    g, coeff, m_g, v_g, a, z = (t(x) for x in _inputs(5, 300, seed=11))
    for args in [(g.half(), coeff, m_g, v_g, a, z.half()),
                 (g.bfloat16(), coeff, m_g, v_g, a, z),
                 (g.bfloat16(), coeff.bfloat16(), m_g, v_g, a, z.bfloat16()),
                 (g.double(), coeff, m_g, v_g, a, z.double())]:
        with pytest.raises(ValueError, match="must be"):
            tkernel.aircomp_fused(*args)
        with pytest.raises(ValueError, match="must be"):
            tkernel.aircomp_fused_batch(*(x[None] for x in args))
