"""Card tests of the port: the aircomp kernel's two entries (one round, and
trial-batched), the flash-attention kernel and the SSD scan kernel against
their plain versions, the round, the lattice round (also under each channel
process with K local steps and the four algorithms, and under the non-finite
quarantine with a poisoned cell), the lattice loops against the fused grid,
and the dense and Mamba2 LMs' prefill and decode on the card against the CPU. They need a CUDA card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports the JAX package.) Where
``torch.cuda.is_available()`` is false every test here skips with that
reason. TF32 is off in these tests: the comparisons are fp32.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.core import pofl
from repro_torch.flatten_util import ravel_pytree, tree_map
from repro_torch.core import scheduling
from repro_torch.kernels.aircomp import kernel, ops
from repro_torch.kernels.aircomp.cases import (BATCH_CHECK_CASES, CHECK_CASES, batch_inputs,
                                               limit, round_inputs)
from repro_torch.kernels.aircomp.ref import aircomp_fused_batch_ref, aircomp_fused_ref
from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.cases import CHECK_CASES as ATTN_CASES
from repro_torch.kernels.attention.cases import attention_inputs, check_case
from repro_torch.kernels.attention.ref import flash_attention_ref
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.cases import CHECK_CASES as SSD_CASES
from repro_torch.kernels.ssd.cases import check_case as ssd_check_case
from repro_torch.kernels.ssd.cases import ssd_inputs
from repro_torch.kernels.ssd.ref import ssd_chunked_ref
from repro_torch.launch.serve import Server, serve_demo
from repro_torch import configs
from repro_torch.models import api as lm_api
from repro_torch.models.cache import pad_cache
from repro_torch.models.config import InputShape
from repro_torch.core.local_update import (ALGORITHMS, AlgState, local_update_stage_cells,
                                           minibatch_indices)
from repro_torch.sim import precision
from repro_torch.sim.engine import FUSED_ALGORITHM, FUSED_POLICY, RoundDraws, SimEngine
from repro_torch.sim.lattice import LatticeSpec, run_lattice
from repro_torch.sim.scenario import CHANNEL_SCENARIOS
from repro_torch.sim.tasks import EvalRecord, TaskEval, make_model_task

pytestmark = pytest.mark.cuda

# card vs CPU over a whole round, as the update's relative L2 error and each
# metric's relative error (other sum orders; cuDNN vs CPU convolutions)
ROUND_TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _given_draws(engine, draws) -> None:
    """The engine's next round takes ``draws``, one ``RoundDraws`` a stream
    in the streams' order, and leaves each stream where it is."""
    it = iter(draws)
    engine.next_draws = lambda stream, dim: (stream, next(it))


def _f32(args):
    """The aircomp operands with g and z in float32 (the plain version's
    inputs for a bf16 case's limit)."""
    g, coeff, m_g, v_g, a, z = args
    return g.float(), coeff, m_g, v_g, a, z.float()


@pytest.mark.parametrize("case", list(CHECK_CASES))
def test_kernel_matches_plain_version(card, case):
    """fp32 within 1e-5·max(1, max|ref|); bf16 g and z element by element
    within 2^-8·|ref| + 1e-5·max(1, max|ref|) of the plain version in fp32
    on the same inputs (``cases.limit``)."""
    n, d, empty, row_stride, dtype = CHECK_CASES[case]
    args = round_inputs(n, d, card, seed=list(CHECK_CASES).index(case), empty=empty,
                        row_stride=row_stride, dtype=dtype)
    got = kernel.aircomp_fused(*args)
    want = aircomp_fused_ref(*_f32(args))
    torch.cuda.synchronize()
    assert got.shape == (d,) and got.dtype == dtype and torch.isfinite(got).all()
    assert bool(((got.float() - want).abs() <= limit(want, dtype)).all())


def test_each_launch_counts_once(card):
    args = round_inputs(30, 7850, card)
    before = kernel.launches
    ops.aircomp_aggregate_fused(*args)
    assert kernel.launches == before + 1


def test_kernel_refuses_what_it_does_not_take(card):
    g, coeff, m_g, v_g, a, z = round_inputs(4, 100, card)
    with pytest.raises(ValueError):
        kernel.aircomp_fused(g.double(), coeff, m_g, v_g, a, z)
    with pytest.raises(ValueError):
        kernel.aircomp_fused(g.half(), coeff, m_g, v_g, a, z.half())
    with pytest.raises(ValueError):
        kernel.aircomp_fused(g.bfloat16(), coeff, m_g, v_g, a, z)
    with pytest.raises(ValueError):
        kernel.aircomp_fused(g, coeff, m_g.cpu(), v_g, a, z)
    with pytest.raises(ValueError):
        kernel.aircomp_fused(g.t(), coeff, m_g, v_g, a, z)


def _round(task, cfg, draws, dev):
    data = task.data.to(dev)
    params = tree_map(lambda p: p.to(dev), task.params0)
    d = RoundDraws(*(x.to(dev) for x in draws))
    params, _, metrics = pofl.round_algorithm(task.loss_fn, data, cfg, params, d.h,
                                              d.batch_idx, d.sched, d.z, 3)
    return params, metrics


@pytest.mark.parametrize("kind", ["logreg", "cnn"])
@pytest.mark.parametrize("backend", ["jnp", "pallas_fused"])
def test_round_on_card_matches_cpu(card, kind, backend):
    task = make_model_task(kind, n_devices=6, n_train=120, n_test=12, device="cpu")
    cfg = pofl.POFLConfig(n_devices=6, n_scheduled=3, batch_size=4, backend=backend,
                          noise_power=1e-10)
    draws = next(SimEngine(task.loss_fn, task.data, cfg, device="cpu").draws(0, task.dim))
    p_cpu, m_cpu = _round(task, cfg, draws, "cpu")
    p_card, m_card = _round(task, cfg, draws, card)
    w0 = ravel_pytree(task.params0)[0]
    d_cpu = ravel_pytree(p_cpu)[0] - w0
    d_card = ravel_pytree(p_card)[0].cpu() - w0
    err = torch.linalg.vector_norm(d_card - d_cpu) / torch.linalg.vector_norm(d_cpu)
    assert err.item() <= ROUND_TOL
    assert m_card.n_scheduled.item() == m_cpu.n_scheduled.item()
    for f in ("e_com", "e_var", "grad_norm", "a_scalar"):
        a, b = getattr(m_card, f).item(), getattr(m_cpu, f).item()
        assert abs(a - b) <= ROUND_TOL * abs(b), f


@pytest.mark.parametrize("kind", ["logreg", "cnn"])
@pytest.mark.parametrize("sampler", ["without_replacement", "topk", "bernoulli"])
def test_rounds_never_wait_on_the_host(card, kind, sampler):
    """Any device→host sync inside a round raises under this debug mode."""
    task = make_model_task(kind, n_devices=8, n_train=160, n_test=16, device=card)
    cfg = pofl.POFLConfig(n_devices=8, n_scheduled=3, batch_size=4,
                          backend="pallas_fused", sampler=sampler)
    engine = SimEngine(task.loss_fn, task.data, cfg, device=card)
    draws = engine.draws(0, task.dim)
    params = task.params0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(3):
            d = next(draws)
            params, _, _ = pofl.round_algorithm(
                task.loss_fn, engine.data, cfg, params, d.h, d.batch_idx, d.sched, d.z, t
            )
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_entry_points_default_to_the_card(card):
    task = make_model_task("logreg", n_devices=8, n_train=160, n_test=16)
    assert task.data.features.device.type == "cuda"
    cfg = pofl.POFLConfig(n_devices=8, n_scheduled=3, backend="pallas_fused")
    before = kernel.launches
    params, hist = pofl.run_pofl(task.loss_fn, task.params0, task.data, cfg, 4,
                                 eval_fn=task.eval, eval_every=2)
    assert kernel.launches == before + 4
    assert params["w"].device.type == "cuda" and len(hist.e_com) == 4


@pytest.mark.parametrize("case", list(BATCH_CHECK_CASES))
def test_batch_kernel_matches_plain_version(card, case):
    b, n, d, empty_trial, strided, dtype = BATCH_CHECK_CASES[case]
    args = batch_inputs(b, n, d, card, seed=100 + list(BATCH_CHECK_CASES).index(case),
                        empty_trial=empty_trial, strided=strided, dtype=dtype)
    got = kernel.aircomp_fused_batch(*args)
    want = aircomp_fused_batch_ref(*_f32(args))
    torch.cuda.synchronize()
    assert got.shape == (b, d) and got.dtype == dtype and torch.isfinite(got).all()
    bound = limit(want, dtype)
    assert bool(((got.float() - want).abs() <= bound).all())
    # each trial used its own scalars: trial c is the one-round version of c
    for c in range(b):
        one = aircomp_fused_ref(*_f32([x[c] for x in args]))
        assert bool(((got[c].float() - one).abs() <= bound[c]).all())


def test_each_batch_launch_counts_once_on_its_own_counter(card):
    args = batch_inputs(4, 30, 7850, card)
    before = (kernel.launches, kernel.batch_launches)
    ops.aircomp_aggregate_fused_batch(*args)
    assert (kernel.launches, kernel.batch_launches) == (before[0], before[1] + 1)


def test_batch_kernel_refuses_what_it_does_not_take(card):
    g, coeff, m_g, v_g, a, z = batch_inputs(3, 4, 100, card)
    before = kernel.batch_launches
    refused = [
        (g.cpu(), coeff.cpu(), m_g.cpu(), v_g.cpu(), a.cpu(), z.cpu()),  # CPU tensors
        (g.double(), coeff, m_g, v_g, a, z),                             # wrong dtype
        (g, coeff, m_g, v_g.half(), a, z),
        (g.transpose(1, 2).contiguous().transpose(1, 2), coeff, m_g, v_g, a, z),  # D stride
        (g, coeff, m_g, v_g, a, z.t().contiguous().t()),
        (g, coeff, m_g[:1], v_g, a, z),                                  # scalar shapes
        (g, coeff, m_g, v_g[:, None], a, z),
        (g, coeff, m_g, v_g, a[0], z),
        (g[0], coeff[0], m_g[0], v_g[0], a[0], z[0]),                    # not batched
    ]
    for args in refused:
        with pytest.raises(ValueError):
            kernel.aircomp_fused_batch(*args)
    assert kernel.batch_launches == before


def _lattice_engine(task, dev, n, **cfg_kw):
    cfg = pofl.POFLConfig(n_devices=n, n_scheduled=3, batch_size=4, noise_power=1e-10,
                          policy=FUSED_POLICY, **cfg_kw)
    return SimEngine(task.loss_fn, task.data, cfg, eval_fn=task.eval, device=dev)


# 2 policies × 2 seeds, as run_lattice flattens them
LATTICE_CELLS = dict(noise_b=[1e-10] * 4, alpha_b=[0.1] * 4, seed_b=[0, 3, 0, 3],
                     policy_b=[scheduling.policy_id(p) for p in ("pofl", "pofl",
                                                                  "channel", "channel")])


@pytest.mark.parametrize("backend", ["jnp", "pallas_fused"])
def test_lattice_round_on_card_matches_cpu(card, backend):
    task = make_model_task("cnn", n_devices=6, n_train=120, n_test=12, device="cpu")
    outs = {}
    for where in ("cpu", card):
        engine = _lattice_engine(task, where, 6, backend=backend)
        state = engine.lattice_start(task.params0, **LATTICE_CELLS)
        draws_cpu = SimEngine(task.loss_fn, task.data, engine.cfg, device="cpu")
        # one set of draws for both: the CPU engine's, moved to the card
        _given_draws(engine, [tuple(x.to(where) for x in next(draws_cpu.draws(s, task.dim)))
                              for s in (0, 3)])
        state, rec = engine.lattice_round(state, 3, False)
        outs[str(where)] = (state.params, rec)
    (p_cpu, r_cpu), (p_card, r_card) = outs["cpu"], outs[str(card)]
    w0 = ravel_pytree(task.params0)[0]
    for c in range(4):
        d_cpu = ravel_pytree(tree_map(lambda p: p[c], p_cpu))[0] - w0
        d_card = ravel_pytree(tree_map(lambda p: p[c].cpu(), p_card))[0] - w0
        err = torch.linalg.vector_norm(d_card - d_cpu) / torch.linalg.vector_norm(d_cpu)
        assert err.item() <= ROUND_TOL
    assert torch.equal(r_card[3].cpu(), r_cpu[3])  # n_scheduled
    for got, want in zip(r_card[:3], r_cpu[:3]):  # e_com, e_var, grad_norm
        assert ((got.cpu() - want).abs() <= ROUND_TOL * want.abs()).all()


@pytest.mark.parametrize("kind", ["logreg", "cnn"])
@pytest.mark.parametrize("sampler", ["without_replacement", "topk", "bernoulli"])
def test_lattice_rounds_never_wait_on_the_host(card, kind, sampler):
    """Any device→host sync inside a lattice round (eval included) raises
    under this debug mode."""
    task = make_model_task(kind, n_devices=8, n_train=160, n_test=16, device=card)
    engine = _lattice_engine(task, card, 8, backend="pallas_fused", sampler=sampler)
    state = engine.lattice_start(task.params0, **LATTICE_CELLS)
    before = kernel.batch_launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(2):
            state, _ = engine.lattice_round(state, t, t == 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert kernel.batch_launches == before + 2


def test_run_lattice_defaults_to_the_card(card):
    task = make_model_task("logreg", n_devices=8, n_train=160, n_test=16)
    spec = LatticeSpec(policies=("pofl", "channel"), noise_powers=(1e-10,), seeds=(0, 1),
                       n_rounds=3, eval_every=2)
    before = (kernel.launches, kernel.batch_launches)
    recs = run_lattice(task.loss_fn, task.data, task.params0, spec, eval_fn=task.eval,
                       base_cfg=pofl.POFLConfig(n_devices=8, n_scheduled=3,
                                                backend="pallas_fused"))
    assert (kernel.launches, kernel.batch_launches) == (before[0], before[1] + 3)
    assert recs.e_com.shape == (1, 2, 1, 1, 2, 3) and recs.acc.shape == (1, 2, 1, 1, 2, 2)
    assert all(getattr(recs, f).dtype.kind == "f" for f in ("e_com", "acc"))


def test_poisoned_lattice_round_on_card_matches_cpu(card):
    """The quarantine on the card: one K = 2 CNN lattice round of the four
    algorithms (one a cell, from a non-zero state) under "skip" with cell
    1's ŷ poisoned, on the card and on the CPU from one state and one set
    of draws. Cell 1 keeps its params and state bitwise on both, only it is
    flagged, and the other cells agree within 1e-4."""
    task = make_model_task("cnn", n_devices=6, n_train=120, n_test=12, device="cpu")
    cfg = pofl.POFLConfig(n_devices=6, n_scheduled=3, batch_size=4, noise_power=1e-10,
                          policy=FUSED_POLICY, local_algorithm=FUSED_ALGORITHM,
                          local_steps=2, backend="pallas_fused", on_nonfinite="skip")
    d = next(SimEngine(task.loss_fn, task.data, cfg, device="cpu").draws(0, task.dim))
    cells = len(ALGORITHMS)
    params = tree_map(lambda p: p.expand(cells, *p.shape).clone(), task.params0)
    gen = torch.Generator().manual_seed(2)
    state0 = AlgState(*(1e-3 * torch.randn(cells, 6, task.dim, generator=gen)
                        for _ in AlgState._fields))
    outs = {}
    for where in ("cpu", card):
        before = kernel.batch_launches
        new_p, new_s, m = pofl.round_algorithm_cells(
            task.loss_fn, task.data.to(where), cfg, tree_map(lambda p: p.to(where), params),
            *(x.to(where).expand(cells, *x.shape) for x in d[:4]), 2,
            torch.full((cells,), 1e-10, device=where), torch.full((cells,), 0.1, device=where),
            torch.zeros(cells, dtype=torch.int64, device=where),
            alg_state_c=AlgState(*(f.to(where) for f in state0)),
            algorithm_id_c=torch.arange(cells, device=where),
            fault_round_c=torch.tensor([-1, 2, -1, -1], device=where))
        outs[str(where)] = (
            [ravel_pytree(tree_map(lambda p, c=c: p[c].cpu(), new_p))[0] for c in range(cells)],
            AlgState(*(f.cpu() for f in new_s)), m.health.nonfinite.cpu(), m.n_scheduled.cpu())
        if where == card:
            assert kernel.batch_launches == before + 1
    (p_cpu, s_cpu, h_cpu, n_cpu), (p_card, s_card, h_card, n_card) = (
        outs["cpu"], outs[str(card)])
    assert torch.equal(h_card, torch.tensor([0.0, 1.0, 0.0, 0.0])) and torch.equal(h_cpu, h_card)
    assert torch.equal(n_card, n_cpu)
    w0 = ravel_pytree(task.params0)[0]
    assert torch.equal(p_card[1], w0) and torch.equal(p_cpu[1], w0)
    for f in AlgState._fields:
        assert torch.equal(getattr(s_card, f)[1], getattr(state0, f)[1])
    for c in (0, 2, 3):
        err = torch.linalg.vector_norm(p_card[c] - p_cpu[c]) / torch.linalg.vector_norm(
            p_cpu[c] - w0)
        assert err.item() <= ROUND_TOL


def test_quarantined_rounds_never_wait_on_the_host(card):
    """Under ``on_nonfinite="skip"`` the hold is a value select: rounds with a
    poisoned ŷ (``run_pofl``'s round) and lattice rounds read nothing back
    to the host under this debug mode, and the poisoned round is held."""
    task = make_model_task("logreg", n_devices=8, n_train=160, n_test=16, device=card)
    cfg = pofl.POFLConfig(n_devices=8, n_scheduled=3, batch_size=4, backend="pallas_fused",
                          on_nonfinite="skip")
    engine = SimEngine(task.loss_fn, task.data, cfg, device=card)
    draws = engine.draws(0, task.dim)
    lattice = _lattice_engine(task, card, 8, backend="pallas_fused", on_nonfinite="skip")
    state = lattice.lattice_start(task.params0, **LATTICE_CELLS)
    params, fault, flags = task.params0, torch.tensor(1, device=card), []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(3):
            d = next(draws)
            params, _, m = pofl.round_algorithm(
                task.loss_fn, engine.data, cfg, params, d.h, d.batch_idx, d.sched, d.z, t,
                fault_round=fault)
            flags.append(m.health.nonfinite)
        for t in range(2):
            state, _ = lattice.lattice_round(state, t, t == 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.stack(flags).tolist() == [0.0, 1.0, 0.0]
    assert torch.isfinite(ravel_pytree(params)[0]).all()


@pytest.mark.parametrize("loop", ["fuse_policies", "fuse_algorithms"])
def test_lattice_loop_on_card_matches_the_fused_grid(card, loop):
    """``run_lattice`` with one loop on the card: the records of the fused
    grid within 1e-4 (the sub-lattices batch fewer cells), |S| equal, and
    one batch-kernel launch a sub-lattice a round."""
    task = make_model_task("logreg", n_devices=8, n_train=160, n_test=16)
    spec = LatticeSpec(algorithms=("fedavg", "scaffold"), policies=("pofl", "channel"),
                       noise_powers=(1e-10,), seeds=(0, 1), n_rounds=3, eval_every=2)
    base = pofl.POFLConfig(n_devices=8, n_scheduled=3, local_steps=2, backend="pallas_fused")
    recs = {}
    for kw in ({}, {loop: False}):
        before = (kernel.launches, kernel.batch_launches)
        recs[bool(kw)] = run_lattice(task.loss_fn, task.data, task.params0, spec,
                                     eval_fn=task.eval, base_cfg=base, **kw)
        launches = (kernel.launches - before[0], kernel.batch_launches - before[1])
        assert launches == (0, 3 * (2 if kw else 1))
    fused, looped = recs[False], recs[True]
    assert (looped.n_scheduled == fused.n_scheduled).all()
    for f in ("e_com", "e_var", "grad_norm", "loss", "acc"):
        got, want = getattr(looped, f), getattr(fused, f)
        assert abs(got - want).max() <= ROUND_TOL * abs(want).max(), f


# the scenario lattice: one cell an algorithm, K = 2, each channel process
SCENARIO_PARAMS = {"static_rayleigh": {}, "gauss_markov": dict(corr=0.9),
                   "mobility": dict(speed=5.0),
                   "dropout": dict(base="gauss_markov", corr=0.9, p_drop=0.4),
                   "churn": dict(p_depart=0.3, p_arrive=0.3)}
ALG_CELLS = dict(noise_b=[1e-10] * 4, alpha_b=[0.1] * 4, seed_b=[0, 0, 3, 3],
                 policy_b=[scheduling.policy_id("pofl")] * 4,
                 algorithm_b=list(range(len(ALGORITHMS))))


def _scenario_engine(task, dev, scenario, **cfg_kw):
    n = task.data.n_devices
    cfg = pofl.POFLConfig(n_devices=n, n_scheduled=min(n // 2, 10), batch_size=4,
                          noise_power=1e-10, policy=FUSED_POLICY,
                          local_algorithm=FUSED_ALGORITHM, local_steps=2,
                          backend="pallas_fused", fedprox_mu=0.1, **cfg_kw)
    task_eval = TaskEval(task.logits_fn, task.eval.x_test.to(dev), task.eval.y_test.to(dev))
    return SimEngine(task.loss_fn, task.data, cfg, scenario=scenario,
                     scenario_params=SCENARIO_PARAMS[scenario], eval_fn=task_eval, device=dev)


@pytest.mark.parametrize("scenario", CHANNEL_SCENARIOS)
def test_scenario_lattice_round_on_card_matches_cpu(card, scenario):
    """One K = 2 lattice round of the four algorithms (one a cell, from a
    non-zero state) under each channel process, the CNN at full width on
    Dirichlet-sized shards (as phase ``scenario_parity``): card against CPU
    on one set of draws, each cell's update and the metrics within 1e-4.
    The new FedDyn h and SCAFFOLD c are held to the CPU's float64 state from
    the same inputs, at ``STATE_TOL``: they carry each device's K-step
    w_K − w0 unweighted, a difference of near-equal fp32 weights (and the
    whole stage in float64, card against CPU, at 1e-10:
    :func:`test_k_step_state_on_card_matches_cpu_in_float64`)."""
    task = make_model_task("cnn", n_devices=30, partition="dirichlet_sized", beta=0.4,
                           n_train=600, n_test=12, channel_bias=1.0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    alg0 = AlgState(*(1e-3 * torch.randn(4, 30, task.dim, generator=gen) for _ in range(2)))
    draws_cpu = _scenario_engine(task, "cpu", scenario)
    outs = {}
    for where in ("cpu", card):
        engine = _scenario_engine(task, where, scenario)
        state = engine.lattice_start(task.params0, **ALG_CELLS)
        state = state._replace(alg=AlgState(*(f.to(where) for f in alg0)))
        _given_draws(engine, [tuple(x.to(where) for x in next(draws_cpu.draws(s, task.dim)))
                              for s in (0, 3)])
        state, rec = engine.lattice_round(state, 1, True)
        outs[str(where)] = (state, rec)
    (s_cpu, r_cpu), (s_card, r_card) = outs["cpu"], outs[str(card)]
    w0 = ravel_pytree(task.params0)[0]
    for c in range(4):
        d_cpu = ravel_pytree(tree_map(lambda p: p[c], s_cpu.params))[0] - w0
        d_card = ravel_pytree(tree_map(lambda p: p[c].cpu(), s_card.params))[0] - w0
        if torch.linalg.vector_norm(d_cpu) == 0:  # nothing scheduled: unchanged
            assert torch.equal(d_card, d_cpu)
            continue
        err = torch.linalg.vector_norm(d_card - d_cpu) / torch.linalg.vector_norm(d_cpu)
        assert err.item() <= ROUND_TOL
    assert torch.equal(r_card[3].cpu(), r_cpu[3])  # n_scheduled
    for got, want in zip(r_card[:3], r_cpu[:3]):
        assert ((got.cpu() - want).abs() <= ROUND_TOL * want.abs()).all()
    assert torch.equal(r_card.eval.n_correct.cpu(), r_cpu.eval.n_correct)
    rows = {s: next(draws_cpu.draws(s, task.dim)).batch_idx for s in (0, 3)}
    state_f64 = precision.k_step_state(
        task, draws_cpu.cfg, torch.stack([rows[s] for s in ALG_CELLS["seed_b"]]), 1, alg0,
        torch.float64, "cpu")
    errs = precision.state_errors(AlgState(*(f.cpu() for f in s_card.alg)), state_f64)
    assert max(errs.values()) <= precision.STATE_TOL, errs


def test_k_step_state_on_card_matches_cpu_in_float64(card):
    """The K = 2 local-update stage of the four algorithms (one a cell, each
    from its own params and a non-zero state) in float64, card against CPU:
    Δ and the new h and c within 1e-10."""
    task = make_model_task("cnn", n_devices=6, partition="dirichlet_sized", n_train=120,
                           n_test=12, device="cpu")
    cfg = pofl.POFLConfig(n_devices=6, batch_size=4, local_steps=2, fedprox_mu=0.1)
    gen = torch.Generator().manual_seed(2)
    rows = torch.stack([torch.stack([minibatch_indices(task.data, 4, gen) for _ in range(2)])
                        for _ in range(4)])
    state0 = AlgState(*(1e-3 * torch.randn(4, 6, task.dim, generator=gen, dtype=torch.float64)
                        for _ in range(2)))
    scale = 1.0 + 0.1 * torch.arange(4, dtype=torch.float64)
    params = tree_map(lambda p: scale.view(4, *[1] * p.dim()) * p.double(), task.params0)
    outs = {}
    for where in ("cpu", card):
        data = task.data.to(where)
        data = data._replace(features=data.features.double())
        delta, state = local_update_stage_cells(
            task.loss_fn, data, cfg, tree_map(lambda p: p.to(where), params), rows.to(where), 1,
            alg_state_c=AlgState(*(f.to(where) for f in state0)),
            algorithm_id_c=torch.arange(len(ALGORITHMS), device=where))
        outs[str(where)] = [delta.cpu(), state.h.cpu(), state.c.cpu()]
    for got, want in zip(outs[str(card)], outs["cpu"]):
        assert got.dtype == torch.float64
        err = torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)
        assert err.item() <= 1e-10


def test_k_step_dropout_rounds_never_wait_on_the_host(card):
    """A K = 2 dropout lattice round of the four algorithms (TaskEval
    included) and a K = 2 SCAFFOLD round raise on any device→host sync."""
    task = make_model_task("cnn", n_devices=6, partition="dirichlet_mixed", n_train=120,
                           n_test=12, device=card)
    engine = _scenario_engine(task, card, "dropout")
    state = engine.lattice_start(task.params0, **ALG_CELLS)
    cfg = pofl.POFLConfig(n_devices=6, n_scheduled=3, batch_size=4, local_steps=2,
                          local_algorithm="scaffold", backend="pallas_fused")
    single = SimEngine(task.loss_fn, task.data, cfg, scenario="dropout", device=card)
    draws, params = single.draws(0, task.dim), task.params0
    alg = AlgState(c=torch.zeros(6, task.dim, device=card))
    before = (kernel.launches, kernel.batch_launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(2):
            state, _ = engine.lattice_round(state, t, t == 1)
            d = next(draws)
            params, alg, _ = pofl.round_algorithm(
                task.loss_fn, single.data, cfg, params, d.h, d.batch_idx, d.sched, d.z, t,
                avail=d.avail, alg_state=alg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.batch_launches) == (before[0] + 2, before[1] + 2)


def test_run_lattice_with_a_task_eval_defaults_to_the_card(card):
    task = make_model_task("logreg", n_devices=8, partition="dirichlet", n_train=160,
                           n_test=16)
    assert isinstance(task.eval, TaskEval) and task.data.features.device.type == "cuda"
    spec = LatticeSpec(algorithms=("fedavg", "scaffold"), policies=("pofl", "channel"),
                       noise_powers=(1e-10,), seeds=(0, 1), n_rounds=3, eval_every=2)
    before = (kernel.launches, kernel.batch_launches)
    recs = run_lattice(task.loss_fn, task.data, task.params0, spec, eval_fn=task.eval,
                       base_cfg=pofl.POFLConfig(n_devices=8, n_scheduled=3, local_steps=2,
                                                backend="pallas_fused"),
                       scenario="churn", scenario_params=dict(base="mobility"))
    assert (kernel.launches, kernel.batch_launches) == (before[0], before[1] + 3)
    assert isinstance(recs.eval, EvalRecord) and recs.eval.acc.shape == (2, 2, 1, 1, 2, 2)
    assert (recs.eval.acc == recs.eval.n_correct / task.eval.n_valid).all()


# -- the flash-attention kernel and the dense LM ------------------------------


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_kernel_matches_plain_version(card, case):
    """fp32 within 1e-5·max(1, max|ref|); bf16 against the plain version in
    fp32 on the same inputs within 2^-8·|ref| + 1e-5 element by element
    (``cases.py``)."""
    _, share = check_case(case, attn_kernel.flash_attention, flash_attention_ref, card,
                          seed=list(ATTN_CASES).index(case))
    assert share <= 1.0


def test_each_flash_launch_counts_once(card):
    q, k, v = attention_inputs(2, 100, 100, 14, 2, 64, torch.bfloat16, card)
    before = attn_kernel.launches
    attn_ops.attention(q, k, v, causal=True)
    assert attn_kernel.launches == before + 1


def test_flash_kernel_refuses_what_it_does_not_take(card):
    q, k, v = attention_inputs(1, 16, 16, 4, 2, 64, torch.float32, card)
    q256, k256, v256 = attention_inputs(1, 16, 16, 4, 2, 256, torch.float32, card)
    qb, kb, vb = attention_inputs(1, 16, 16, 4, 2, 64, torch.bfloat16, card)
    flat = torch.zeros(qb.numel() + 8, dtype=torch.bfloat16, device=card)
    q_odd = flat[1:qb.numel() + 1].view(qb.shape)  # starts 2 bytes past a 16-byte boundary
    q_stride = torch.zeros(1, 16, 4, 68, dtype=torch.bfloat16, device=card)[..., :64]
    before = attn_kernel.launches
    refused = [
        (q.cpu(), k.cpu(), v.cpu()),                               # CPU tensors
        (q.half(), k.half(), v.half()),                            # fp16
        (q256, k256, v256),                                        # dh 256
        (q.transpose(1, 3).contiguous().transpose(1, 3), k, v),   # dh stride ≠ 1
        (q, k.double(), v),                                        # mixed types
        (q, k[:, :, :1].expand(-1, -1, 3, -1), v[:, :, :1].expand(-1, -1, 3, -1)),  # h % kv
        (q_odd, kb, vb),                                           # bf16 at an odd offset
        (q_stride, kb, vb),                                        # bf16 head stride 68
    ]
    for args in refused:
        with pytest.raises(ValueError):
            attn_kernel.flash_attention(*args)
    assert attn_kernel.launches == before


def _lm_cfg(layers=3):
    return dataclasses.replace(configs.reduced_config("qwen2-0.5b"), n_layers=layers)


def test_reduced_prefill_and_decode_on_card_match_cpu(card):
    """reduced qwen2-0.5b (3 layers), fp32: the card's prefill (one kernel
    launch a layer) and 4 greedy decode steps against the CPU path on the
    same weights and tokens, logits within 1e-4 relative L2, tokens equal."""
    cfg = _lm_cfg()
    params = lm_api.model_init(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 50), generator=torch.Generator().manual_seed(1))
    shape = InputShape("serve", seq_len=60, global_batch=2, kind="decode")
    out = {}
    for where in ("cpu", card):
        srv = Server(cfg, shape, where, dtype=torch.float32)
        p = srv.load_params(params)
        before = attn_kernel.launches
        first, logits, cache = srv.prefill(p, {"tokens": tokens})
        launched = attn_kernel.launches - before
        toks, cache = srv.decode(p, first, pad_cache(cache, 60), 50, 5)
        out[str(where)] = (logits.cpu(), toks.cpu(), cache.k.cpu(), launched)
    (l_cpu, t_cpu, k_cpu, n_cpu), (l_card, t_card, k_card, n_card) = out["cpu"], out[str(card)]
    assert (n_cpu, n_card) == (0, cfg.n_layers)
    rel = (torch.linalg.vector_norm(l_card - l_cpu) / torch.linalg.vector_norm(l_cpu)).item()
    assert rel <= ROUND_TOL
    rel_k = (torch.linalg.vector_norm(k_card - k_cpu) / torch.linalg.vector_norm(k_cpu)).item()
    assert rel_k <= ROUND_TOL
    assert torch.equal(t_card, t_cpu)


def test_server_and_model_init_default_to_the_card(card):
    cfg = _lm_cfg(layers=2)
    params = lm_api.model_init(cfg)
    assert params["embed"].device.type == "cuda"
    assert lm_api.init_cache(cfg, 2, 40).k.device.type == "cuda"
    srv = Server(cfg, InputShape("serve", seq_len=40, global_batch=2, kind="decode"))
    assert srv.device.type == "cuda" and srv.dtype == torch.bfloat16
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(2))
    before = attn_kernel.launches
    toks, stats = serve_demo(cfg, {"tokens": tokens}, n_tokens=4)
    assert attn_kernel.launches == before + cfg.n_layers
    assert toks.shape == (2, 4) and int(toks.max()) < cfg.vocab_size
    assert stats["decode_s"] > 0


def test_prefill_and_decode_never_wait_on_the_host(card):
    """Any device→host sync in a prefill or a decode loop raises under this
    debug mode: the greedy tokens stay on the card until the caller reads
    them."""
    cfg = _lm_cfg(layers=2)
    srv = Server(cfg, InputShape("serve", seq_len=40, global_batch=2, kind="decode"), card)
    params = srv.load_params(lm_api.model_init(cfg, device=card))
    tokens = torch.randint(0, cfg.vocab_size, (2, 30), generator=torch.Generator().manual_seed(3))
    tokens = tokens.to(card)  # a copy from pageable host memory syncs
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first, _, cache = srv.prefill(params, {"tokens": tokens})
        toks, _ = srv.decode(params, first, pad_cache(cache, 40), 30, 6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert toks.shape == (2, 6)


# -- the SSD scan kernel and the Mamba2 LM --------------------------------------


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_kernel_matches_plain_version(card, case):
    """fp32 within 1e-5·max(1, max|ref|); bf16 against the plain version in
    fp32 on the same inputs within 2^-8·|ref| + 1e-5·max(1, max|ref|)
    element by element (``kernels/ssd/cases.py``)."""
    _, share = ssd_check_case(case, ssd_kernel.ssd_scan, ssd_chunked_ref, card,
                              seed=list(SSD_CASES).index(case))
    assert share <= 1.0


def test_each_ssd_launch_counts_once(card):
    xdt, la, B, C = ssd_inputs(2, 64, 3, 32, 16, torch.bfloat16, card)
    before = ssd_kernel.launches
    ssd_ops.ssd(xdt, la, B, C, chunk=16)
    assert ssd_kernel.launches == before + 1


def test_ssd_kernel_refuses_what_it_does_not_take(card):
    xdt, la, B, C = ssd_inputs(1, 64, 2, 32, 16, torch.float32, card)
    wide = ssd_inputs(1, 64, 2, 128, 16, torch.float32, card)
    big_n = ssd_inputs(1, 64, 2, 32, 256, torch.float32, card)
    before = ssd_kernel.launches
    refused = [
        ((xdt.cpu(), la.cpu(), B.cpu(), C.cpu()), 16),                  # CPU tensors
        ((xdt, la.bfloat16(), B, C), 16),                                # la not fp32
        ((xdt.half(), la, B.half(), C.half()), 16),                      # fp16
        ((xdt.bfloat16(), la, B, C), 16),                                # mixed types
        ((xdt, la, B, C), 24),                                           # s % chunk != 0
        ((*ssd_inputs(1, 512, 2, 32, 16, torch.float32, card),), 512),   # chunk > 256
        (wide, 16),                                                      # p 128
        (big_n, 16),                                                     # n 256
        ((xdt.transpose(2, 3).contiguous().transpose(2, 3), la, B, C), 16),  # p stride ≠ 1
        ((xdt, la[:, :32], B, C), 16),                                   # shapes
    ]
    for args, chunk in refused:
        with pytest.raises(ValueError):
            ssd_kernel.ssd_scan(*args, chunk=chunk)
    assert ssd_kernel.launches == before


def test_ssd_bf16_path_refuses_misaligned_views_and_counts_no_launch(card):
    """The bf16 kernels copy 16 bytes at a time (cp.async): xdt, B and C must
    start on a 16-byte boundary with strides in multiples of 8 elements."""
    xdt, la, B, C = ssd_inputs(1, 64, 2, 32, 16, torch.bfloat16, card)
    flat = torch.zeros(xdt.numel() + 8, dtype=torch.bfloat16, device=card)
    x_odd = flat[1:xdt.numel() + 1].view(xdt.shape)  # starts 2 bytes past a 16-byte boundary
    x_stride = torch.zeros(1, 64, 2, 36, dtype=torch.bfloat16, device=card)[..., :32]
    fused = torch.zeros(1, 64, 64 + 2 * 16 + 4, dtype=torch.bfloat16, device=card)  # row 100
    b_rows, c_rows = fused[..., 64:80], fused[..., 80:96]
    b_odd = torch.zeros(1, 64, 16 + 4, dtype=torch.bfloat16, device=card)[..., 4:]  # 8 bytes in
    before = ssd_kernel.launches
    for args in [(x_odd, la, B, C), (x_stride, la, B, C), (xdt, la, b_rows, C),
                 (xdt, la, B, c_rows), (xdt, la, b_odd, C)]:
        with pytest.raises(ValueError, match="16-byte boundary"):
            ssd_kernel.ssd_scan(*args, chunk=16)
    assert ssd_kernel.launches == before
    assert ssd_kernel.ssd_scan(xdt, la, B, C, chunk=16).shape == xdt.shape  # aligned: launches
    assert ssd_kernel.launches == before + 1


def _ssm_cfg(layers=2):
    return dataclasses.replace(configs.reduced_config("mamba2-370m"), n_layers=layers)


def test_reduced_mamba2_prefill_and_decode_on_card_match_cpu(card):
    """reduced mamba2 (2 layers, chunk 16), fp32: the card's prefill of a
    48-token prompt (three chunks; one kernel launch a layer, none in
    decode) and 5 greedy decode steps against the CPU path on the same
    weights and tokens: logits, SSM state and conv window within 1e-4
    relative L2, tokens equal."""
    cfg = _ssm_cfg()
    params = lm_api.model_init(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), generator=torch.Generator().manual_seed(1))
    shape = InputShape("serve", seq_len=60, global_batch=2, kind="decode")
    out = {}
    for where in ("cpu", card):
        srv = Server(cfg, shape, where, dtype=torch.float32)
        p = srv.load_params(params)
        before = ssd_kernel.launches
        first, logits, cache = srv.prefill(p, {"tokens": tokens})
        prefill_launches = ssd_kernel.launches - before
        toks, cache = srv.decode(p, first, cache, 48, 6)
        out[str(where)] = (logits.cpu(), toks.cpu(), [c.cpu() for c in cache],
                           prefill_launches, ssd_kernel.launches - before)
    (l_cpu, t_cpu, c_cpu, *n_cpu), (l_card, t_card, c_card, *n_card) = out["cpu"], out[str(card)]
    assert n_cpu == [0, 0] and n_card == [cfg.n_layers, cfg.n_layers]
    for a, b in [(l_card, l_cpu), *zip(c_card, c_cpu)]:
        rel = (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
        assert rel <= ROUND_TOL
    assert torch.equal(t_card, t_cpu)


def test_mamba2_serve_demo_defaults_to_the_card_and_never_waits_on_the_host(card):
    """``serve_demo`` and ``init_cache`` run on the card by default, L launches
    a prefill; then a bf16 prefill and decode with every device→host sync
    made an error."""
    cfg = _ssm_cfg()
    assert lm_api.init_cache(cfg, 2, 40).state.device.type == "cuda"
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(2))
    before = ssd_kernel.launches
    toks, stats = serve_demo(cfg, {"tokens": tokens}, n_tokens=4)
    assert ssd_kernel.launches == before + cfg.n_layers
    assert toks.shape == (2, 4) and int(toks.max()) < cfg.vocab_size and stats["decode_s"] > 0
    srv = Server(cfg, InputShape("serve", seq_len=40, global_batch=2, kind="decode"), card)
    params = srv.load_params(lm_api.model_init(cfg, device=card))
    tokens = tokens.to(card)  # a copy from pageable host memory syncs
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first, _, cache = srv.prefill(params, {"tokens": tokens})
        toks, cache = srv.decode(params, first, cache, 32, 6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert toks.shape == (2, 6) and cache.state.dtype == torch.bfloat16


# -- the diagnostics taps and checkpointed sweeps on the card ---------------------


def _cnn_lattice(card, n_rounds=4):
    task = make_model_task("cnn", n_devices=6, n_train=120, n_test=12, device=card)
    spec = LatticeSpec(policies=("pofl", "channel"), seeds=(0, 1), n_rounds=n_rounds,
                       eval_every=2, algorithms=("fedavg", "feddyn"))
    cfg = pofl.POFLConfig(n_devices=6, n_scheduled=3, batch_size=4, noise_power=1e-10,
                          backend="pallas_fused", local_steps=2)
    return task, spec, cfg


def test_diagnostics_leave_the_card_records_bitwise_unchanged(card):
    """With cuDNN's deterministic algorithms a CNN lattice with the taps
    gives bitwise the base records of one without them (the taps only
    read), and every tap is finite; one batch launch a round either way."""
    from repro_torch.obs import ObsConfig
    from repro_torch.sim.resilience import cudnn_deterministic

    task, spec, cfg = _cnn_lattice(card)
    runs = []
    with cudnn_deterministic(card):
        for obs in (None, ObsConfig(diagnostics=True)):
            before = kernel.batch_launches
            runs.append(run_lattice(task.loss_fn, task.data, task.params0, spec, base_cfg=cfg,
                                    eval_fn=task.eval, scenario="churn", obs=obs))
            assert kernel.batch_launches == before + spec.n_rounds
    off, on = runs
    assert off.diag is None
    for f in ("e_com", "e_var", "grad_norm", "n_scheduled", "loss", "acc"):
        assert (getattr(on, f) == getattr(off, f)).all(), f
    assert all(torch.isfinite(torch.as_tensor(getattr(on.diag, f))).all()
               for f in on.diag._fields)


def test_checkpointed_resume_on_the_card_is_bitwise(card, tmp_path):
    """A CNN lattice (FedDyn state, churn) checkpointed every 2 rounds,
    stopped at round 2 and resumed: bitwise the uninterrupted checkpointed
    run, and the deterministic flag as it was before each call."""
    from repro_torch.sim.resilience import CheckpointConfig, run_lattice_checkpointed

    task, spec, cfg = _cnn_lattice(card, n_rounds=5)
    kw = dict(base_cfg=cfg, eval_fn=task.eval, scenario="churn")
    before = torch.backends.cudnn.deterministic
    full = run_lattice_checkpointed(task.loss_fn, task.data, task.params0, spec,
                                    checkpoint=CheckpointConfig(str(tmp_path / "full"), 2), **kw)
    ck = CheckpointConfig(str(tmp_path / "stop"), 2)
    assert run_lattice_checkpointed(task.loss_fn, task.data, task.params0, spec,
                                    checkpoint=ck, _stop_after_round=2, **kw) is None
    resumed = run_lattice_checkpointed(task.loss_fn, task.data, task.params0, spec,
                                       checkpoint=ck, **kw)
    assert torch.backends.cudnn.deterministic == before
    for f in ("e_com", "e_var", "grad_norm", "n_scheduled", "loss", "acc"):
        assert (getattr(full, f) == getattr(resumed, f)).all(), f


def test_checkpointed_run_restores_the_deterministic_flag_after_an_exception(card, tmp_path,
                                                                             monkeypatch):
    """The flag is on inside the chunks and back to its old value after the
    call, also when a chunk raises."""
    from repro_torch.sim import resilience

    task, spec, cfg = _cnn_lattice(card, n_rounds=2)
    seen = []

    def failing_chunk(self, *args, **kw):
        seen.append(torch.backends.cudnn.deterministic)
        raise RuntimeError("chunk failed")

    monkeypatch.setattr(SimEngine, "run_lattice_chunk", failing_chunk)
    for before in (False, True):
        torch.backends.cudnn.deterministic = before
        with pytest.raises(RuntimeError, match="chunk failed"):
            resilience.run_lattice_checkpointed(task.loss_fn, task.data, task.params0, spec,
                                                base_cfg=cfg, checkpoint_every=1,
                                                checkpoint_dir=str(tmp_path / str(before)))
        assert torch.backends.cudnn.deterministic is before
    torch.backends.cudnn.deterministic = False
    assert seen == [True, True]
