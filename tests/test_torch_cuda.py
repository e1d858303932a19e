"""Card tests of the port: the aircomp kernel's two entries (one round, and
trial-batched), the flash-attention kernel and the SSD scan kernel against
their plain versions, the round, the lattice round (also under each channel
process with K local steps and the four algorithms, and under the non-finite
quarantine with a poisoned cell), the lattice loops against the fused grid,
the dense, Mamba2, hybrid, MoE, enc-dec and VLM LMs' prefill and decode
on the card against the CPU, and their training: the kernels' autograd
Functions, a train step of every family card against CPU, and the trainer.
They need a CUDA card and no JAX:

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


# -- the hybrid (Zamba2) and MoE LMs ---------------------------------------------


def _family_cfg(arch):
    """reduced zamba2 with 5 layers and the shared block every 2 (3
    invocations, the last group partial), or reduced olmoe (4 experts,
    top-2) at capacity factor 0.5, so the prefill drops tokens."""
    cfg = configs.reduced_config(arch)
    if cfg.arch_type == "hybrid":
        return dataclasses.replace(cfg, n_layers=5,
                                   hybrid=dataclasses.replace(cfg.hybrid, attn_every=2))
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))


def _launches():
    return attn_kernel.launches, ssd_kernel.launches


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "olmoe-1b-7b"])
def test_reduced_hybrid_and_moe_prefill_and_decode_on_card_match_cpu(card, arch):
    """fp32: the card's prefill of a 48-token prompt (zamba2: one flash
    launch an invocation and one SSD launch a layer; olmoe: one flash launch
    a layer; none in decode) and 5 greedy decode steps against the CPU path
    on the same weights and tokens: logits and every cache tensor within
    1e-4 relative L2, tokens equal."""
    from repro_torch.models.cache import cache_leaves, n_shared_invocations

    cfg = _family_cfg(arch)
    params = lm_api.model_init(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), generator=torch.Generator().manual_seed(1))
    shape = InputShape("serve", seq_len=60, global_batch=2, kind="decode")
    out = {}
    for where in ("cpu", card):
        srv = Server(cfg, shape, where, dtype=torch.float32)
        p = srv.load_params(params)
        before = _launches()
        first, logits, cache = srv.prefill(p, {"tokens": tokens})
        prefill = [a - b for a, b in zip(_launches(), before)]
        toks, cache = srv.decode(p, first, pad_cache(cache, 60), 48, 6)
        out[str(where)] = (logits.cpu(), toks.cpu(), [c.cpu() for c in cache_leaves(cache)],
                           prefill, [a - b for a, b in zip(_launches(), before)])
    (l_cpu, t_cpu, c_cpu, *n_cpu), (l_card, t_card, c_card, *n_card) = out["cpu"], out[str(card)]
    want = ([n_shared_invocations(cfg), cfg.n_layers] if cfg.arch_type == "hybrid"
            else [cfg.n_layers, 0])
    assert n_cpu == [[0, 0], [0, 0]] and n_card == [want, want]
    for a, b in [(l_card, l_cpu), *zip(c_card, c_cpu)]:
        if b.is_floating_point():
            rel = (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
            assert rel <= ROUND_TOL
        else:
            assert torch.equal(a, b)
    assert torch.equal(t_card, t_cpu)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "olmoe-1b-7b"])
def test_hybrid_and_moe_serving_defaults_to_the_card_and_never_waits_on_the_host(card, arch):
    """``serve_demo`` and ``init_cache`` run on the card by default; then a
    bf16 prefill and decode with every device→host sync made an error (the
    MoE's routing, dispatch and gather included)."""
    from repro_torch.models.cache import cache_leaves

    cfg = _family_cfg(arch)
    assert all(c.device.type == "cuda" for c in cache_leaves(lm_api.init_cache(cfg, 2, 40)))
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(2))
    toks, stats = serve_demo(cfg, {"tokens": tokens}, n_tokens=4)
    assert toks.shape == (2, 4) and int(toks.max()) < cfg.vocab_size and stats["decode_s"] > 0
    srv = Server(cfg, InputShape("serve", seq_len=40, global_batch=2, kind="decode"), card)
    params = srv.load_params(lm_api.model_init(cfg, device=card))
    tokens = tokens.to(card)  # a copy from pageable host memory syncs
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first, _, cache = srv.prefill(params, {"tokens": tokens})
        toks, cache = srv.decode(params, first, pad_cache(cache, 40), 32, 6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert toks.shape == (2, 6)


# -- the enc-dec (seamless) and VLM (internvl2) LMs ------------------------------


def _prompt(cfg, b, s, seed):
    """``s`` tokens and the config's frames (enc-dec) or patches (VLM),
    drawn on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen)}
    if cfg.arch_type == "encdec":
        batch["frames"] = torch.randn(b, cfg.encdec.n_enc_frames, cfg.d_model, generator=gen)
    else:
        batch["embeds"] = torch.randn(b, cfg.vlm.n_patches, cfg.d_model, generator=gen)
    return batch


def _n_patches(cfg):
    return cfg.vlm.n_patches if cfg.arch_type == "vlm" else 0


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-76b"])
def test_reduced_encdec_and_vlm_prefill_and_decode_on_card_match_cpu(card, arch):
    """fp32, the reduced configs (seamless: 2 + 2 layers over 16 frames, one
    flash launch an encoder layer and two a decoder layer in the prefill, one
    a decoder layer in each decode step; internvl2: 2 layers after 8
    patches, one flash launch a layer in the prefill, none in decode): the
    card's prefill of a 40-token prompt and 5 greedy decode steps against
    the CPU path on the same weights and inputs, logits and every cache
    tensor within 1e-4 relative L2, tokens equal."""
    from repro_torch.models.cache import cache_leaves

    cfg = configs.reduced_config(arch)
    params = lm_api.model_init(cfg, seed=0, device="cpu")
    batch = _prompt(cfg, 2, 40, 1)
    n_pos = _n_patches(cfg) + 40
    shape = InputShape("serve", seq_len=n_pos + 6, global_batch=2, kind="decode")
    out = {}
    for where in ("cpu", card):
        srv = Server(cfg, shape, where, dtype=torch.float32)
        p = srv.load_params(params)
        before = attn_kernel.launches
        first, logits, cache = srv.prefill(p, batch)
        prefill = attn_kernel.launches - before
        toks, cache = srv.decode(p, first, pad_cache(cache, n_pos + 6), n_pos, 6)
        out[str(where)] = (logits.cpu(), toks.cpu(), [c.cpu() for c in cache_leaves(cache)],
                           prefill, attn_kernel.launches - before)
    (l_cpu, t_cpu, c_cpu, *n_cpu), (l_card, t_card, c_card, *n_card) = out["cpu"], out[str(card)]
    if cfg.arch_type == "encdec":
        want = [cfg.encdec.n_enc_layers + 2 * cfg.n_layers]
        want.append(want[0] + 5 * cfg.n_layers)
    else:
        want = [cfg.n_layers, cfg.n_layers]
    assert n_cpu == [0, 0] and n_card == want
    for a, b in [(l_card, l_cpu), *zip(c_card, c_cpu)]:
        if b.is_floating_point():
            rel = (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
            assert rel <= ROUND_TOL
        else:
            assert torch.equal(a, b)
    assert torch.equal(t_card, t_cpu)


def test_encdec_decode_step_launches_the_flash_kernel_once_a_decoder_layer(card):
    """Each decode step of seamless sends every decoder layer's
    cross-attention (one query against the cached frames) to the kernel,
    in bf16 as served, and nothing else: its self-attention is the plain
    decode against the KV cache."""
    cfg = dataclasses.replace(configs.reduced_config("seamless-m4t-large-v2"), n_layers=3)
    srv = Server(cfg, InputShape("serve", seq_len=24, global_batch=2, kind="decode"), card)
    params = srv.load_params(lm_api.model_init(cfg, device=card))
    first, _, cache = srv.prefill(params, _prompt(cfg, 2, 16, 2))
    cache = pad_cache(cache, 24)
    tok = first
    for t in range(16, 22):
        before = attn_kernel.launches
        logits, cache = lm_api.model_decode(params, cfg, tok, cache, t, torch.bfloat16)
        assert attn_kernel.launches - before == cfg.n_layers
        assert bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-76b"])
def test_encdec_and_vlm_serving_defaults_to_the_card_and_never_waits_on_the_host(card, arch):
    """``serve_demo`` and ``init_cache`` run on the card by default; then a
    bf16 prefill and decode with every device→host sync made an error."""
    from repro_torch.models.cache import cache_leaves

    cfg = configs.reduced_config(arch)
    assert all(c.device.type == "cuda" for c in cache_leaves(lm_api.init_cache(cfg, 2, 40)))
    batch = _prompt(cfg, 2, 24, 3)
    toks, stats = serve_demo(cfg, batch, n_tokens=4)
    assert toks.shape == (2, 4) and int(toks.max()) < cfg.vocab_size and stats["decode_s"] > 0
    n_pos = _n_patches(cfg) + 24
    srv = Server(cfg, InputShape("serve", seq_len=n_pos + 8, global_batch=2, kind="decode"),
                 card)
    params = srv.load_params(lm_api.model_init(cfg, device=card))
    on_card = {k: v.to(card) for k, v in batch.items()}  # a copy from pageable memory syncs
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first, _, cache = srv.prefill(params, on_card)
        toks, cache = srv.decode(params, first, pad_cache(cache, n_pos + 8), n_pos, 6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert toks.shape == (2, 6)


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
    from repro_torch.device import cudnn_deterministic
    from repro_torch.obs import ObsConfig

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


def test_checkpointed_run_restores_the_deterministic_flag_after_an_exception(card, tmp_path):
    """The flag is on inside the local update's gradients and back to its
    old value after the call, also when a gradient raises."""
    from repro_torch.sim import resilience

    task, spec, cfg = _cnn_lattice(card, n_rounds=2)
    seen = []

    def failing_loss(params, x, y):
        seen.append(torch.backends.cudnn.deterministic)
        raise RuntimeError("gradient failed")

    for before in (False, True):
        torch.backends.cudnn.deterministic = before
        with pytest.raises(RuntimeError, match="gradient failed"):
            resilience.run_lattice_checkpointed(failing_loss, task.data, task.params0, spec,
                                                base_cfg=cfg, checkpoint_every=1,
                                                checkpoint_dir=str(tmp_path / str(before)))
        assert torch.backends.cudnn.deterministic is before
    torch.backends.cudnn.deterministic = False
    assert seen == [True, True]


# -- the card's lattices repeat bitwise by default -------------------------------


def _full_width_cnn_lattices(card):
    """The CNN lattice (5 policies × 3 seeds, full width) and the CNN
    scenario lattice (4 algorithms × 3 policies × 2 seeds, K = 2, dropout
    over Gauss–Markov, Dirichlet-sized shards), 2 rounds each: ``(task,
    spec, cfg, run_lattice keywords)`` each."""
    base = dict(n_devices=30, n_train=3000, n_test=1000, seed=0, channel_bias=1.0, device=card)
    cfg = pofl.POFLConfig(n_devices=30, n_scheduled=10, noise_power=1e-10,
                          backend="pallas_fused")
    cnn = (make_model_task("cnn", **base),
           LatticeSpec(policies=scheduling.POLICIES, noise_powers=(1e-10,), seeds=(0, 1, 2),
                       n_rounds=2, eval_every=1),
           cfg, {})
    scenario = (make_model_task("cnn", partition="dirichlet_sized", beta=0.4, **base),
                LatticeSpec(algorithms=ALGORITHMS, policies=("pofl", "importance", "channel"),
                            noise_powers=(1e-10,), seeds=(0, 1), n_rounds=2, eval_every=1),
                dataclasses.replace(cfg, local_steps=2, fedprox_mu=0.1),
                dict(scenario="dropout",
                     scenario_params={"base": "gauss_markov", "corr": 0.9, "p_drop": 0.1}))
    return {"cnn_lattice": cnn, "cnn_scenario_lattice": scenario}


@pytest.mark.parametrize("lattice", ["cnn_lattice", "cnn_scenario_lattice"])
def test_cnn_lattices_repeat_bitwise_by_default(card, lattice):
    """Two runs of a full-width CNN lattice give bitwise the same records
    with cuDNN's flag as the user left it (off): the local update's
    gradients run under the deterministic algorithms (with cuDNN's default
    ones both convolution gradients differ run to run), and the flag is
    back off after each run."""
    task, spec, cfg, kw = _full_width_cnn_lattices(card)[lattice]
    torch.backends.cudnn.deterministic = False
    a, b = (run_lattice(task.loss_fn, task.data, task.params0, spec, base_cfg=cfg,
                        eval_fn=task.eval, **kw) for _ in range(2))
    assert torch.backends.cudnn.deterministic is False
    for f in ("e_com", "e_var", "grad_norm", "n_scheduled", "loss", "acc"):
        assert (getattr(a, f) == getattr(b, f)).all(), f
    for fa, fb in zip(a.eval, b.eval):
        assert (fa == fb).all()


# -- the LM training path ---------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_functions_backward_and_jvp_match_the_plain_rules(card, dtype):
    """The flash and SSD kernels through their autograd Functions (as
    ``ops`` applies them on a CUDA tensor): each launches its kernel once a
    forward, and the gradients and tangents match autograd and
    ``torch.func.jvp`` of the plain version (relative L2 ≤ 1e-5 in fp32,
    2^-7 in bf16: the backward rounds its query chunks' dk, dv first)."""
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7
    gen = torch.Generator(device=card).manual_seed(0)

    def rel(a, b):
        return (torch.linalg.vector_norm((a - b).float())
                / torch.linalg.vector_norm(b.float())).item()

    q, k, v = attention_inputs(2, 1100, 1100, 4, 2, 64, dtype, card, seed=1)
    xdt, la, B, C = ssd_inputs(2, 512, 4, 32, 16, dtype, card, seed=2)
    cases = [
        (attn_kernel, lambda *a: attn_ops.attention(*a, causal=True),
         lambda *a: flash_attention_ref(*a, causal=True), (q, k, v)),
        (ssd_kernel, lambda *a: ssd_ops.ssd(*a, chunk=256),
         lambda *a: ssd_chunked_ref(*a, 256), (xdt, la, B, C)),
    ]
    for kern, fn, plain, inputs in cases:
        ins = [x.clone().requires_grad_() for x in inputs]
        before = kern.launches
        out = fn(*ins)
        assert kern.launches == before + 1 and out.grad_fn is not None
        dout = torch.randn(out.shape, generator=gen, device=card, dtype=dtype)
        got = torch.autograd.grad(out, ins, dout)
        ref_ins = [x.clone().requires_grad_() for x in inputs]
        want = torch.autograd.grad(plain(*ref_ins), ref_ins, dout)
        assert all(rel(g, w) <= tol for g, w in zip(got, want))
        tangents = tuple(torch.randn(x.shape, generator=gen, device=card, dtype=x.dtype)
                         for x in inputs)
        _, t_got = torch.func.jvp(fn, inputs, tangents)
        _, t_want = torch.func.jvp(plain, inputs, tangents)
        assert rel(t_got, t_want) <= tol


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m", "zamba2-2.7b", "olmoe-1b-7b",
                                  "seamless-m4t-large-v2", "internvl2-76b"])
def test_reduced_train_step_on_card_matches_cpu_in_every_leaf(card, arch):
    """One train step (fp32, remat, 2 FL devices, no noise) of each family's
    reduced config, 2 layers: every gradient leaf on the card non-zero and
    within 1e-4 relative L2 of the CPU's (a kernel that cut the graph would
    leave its inputs' weights without a gradient)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim.optimizers import Optimizer, sgd

    cfg = dataclasses.replace(configs.reduced_config(arch), n_layers=2)
    params = lm_api.model_init(cfg, seed=0, device="cpu")
    if cfg.ssm is not None:  # Mamba2's own dt init (the reference's zeros are ill-conditioned)
        dt = torch.exp(torch.empty(params["layers"]["mamba"]["dt_bias"].shape).uniform_(
            -6.9, -2.3, generator=torch.Generator().manual_seed(1)))
        params["layers"]["mamba"]["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    gen = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)}
    if cfg.arch_type == "vlm":
        batch["embeds"] = torch.randn(4, cfg.vlm.n_patches, cfg.d_model, generator=gen)
    if cfg.arch_type == "encdec":
        batch["frames"] = torch.randn(4, cfg.encdec.n_enc_frames, cfg.d_model, generator=gen)
    grads = {}
    for where in ("cpu", card):
        seen, base = {}, sgd(0.0)

        def update(g, state, p, _seen=seen):
            _seen["g"] = g
            return base.update(g, state, p)

        bundle = build_train_step(cfg, InputShape("t", 32, 4, "train"),
                                  make_host_mesh(1, 2, where), Optimizer(base.init, update),
                                  dtype=torch.float32, aircomp_noise=False)
        p = tree_map(lambda x: x.to(where), params)
        bundle.fn(p, base.init(p), {k: v.to(where) for k, v in batch.items()},
                  torch.tensor([0.7, 1.3], device=where), torch.zeros((), device=where), None)
        grads[str(where)] = ravel_pytree(tree_map(lambda x: x.cpu(), seen["g"]))[0]
        if where != "cpu":
            from repro_torch.flatten_util import tree_leaves
            assert all(float(torch.linalg.vector_norm(g)) > 0 for g in tree_leaves(seen["g"]))
    c, g = grads["cpu"], grads[str(card)]
    assert (torch.linalg.vector_norm(g - c) / torch.linalg.vector_norm(c)).item() <= ROUND_TOL


def test_trainer_defaults_to_the_card_and_runs_two_rounds(card):
    """``POFLTrainer`` on a card mesh (the default device), bf16, sketch
    mode: two rounds, every value finite, the flash kernel launched once a
    layer in each JVP pass and twice a layer in the step."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import POFLTrainer, TrainerConfig

    cfg = _lm_cfg(layers=2)
    mesh = make_host_mesh(1, 4)
    assert mesh.device.type == "cuda"
    trainer = POFLTrainer(cfg, InputShape("t", 64, 8, "train"), mesh,
                          TrainerConfig(n_scheduled=2, n_probes=2, noise_power=1e-10))
    params, opt_state = trainer.init_state(0)
    tokens = torch.randint(0, cfg.vocab_size, (8, 64), device=card,
                           generator=torch.Generator(device=card).manual_seed(0))
    before = attn_kernel.launches
    for _ in range(2):
        params, opt_state, diag = trainer.train_round(params, opt_state, {"tokens": tokens})
        assert all(bool(torch.isfinite(v).all()) for v in diag.values())
    assert attn_kernel.launches - before == 2 * cfg.n_layers * (3 + 2)
    assert params["embed"].device.type == "cuda"


def test_one_rank_nccl_trainer_matches_the_one_card_trainer(card):
    """``POFLTrainer`` on a (1, 1) mesh of one NCCL rank (this process)
    against the one-card ``HostMesh`` trainer on the same draws: two bf16
    rounds, the round's values and the parameters bitwise equal; the flash
    kernel launched L × (3 + 2) times a round on the rank path too."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh, make_rank_mesh
    from repro_torch.launch.train import POFLTrainer, TrainerConfig

    cfg = _lm_cfg(layers=2)
    shape = InputShape("t", 64, 8, "train")
    tcfg = TrainerConfig(n_scheduled=2, n_probes=2, noise_power=1e-10)
    tokens = torch.randint(0, cfg.vocab_size, (8, 64), device=card,
                           generator=torch.Generator(device=card).manual_seed(0))

    def rounds(mesh):
        trainer = POFLTrainer(cfg, shape, mesh, tcfg)
        params, opt_state = trainer.init_state(0)
        diags = []
        for _ in range(2):
            params, opt_state, diag = trainer.train_round(params, opt_state, {"tokens": tokens})
            diags.append(diag)
        return params, diags

    want_params, want = rounds(make_host_mesh(1, 4))
    try:
        mesh = make_rank_mesh(model=1, n_fl=4)
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        before = attn_kernel.launches
        got_params, got = rounds(mesh)
        assert attn_kernel.launches - before == 2 * cfg.n_layers * (3 + 2)
    finally:
        dist.destroy_process_group()
    for g, w in zip(got, want):
        for k in w:
            assert torch.equal(g[k], w[k]), k
    assert torch.equal(ravel_pytree(got_params)[0], ravel_pytree(want_params)[0])


# -- tensor-parallel serving --------------------------------------------------------


def test_row_split_product_on_card_keeps_the_fp32_accumulator(card):
    """A bf16 row-split product on the card hands the group its GEMM's fp32
    accumulator (``mm``'s ``out_dtype``), not a rounded partial: each
    rank's partial is the exact product to fp32 accumulation, and the sum
    rounded once is the CPU's fp32 product of the same values rounded once
    but for roundings the summation order tips."""
    from repro_torch.models.layers import ModelGroup, row_split_matmul

    dtype = torch.bfloat16
    gen = torch.Generator(device=card).manual_seed(0)
    a = torch.randn(2, 64, 2 * 448, generator=gen, device=card).to(dtype)
    w = torch.randn(2 * 448, 896, generator=gen, device=card).to(dtype)
    parts = []

    def keep(x):
        assert x.dtype == torch.float32
        parts.append(x.clone())

    outs = [row_split_matmul(a[..., r * 448:(r + 1) * 448], w[r * 448:(r + 1) * 448], dtype,
                             ModelGroup(r, 2, None, keep, None)) for r in range(2)]
    for r, (part, out) in enumerate(zip(parts, outs)):
        exact = a[..., r * 448:(r + 1) * 448].double() @ w[r * 448:(r + 1) * 448].double()
        assert part.shape == (2, 64, 896) and out.dtype == dtype
        assert ((part.double() - exact).norm() / exact.norm()).item() <= 1e-6
    whole = (parts[0] + parts[1]).to(dtype)
    cpu = (a.cpu().float() @ w.cpu().float()).to(dtype)
    off = (whole.cpu() != cpu).float().mean().item()
    assert off <= 1e-3, off


# -- tensor-parallel training -------------------------------------------------------


def test_split_bf16_train_step_gradients_on_card_match_the_fp32_route(card, tmp_path):
    """``mm`` with ``out_dtype`` has no derivative, so a bf16 row-split
    partial on the card is an autograd Function (``layers._Fp32Accumulate``):
    its gradients (two bf16 GEMMs, fp32 accumulators, one rounding each)
    and its tangent against autograd and ``torch.func.jvp`` of the same
    product from fp32 copies of the same bf16 values, each within 2^-7
    relative L2. Then one bf16 train step of qwen2-0.5b at full width cut
    to 1 layer (2 × 512 tokens) split over a (1, 2) mesh of two gloo ranks
    sharing the card, its partials by that Function, against the same step
    with them from fp32 copies: each rank's every gradient block non-zero
    and within 2^-7 relative L2 (5.5e-3 at most; the two accumulation
    orders move a few bf16 roundings, which the random-weight model
    amplifies with depth, ROADMAP C: 8.5e-3 at 2 layers, 1.2e-2 at 4, in
    the whole raveled gradient). The ranks run through the launcher
    (``tests/_torch_mesh_worker.py``, job ``tp_route``): two threads'
    backwards on one card would share its autograd device thread and wait
    on each other."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.flatten_util import tree_leaves
    from repro_torch.models.layers import _Fp32Accumulate

    def rel(a, b):
        return (torch.linalg.vector_norm((a - b).float())
                / torch.linalg.vector_norm(b.float())).item()

    gen = torch.Generator(device=card).manual_seed(4)
    a, w, dy = (torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
                for shape in ((512, 448), (448, 896), (512, 896)))
    ta, tw = torch.randn_like(a), torch.randn_like(w)
    with pytest.raises(RuntimeError, match="derivative"):
        torch.mm(a.clone().requires_grad_(), w, out_dtype=torch.float32).backward(dy.float())
    ins = [x.clone().requires_grad_() for x in (a, w)]
    got = torch.autograd.grad(_Fp32Accumulate.apply(*ins), ins, dy.float())
    ref = [x.clone().requires_grad_() for x in (a, w)]
    want = torch.autograd.grad(ref[0].float() @ ref[1].float(), ref, dy.float())
    assert all(g.dtype == torch.bfloat16 and rel(g, v) <= 2.0**-7 for g, v in zip(got, want))
    _, t_got = torch.func.jvp(_Fp32Accumulate.apply, (a, w), (ta, tw))
    _, t_want = torch.func.jvp(lambda x, y: x.float() @ y.float(), (a, w), (ta, tw))
    assert t_got.dtype == torch.float32 and rel(t_got, t_want) <= 2.0**-7

    root = Path(__file__).resolve().parents[1]
    cfg = configs.cut_depth(configs.base_config("qwen2-0.5b"), 1)
    inp = {"cfg": cfg, "shape": InputShape("t", 512, 2, "train"), "seed": 0,
           "tokens": torch.randint(0, cfg.vocab_size, (2, 512),
                                   generator=torch.Generator().manual_seed(2))}
    path_in, path_out = tmp_path / "in.pt", tmp_path / "out.pt"
    torch.save(inp, path_in)
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.distributed", "--procs", "2", "--timeout",
         "240", "--", sys.executable, str(root / "tests" / "_torch_mesh_worker.py"), "tp_route",
         str(path_in), str(path_out)],
        capture_output=True, text=True, cwd=root, timeout=300,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    ranks = torch.load(path_out, weights_only=False)["result"]["ranks"]
    for rank in ranks:
        assert rank["card_partials"] == 2 * cfg.n_layers * 2  # forward and recompute
        got, want = (tree_leaves(rank["grads"][route]) for route in ("card", "fp32"))
        assert all(float(torch.linalg.vector_norm(g.float())) > 0 for g in got)
        errs = [rel(g, v) for g, v in zip(got, want, strict=True)]
        assert max(errs) <= 2.0**-7, errs


# -- the MoE over data ranks -------------------------------------------------------


def test_moe_decode_of_128_rows_over_two_ranks_on_card_routes_as_one_process(card, tmp_path):
    """One olmoe-1b-7b MoE layer at full width (64 experts, top-8), fp32,
    on a decode step's 128 rows: two gloo ranks sharing the card, 64 rows
    each, route them in the batch's one group of 128 (capacity 20)
    gathering each other's experts (job ``moe_ranks`` of
    ``tests/_torch_mesh_worker.py``), against this process's ``moe_fwd`` on
    all 128 rows: the ranks' routes joined (``layers.whole_route``) have the
    same experts wherever the one process's k + 1 largest probabilities are
    more than 1e-6 apart, the same positions and drops wherever no changed
    choice touched the expert, and drop at least one (slot, token); the
    outputs joined and the mean of the ranks' aux within 1e-5 relative L2."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.models import layers

    def rel(a, b):
        return (torch.linalg.vector_norm((a - b).double())
                / torch.linalg.vector_norm(b.double())).item()

    root = Path(__file__).resolve().parents[1]
    cfg = configs.base_config("olmoe-1b-7b")
    x = torch.randn((128, 1, cfg.d_model), generator=torch.Generator().manual_seed(3))
    path_in, path_out = tmp_path / "in.pt", tmp_path / "out.pt"
    torch.save({"device": "cuda", "layer": {"decode": {"cfg": cfg, "seed": 5, "x": x}}}, path_in)
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.distributed", "--procs", "2", "--timeout",
         "240", "--", sys.executable, str(root / "tests" / "_torch_mesh_worker.py"), "moe_ranks",
         str(path_in), str(path_out)],
        capture_output=True, text=True, cwd=root, timeout=300,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-3000:]
    ranks = torch.load(path_out, weights_only=False)["result"]["decode"]
    params = layers.init_moe(torch.Generator(card).manual_seed(5), cfg, device=card)
    with layers.recorded_routes() as seen:
        out, aux = layers.moe_fwd(params, x.to(card), cfg, torch.float32)
    want = type(seen[0])(*(v.cpu() if isinstance(v, torch.Tensor) else v for v in seen[0]))
    got = layers.whole_route([r["route"] for r in ranks])
    assert got.cap == want.cap == 20 and got.gate_idx.shape == want.gate_idx.shape == (1, 128, 8)
    k = cfg.moe.top_k
    top = want.probs.sort(dim=-1, descending=True).values[..., :k + 1]
    tie = ((top[..., :-1] - top[..., 1:]) <= 1e-6).any(-1)
    differ = (got.gate_idx != want.gate_idx).any(-1)
    assert not (differ & ~tie).any()
    touched = torch.zeros(cfg.moe.n_experts, dtype=torch.bool)
    for side in (got, want):
        touched[side.gate_idx[0][differ[0]].flatten()] = True
    held = ~touched[want.gate_idx[0].T]  # (k, 128)
    assert torch.equal(got.pos[0][held], want.pos[0][held])
    assert torch.equal(got.within[0][held], want.within[0][held])
    assert int((~got.within).sum()) > 0
    assert rel(torch.cat([r["out"] for r in ranks]), out.detach().cpu()) <= 1e-5
    assert rel(sum(r["aux"] for r in ranks) / 2, aux.detach().cpu()) <= 1e-5
