#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main path on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; a phase that fails ends the run with a
non-zero exit and no result line:

  device     the card, as torch and ``nvidia-smi`` name it
  build      every kernel of both paths compiled from ``src/repro_torch``
             (one library, two entries)
  check      each kernel against its plain PyTorch version on the card
             (fp32, |kernel - plain| ≤ 1e-5 · max(1, max|plain|))
  times      each kernel, its plain version, one library call and the bound
             at its path's shapes (and, for the batch kernel, B launches of
             the one-round kernel it replaces)
  main       ``run_pofl`` through the user's entry points: logreg (pofl and
             channel, 30 rounds) and the full-width CNN (D=258,634, N=30
             devices, 10 scheduled), ``backend="pallas_fused"``; launch
             counts are zeroed just before and read just after
  no_sync    rounds run with device→host syncs turned into errors
  parity     one CNN round on the card against the port's CPU path from one
             state and one set of draws (relative L2 error of the update and
             relative error of each metric ≤ 1e-4)
  breakdown  ``torch.profiler`` over the real ``round_algorithm``: host and
             device kernel ms per ``pofl.*`` range, and the device's idle share
  lattice    ``run_lattice`` through the user's entry points,
             ``backend="pallas_fused"``: the full-width CNN (5 policies × 3
             seeds, 10 rounds) and logreg (5 policies × 2 noise levels × 3
             seeds, 30 rounds); counts zeroed just before and read just
             after: one batch-kernel launch a round, no one-round launch;
             every record finite but in the cells named in DIVERGING_CELLS
  diverging  each named diverging cell again through ``run_pofl`` on the
             card and through the port's CPU round on the card's draws:
             both must diverge too, within one round of the lattice cell
  lattice_no_sync  two CNN lattice rounds with device→host syncs as errors
  lattice_parity   one full-width CNN lattice round (2 policies × 2 seeds)
             on the card against the port's CPU path (≤ 1e-4, as ``parity``)
  lattice_breakdown  ``torch.profiler`` over one CNN lattice round: host and
             device kernel ms per ``lattice.*`` range, the device's idle share

then the ``kernels`` line, the card's name and power limit, and the result
``{"ok": true, "device": {...}}``. Everything runs in fp32: TF32 is off for
matmuls and for cuDNN's convolutions (with TF32 the CNN round misses the
parity tolerance). Without a CUDA card, or without the repo's sources beside
this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import bisect
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
KERNEL_TOL = 1e-5
ROUND_TOL = 1e-4
N_DEVICES, N_SCHEDULED = 30, 10
CNN_DIM, LOGREG_DIM = 258_634, 7850
CNN_ROUNDS, LOGREG_ROUNDS = 20, 30
POLICIES = ("pofl", "importance", "channel", "noisefree", "deterministic")
LATTICE_SEEDS = (0, 1, 2)
# (task, noise levels, rounds, eval_every) of the lattice phase
LATTICES = {"cnn": ((1e-10,), 10, 5), "logreg": ((1e-10, 1e-8), 30, 10)}
# The lattice cells whose records may go non-finite, by name: (task, policy,
# σ_z², seed). The `diverging` phase requires each one to diverge also through
# `run_pofl` on the card and through the port's CPU round on the card's
# draws; every value of every other cell must be finite.
DIVERGING_CELLS = (("cnn", "channel", 1e-10, 2),)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- kernel inputs, check and timing -----------------------------------------


def aircomp_inputs(n, d, dev, seed=0, empty=False, row_stride=None):
    """Gradient-like g (n, d), coeff = mask·ρ, z and the 0-d scalars."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randn(n, row_stride or d, generator=gen, device=dev) * 0.05 + 0.01
    g = rows[:, :d]
    coeff = torch.rand(n, generator=gen, device=dev)
    coeff = coeff * (torch.rand(n, generator=gen, device=dev) > 0.3)
    z = torch.randn(d, generator=gen, device=dev)
    m_g, v_g, a = (torch.rand((), generator=gen, device=dev) + 0.1 for _ in range(3))
    if empty:  # nothing scheduled: a = min over the empty set = inf, coeff = 0
        coeff = torch.zeros_like(coeff)
        m_g, a = torch.zeros((), device=dev), torch.full((), math.inf, device=dev)
    return g, coeff, m_g, v_g, a, z


CHECK_CASES = {  # name: (n, d, empty, row_stride)
    "cnn": (N_DEVICES, CNN_DIM, False, None),
    "logreg": (N_DEVICES, LOGREG_DIM, False, None),
    "d_off_block": (5, 1000, False, None),
    "d_below_block": (3, 100, False, None),
    "n_1": (1, 4096, False, None),
    "d_odd": (7, 1001, False, None),
    "d_mult_4": (N_DEVICES, 8192, False, None),
    "strided_rows": (4, 1000, False, 1200),
    "empty_schedule": (N_DEVICES, CNN_DIM, True, None),
}


def check_aircomp(kernel, ref, dev) -> float:
    worst = 0.0
    errs = {}
    for i, (name, (n, d, empty, stride)) in enumerate(CHECK_CASES.items()):
        args = aircomp_inputs(n, d, dev, seed=i, empty=empty, row_stride=stride)
        got, want = kernel.aircomp_fused(*args), ref(*args)
        torch.cuda.synchronize()
        if got.shape != (d,) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"aircomp_fused {name}: bad shape or non-finite output")
        err = (got - want).abs().max().item()
        limit = KERNEL_TOL * max(1.0, want.abs().max().item())
        if err > limit:
            raise AssertionError(f"aircomp_fused {name}: max error {err} > {limit}")
        errs[name] = err
        worst = max(worst, err)
    emit("check", kernel="aircomp_fused", tolerance=KERNEL_TOL, max_abs_err=errs)
    return worst


def time_ms(fn, flush: torch.Tensor, reps: int = 50) -> float:
    """Median device time of one call, L2 flushed before each (cold, as g
    comes from HBM), by CUDA events around the call alone."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def aircomp_bound(n: int, d: int) -> tuple[float, str]:
    """The least time for the work: each input read once, the output written once."""
    nbytes = n * d * 4 + 2 * d * 4 + n * 4
    flops = 2 * n * d + 4 * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_aircomp(kernel, ref, dev) -> dict:
    flush = torch.empty(256 * 2**20 // 4, device=dev)  # 256 MiB > the 50 MB L2
    out = {}
    for name, d in (("cnn", CNN_DIM), ("logreg", LOGREG_DIM)):
        g, coeff, m_g, v_g, a, z = aircomp_inputs(N_DEVICES, d, dev, seed=7)
        beta = (math.sqrt(max(v_g.item(), 1e-30)) / a.item())
        bound_ms, bound_by = aircomp_bound(N_DEVICES, d)
        out[name] = {
            "shape": [N_DEVICES, d],
            "ms": time_ms(lambda: kernel.aircomp_fused(g, coeff, m_g, v_g, a, z), flush),
            "plain_ms": time_ms(lambda: ref(g, coeff, m_g, v_g, a, z), flush),
            # one library call for the same matvec + noise axpy (the scalar
            # offset M_g(1-W) left out); timed here only, never in the port
            "library_ms": time_ms(lambda: torch.addmv(z, g.t(), coeff, beta=beta), flush),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
    emit("times", kernel="aircomp_fused", **out)
    return out


def check_aircomp_batch(kernel, ref, single_ref, dev) -> float:
    """The batch kernel against its plain version, and each trial against
    the one-round plain version on that trial's inputs (so a kernel that
    read another trial's scalars fails)."""
    from repro_torch.kernels.aircomp.cases import BATCH_CHECK_CASES, batch_inputs

    worst, errs = 0.0, {}
    for i, (name, (b, n, d, empty, strided)) in enumerate(BATCH_CHECK_CASES.items()):
        args = batch_inputs(b, n, d, dev, seed=100 + i, empty_trial=empty, strided=strided)
        got, want = kernel.aircomp_fused_batch(*args), ref(*args)
        torch.cuda.synchronize()
        if got.shape != (b, d) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"aircomp_fused_batch {name}: bad shape or non-finite")
        limit = KERNEL_TOL * max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item()
        per_trial = max((got[c] - single_ref(*(x[c] for x in args))).abs().max().item()
                        for c in range(b))
        if err > limit or per_trial > limit:
            raise AssertionError(
                f"aircomp_fused_batch {name}: max error {err} (per trial {per_trial}) > {limit}")
        errs[name] = err
        worst = max(worst, err)
    emit("check", kernel="aircomp_fused_batch", tolerance=KERNEL_TOL, max_abs_err=errs)
    return worst


def aircomp_batch_bound(b: int, n: int, d: int) -> tuple[float, str]:
    """The least time for one batch call: g, z, coeff and the scalars read
    once, ŷ written once; 2·B·N·D + 4·B·D flops."""
    nbytes = b * n * d * 4 + 2 * b * d * 4 + b * n * 4 + 3 * b * 4
    flops = 2 * b * n * d + 4 * b * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_aircomp_batch(kernel, ref, dev) -> dict:
    from repro_torch.kernels.aircomp.cases import batch_inputs

    flush = torch.empty(256 * 2**20 // 4, device=dev)  # 256 MiB > the 50 MB L2
    out = {}
    for name, b, d in (("cnn", 15, CNN_DIM), ("logreg", 30, LOGREG_DIM)):
        g, coeff, m_g, v_g, a, z = batch_inputs(b, N_DEVICES, d, dev, seed=7)

        def one_round_launches():  # what a lattice round without the batch kernel does
            for c in range(b):
                kernel.aircomp_fused(g[c], coeff[c], m_g[c], v_g[c], a[c], z[c])

        bound_ms, bound_by = aircomp_batch_bound(b, N_DEVICES, d)
        out[name] = {
            "shape": [b, N_DEVICES, d],
            "ms": time_ms(lambda: kernel.aircomp_fused_batch(g, coeff, m_g, v_g, a, z), flush),
            "plain_ms": time_ms(lambda: ref(g, coeff, m_g, v_g, a, z), flush),
            # one library call for the dominant work, the B weighted sums
            # over devices; timed here only, never in the port
            "library_ms": time_ms(lambda: torch.bmm(coeff[:, None, :], g), flush),
            "b_launches_of_aircomp_fused_ms": time_ms(one_round_launches, flush),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
    emit("times", kernel="aircomp_fused_batch", **out)
    return out


# -- the main path -------------------------------------------------------------


def main_path(dev) -> dict:
    from repro_torch.core.channel import ChannelConfig
    from repro_torch.core.pofl import POFLConfig, run_pofl
    from repro_torch.kernels.aircomp import kernel
    from repro_torch.sim.tasks import make_model_task

    tasks = {kind: make_model_task(kind, n_devices=N_DEVICES, n_train=3000, n_test=1000,
                                   seed=0, device=dev, **kw)
             for kind, kw in (("logreg", {}), ("cnn", {"channel_bias": 1.0}))}
    runs = [("logreg", "pofl", LOGREG_ROUNDS), ("logreg", "channel", LOGREG_ROUNDS),
            ("cnn", "pofl", CNN_ROUNDS)]
    ccfg = ChannelConfig(n_devices=N_DEVICES, noise_power=1e-10)
    for kind, task in tasks.items():  # first calls (cuBLAS, cuDNN, allocator) off the clock
        run_pofl(task.loss_fn, task.params0, task.data,
                 POFLConfig(n_devices=N_DEVICES, backend="pallas_fused"), 2)
    results = {}
    torch.cuda.synchronize()
    kernel.launches = 0  # every count zeroed just before the main path
    for kind, policy, rounds in runs:
        task = tasks[kind]
        cfg = POFLConfig(n_devices=N_DEVICES, n_scheduled=N_SCHEDULED, policy=policy,
                         noise_power=1e-10, backend="pallas_fused")
        before = kernel.launches
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params, hist = run_pofl(task.loss_fn, task.params0, task.data, cfg, rounds,
                                eval_fn=task.eval, eval_every=5, channel_cfg=ccfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = kernel.launches - before
        flat = task.ravel(params)
        finite = all(math.isfinite(v) for v in hist.e_com + hist.e_var + hist.test_acc)
        if launched != rounds or flat.shape != (task.dim,) or not finite \
                or not bool(torch.isfinite(flat).all()) or len(hist.e_com) != rounds:
            raise AssertionError(f"main path {kind}/{policy}: launches {launched}, "
                                 f"dim {flat.shape}, finite {finite}")
        results[f"{kind}_{policy}"] = hist
        emit("main", run=f"{kind}_{policy}", d=task.dim, rounds=rounds,
             seconds=seconds, rounds_per_s=rounds / seconds,
             test_round=hist.test_round, test_acc=hist.test_acc,
             launches={"aircomp_fused": launched},
             max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    main_launches = kernel.launches  # read just after the main path
    acc = results["logreg_pofl"].test_acc
    if not acc[-1] > max(0.8, acc[0]):
        raise AssertionError(f"logreg pofl did not learn: {acc}")
    return {"aircomp_fused": main_launches}


def no_sync(dev) -> None:
    """Rounds of both models with every device→host sync made an error."""
    from repro_torch.core.pofl import POFLConfig, round_algorithm
    from repro_torch.sim.engine import SimEngine
    from repro_torch.sim.tasks import make_model_task

    rounds = 0
    for kind in ("logreg", "cnn"):
        task = make_model_task(kind, n_devices=N_DEVICES, n_train=600, n_test=10, device=dev)
        cfg = POFLConfig(n_devices=N_DEVICES, n_scheduled=N_SCHEDULED, backend="pallas_fused")
        engine = SimEngine(task.loss_fn, task.data, cfg, device=dev)
        draws, params = engine.draws(0, task.dim), task.params0
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for t in range(3):
                d = next(draws)
                params, _ = round_algorithm(task.loss_fn, engine.data, cfg, params,
                                            d.h, d.batch_idx, d.sched, d.z, t)
                rounds += 1
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    emit("no_sync", rounds=rounds, sync_debug_mode="error")


def parity(dev) -> None:
    """One full-width CNN round, card against the port's CPU path."""
    from repro_torch.core.pofl import POFLConfig, round_algorithm
    from repro_torch.flatten_util import ravel_pytree, tree_map
    from repro_torch.sim.engine import SimEngine
    from repro_torch.sim.tasks import make_model_task

    task = make_model_task("cnn", n_devices=N_DEVICES, n_train=600, n_test=10,
                           channel_bias=1.0, device="cpu")
    cfg = POFLConfig(n_devices=N_DEVICES, n_scheduled=N_SCHEDULED, noise_power=1e-10,
                     backend="pallas_fused")
    draws = next(SimEngine(task.loss_fn, task.data, cfg, device="cpu").draws(0, task.dim))
    w0 = task.ravel(task.params0)
    out, seconds = {}, {}
    for where in ("cpu", dev):
        params = tree_map(lambda p: p.to(where), task.params0)
        t0 = time.perf_counter()
        new, m = round_algorithm(task.loss_fn, task.data.to(where), cfg, params,
                                 *(x.to(where) for x in draws), 3)
        out[str(where)] = (ravel_pytree(new)[0].cpu() - w0, m)
        seconds[str(where)] = time.perf_counter() - t0
    (d_cpu, m_cpu), (d_card, m_card) = out["cpu"], out[str(dev)]
    # the checked error is the update's relative L2 error; the worst single
    # element, relative to the largest, is reported beside it
    rel = (torch.linalg.vector_norm(d_card - d_cpu) / torch.linalg.vector_norm(d_cpu)).item()
    rel_max = ((d_card - d_cpu).abs().max() / d_cpu.abs().max()).item()
    metrics = {f: [getattr(m_card, f).item(), getattr(m_cpu, f).item()]
               for f in ("e_com", "e_var", "grad_norm", "a_scalar", "n_scheduled")}
    bad = rel > ROUND_TOL or metrics["n_scheduled"][0] != metrics["n_scheduled"][1] or any(
        abs(a - b) > ROUND_TOL * abs(b) for a, b in metrics.values())
    emit("parity", d=task.dim, n=N_DEVICES, update_rel_l2_err=rel,
         update_max_elem_rel_err=rel_max, tolerance=ROUND_TOL,
         metrics_card_cpu=metrics, seconds=seconds)
    if bad:
        raise AssertionError("card round disagrees with the CPU round")


def profile_ranges(drive, rounds: int, prefix: str, n_ranges: int) -> dict:
    """Profile ``drive()`` (``rounds`` warm rounds); split host and device
    time by the ``<prefix>*`` ranges.

    A device activity (kernel, copy, set) counts toward the range whose host
    interval holds the start of the host op that launched it — the autograd
    engine launches the backward kernels from its own thread, inside the
    main thread's local-update range. ``device_kernel_ms`` sums the
    activities' durations; they can run at once on several streams (cuDNN's
    weight gradients in the local update do), so the sums can exceed the
    busy time. The idle share is the device's busy time per round (the union
    of its activities) over the round's wall time measured without the
    profiler.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / rounds
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        drive()
        torch.cuda.synchronize()
    events = prof.events()

    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type == DeviceType.CPU and e.name.startswith(prefix))
    stages: dict = {}
    for start, end, name in ranges:
        st = stages.setdefault(name, {"host_ms": 0.0, "device_kernel_ms": 0.0, "ranges": 0})
        st["host_ms"] += (end - start) / 1e3 / rounds
        st["ranges"] += 1
    starts = [r[0] for r in ranges]
    outside = 0.0
    for e in events:  # every device activity once, by the op that launched it
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        dev_us = sum(k.duration for k in e.kernels)
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start <= ranges[i][1]:
            stages[ranges[i][2]]["device_kernel_ms"] += dev_us / 1e3 / rounds
        else:
            outside += dev_us / 1e3 / rounds

    spans = sorted(  # device activity: kernels, copies, sets — not the ranges
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == DeviceType.CUDA and not e.name.startswith(prefix)
        and not getattr(e, "is_user_annotation", False))
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:  # union of the device's busy intervals
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += 0.0 if cur_e is None else cur_e - cur_s
    busy_ms = busy / 1e3 / rounds
    window_ms = (max(e.time_range.end for e in events)
                 - min(e.time_range.start for e in events)) / 1e3 / rounds
    local = stages.get(f"{prefix}local_update", {}).get("device_kernel_ms", 0.0)
    if busy_ms <= 0.0 or len(stages) != n_ranges or local <= 0:
        raise AssertionError(f"profiler saw no device time or missing ranges: {stages}")
    return {
        "rounds": rounds, "round_ms": wall_ms, "round_ms_profiled": window_ms,
        "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_kernel_ms_outside_ranges": outside, "stages": stages,
    }


def breakdown(dev) -> None:
    """Profile run_pofl rounds; split host and device time by pofl.* range."""
    from repro_torch.core.pofl import POFLConfig, run_pofl
    from repro_torch.sim.tasks import make_model_task

    out = {}
    rounds = 10
    for kind, kw in (("logreg", {}), ("cnn", {"channel_bias": 1.0})):
        task = make_model_task(kind, n_devices=N_DEVICES, n_train=3000, n_test=10,
                               device=dev, **kw)
        cfg = POFLConfig(n_devices=N_DEVICES, n_scheduled=N_SCHEDULED, noise_power=1e-10,
                         backend="pallas_fused")
        run_pofl(task.loss_fn, task.params0, task.data, cfg, 2)  # warm-up
        out[kind] = profile_ranges(
            lambda: run_pofl(task.loss_fn, task.params0, task.data, cfg, rounds),
            rounds, "pofl.", 5)
    emit("breakdown", per_round=True, **out)


# -- the lattice path ----------------------------------------------------------


def lattice_cfg(**kw):
    from repro_torch.core.pofl import POFLConfig

    return POFLConfig(n_devices=N_DEVICES, n_scheduled=N_SCHEDULED, backend="pallas_fused",
                      **kw)


def lattice_tasks(dev) -> dict:
    from repro_torch.sim.tasks import make_model_task

    return {kind: make_model_task(kind, n_devices=N_DEVICES, n_train=3000, n_test=1000,
                                  seed=0, device=dev, **kw)
            for kind, kw in (("cnn", {"channel_bias": 1.0}), ("logreg", {}))}


def lattice_path(dev) -> tuple[dict, dict]:
    """``run_lattice`` of both lattices → (launch counts, {task: (records,
    task, rounds)}); the counts are zeroed just before the two runs and read
    just after."""
    from repro_torch.kernels.aircomp import kernel
    from repro_torch.sim.lattice import LatticeSpec, run_lattice

    tasks = lattice_tasks(dev)
    specs = {kind: LatticeSpec(policies=POLICIES, noise_powers=noises, alphas=(0.1,),
                               seeds=LATTICE_SEEDS, n_rounds=rounds, eval_every=every)
             for kind, (noises, rounds, every) in LATTICES.items()}
    for kind, task in tasks.items():  # first calls (cuBLAS, cuDNN, allocator) off the clock
        run_lattice(task.loss_fn, task.data, task.params0,
                    LatticeSpec(policies=POLICIES, seeds=LATTICE_SEEDS, n_rounds=1),
                    base_cfg=lattice_cfg())
    torch.cuda.synchronize()
    kernel.launches = kernel.batch_launches = 0  # zeroed just before the lattice path
    results, records = {}, {}
    for kind, spec in specs.items():
        task = tasks[kind]
        before = (kernel.launches, kernel.batch_launches)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        recs = run_lattice(task.loss_fn, task.data, task.params0, spec,
                           base_cfg=lattice_cfg(), eval_fn=task.eval)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        single = kernel.launches - before[0]
        batch = kernel.batch_launches - before[1]
        grid = (1, len(POLICIES), len(spec.noise_powers), 1, len(LATTICE_SEEDS))
        n_eval = len(recs.eval_rounds)
        shapes_ok = all(getattr(recs, f).shape == grid + (spec.n_rounds,)
                        for f in ("e_com", "e_var", "grad_norm", "n_scheduled")) and \
            recs.acc.shape == recs.loss.shape == grid + (n_eval,)
        # every value of every cell is finite, except in the cells named in
        # DIVERGING_CELLS (held to the `diverging` phase)
        fields = ("e_com", "e_var", "grad_norm", "n_scheduled", "loss", "acc")
        cell_finite = np.stack([np.isfinite(getattr(recs, f)).all(axis=-1)
                                for f in fields]).all(axis=0)[0]  # (P, Nn, Na, Ns)
        diverged = [[POLICIES[i[0]], spec.noise_powers[i[1]], spec.seeds[i[3]]]
                    for i in zip(*np.nonzero(~cell_finite))]
        finite = all((kind, *cell) in DIVERGING_CELLS for cell in diverged)
        if batch != spec.n_rounds or single != 0 or not shapes_ok or not finite:
            raise AssertionError(f"lattice {kind}: batch launches {batch}, one-round "
                                 f"launches {single}, shapes {shapes_ok}, non-finite "
                                 f"cells {diverged}")
        final_acc = {p: float(recs.cell(policy=p, noise_power=spec.noise_powers[0])
                              ["acc"][..., -1].mean()) for p in POLICIES}
        results[kind] = final_acc
        records[kind] = (recs, task, spec.n_rounds)
        emit("lattice", run=kind, d=task.dim, cells=spec.n_cells, rounds=spec.n_rounds,
             seconds=seconds, cells_per_s=spec.n_cells / seconds,
             rounds_per_s=spec.n_rounds / seconds,
             cell_rounds_per_s=spec.n_cells * spec.n_rounds / seconds,
             launches={"aircomp_fused_batch": batch, "aircomp_fused": single},
             max_memory_allocated=torch.cuda.max_memory_allocated(dev),
             eval_rounds=recs.eval_rounds.tolist(),
             final_acc_mean_over_seeds_at_1e_10=final_acc, diverged_cells=diverged,
             mean_n_scheduled=float(recs.n_scheduled.mean()))
    launches = {"aircomp_fused_batch": kernel.batch_launches,  # read just after
                "aircomp_fused": kernel.launches}
    if launches["aircomp_fused"] != 0:
        raise AssertionError(f"the lattice path launched the one-round kernel: {launches}")
    if not results["logreg"]["pofl"] > 0.8:
        raise AssertionError(f"logreg lattice pofl did not learn: {results['logreg']}")
    return launches, records


def first_nonfinite(series: dict) -> int | None:
    """The first round at which any of the per-round series is non-finite."""
    bad = ~np.isfinite(np.stack([np.asarray(v, np.float64) for v in series.values()]))
    bad = bad.any(axis=0)
    return int(np.argmax(bad)) if bad.any() else None


def diverging(dev, records) -> None:
    """Each cell of DIVERGING_CELLS run again two other ways on the same
    draws: ``run_pofl`` on the card (the single-run path, which draws the
    seed's stream as the lattice cell does), and the port's CPU round on the
    card's draws moved to the CPU. All three must go non-finite, their first
    non-finite rounds at most one round apart. Reported: the first
    non-finite round of each, the per-round series, and the largest
    aggregation weight ρ_i = m_i/(M·|S|·q_i) (Eq. 37) drawn each round,
    which for the `channel` policy follows from h and the draw."""
    from repro_torch.core import scheduling
    from repro_torch.core.pofl import round_algorithm, run_pofl
    from repro_torch.flatten_util import tree_map
    from repro_torch.sim.engine import SimEngine

    for kind, policy, noise, seed in DIVERGING_CELLS:
        recs, task, n_rounds = records[kind]
        cell = recs.cell(policy=policy, noise_power=noise, seed=seed)
        lattice = {f: cell[f].ravel().tolist() for f in ("e_com", "e_var", "grad_norm")}
        cfg = lattice_cfg(policy=policy, noise_power=noise, alpha=0.1, seed=seed)
        _, hist = run_pofl(task.loss_fn, task.params0, task.data, cfg, n_rounds, device=dev)
        card = {"e_com": hist.e_com, "e_var": hist.e_var}
        data = task.data.to("cpu")
        params = tree_map(lambda p: p.to("cpu", copy=True), task.params0)
        draws = SimEngine(task.loss_fn, task.data, cfg, device=dev).draws(seed, task.dim)
        cpu = {"e_com": [], "e_var": [], "grad_norm": []}
        rho_max = []
        for t in range(n_rounds):
            d = [x.to("cpu") for x in next(draws)]
            params, m = round_algorithm(task.loss_fn, data, cfg, params, *d, t)
            for f, v in cpu.items():
                v.append(float(getattr(m, f)))
            if policy == "channel":
                zeros = torch.zeros(N_DEVICES)
                probs = scheduling.scheduling_probs(policy, zeros, zeros, d[0].abs(),
                                                    data.data_frac, task.dim, 0.1, 1.0, noise)
                sched = scheduling.sample_without_replacement(d[2], probs, N_SCHEDULED)
                rho = scheduling.aggregation_weights(sched, probs, data.data_frac, N_SCHEDULED)
                rho_max.append(float(rho.max()))
        rounds = {"lattice": first_nonfinite(lattice), "run_pofl_card": first_nonfinite(card),
                  "cpu_on_card_draws": first_nonfinite(cpu)}
        emit("diverging", cell=[kind, policy, noise, seed], rounds=n_rounds,
             first_nonfinite_round=rounds, lattice=lattice, run_pofl_card=card,
             cpu_on_card_draws=cpu, rho_max=rho_max)
        if None in rounds.values() or max(rounds.values()) - min(rounds.values()) > 1:
            raise AssertionError(f"{kind}/{policy}/{noise}/seed {seed} does not diverge on "
                                 f"every path within one round: first non-finite rounds "
                                 f"{rounds}")


def fused_lattice_engine(task, dev, small=False):
    """An engine of the policy-fused lattice and its (B,) cell axes: the
    five policies × the seeds (or two policies × two seeds), as
    ``run_lattice`` flattens them."""
    from repro_torch.core.scheduling import policy_id
    from repro_torch.sim.engine import FUSED_POLICY, SimEngine

    policies, seeds = (("pofl", "channel"), (0, 1)) if small else (POLICIES, LATTICE_SEEDS)
    cells = [(policy_id(p), s) for p in policies for s in seeds]
    engine = SimEngine(task.loss_fn, task.data,
                       lattice_cfg(policy=FUSED_POLICY, noise_power=1e-10),
                       eval_fn=task.eval, device=dev)
    axes = dict(noise_b=[1e-10] * len(cells), alpha_b=[0.1] * len(cells),
                seed_b=[s for _, s in cells], policy_b=[p for p, _ in cells])
    return engine, axes


def lattice_no_sync(dev) -> None:
    """Two rounds of the CNN lattice (15 cells, eval after the second) with
    every device→host sync made an error."""
    task = lattice_tasks(dev)["cnn"]
    engine, axes = fused_lattice_engine(task, dev)
    state = engine.lattice_start(task.params0, **axes)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(2):
            state, _ = engine.lattice_round(state, t, t == 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit("lattice_no_sync", rounds=2, cells=len(axes["seed_b"]), sync_debug_mode="error")


def lattice_parity(dev) -> None:
    """One full-width CNN lattice round (4 cells), card against the CPU."""
    from repro_torch.flatten_util import ravel_pytree, tree_map
    from repro_torch.sim.tasks import make_model_task

    task = make_model_task("cnn", n_devices=N_DEVICES, n_train=600, n_test=10,
                           channel_bias=1.0, device="cpu")
    engine_cpu, axes = fused_lattice_engine(task, "cpu", small=True)
    draws = [next(engine_cpu.draws(s, task.dim)) for s in (0, 1)]  # one set for both
    w0 = task.ravel(task.params0)
    out, seconds = {}, {}
    for where in ("cpu", dev):
        engine, _ = fused_lattice_engine(task, where, small=True)
        state = engine.lattice_start(task.params0, **axes)
        state = state._replace(streams=[iter([tuple(x.to(where) for x in d)])
                                        for d in draws])
        t0 = time.perf_counter()
        state, rec = engine.lattice_round(state, 3, False)
        out[str(where)] = ([ravel_pytree(tree_map(lambda p, c=c: p[c].cpu(), state.params))[0]
                            - w0 for c in range(4)], [r.cpu() for r in rec])
        seconds[str(where)] = time.perf_counter() - t0
    (d_cpu, r_cpu), (d_card, r_card) = out["cpu"], out[str(dev)]
    rel = max((torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
              for a, b in zip(d_card, d_cpu))
    names = ("e_com", "e_var", "grad_norm", "n_scheduled")
    metrics = {f: [r_card[i].tolist(), r_cpu[i].tolist()] for i, f in enumerate(names)}
    metric_err = max(((r_card[i] - r_cpu[i]).abs() / r_cpu[i].abs()).max().item()
                     for i in range(3))
    bad = rel > ROUND_TOL or metric_err > ROUND_TOL or not torch.equal(r_card[3], r_cpu[3])
    emit("lattice_parity", d=task.dim, n=N_DEVICES, cells=4,
         update_rel_l2_err_worst_cell=rel, metric_rel_err_worst=metric_err,
         tolerance=ROUND_TOL, metrics_card_cpu=metrics, seconds=seconds)
    if bad:
        raise AssertionError("card lattice round disagrees with the CPU lattice round")


def lattice_breakdown(dev) -> None:
    """Profile one CNN lattice round (15 cells); host and device time per
    lattice.* range, and the device's idle share."""
    task = lattice_tasks(dev)["cnn"]
    engine, axes = fused_lattice_engine(task, dev)
    state = engine.lattice_start(task.params0, **axes)
    holder = {"state": engine.lattice_round(state, 0, False)[0], "t": 1}  # warm-up

    def one_round():
        holder["state"], _ = engine.lattice_round(holder["state"], holder["t"], False)
        holder["t"] += 1

    out = profile_ranges(one_round, 1, "lattice.", 5)
    emit("lattice_breakdown", per_round=True, cells=len(axes["seed_b"]), cnn=out)


def kernel_entry(name, replaces, launches, max_err, times) -> dict:
    """One entry of the ``kernels`` line: the times at the path's larger
    shape, the other shape's beside them."""
    big, small = times["cnn"], times["logreg"]
    return {
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/aircomp/csrc/aircomp.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
        "shape": big["shape"],
        **{k: v for k, v in big.items() if k.startswith("b_launches")},
        "logreg": small,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels.aircomp import kernel
    from repro_torch.kernels.aircomp.ref import aircomp_fused_batch_ref, aircomp_fused_ref

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         tf32={"matmul": False, "cudnn": False})

    built = kernel.build()
    emit("build", kernels=["aircomp_fused", "aircomp_fused_batch"], seconds=built.seconds,
         library=str(built.path.relative_to(ROOT)), ptxas=list(built.ptxas))

    max_err = check_aircomp(kernel, aircomp_fused_ref, dev)
    batch_err = check_aircomp_batch(kernel, aircomp_fused_batch_ref, aircomp_fused_ref, dev)
    times = time_aircomp(kernel, aircomp_fused_ref, dev)
    batch_times = time_aircomp_batch(kernel, aircomp_fused_batch_ref, dev)
    launches = main_path(dev)
    no_sync(dev)
    parity(dev)
    breakdown(dev)
    lattice_launches, lattice_records = lattice_path(dev)
    diverging(dev, lattice_records)
    lattice_no_sync(dev)
    lattice_parity(dev)
    lattice_breakdown(dev)
    emit("total", seconds=time.perf_counter() - t_start)

    print(json.dumps({"kernels": [
        kernel_entry("aircomp_fused", "src/repro/kernels/aircomp/kernel.py:132",
                     launches["aircomp_fused"], max_err, times),
        kernel_entry("aircomp_fused_batch", "src/repro/kernels/aircomp/kernel.py:82",
                     lattice_launches["aircomp_fused_batch"], batch_err, batch_times),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
