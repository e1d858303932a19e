#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its main path on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; a phase that fails ends the run with a
non-zero exit and no result line:

  device     the card, as torch and ``nvidia-smi`` name it
  build      every kernel of the four paths compiled from ``src/repro_torch``,
             one ``nvcc`` per source, started together (the aircomp library
             with two entries, the flash-attention library, the SSD library),
             with each kernel's registers (ptxas) and the aircomp kernel's
             loads in flight a thread (the most ``LDG`` its SASS issues
             before an ``FFMA``)
  check      each kernel against its plain PyTorch version on the card
             (fp32, |kernel - plain| ≤ 1e-5 · max(1, max|plain|); the flash,
             SSD and aircomp kernels in bf16 against the plain version in
             fp32 on the same inputs within 2^-8 · |plain| + 1e-5 (the SSD
             and aircomp kernels: + 1e-5 · max(1, max|plain|)), element by
             element; the flash
             and SSD kernels' bf16 paths (tensor cores) and fp32 paths (CUDA
             cores) over the same features, with each case's largest share
             of its limit)
  times      each kernel, its plain version, one library call and the bound
             at its path's shapes (and, for the one-round aircomp kernel, the
             launch floor, its time with g warm in L2 and with L2 flushed
             clean; for the batch kernel, B launches of the one-round kernel
             it replaces; for the flash kernel its useful TFLOP/s, its time
             over the library call's and its 3 tensor-core passes)
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
  diverging  each named diverging cell again through ``run_pofl``'s
             ``SimEngine.run_with_history`` on the card and through the
             port's CPU round on the card's draws: both must diverge too,
             within one round of the lattice cell
  lattice_no_sync  two CNN lattice rounds with device→host syncs as errors
  lattice_parity   one full-width CNN lattice round (2 policies × 2 seeds)
             on the card against the port's CPU path (≤ 1e-4, as ``parity``)
  lattice_breakdown  ``torch.profiler`` over one CNN lattice round: host and
             device kernel ms per ``lattice.*`` range, the device's idle share
  scenario_lattice  the lattice's scenario axes through ``run_lattice``: the
             full-width CNN on Dirichlet(0.4)-sized shards, 4 algorithms ×
             3 policies × 2 seeds, 2 local steps, 6 rounds, a ``TaskEval``
             every 3, ``dropout`` (p 0.1) over ``gauss_markov`` (ρ 0.9);
             ``examples/sim_lattice.py``'s logreg setting (20 devices, 8
             scheduled, Dirichlet(0.3) labels, 3 policies × 2 noise levels ×
             4 seeds, 30 rounds, eval every 10, the same scenario); then a
             FedDyn CNN run of ``SimEngine.run_with_history`` (what
             ``run_pofl`` runs) under ``churn``, 2 local steps. Counts zeroed
             just before each run and read just after: one batch launch a
             lattice round and no one-round launch, one one-round launch a
             ``run_with_history`` round; ``acc == n_correct / n_valid`` in
             every eval cell; every record finite but in the cells named in
             SCENARIO_DIVERGING_CELLS; cell-rounds/s (diverged cells
             included), peak memory, and the mean |S| and the share of
             cell-rounds with no device scheduled, over the finite cells and
             the diverged ones apart
  scenario_diverging  each named diverging scenario cell again through
             ``run_with_history`` on the card and through the port's CPU
             rounds on the card's draws, as ``diverging`` does
  scenario_parity  one K = 2 CNN lattice round of the 4 algorithms (one a
             cell, from a non-zero FedDyn/SCAFFOLD state) with an ``avail``
             that drops devices, and one with every device dropped, on the
             card against the port's CPU path from one state and one set of
             draws (≤ 1e-4, as ``parity``; the all-dropped round leaves the
             params unchanged and finite on both); the new FedDyn h and
             SCAFFOLD c against the CPU's float64 state from the same
             inputs, ≤ ``repro_torch.sim.precision.STATE_TOL`` (the fp32
             state carries w_K − w0, a difference of near-equal weights)
  quarantine  the CNN scenario lattice of ``scenario_lattice`` again (24
             cells, K = 2, 6 rounds) under ``on_nonfinite="skip"``: each cell
             of SCENARIO_DIVERGING_CELLS flagged, first at or after the round
             its "propagate" record went non-finite; no other cell flagged;
             every round after a cell's first flagged round that is not
             flagged itself finite in every record; each cell's final params
             finite; one batch launch a round. Then a "propagate" and a
             "skip" run with cuDNN's deterministic algorithms (with its
             default ones two runs of one CNN lattice differ): the same
             flags, and every cell that stays finite within 1e-4 of its
             "propagate" records, |S| equal. Then the (``channel``, seed 2)
             CNN cell of DIVERGING_CELLS through ``run_with_history`` under
             "skip": final params finite, one one-round launch a round
  lattice_loops  ``run_lattice(fuse_policies=False)`` over the CNN lattice
             (15 cells) and ``run_lattice(fuse_algorithms=False)`` over the
             CNN scenario lattice (24 cells), both cut to 3 rounds, each
             timed beside the fused run of the same spec (one batch launch a
             sub-lattice a round: 5 × 3, 4 × 3). Then, with cuDNN's
             deterministic algorithms, every round of the loop's
             sub-lattices from the fused grid's state of the round before,
             on the same draws, against the fused round: every record value
             within 1e-4 relative, |S| equal (the cells of
             SCENARIO_DIVERGING_CELLS, ill-conditioned in the round before
             they go non-finite, are reported); and both whole runs again:
             every cell finite, |S| equal, the differences reported by round
             (the scenario lattice amplifies a rounding difference about
             100× a round, so its trajectories part beyond 1e-4 by round 2)
  obs        the CNN lattice of ``lattice`` with ``ObsConfig(diagnostics=True)``
             and ``REPRO_OBS_DIR`` set, and again without the taps, both
             with cuDNN's deterministic algorithms: the base records bitwise
             equal, every tap finite (but in the cells of DIVERGING_CELLS),
             the scheduling entropy in [0, log N]; one ``lattice.run`` and
             one ``lattice.diagnostics`` event, ``gate_warm_lattice``
             passing on a warm repeat; a ``REPRO_OBS_PROFILE=1`` run whose
             ``torch.profiler`` trace names the batch kernel; one CNN
             lattice round's taps card vs CPU (≤ 1e-4, ``eps_clamps``
             equal); cell-rounds/s with and without the taps (CNN and
             logreg lattices, cuDNN's default algorithms); a CNN
             ``run_with_history`` with the taps (one one-round launch a round)
  checkpoint ``run_lattice_checkpointed`` (chunks under cuDNN's deterministic
             algorithms): the CNN lattice every 3 rounds, stopped after
             round 4 and resumed, bitwise the uninterrupted run, timed beside
             ``run_lattice``; the same with ``REPRO_FAULT_NAN`` on one cell
             under "skip" (only that flag new, every other cell bitwise); a
             logreg scenario lattice (4 algorithms × 3 policies × 2 seeds,
             K = 2, churn over Gauss-Markov) resumed bitwise; one npz write
             and read of the full-width CNN scenario lattice's carry (FedDyn
             h and SCAFFOLD c, 1.49 GB), timed, bitwise; the flag restored
  serve      qwen2-0.5b at full width through ``repro_torch.launch.serve``:
             bf16 weights from the port's ``init_model``, batch 8, a 2,048-token
             prompt, ``Server.prefill`` (``model_prefill``), ``pad_cache`` to
             2,080, ``Server.decode`` of 32 greedy tokens; counts zeroed just
             before and read just after: 24 flash launches (one a layer)
  serve_no_sync  a prefill and 4 decode steps with device→host syncs as errors
  serve_parity  all 24 layers in fp32, batch 2, prompt 256, 8 decode steps,
             card against the port's CPU path on one set of weights and
             tokens (logits and KV cache within 1e-4 relative L2; greedy
             tokens equal wherever the CPU's top-2 margin exceeds 1e-4 of
             the logits' scale)
  serve_breakdown  ``torch.profiler`` over one prefill and 8 decode steps:
             host and device ms per ``serve.*`` range and per ``lm.*`` range
             inside it, the flash kernel's share of prefill device time, the
             device's idle share
  ssm_serve  mamba2-370m at full width (48 layers, d 1024, d_state 128, 32
             heads of 64, chunk 256, vocab 50,432 padded, untied head), the
             same way: batch 8, a 2,048-token prompt, 32 greedy tokens, bf16;
             48 SSD launches (one a layer of the prefill), none in decode
  ssm_serve_no_sync, ssm_serve_breakdown  as for qwen2 (``lm.mamba``,
             ``lm.logits``; the share of prefill device time of every SSD
             kernel, the ``ssd_fwd_*`` names: in bf16 the three stages of
             one ``ssd_scan`` call, each listed with its ms)
  ssm_serve_parity  all 48 layers in fp32, batch 2, prompt 512 (two chunks),
             8 decode steps, card against CPU: logits, SSM state and conv
             window within 1e-4 relative L2, greedy tokens as for qwen2;
             dt_bias drawn as Mamba2 initialises it
  ssm_depth_drift  at the reference's zero dt_bias: the prefill logits' card
             vs CPU relative L2 at 1, 12 and 48 layers, through the kernel
             and through the plain version on the card (reported)

then the ``kernels`` line, the card's name and power limit, and the result
``{"ok": true, "device": {...}}``. TF32 is off for matmuls and for cuDNN's
convolutions (with TF32 the CNN round misses the parity tolerance); the PO-FL
paths run in fp32, the serving paths in bf16 (their parity phases in fp32). Without a CUDA card, or without the repo's sources beside
this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM bf16 dense tensor-core rate
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
# the scenario axes (phase scenario_lattice): the full-width CNN lattice and
# examples/sim_lattice.py's logreg lattice, both under dropout over
# Gauss-Markov fading; a run_with_history CNN run under churn
SCENARIO = ("dropout", {"base": "gauss_markov", "corr": 0.9, "p_drop": 0.1})
SCENARIO_ALGORITHMS = ("fedavg", "fedprox", "feddyn", "scaffold")
SCENARIO_POLICIES = ("pofl", "importance", "channel")
SCENARIO_SEEDS = (0, 1)
SCENARIO_K, SCENARIO_ROUNDS, SCENARIO_EVAL_EVERY = 2, 6, 3
SCENARIO_FEDPROX_MU = 0.1  # the reference's default μ = 0 would make FedProx FedAvg
EXAMPLE_DEVICES, EXAMPLE_SCHEDULED, EXAMPLE_BETA = 20, 8, 0.3
EXAMPLE_NOISES, EXAMPLE_SEEDS = (1e-11, 1e-9), (0, 1000, 2000, 3000)
EXAMPLE_ROUNDS, EXAMPLE_EVAL_EVERY = 30, 10
CHURN_ROUNDS = 6
SCENARIO_N_TEST = 1000  # test rows of both scenario lattices: acc = n_correct / this
# The scenario-lattice cells whose records may go non-finite, by name:
# (run, algorithm, policy, σ_z², seed), each with its cause.
SCENARIO_DIVERGING_CELLS = tuple(
    # the reference's own SCAFFOLD diverges at this setting (its engine on the
    # CPU at the (pofl, seed 0) cell: e_var 6.7, 12.5, 2.1e3, 3.1e33, NaN over
    # rounds 0-4; ROADMAP queue C): every device refreshes c_i from its round's
    # heterogeneous deltas and the Eq. 37 weights amplify the stale corrections
    ("cnn", "scaffold", policy, 1e-10, seed)
    for policy in ("pofl", "importance", "channel") for seed in (0, 1))
# the lattice loops (phase lattice_loops): both CNN lattices cut to 3 rounds;
# they and the quarantine are held to their fused / "propagate" runs at
# ROUND_TOL, the card's card-vs-CPU limit
LOOP_ROUNDS = 3
# the serving path: qwen2-0.5b at full width
SERVE_ARCH = "qwen2-0.5b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 2048, 32
PARITY_BATCH, PARITY_PROMPT, PARITY_NEW = 2, 256, 8
BREAKDOWN_STEPS = 8
# (b, s, h, kv, dh) of the flash kernel's times, bf16, causal: the serving
# prefill and the prefill_32k sequence length
ATTN_TIME_SHAPES = {"prefill_2k": (8, 2048, 14, 2, 64), "prefill_32k": (1, 32768, 14, 2, 64)}
# the second serving path: mamba2-370m at full width, the same batch, prompt
# and new tokens; its parity at two chunks
SSM_ARCH = "mamba2-370m"
SSM_PARITY_BATCH, SSM_PARITY_PROMPT = 2, 512
SSM_DRIFT_DEPTHS = (1, 12, 48)
# (b, s, h, p, n, chunk) of the SSD kernel's times, bf16: one layer of the
# serving prefill and the prefill_32k sequence length
SSD_TIME_SHAPES = {"prefill_2k": (8, 2048, 32, 64, 128, 256),
                   "prefill_32k": (1, 32768, 32, 64, 128, 256)}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- kernel inputs, check and timing -----------------------------------------


def check_aircomp(kernel, ref, dev) -> dict:
    """The one-round kernel against its plain version over
    ``cases.CHECK_CASES`` (bf16 cases against the plain version in fp32 on
    the same inputs, element by element: ``cases.limit``) → {case: (max
    error, its share of the limit, dtype)}."""
    from repro_torch.kernels.aircomp.cases import CHECK_CASES, limit, round_inputs

    errs = {}
    for i, (name, (n, d, empty, stride, dtype)) in enumerate(CHECK_CASES.items()):
        args = round_inputs(n, d, dev, seed=i, empty=empty, row_stride=stride, dtype=dtype)
        got = kernel.aircomp_fused(*args)
        want = ref(args[0].float(), *args[1:5], args[5].float())
        torch.cuda.synchronize()
        if got.shape != (d,) or got.dtype != dtype or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"aircomp_fused {name}: bad shape, type or non-finite output")
        err = (got.float() - want).abs()
        share = (err / limit(want, dtype)).max().item()
        if share > 1.0:
            raise AssertionError(f"aircomp_fused {name}: {share:.3g} of its limit")
        errs[name] = (err.max().item(), share, str(dtype))
    emit("check", kernel="aircomp_fused", tolerance={"float32": KERNEL_TOL,
         "bfloat16": "2^-8·|ref| + 1e-5·max(1, max|ref|)"},
         max_abs_err={k: v[0] for k, v in errs.items()},
         share_of_limit={k: v[1] for k, v in errs.items()})
    return errs


def time_ms(fn, flush: torch.Tensor, reps: int = 50, before=None) -> float:
    """Median device time of one call, by CUDA events around the call
    alone. Before each, L2 is flushed by writing ``flush`` (cold, as g comes
    from HBM), or ``before()`` runs in its place."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        if before is None:
            flush.zero_()
        else:
            before()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def aircomp_bound(n: int, d: int, itemsize: int = 4) -> tuple[float, str]:
    """The least time for the work: each input read once, the output written
    once (g, z and ŷ of ``itemsize`` bytes an element, coeff float32)."""
    nbytes = n * d * itemsize + 2 * d * itemsize + n * 4
    flops = 2 * n * d + 4 * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_aircomp(kernel, ref, dev) -> dict:
    """Kernel 1's times at both main shapes; beside them the launch floor
    (one trivial op on a one-element tensor, timed the same way) and, at the
    CNN shape, ``warm_ms`` (g read once just before the call, as in
    ``run_pofl``, where g comes fresh from the local update and fits L2) and
    ``clean_ms`` (L2 flushed by reading, so it holds no dirty lines whose
    write-back the call would pay)."""
    from repro_torch.kernels.aircomp.cases import round_inputs

    flush = torch.empty(256 * 2**20 // 4, device=dev)  # 256 MiB > the 50 MB L2
    one = torch.zeros(1, device=dev)
    out = {"launch_floor_ms": time_ms(lambda: one.add_(1.0), flush)}
    for name, d in (("cnn", CNN_DIM), ("logreg", LOGREG_DIM)):
        g, coeff, m_g, v_g, a, z = round_inputs(N_DEVICES, d, dev, seed=7)
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
        if name == "cnn":
            bf16 = (g.bfloat16(), coeff, m_g, v_g, a, z.bfloat16())
            g16, z16, coeff16 = bf16[0], bf16[5], coeff.bfloat16()
            bound_ms, bound_by = aircomp_bound(N_DEVICES, d, itemsize=2)
            out["cnn_bf16"] = {  # g and z in bf16: half the bytes
                "shape": [N_DEVICES, d], "dtype": "bfloat16",
                "ms": time_ms(lambda: kernel.aircomp_fused(*bf16), flush),
                "plain_ms": time_ms(lambda: ref(*bf16), flush),
                # the fp32 row's library call on bf16 operands
                "library_ms": time_ms(lambda: torch.addmv(z16, g16.t(), coeff16, beta=beta),
                                      flush),
                "bound_ms": bound_ms, "bound_by": bound_by}
            out[name]["warm_ms"] = time_ms(
                lambda: kernel.aircomp_fused(g, coeff, m_g, v_g, a, z), flush,
                before=lambda: (flush.zero_(), g.sum()))
            out[name]["clean_ms"] = time_ms(
                lambda: kernel.aircomp_fused(g, coeff, m_g, v_g, a, z), flush,
                before=flush.sum)
    emit("times", kernel="aircomp_fused", **out)
    return out


def check_aircomp_batch(kernel, ref, single_ref, dev) -> dict:
    """The batch kernel against its plain version, and each trial against
    the one-round plain version on that trial's inputs (so a kernel that
    read another trial's scalars fails); limits as in :func:`check_aircomp`."""
    from repro_torch.kernels.aircomp.cases import BATCH_CHECK_CASES, batch_inputs, limit

    errs = {}
    for i, (name, (b, n, d, empty, strided, dtype)) in enumerate(BATCH_CHECK_CASES.items()):
        args = batch_inputs(b, n, d, dev, seed=100 + i, empty_trial=empty, strided=strided,
                            dtype=dtype)
        f32 = (args[0].float(), *args[1:5], args[5].float())
        got, want = kernel.aircomp_fused_batch(*args), ref(*f32)
        torch.cuda.synchronize()
        if got.shape != (b, d) or got.dtype != dtype or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"aircomp_fused_batch {name}: bad shape, type or non-finite")
        bound = limit(want, dtype)
        err = (got.float() - want).abs()
        share = (err / bound).max().item()
        per_trial = max(((got[c].float() - single_ref(*(x[c] for x in f32))).abs()
                         / bound[c]).max().item() for c in range(b))
        if share > 1.0 or per_trial > 1.0:
            raise AssertionError(f"aircomp_fused_batch {name}: {share:.3g} of its limit "
                                 f"(per trial {per_trial:.3g})")
        errs[name] = (err.max().item(), share, str(dtype))
    emit("check", kernel="aircomp_fused_batch", tolerance={"float32": KERNEL_TOL,
         "bfloat16": "2^-8·|ref| + 1e-5·max(1, max|ref|)"},
         max_abs_err={k: v[0] for k, v in errs.items()},
         share_of_limit={k: v[1] for k, v in errs.items()})
    return errs


def aircomp_batch_bound(b: int, n: int, d: int, itemsize: int = 4) -> tuple[float, str]:
    """The least time for one batch call: g, z, coeff and the scalars read
    once, ŷ written once (g, z and ŷ of ``itemsize`` bytes an element, the
    rest float32); 2·B·N·D + 4·B·D flops."""
    nbytes = b * n * d * itemsize + 2 * b * d * itemsize + b * n * 4 + 3 * b * 4
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
        if name == "cnn":
            g16, z16, coeff16 = g.bfloat16(), z.bfloat16(), coeff.bfloat16()
            bound_ms, bound_by = aircomp_batch_bound(b, N_DEVICES, d, itemsize=2)
            out["cnn_bf16"] = {  # g and z in bf16: half the bytes
                "shape": [b, N_DEVICES, d], "dtype": "bfloat16",
                "ms": time_ms(lambda: kernel.aircomp_fused_batch(g16, coeff, m_g, v_g, a, z16),
                              flush),
                "plain_ms": time_ms(lambda: ref(g16, coeff, m_g, v_g, a, z16), flush),
                # the fp32 row's library call on bf16 operands
                "library_ms": time_ms(lambda: torch.bmm(coeff16[:, None, :], g16), flush),
                "bound_ms": bound_ms, "bound_by": bound_by}
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
                params, _, _ = round_algorithm(task.loss_fn, engine.data, cfg, params,
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
    from repro_torch.sim.engine import RoundDraws, SimEngine
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
        d = RoundDraws(*(x.to(where) for x in draws))
        new, _, m = round_algorithm(task.loss_fn, task.data.to(where), cfg, params,
                                    d.h, d.batch_idx, d.sched, d.z, 3)
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


def busy_us(device_events) -> float:
    """The union of the events' intervals (µs): the device's busy time."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in device_events):
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (0.0 if cur_e is None else cur_e - cur_s)


def profile_ranges(drive, rounds: int, prefixes: tuple, n_ranges: int,
                   busy_stage: str) -> dict:
    """Profile ``drive()`` (``rounds`` warm rounds); split host and device
    time by the ``<prefixes[0]>*`` ranges and, when a second prefix is
    given, by the ``<prefixes[1]>*`` ranges inside them (as ``outer/inner``).

    A device activity (kernel, copy, set) counts toward the range whose host
    interval holds the start of the host op that launched it — the autograd
    engine launches the backward kernels from its own thread, inside the
    main thread's local-update range. ``device_kernel_ms`` sums the
    activities' durations; they can run at once on several streams (cuDNN's
    weight gradients in the local update do), so the sums can exceed the
    busy time. The profiler links no host op to a kernel that a ctypes
    library launches (the port's own kernels link the CUDA runtime
    statically): such kernels are listed by name under
    ``unlinked_kernels_ms`` and are in no range. The idle share is the
    device's busy time per round (the union of its activities) over the
    round's wall time measured without the profiler. Raises unless there
    are ``n_ranges`` stages and ``busy_stage`` launched device work.
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

    def ranges(prefix):  # non-overlapping, sorted by start
        return sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                      if e.device_type == DeviceType.CPU and e.name.startswith(prefix))

    def holder(rs, at):  # the range of ``rs`` that holds time ``at``
        i = bisect.bisect_right([r[0] for r in rs], at) - 1
        return rs[i][2] if i >= 0 and at <= rs[i][1] else None

    levels = [ranges(p) for p in prefixes]
    stages: dict = {}

    def keys(at):  # the outer range that holds ``at``, then the nested one
        outer = holder(levels[0], at)
        if outer is None:
            return []
        inner = holder(levels[1], at) if len(levels) > 1 else None
        return [outer] + ([f"{outer}/{inner}"] if inner is not None else [])

    def stage(key):
        return stages.setdefault(key, {"host_ms": 0.0, "device_kernel_ms": 0.0, "ranges": 0})

    for depth, level in enumerate(levels):
        for start, end, name in level:
            st = stage(name if depth == 0 else f"{holder(levels[0], start)}/{name}")
            st["host_ms"] += (end - start) / 1e3 / rounds
            st["ranges"] += 1
    outside, linked = 0.0, set()
    for e in events:  # every device activity once, by the op that launched it
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        linked.update(k.name for k in e.kernels)
        ms = sum(k.duration for k in e.kernels) / 1e3 / rounds
        hit = keys(e.time_range.start)
        for key in hit:
            stage(key)["device_kernel_ms"] += ms
        outside += 0.0 if hit else ms

    device = [e for e in events if e.device_type == DeviceType.CUDA  # not the ranges
              and not e.name.startswith(prefixes)
              and not getattr(e, "is_user_annotation", False)]
    busy_ms = busy_us(device) / 1e3 / rounds
    unlinked: dict = {}
    for e in device:
        if e.name not in linked:
            unlinked[e.name] = (unlinked.get(e.name, 0.0)
                                + (e.time_range.end - e.time_range.start) / 1e3 / rounds)
    window_ms = (max(e.time_range.end for e in events)
                 - min(e.time_range.start for e in events)) / 1e3 / rounds
    busy_stage_ms = stages.get(busy_stage, {}).get("device_kernel_ms", 0.0)
    if busy_ms <= 0.0 or len(stages) != n_ranges or busy_stage_ms <= 0:
        raise AssertionError(f"profiler saw no device time or missing ranges: {stages}")
    return {
        "rounds": rounds, "round_ms": wall_ms, "round_ms_profiled": window_ms,
        "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_kernel_ms": sum((e.time_range.end - e.time_range.start) for e in device)
        / 1e3 / rounds,
        "device_kernel_ms_outside_ranges": outside, "unlinked_kernels_ms": unlinked,
        "stages": stages,
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
            rounds, ("pofl.",), 5, "pofl.local_update")
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


def lattice_spec(kind: str, **kw):
    """The ``lattice`` phase's spec of ``kind`` (cnn, logreg), ``kw`` replaced."""
    from repro_torch.sim.lattice import LatticeSpec

    noises, rounds, every = LATTICES[kind]
    return LatticeSpec(**{**dict(policies=POLICIES, noise_powers=noises, alphas=(0.1,),
                                 seeds=LATTICE_SEEDS, n_rounds=rounds, eval_every=every),
                          **kw})


def lattice_path(dev) -> tuple[dict, dict]:
    """``run_lattice`` of both lattices → (launch counts, {task: (records,
    task, rounds)}); the counts are zeroed just before the two runs and read
    just after."""
    from repro_torch.kernels.aircomp import kernel
    from repro_torch.sim.lattice import LatticeSpec, run_lattice

    tasks = lattice_tasks(dev)
    specs = {kind: lattice_spec(kind) for kind in LATTICES}
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


def diverges_on_every_path(dev, phase, name, cell, task, cfg, n_rounds, **engine_kw):
    """A lattice cell that went non-finite, run again two other ways on the
    same draws: its configuration alone through ``SimEngine.run_with_history``
    on the card (what ``run_pofl`` runs; it draws the seed's stream as the
    lattice cell does), and the port's CPU rounds on the card's draws moved
    to the CPU. All three must go non-finite, their first non-finite rounds
    at most one round apart. Reported: the first non-finite round of each,
    the per-round series, and for the `channel` policy the largest
    aggregation weight ρ_i = m_i/(M·|S|·q_i) (Eq. 37) drawn each round,
    which follows from h, the availability and the draw."""
    from repro_torch.core.aircomp import GradStats
    from repro_torch.core.local_update import init_state
    from repro_torch.core.pofl import round_algorithm, scheduling_stage
    from repro_torch.flatten_util import tree_map
    from repro_torch.sim.engine import RoundDraws, SimEngine

    lattice = {f: cell[f].ravel().tolist() for f in ("e_com", "e_var", "grad_norm")}
    engine = SimEngine(task.loss_fn, task.data, cfg, device=dev, **engine_kw)
    _, hist = engine.run_with_history(task.params0, n_rounds)
    card = {"e_com": hist.e_com, "e_var": hist.e_var}
    data = task.data.to("cpu")
    params = tree_map(lambda p: p.to("cpu", copy=True), task.params0)
    alg_state = init_state(cfg.local_algorithm, cfg.n_devices, task.dim)
    draws = engine.draws(cfg.seed, task.dim)
    cpu = {"e_com": [], "e_var": [], "grad_norm": []}
    rho_max = []
    for t in range(n_rounds):
        d = RoundDraws(*(x.to("cpu") for x in next(draws)))
        avail = d.avail if engine.process.can_drop else None
        params, alg_state, m = round_algorithm(task.loss_fn, data, cfg, params, d.h,
                                               d.batch_idx, d.sched, d.z, t, avail=avail,
                                               alg_state=alg_state)
        for f, v in cpu.items():
            v.append(float(getattr(m, f)))
        if cfg.policy == "channel":  # its probabilities ignore the statistics
            zeros = torch.zeros(cfg.n_devices)
            rho, _ = scheduling_stage(cfg, GradStats(zeros, zeros, zeros), d.h.abs(),
                                      data.data_frac, task.dim, cfg.alpha, cfg.noise_power,
                                      d.sched, avail=avail)
            rho_max.append(float(rho.max()))
    rounds = {"lattice": first_nonfinite(lattice), "single_run_card": first_nonfinite(card),
              "cpu_on_card_draws": first_nonfinite(cpu)}
    emit(phase, cell=name, rounds=n_rounds, first_nonfinite_round=rounds, lattice=lattice,
         single_run_card=card, cpu_on_card_draws=cpu, rho_max=rho_max)
    if None in rounds.values() or max(rounds.values()) - min(rounds.values()) > 1:
        raise AssertionError(f"{name} does not diverge on every path within one round: "
                             f"first non-finite rounds {rounds}")


def diverging(dev, records) -> None:
    """Each cell of DIVERGING_CELLS through :func:`diverges_on_every_path`."""
    for kind, policy, noise, seed in DIVERGING_CELLS:
        recs, task, n_rounds = records[kind]
        diverges_on_every_path(
            dev, "diverging", [kind, policy, noise, seed],
            recs.cell(policy=policy, noise_power=noise, seed=seed), task,
            lattice_cfg(policy=policy, noise_power=noise, alpha=0.1, seed=seed), n_rounds)


def given_draws(engine, draws) -> None:
    """The engine's next round takes ``draws``, one ``RoundDraws`` a stream
    in the streams' order, and leaves each stream where it is."""
    it = iter(draws)
    engine.next_draws = lambda stream, dim: (stream, next(it))


def fused_lattice_engine(task, dev, small=False, obs=None):
    """An engine of the policy-fused lattice and its (B,) cell axes: the
    five policies × the seeds (or two policies × two seeds), as
    ``run_lattice`` flattens them; ``obs`` as ``SimEngine`` takes it."""
    from repro_torch.core.scheduling import policy_id
    from repro_torch.sim.engine import FUSED_POLICY, SimEngine

    policies, seeds = (("pofl", "channel"), (0, 1)) if small else (POLICIES, LATTICE_SEEDS)
    cells = [(policy_id(p), s) for p in policies for s in seeds]
    engine = SimEngine(task.loss_fn, task.data,
                       lattice_cfg(policy=FUSED_POLICY, noise_power=1e-10),
                       eval_fn=task.eval, device=dev, obs=obs)
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
        t0 = time.perf_counter()
        given_draws(engine, [tuple(x.to(where) for x in d) for d in draws])
        state, rec = engine.lattice_round(state, 3, False)
        out[str(where)] = ([ravel_pytree(tree_map(lambda p, c=c: p[c].cpu(), state.params))[0]
                            - w0 for c in range(4)], [r.cpu() for r in rec[:4]])
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

    out = profile_ranges(one_round, 1, ("lattice.",), 5, "lattice.local_update")
    emit("lattice_breakdown", per_round=True, cells=len(axes["seed_b"]), cnn=out)


# -- the scenario axes ------------------------------------------------------------


def check_scenario_records(run, recs, spec, n_valid) -> tuple[np.ndarray, list, bool]:
    """The scenario lattice's checks → (each cell finite, the non-finite
    cells, the checks passed): records finite in every cell that
    SCENARIO_DIVERGING_CELLS does not name, and acc == n_correct / n_valid
    in every eval cell (``n_valid`` the test rows the phase made)."""
    fields = [getattr(recs, f) for f in ("e_com", "e_var", "grad_norm", "n_scheduled",
                                         "loss", "acc")] + list(recs.eval)
    finite = np.stack([np.isfinite(f).all(axis=-1) for f in fields]).all(axis=0)
    bad = [[spec.algorithms[i[0]], spec.policies[i[1]], spec.noise_powers[i[2]],
            spec.seeds[i[4]]] for i in zip(*np.nonzero(~finite))]
    unnamed = [c for c in bad if (run, *c) not in SCENARIO_DIVERGING_CELLS]
    acc_exact = bool(np.array_equal(recs.eval.acc,
                                    recs.eval.n_correct / np.float32(n_valid)))
    return finite, bad, not unnamed and acc_exact


def scheduled_stats(n_scheduled: np.ndarray) -> dict:
    """The mean |S| and the share of cell-rounds that scheduled nobody."""
    if n_scheduled.size == 0:
        return {"mean_n_scheduled": None, "share_rounds_none_scheduled": None}
    return {"mean_n_scheduled": float(n_scheduled.mean()),
            "share_rounds_none_scheduled": float((n_scheduled == 0).mean())}


def scenario_cnn_task(dev):
    """The CNN scenario lattice's task (phase scenario_lattice): the full-width
    CNN on Dirichlet(0.4)-sized shards."""
    from repro_torch.sim.tasks import make_model_task

    return make_model_task("cnn", n_devices=N_DEVICES, partition="dirichlet_sized", beta=0.4,
                           n_train=3000, n_test=SCENARIO_N_TEST, seed=0, channel_bias=1.0,
                           device=dev)


def scenario_cnn_spec():
    """The CNN scenario lattice's axes and rounds."""
    from repro_torch.sim.lattice import LatticeSpec

    return LatticeSpec(algorithms=SCENARIO_ALGORITHMS, policies=SCENARIO_POLICIES,
                       noise_powers=(1e-10,), seeds=SCENARIO_SEEDS, n_rounds=SCENARIO_ROUNDS,
                       eval_every=SCENARIO_EVAL_EVERY)


def scenario_cnn_cfg():
    """The CNN scenario lattice's base config: K = 2, FedProx μ 0.1."""
    return lattice_cfg(local_steps=SCENARIO_K, noise_power=1e-10,
                       fedprox_mu=SCENARIO_FEDPROX_MU)


def scenario_lattice(dev) -> tuple[dict, dict]:
    """``run_lattice`` over the scenario axes (the CNN at full width and
    ``examples/sim_lattice.py``'s logreg setting), then a CNN
    ``run_with_history`` under churn → (their launch counts, {run:
    (records, task, cfg)})."""
    from repro_torch.kernels.aircomp import kernel
    from repro_torch.sim.engine import SimEngine
    from repro_torch.sim.lattice import LatticeSpec, run_lattice
    from repro_torch.sim.tasks import make_model_task

    scenario, params = SCENARIO
    runs = {
        "cnn": (scenario_cnn_task(dev), scenario_cnn_spec(), scenario_cnn_cfg()),
        "logreg_example": (
            make_model_task("logreg", n_devices=EXAMPLE_DEVICES, partition="dirichlet",
                            beta=EXAMPLE_BETA, n_train=3000, n_test=SCENARIO_N_TEST, seed=0,
                            device=dev),
            LatticeSpec(policies=SCENARIO_POLICIES, noise_powers=EXAMPLE_NOISES,
                        seeds=EXAMPLE_SEEDS, n_rounds=EXAMPLE_ROUNDS,
                        eval_every=EXAMPLE_EVAL_EVERY),
            dataclasses.replace(lattice_cfg(), n_devices=EXAMPLE_DEVICES,
                                n_scheduled=EXAMPLE_SCHEDULED)),
    }
    for task, spec, cfg in runs.values():  # first calls (cuDNN, allocator) off the clock
        run_lattice(task.loss_fn, task.data, task.params0,
                    dataclasses.replace(spec, n_rounds=1), base_cfg=cfg,
                    scenario=scenario, scenario_params=params)
    launches = {"aircomp_fused_batch": 0, "aircomp_fused": 0}
    records = {}
    for run, (task, spec, cfg) in runs.items():
        torch.cuda.synchronize()
        zero_counts()  # zeroed just before the run
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        recs = run_lattice(task.loss_fn, task.data, task.params0, spec, base_cfg=cfg,
                           eval_fn=task.eval, scenario=scenario, scenario_params=params)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()  # read just after
        grid = (len(spec.algorithms), len(spec.policies), len(spec.noise_powers), 1,
                len(spec.seeds))
        shapes_ok = all(getattr(recs, f).shape == grid + (spec.n_rounds,)
                        for f in ("e_com", "e_var", "grad_norm", "n_scheduled")) and all(
            f.shape == grid + (len(recs.eval_rounds),) for f in recs.eval)
        finite, bad, ok = check_scenario_records(run, recs, spec, SCENARIO_N_TEST)
        emit("scenario_lattice", run=run, d=task.dim, n=cfg.n_devices,
             scheduled=cfg.n_scheduled, local_steps=cfg.local_steps,
             scenario=[scenario, params], cells=spec.n_cells, rounds=spec.n_rounds,
             seconds=seconds, cell_rounds_per_s=spec.n_cells * spec.n_rounds / seconds,
             launches={k: counts[k] for k in launches},
             max_memory_allocated=torch.cuda.max_memory_allocated(dev),
             finite_cells=scheduled_stats(recs.n_scheduled[finite]),
             diverged_cells={"cells": len(bad), **scheduled_stats(recs.n_scheduled[~finite])},
             eval_rounds=recs.eval_rounds.tolist(), n_valid=SCENARIO_N_TEST,
             final_acc_by_algorithm_policy={
                 f"{a}/{p}": float(recs.eval.acc[i, j, ..., -1].mean())
                 for i, a in enumerate(spec.algorithms)
                 for j, p in enumerate(spec.policies)},
             nonfinite_cells=bad)
        if counts["aircomp_fused_batch"] != spec.n_rounds or counts["aircomp_fused"] != 0 \
                or not shapes_ok or not ok:
            raise AssertionError(f"scenario lattice {run}: launches {counts}, shapes "
                                 f"{shapes_ok}, non-finite cells {bad}, checks {ok}")
        for k in launches:
            launches[k] += counts[k]
        records[run] = (recs, task, cfg)

    task = runs["cnn"][0]
    cfg = lattice_cfg(local_algorithm="feddyn", local_steps=SCENARIO_K, noise_power=1e-10)
    engine = SimEngine(task.loss_fn, task.data, cfg, scenario="churn", device=dev)
    engine.run_with_history(task.params0, 1)  # first calls off the clock
    torch.cuda.synchronize()
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, hist = engine.run_with_history(task.params0, CHURN_ROUNDS, eval_fn=task.eval,
                                           eval_every=SCENARIO_EVAL_EVERY)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    finite = all(math.isfinite(v) for v in hist.e_com + hist.e_var + hist.test_acc) and \
        bool(torch.isfinite(task.ravel(params)).all())
    emit("scenario_lattice", run="cnn_run_with_history_churn", d=task.dim, n=N_DEVICES,
         algorithm="feddyn", local_steps=SCENARIO_K, rounds=CHURN_ROUNDS, seconds=seconds,
         rounds_per_s=CHURN_ROUNDS / seconds, launches={k: counts[k] for k in launches},
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         test_round=hist.test_round, test_acc=hist.test_acc)
    if counts["aircomp_fused"] != CHURN_ROUNDS or counts["aircomp_fused_batch"] != 0 \
            or not finite:
        raise AssertionError(f"run_with_history under churn: launches {counts}, "
                             f"finite {finite}")
    for k in launches:
        launches[k] += counts[k]
    return launches, records


def scenario_diverging(dev, records) -> None:
    """Each cell of SCENARIO_DIVERGING_CELLS through
    :func:`diverges_on_every_path`, its algorithm alone and the scenario's
    channel process on both other paths."""
    scenario, params = SCENARIO
    for run, alg, policy, noise, seed in SCENARIO_DIVERGING_CELLS:
        recs, task, base = records[run]
        cfg = dataclasses.replace(base, policy=policy, noise_power=noise, local_algorithm=alg,
                                  seed=seed)
        diverges_on_every_path(
            dev, "scenario_diverging", [run, alg, policy, noise, seed],
            recs.cell(algorithm=alg, policy=policy, noise_power=noise, seed=seed), task, cfg,
            recs.e_com.shape[-1], scenario=scenario, scenario_params=params)


def scenario_parity(dev) -> None:
    """One K = 2 CNN lattice round of the 4 algorithms, with devices dropped
    and with every device dropped, card against the CPU; the new FedDyn and
    SCAFFOLD state also against the CPU's float64 state (``STATE_TOL``)."""
    from repro_torch.core.local_update import ALGORITHM_IDS, AlgState
    from repro_torch.core.scheduling import policy_id
    from repro_torch.flatten_util import ravel_pytree, tree_map
    from repro_torch.sim.engine import FUSED_ALGORITHM, FUSED_POLICY, SimEngine
    from repro_torch.sim.precision import STATE_TOL, k_step_state, rel_l2, state_errors
    from repro_torch.sim.tasks import make_model_task

    task = make_model_task("cnn", n_devices=N_DEVICES, partition="dirichlet_sized", beta=0.4,
                           n_train=600, n_test=10, channel_bias=1.0, device="cpu")
    cfg = lattice_cfg(policy=FUSED_POLICY, local_algorithm=FUSED_ALGORITHM,
                      local_steps=SCENARIO_K, noise_power=1e-10,
                      fedprox_mu=SCENARIO_FEDPROX_MU)
    scenario = dict(scenario="dropout", scenario_params={"base": "gauss_markov", "p_drop": 0.5})
    cells = dict(noise_b=[1e-10] * 4, alpha_b=[0.1] * 4, seed_b=[0] * 4,
                 policy_b=[policy_id("pofl")] * 4, algorithm_b=list(ALGORITHM_IDS.values()))
    engine_cpu = SimEngine(task.loss_fn, task.data, cfg, device="cpu", **scenario)
    draws = next(engine_cpu.draws(0, task.dim))
    gen = torch.Generator().manual_seed(3)
    alg0 = AlgState(*(1e-3 * torch.randn(4, N_DEVICES, task.dim, generator=gen)
                      for _ in AlgState._fields))
    state_f64 = k_step_state(task, cfg, draws.batch_idx, 1, alg0, torch.float64, "cpu")
    w0 = task.ravel(task.params0)
    names = ("e_com", "e_var", "grad_norm", "n_scheduled")
    for case, avail in (("drops", draws.avail), ("all_dropped", torch.zeros(N_DEVICES))):
        out, seconds = {}, {}
        for where in ("cpu", dev):
            engine = SimEngine(task.loss_fn, task.data, cfg, device=where, **scenario)
            state = engine.lattice_start(task.params0, **cells)
            d = draws._replace(avail=avail)
            state = state._replace(alg=AlgState(*(f.to(where) for f in alg0)))
            t0 = time.perf_counter()
            given_draws(engine, [tuple(x.to(where) for x in d)])
            state, rec = engine.lattice_round(state, 1, False)
            updates = [ravel_pytree(tree_map(lambda p, c=c: p[c].cpu(), state.params))[0]
                       - w0 for c in range(4)]
            out[str(where)] = (updates, AlgState(*(f.cpu() for f in state.alg)),
                               [r.cpu() for r in rec[:4]])
            seconds[str(where)] = time.perf_counter() - t0
        (u_cpu, a_cpu, r_cpu), (u_card, a_card, r_card) = out["cpu"], out[str(dev)]

        def rel(a, b):
            return rel_l2(a, b) if torch.linalg.vector_norm(b) > 0 else \
                float(torch.linalg.vector_norm(a))
        update_err = max(rel(a, b) for a, b in zip(u_card, u_cpu))
        state_err = state_errors(a_card, state_f64)
        metric_err = max(((r_card[i] - r_cpu[i]).abs()
                          / r_cpu[i].abs().clamp_min(1e-30)).max().item() for i in range(3))
        finite = all(bool(torch.isfinite(x).all()) for x in u_card + list(a_card) + r_card)
        unchanged = all(not u.any() for u in u_card + u_cpu)
        emit("scenario_parity", case=case, d=task.dim, n=N_DEVICES, local_steps=SCENARIO_K,
             algorithms=list(ALGORITHM_IDS), available=int(avail.sum()),
             update_rel_l2_err_worst_cell=update_err, tolerance=ROUND_TOL,
             state_rel_l2_err_card_f64=state_err,
             state_rel_l2_err_cpu_f64=state_errors(a_cpu, state_f64),
             state_rel_l2_err_card_cpu=state_errors(a_card, a_cpu), state_tolerance=STATE_TOL,
             metric_rel_err_worst=metric_err, finite=finite, params_unchanged=unchanged,
             metrics_card_cpu={f: [r_card[i].tolist(), r_cpu[i].tolist()]
                               for i, f in enumerate(names)}, seconds=seconds)
        bad = update_err > ROUND_TOL or max(state_err.values()) > STATE_TOL \
            or metric_err > ROUND_TOL or not torch.equal(r_card[3], r_cpu[3]) or not finite
        if case == "all_dropped":
            bad = bad or not unchanged or bool(r_card[3].any())
        elif not 0 < int(avail.sum()) < N_DEVICES:
            bad = True
        if bad:
            raise AssertionError(f"scenario_parity {case}: card round disagrees with the CPU "
                                 f"round or breaks its case")


# -- the non-finite quarantine and the lattice loops --------------------------------


@contextlib.contextmanager
def final_lattice_state():
    """Inside the block, ``held["state"]`` is the state the last lattice
    round left: each cell's params and AlgState, which ``run_lattice``'s
    records leave out."""
    from repro_torch.sim.engine import SimEngine

    held, lattice_round = {}, SimEngine.lattice_round

    def keep(engine, state, t, do_eval, **kw):
        held["state"], record = lattice_round(engine, state, t, do_eval, **kw)
        return held["state"], record

    SimEngine.lattice_round = keep
    try:
        yield held
    finally:
        SimEngine.lattice_round = lattice_round


def record_rounds(recs) -> dict:
    """Each record field of a ``LatticeRecords`` by round: ``{field: (array
    of (A, P, Nn, Na, Ns, T'), the rounds of its last axis)}``."""
    rounds = np.arange(recs.e_com.shape[-1])
    fields = {f: (getattr(recs, f), rounds) for f in ("e_com", "e_var", "grad_norm",
                                                       "n_scheduled")}
    evals = {"loss": recs.loss, "acc": recs.acc}
    evals.update({f"eval.{f}": v for f, v in ([] if recs.eval is None else
                                               recs.eval._asdict().items())})
    fields.update({f: (v, recs.eval_rounds) for f, v in evals.items()})
    return fields


def nonfinite_rounds(fields: dict, cell) -> list:
    """The rounds at which any record field of ``cell`` is non-finite."""
    return sorted({int(r) for v, rounds in fields.values()
                   for r in rounds[~np.isfinite(v[cell])]})


def max_rel_diff(got: dict, want: dict, cells) -> tuple[float, dict]:
    """The largest |got − want| over ``cells``, each field of each cell
    relative to its largest |want| → (that error, {field: its error})."""
    by_field = {}
    for f, (w, _) in want.items():
        errs = [float(np.abs(got[f][0][c] - w[c]).max() / max(np.abs(w[c]).max(), 1e-30))
                for c in cells]
        by_field[f] = max(errs, default=0.0)
    return max(by_field.values(), default=0.0), by_field


def cell_name(spec, cell) -> str:
    a, p, n, _, s = cell
    return f"{spec.algorithms[a]}/{spec.policies[p]}/{spec.noise_powers[n]}/{spec.seeds[s]}"


def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block (the port's scoped
    switch, which ``run_lattice_checkpointed`` runs its chunks under). With
    its default ones two runs of one CNN lattice on the card part from the
    first rounds on, by percents after 6 rounds of the scenario lattice
    (measured by ``chip_repeatability.py``), so a comparison of two runs is
    made in this mode."""
    from repro_torch.sim.resilience import cudnn_deterministic as scoped

    return scoped("cuda")


def timed_lattice(task, spec, cfg, **kw):
    """``run_lattice`` on the card → (records, seconds)."""
    from repro_torch.sim.lattice import run_lattice

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = run_lattice(task.loss_fn, task.data, task.params0, spec, base_cfg=cfg,
                       eval_fn=task.eval, **kw)
    torch.cuda.synchronize()
    return recs, time.perf_counter() - t0


def quarantine(dev, lattice_records, scenario_records) -> dict:
    """The CNN scenario lattice of phase ``scenario_lattice`` again under
    ``on_nonfinite="skip"`` (timed, its launches counted), held to that
    phase's "propagate" records; then a "propagate" and a "skip" run of it
    with cuDNN's deterministic algorithms, held to each other; then the
    diverging (``channel``, seed 2) CNN cell of ``DIVERGING_CELLS`` through
    ``run_with_history`` under "skip" → the launch counts, each zeroed just
    before its run and read just after."""
    from repro_torch.flatten_util import tree_leaves
    from repro_torch.sim.engine import SimEngine

    scenario = dict(zip(("scenario", "scenario_params"), SCENARIO))
    prop, task, cfg = scenario_records["cnn"]
    spec = scenario_cnn_spec()
    skip_cfg = dataclasses.replace(cfg, on_nonfinite="skip")
    zero_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with final_lattice_state() as held:
        recs, seconds = timed_lattice(task, spec, skip_cfg, **scenario)
    counts = read_counts()
    launches = {k: counts[k] for k in ("aircomp_fused", "aircomp_fused_batch")}
    peak = torch.cuda.max_memory_allocated(dev)
    with cudnn_deterministic():
        det_prop, det_prop_s = timed_lattice(task, spec, cfg, **scenario)
        det_skip, det_skip_s = timed_lattice(task, spec, skip_cfg, **scenario)

    final = held["state"].params
    final_finite = torch.stack([torch.isfinite(p.reshape(p.shape[0], -1)).all(dim=1)
                                for p in tree_leaves(final)]).all(dim=0).cpu().numpy()
    cells = list(np.ndindex(recs.health.nonfinite.shape[:-1]))
    named = {c for c in cells if ("cnn", spec.algorithms[c[0]], spec.policies[c[1]],
                                  spec.noise_powers[c[2]], spec.seeds[c[4]])
             in SCENARIO_DIVERGING_CELLS}
    faults = []
    report = {}
    for run, skip, propagate in (("default", recs, prop), ("deterministic", det_skip,
                                                           det_prop)):
        skip_f, prop_f = record_rounds(skip), record_rounds(propagate)
        flagged = {c: [int(t) for t in np.nonzero(skip.health.nonfinite[c])[0]]
                   for c in cells}
        first_bad = {c: nonfinite_rounds(prop_f, c)[:1] for c in cells}
        finite_cells = [c for c in cells if not first_bad[c]]
        diff, by_field = max_rel_diff(skip_f, prop_f, finite_cells)
        for c in cells:
            name = f"{run} {cell_name(spec, c)}"
            if c in named and not (flagged[c] and first_bad[c]
                                   and flagged[c][0] >= first_bad[c][0]):
                faults.append(f"{name}: flagged {flagged[c]}, first non-finite under "
                              f"propagate {first_bad[c]}")
            if c not in named and (flagged[c] or first_bad[c]):
                faults.append(f"{name}: flagged {flagged[c]} (not a named diverging cell)")
            # every round after the first flagged one that is not flagged
            # itself is finite in every record field
            late = set(nonfinite_rounds(skip_f, c)) - set(flagged[c])
            if flagged[c] and any(t > flagged[c][0] for t in late):
                faults.append(f"{name}: unflagged rounds {sorted(late)} non-finite")
        if run == "deterministic":  # the comparison: one program, run twice
            if diff > ROUND_TOL:
                faults.append(f"finite cells {diff:.3g} from the propagate run")
            if not all(np.array_equal(skip.n_scheduled[c], propagate.n_scheduled[c])
                       for c in finite_cells):
                faults.append("|S| differs from the propagate run")
        report[run] = {
            "flagged_rounds_by_cell": {cell_name(spec, c): flagged[c]
                                       for c in cells if flagged[c]},
            "first_nonfinite_round_propagate": {cell_name(spec, c): first_bad[c][0]
                                                for c in cells if first_bad[c]},
            "nonfinite_fields_in_flagged_rounds": {
                cell_name(spec, c): sorted({f for f, (v, rounds) in skip_f.items()
                                            for r in flagged[c] if r in rounds and
                                            not np.isfinite(v[c][list(rounds).index(r)])})
                for c in cells if flagged[c]},
            "finite_cells": len(finite_cells),
            "finite_cells_max_rel_diff_from_propagate": diff,
            "finite_cells_max_rel_diff_by_field": by_field}
    faults += [f"default {cell_name(spec, c)}: final params non-finite"
               for i, c in enumerate(cells) if not final_finite[i]]
    if launches != {"aircomp_fused": 0, "aircomp_fused_batch": spec.n_rounds}:
        faults.append(f"launches {launches}")
    emit("quarantine", run="cnn_scenario_lattice_skip", d=task.dim, cells=spec.n_cells,
         rounds=spec.n_rounds, local_steps=cfg.local_steps, scenario=list(SCENARIO),
         seconds=seconds, cell_rounds_per_s=spec.n_cells * spec.n_rounds / seconds,
         max_memory_allocated=peak, launches=launches, tolerance=ROUND_TOL,
         final_params_finite=bool(final_finite.all()),
         deterministic_cell_rounds_per_s={
             "propagate": spec.n_cells * spec.n_rounds / det_prop_s,
             "skip": spec.n_cells * spec.n_rounds / det_skip_s},
         cudnn_default=report["default"], cudnn_deterministic=report["deterministic"],
         faults=faults)
    if faults:
        raise AssertionError(f"quarantine of the CNN scenario lattice: {faults}")

    _, policy, noise, seed = next(c for c in DIVERGING_CELLS if c[1:] == ("channel", 1e-10, 2))
    _, cnn, n_rounds = lattice_records["cnn"]
    cfg = lattice_cfg(policy=policy, noise_power=noise, alpha=0.1, seed=seed,
                      on_nonfinite="skip")
    engine = SimEngine(cnn.loss_fn, cnn.data, cfg, device=dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    params, hist = engine.run_with_history(cnn.params0, n_rounds)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    single = {k: counts[k] for k in ("aircomp_fused", "aircomp_fused_batch")}
    finite = bool(torch.isfinite(cnn.ravel(params)).all())
    series = {"e_com": hist.e_com, "e_var": hist.e_var}
    emit("quarantine", run="cnn_run_with_history_skip", cell=["cnn", policy, noise, seed],
         d=cnn.dim, rounds=n_rounds, seconds=seconds, rounds_per_s=n_rounds / seconds,
         launches=single, final_params_finite=finite,
         first_nonfinite_round=first_nonfinite(series), **series)
    if not finite or single != {"aircomp_fused": n_rounds, "aircomp_fused_batch": 0}:
        raise AssertionError(f"run_with_history under skip: launches {single}, final "
                             f"params finite {finite}")
    return {k: launches[k] + single[k] for k in launches}


def loop_rounds_from_fused_state(task, spec, cfg, scen_kw, loop_kw) -> tuple[np.ndarray, bool]:
    """Each round of a loop's sub-lattices started from the fused grid's state
    of the round before and fed the same draws, against the fused grid's
    round (what the loop changes, apart from the trajectory's amplification
    of it) → (the largest relative difference of any record value, (B, T)
    by flat cell and round; whether |S| is equal everywhere)."""
    from repro_torch.core.local_update import AlgState, algorithm_id
    from repro_torch.core.scheduling import policy_id
    from repro_torch.flatten_util import tree_map
    from repro_torch.sim.engine import FUSED_ALGORITHM, FUSED_POLICY, SimEngine
    from repro_torch.sim.lattice import cell_axes

    algs = [algorithm_id(a) for a in spec.algorithms]
    pols = [policy_id(p) for p in spec.policies]
    traced = len(algs) > 1
    dev = task.data.features.device
    engine = SimEngine(task.loss_fn, task.data, dataclasses.replace(
        cfg, policy=FUSED_POLICY,
        local_algorithm=FUSED_ALGORITHM if traced else spec.algorithms[0]),
        eval_fn=task.eval, device=dev, **scen_kw)
    flat = np.arange(spec.n_cells).reshape(len(algs), len(pols), -1)
    if "fuse_policies" in loop_kw:
        groups = [(algs, [p], flat[:, i].ravel()) for i, p in enumerate(pols)]
    else:
        groups = [([a], pols, flat[i].ravel()) for i, a in enumerate(algs)]

    def start(alg_ids, pol_ids):
        axes = cell_axes(spec, alg_ids, pol_ids)
        if not traced:
            axes["algorithm_b"] = None
        return engine.lattice_start(task.params0, **axes)

    def values(rec):  # the record's fields, each (B,)
        return list(rec[:6]) + ([] if rec.eval is None else list(rec.eval))

    fused = start(algs, pols)
    subs = [(idx, start(a, p)) for a, p, idx in groups]
    worst = np.zeros((spec.n_cells, spec.n_rounds))
    same_s = True
    for t in range(spec.n_rounds):
        ev = t % spec.eval_every == 0 or t == spec.n_rounds - 1
        prev = fused
        fused, rec = engine.lattice_round(fused, t, ev)
        want = values(rec)
        for k, (idx, sub) in enumerate(subs):
            at = torch.as_tensor(idx, device=dev)
            sub = sub._replace(
                params=tree_map(lambda p: p[at], prev.params),
                alg=None if prev.alg is None else AlgState(
                    *(None if f is None else f[at] for f in prev.alg)))
            sub, sub_rec = engine.lattice_round(sub, t, ev)
            subs[k] = (idx, sub)
            got = values(sub_rec)
            same_s = same_s and bool(torch.equal(got[3], want[3][at]))
            for g, w in zip(got, want):
                w = w[at]
                rel = torch.where(torch.isfinite(w),
                                  (g - w).abs() / w.abs().clamp_min(1e-30), 0.0)
                worst[idx, t] = np.maximum(worst[idx, t], rel.cpu().numpy())
    return worst, same_s


def lattice_loops(dev, lattice_records, scenario_records) -> dict:
    """``run_lattice(fuse_policies=False)`` over the CNN lattice and
    ``run_lattice(fuse_algorithms=False)`` over the CNN scenario lattice,
    both cut to ``LOOP_ROUNDS``: each loop timed beside the fused run of the
    same spec (the loop's launches zeroed just before it and read just
    after); then, with cuDNN's deterministic algorithms, every round of the
    loop's sub-lattices from the fused grid's state against the fused round
    (held to ``ROUND_TOL``, |S| equal; the cells of SCENARIO_DIVERGING_CELLS
    reported), and the loop's whole run against the
    fused run (|S| equal and every cell finite; the differences reported by
    round, since the trajectory amplifies a rounding difference) → the
    loops' launch counts."""
    scenario = dict(zip(("scenario", "scenario_params"), SCENARIO))
    _, cnn, _ = lattice_records["cnn"]
    _, scen_task, scen_cfg = scenario_records["cnn"]
    runs = {
        "cnn_lattice_per_policy": (
            cnn, lattice_spec("cnn", n_rounds=LOOP_ROUNDS),
            lattice_cfg(), {}, {"fuse_policies": False}, len(POLICIES)),
        "cnn_scenario_lattice_per_algorithm": (
            scen_task, dataclasses.replace(scenario_cnn_spec(), n_rounds=LOOP_ROUNDS),
            scen_cfg, scenario, {"fuse_algorithms": False}, len(SCENARIO_ALGORITHMS)),
    }
    launches = {"aircomp_fused": 0, "aircomp_fused_batch": 0}
    for run, (task, spec, cfg, scen_kw, loop_kw, subs) in runs.items():
        fused, fused_s = timed_lattice(task, spec, cfg, **scen_kw)
        zero_counts()
        loop, loop_s = timed_lattice(task, spec, cfg, **scen_kw, **loop_kw)
        counts = read_counts()
        with cudnn_deterministic():
            worst, same_s = loop_rounds_from_fused_state(task, spec, cfg, scen_kw, loop_kw)
            det_fused, det_fused_s = timed_lattice(task, spec, cfg, **scen_kw)
            det_loop, det_loop_s = timed_lattice(task, spec, cfg, **scen_kw, **loop_kw)
        # every cell is held to ROUND_TOL in every round but the cells named as
        # diverging, which are reported
        grid = (len(spec.algorithms), len(spec.policies), len(spec.noise_powers),
                len(spec.alphas), len(spec.seeds))
        names = [cell_name(spec, c) for c in np.ndindex(grid)]
        named = [i for i, c in enumerate(np.ndindex(grid)) if (
            "cnn", spec.algorithms[c[0]], spec.policies[c[1]], spec.noise_powers[c[2]],
            spec.seeds[c[4]]) in SCENARIO_DIVERGING_CELLS and run.startswith("cnn_scenario")]
        held = np.delete(worst, named, axis=0)
        per_round = {
            "held_cells": len(held), "max_rel_diff": float(held.max()),
            "by_round": held.max(axis=0).tolist(), "n_scheduled_equal": same_s,
            "cells_outside_tolerance": {names[i]: worst[i].tolist() for i in range(len(names))
                                        if i not in named and worst[i].max() > ROUND_TOL},
            "named_diverging_cells": {names[i]: worst[i].tolist() for i in named}}
        runs_diff = {}
        for mode, got, want in (("default", loop, fused), ("deterministic", det_loop,
                                                           det_fused)):
            got_f, want_f = record_rounds(got), record_rounds(want)
            cells = list(np.ndindex(want.e_com.shape[:-1]))
            finite = [c for c in cells if not nonfinite_rounds(want_f, c)]
            diff, by_field = max_rel_diff(got_f, want_f, finite)
            scale = {f: np.abs(getattr(want, f)).max(axis=-1, keepdims=True)
                     for f in ("e_com", "e_var", "grad_norm")}
            by_round = np.max([np.abs(getattr(got, f) - getattr(want, f)) /
                               np.maximum(scale[f], 1e-30) for f in scale], axis=0)
            per_cell = {cell_name(spec, c): max_rel_diff(got_f, want_f, [c])[0]
                        for c in finite}
            runs_diff[mode] = {
                "finite_cells": len(finite), "cells": len(cells),
                "n_scheduled_equal": all(np.array_equal(got.n_scheduled[c],
                                                        want.n_scheduled[c])
                                         for c in finite),
                "max_rel_diff_from_fused": diff, "max_rel_diff_by_field": by_field,
                "max_rel_diff_by_round": by_round.reshape(-1, spec.n_rounds)
                .max(axis=0).tolist(),
                "cells_outside_tolerance": {k: v for k, v in per_cell.items()
                                            if v > ROUND_TOL}}
        run_launches = {k: counts[k] for k in launches}
        emit("lattice_loops", run=run, loop=loop_kw, d=task.dim, cells=spec.n_cells,
             sub_lattices=subs, rounds=spec.n_rounds, seconds=loop_s,
             cell_rounds_per_s=spec.n_cells * spec.n_rounds / loop_s, fused_seconds=fused_s,
             fused_cell_rounds_per_s=spec.n_cells * spec.n_rounds / fused_s,
             deterministic_cell_rounds_per_s={
                 "fused": spec.n_cells * spec.n_rounds / det_fused_s,
                 "loop": spec.n_cells * spec.n_rounds / det_loop_s},
             launches=run_launches, tolerance=ROUND_TOL,
             rounds_from_fused_state=per_round, runs_cudnn_default=runs_diff["default"],
             runs_cudnn_deterministic=runs_diff["deterministic"])
        det = runs_diff["deterministic"]
        if run_launches != {"aircomp_fused": 0, "aircomp_fused_batch": subs * spec.n_rounds} \
                or per_round["cells_outside_tolerance"] or not same_s \
                or not det["n_scheduled_equal"] or det["finite_cells"] != det["cells"]:
            raise AssertionError(f"lattice loop {run}: launches {run_launches}, rounds "
                                 f"from the fused state {per_round}, whole runs {det}")
        for k in launches:
            launches[k] += run_launches[k]
    return launches


# -- the flight recorder and checkpointed sweeps ---------------------------------


@contextlib.contextmanager
def environ(**values):
    """The process environment with ``values`` set inside the block."""
    import os

    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def named_cells(spec, kind: str) -> list:
    """The flat cells of ``spec`` that ``DIVERGING_CELLS`` names."""
    grid = (len(spec.algorithms), len(spec.policies), len(spec.noise_powers),
            len(spec.alphas), len(spec.seeds))
    return [i for i, c in enumerate(np.ndindex(grid)) if (
        kind, spec.policies[c[1]], spec.noise_powers[c[2]], spec.seeds[c[4]]) in DIVERGING_CELLS]


def taps_parity(dev) -> dict:
    """One full-width CNN lattice round (4 cells) with the taps, card
    against the port's CPU path from one state and one set of draws → the
    largest relative difference of each tap (``eps_clamps`` must be equal)."""
    from repro_torch.obs import ObsConfig
    from repro_torch.sim.tasks import make_model_task

    task = make_model_task("cnn", n_devices=N_DEVICES, n_train=600, n_test=10,
                           channel_bias=1.0, device="cpu")
    engine_cpu, axes = fused_lattice_engine(task, "cpu", small=True)
    draws = [next(engine_cpu.draws(s, task.dim)) for s in (0, 1)]
    taps = {}
    for where in ("cpu", dev):
        engine, _ = fused_lattice_engine(task, where, small=True,
                                         obs=ObsConfig(diagnostics=True))
        state = engine.lattice_start(task.params0, **axes)
        given_draws(engine, [tuple(x.to(where) for x in d) for d in draws])
        _, rec = engine.lattice_round(state, 3, False)
        taps[str(where)] = {f: v.cpu() for f, v in rec.diag._asdict().items()}
    card, cpu = taps[str(dev)], taps["cpu"]
    errs = {f: ((card[f] - cpu[f]).abs() / cpu[f].abs().clamp_min(1e-30)).max().item()
            for f in ("noise_eff", "sched_entropy", "grad_norm_spread")}
    errs["eps_clamps_equal"] = torch.equal(card["eps_clamps"], cpu["eps_clamps"])
    return errs


def obs_phase(dev, lattice_records) -> dict:
    """The flight recorder on the card: the CNN lattice of phase ``lattice``
    with ``ObsConfig(diagnostics=True)`` and ``REPRO_OBS_DIR`` set, against
    the same call's run without the taps, both with cuDNN's deterministic
    algorithms; its events and the warm gate; one profiled run; the taps
    card vs CPU; the taps' cost on both lattices; a ``run_with_history``
    with the taps → the launch counts, zeroed at the start and read at the
    end."""
    import tempfile

    from repro_torch.obs import ObsConfig, close_sink, read_events
    from repro_torch.obs.report import collect, gate_warm_lattice
    from repro_torch.sim.engine import SimEngine

    tasks = {kind: lattice_records[kind][1] for kind in ("cnn", "logreg")}
    spec = lattice_spec("cnn")
    diag = ObsConfig(diagnostics=True)
    faults, expected = [], {"aircomp_fused": 0, "aircomp_fused_batch": 0}
    zero_counts()
    with tempfile.TemporaryDirectory() as sink, environ(REPRO_OBS_DIR=sink):
        with cudnn_deterministic():
            on, on_s = timed_lattice(tasks["cnn"], spec, lattice_cfg(), obs=diag)
            close_sink()
            first = collect(read_events(sink))
            off, off_s = timed_lattice(tasks["cnn"], spec, lattice_cfg())
            timed_lattice(tasks["cnn"], spec, lattice_cfg(), obs=diag)  # a warm repeat
        expected["aircomp_fused_batch"] += 3 * spec.n_rounds
        close_sink()
        summary = collect(read_events(sink))
        gate = gate_warm_lattice(summary)
        with environ(REPRO_OBS_PROFILE="1"):
            profiled, _ = timed_lattice(tasks["cnn"], lattice_spec("cnn", n_rounds=2),
                                        lattice_cfg())
        expected["aircomp_fused_batch"] += 2
        close_sink()
        (prof,) = [e for e in read_events(sink) if e["kind"] == "profile"]
        with open(prof["trace"]) as f:
            kernels = sorted({e["name"] for e in json.load(f)["traceEvents"]
                              if e.get("cat") == "kernel" and "aircomp" in e.get("name", "")})
    close_sink()

    base_equal = all(np.array_equal(getattr(on, f), getattr(off, f), equal_nan=True)
                     for f in ("e_com", "e_var", "grad_norm", "n_scheduled", "loss", "acc"))
    held = np.delete(np.arange(spec.n_cells), named_cells(spec, "cnn"))
    tap = {f: np.asarray(v).reshape(spec.n_cells, -1)[held] for f, v in on.diag._asdict().items()}
    finite = all(np.isfinite(v).all() for v in tap.values())
    entropy_ok = bool(((tap["sched_entropy"] >= 0)
                       & (tap["sched_entropy"] <= math.log(N_DEVICES) + 1e-5)).all())
    events = {k: [e for e in first[k] if e["name"] == n]
              for k, n in (("lattice", "lattice.run"), ("diag", "lattice.diagnostics"))}
    parity = taps_parity(dev)
    expected["aircomp_fused_batch"] += 1  # the card's round of the parity
    if not base_equal:
        faults.append("base records with the taps differ from those without")
    if not finite or not entropy_ok:
        faults.append(f"taps finite {finite}, sched_entropy in [0, log N] {entropy_ok}")
    if len(events["lattice"]) != 1 or len(events["diag"]) != 1:
        faults.append(f"events of the taps run: {[len(v) for v in events.values()]}")
    if gate:
        faults.append(f"warm gate: {gate}")
    if not any("aircomp_fused_kernel" in k for k in kernels):
        faults.append(f"profile names no batch kernel: {kernels}")
    if max(parity[f] for f in ("noise_eff", "sched_entropy", "grad_norm_spread")) > ROUND_TOL \
            or not parity["eps_clamps_equal"]:
        faults.append(f"taps card vs CPU {parity}")

    rates = {}
    for kind in ("cnn", "logreg"):  # cuDNN's default algorithms, as users run
        kspec = lattice_spec(kind)
        runs = {}
        for name, obs in (("off", None), ("on", diag), ("on_2", diag), ("off_2", None)):
            _, seconds = timed_lattice(tasks[kind], kspec, lattice_cfg(), obs=obs)
            runs[name] = kspec.n_cells * kspec.n_rounds / seconds
        expected["aircomp_fused_batch"] += 4 * kspec.n_rounds
        rates[kind] = runs

    cnn = tasks["cnn"]
    engine = SimEngine(cnn.loss_fn, cnn.data, lattice_cfg(noise_power=1e-10), device=dev,
                       obs=diag)
    params, hist = engine.run_with_history(cnn.params0, 5)
    expected["aircomp_fused"] += 5
    torch.cuda.synchronize()
    history_finite = all(math.isfinite(v) for v in hist.e_com + hist.e_var)
    counts = {k: read_counts()[k] for k in expected}
    if counts != expected or not history_finite:
        faults.append(f"launches {counts} (expected {expected}), run_with_history finite "
                      f"{history_finite}")
    emit("obs", run="cnn_lattice_diagnostics", d=cnn.dim, cells=spec.n_cells,
         rounds=spec.n_rounds, deterministic_seconds={"taps": on_s, "no_taps": off_s},
         base_records_bitwise_equal=base_equal, taps_finite_outside_named_cells=finite,
         named_cells=named_cells(spec, "cnn"),
         sched_entropy_range=[float(tap["sched_entropy"].min()),
                              float(tap["sched_entropy"].max())],
         eps_clamps_total=float(tap["eps_clamps"].sum()),
         tap_means_by_round=events["diag"][0]["taps"] if events["diag"] else None,
         lattice_run_event={k: events["lattice"][0].get(k) for k in
                            ("warm", "trace_delta", "compile_delta", "engine_compiles")}
         if events["lattice"] else None,
         gate_warm_lattice=gate or "ok", profile_trace_kernels=kernels,
         taps_card_vs_cpu=parity, tolerance=ROUND_TOL,
         cell_rounds_per_s_default_cudnn=rates, launches=counts, faults=faults)
    if faults:
        raise AssertionError(f"obs: {faults}")
    return counts


def checkpoint_phase(dev, lattice_records, scenario_records) -> dict:
    """``run_lattice_checkpointed`` on the card: (a) the CNN lattice
    checkpointed every 3 rounds, stopped after round 4 and resumed, bitwise
    the uninterrupted checkpointed run, and timed beside plain
    ``run_lattice``; (b) the same with ``REPRO_FAULT_NAN`` on one cell under
    "skip": only that cell's fault round flagged beyond (a)'s flags, every
    other cell bitwise (a)'s; (c) a logreg scenario lattice (4 algorithms ×
    3 policies × 2 seeds, K = 2, churn over Gauss-Markov) resumed bitwise;
    (d) one write and read of the full-width CNN scenario lattice's carry
    (its FedDyn h and SCAFFOLD c 1.49 GB), timed → the launch counts,
    zeroed at the start and read at the end."""
    import os
    import tempfile

    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.checkpoint.npz import leaves_with_paths
    from repro_torch.core.local_update import algorithm_id
    from repro_torch.core.scheduling import policy_id
    from repro_torch.sim.engine import FUSED_ALGORITHM, FUSED_POLICY, SimEngine
    from repro_torch.sim.lattice import LatticeSpec, cell_axes
    from repro_torch.sim.resilience import CheckpointConfig, run_lattice_checkpointed
    from repro_torch.sim.tasks import make_model_task

    def checkpointed(task, spec, cfg, where, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = run_lattice_checkpointed(task.loss_fn, task.data, task.params0, spec,
                                        base_cfg=cfg, eval_fn=task.eval,
                                        checkpoint=CheckpointConfig(where, 3), **kw)
        torch.cuda.synchronize()
        return recs, time.perf_counter() - t0

    def bitwise(a, b, cells=None) -> bool:
        fields = [(getattr(a, f), getattr(b, f)) for f in
                  ("e_com", "e_var", "grad_norm", "n_scheduled", "loss", "acc")]
        for sub in ("eval", "health"):
            if getattr(a, sub) is not None:
                fields += list(zip(getattr(a, sub), getattr(b, sub)))
        n = a.e_com[..., 0].size
        keep = np.arange(n) if cells is None else np.asarray(cells)
        return all(np.array_equal(np.asarray(x).reshape(n, -1)[keep],
                                  np.asarray(y).reshape(n, -1)[keep], equal_nan=True)
                   for x, y in fields)

    faults, expected, report = [], {"aircomp_fused": 0, "aircomp_fused_batch": 0}, {}
    cnn = lattice_records["cnn"][1]
    spec = lattice_spec("cnn")
    skip = lattice_cfg(on_nonfinite="skip")
    zero_counts()
    with tempfile.TemporaryDirectory() as d:
        plain, plain_s = timed_lattice(cnn, spec, skip)
        full, full_s = checkpointed(cnn, spec, skip, f"{d}/a_full")
        stopped, _ = checkpointed(cnn, spec, skip, f"{d}/a_stop", _stop_after_round=4)
        resumed, resumed_s = checkpointed(cnn, spec, skip, f"{d}/a_stop")
        # plain, full, stopped at the first boundary past round 4 (6), resumed
        expected["aircomp_fused_batch"] += 3 * spec.n_rounds
        fault_cell, fault_round = 0, 2
        with environ(REPRO_FAULT_NAN=f"{fault_cell}:{fault_round}"):
            faulted, _ = checkpointed(cnn, spec, skip, f"{d}/b")
        expected["aircomp_fused_batch"] += spec.n_rounds
        flags = faulted.health.nonfinite.reshape(spec.n_cells, -1) - \
            full.health.nonfinite.reshape(spec.n_cells, -1)
        others = [c for c in range(spec.n_cells) if c != fault_cell]
        report["a"] = {"resumed_bitwise": stopped is None and bitwise(full, resumed),
                       "flagged_cells": int((full.health.nonfinite.reshape(
                           spec.n_cells, -1).sum(axis=1) > 0).sum()),
                       "cell_rounds_per_s": {
                           "run_lattice": spec.n_cells * spec.n_rounds / plain_s,
                           "checkpointed": spec.n_cells * spec.n_rounds / full_s,
                           "resumed_run": spec.n_cells * (spec.n_rounds - 6) / resumed_s}}
        report["b"] = {"new_flags": [[int(c), int(r)] for c, r in zip(*np.nonzero(flags))],
                       "other_cells_bitwise": bitwise(faulted, full, others)}
        if not report["a"]["resumed_bitwise"]:
            faults.append("(a) the resumed CNN lattice is not bitwise the uninterrupted one")
        if report["b"]["new_flags"] != [[fault_cell, fault_round]] or \
                not report["b"]["other_cells_bitwise"]:
            faults.append(f"(b) NaN fault: {report['b']}")

        logreg = make_model_task("logreg", n_devices=N_DEVICES, partition="dirichlet",
                                 beta=0.4, n_train=3000, n_test=SCENARIO_N_TEST, seed=0,
                                 device=dev)
        lspec = LatticeSpec(algorithms=SCENARIO_ALGORITHMS, policies=SCENARIO_POLICIES,
                            noise_powers=(1e-10,), seeds=SCENARIO_SEEDS, n_rounds=8,
                            eval_every=4)
        lcfg = lattice_cfg(local_steps=SCENARIO_K, noise_power=1e-10,
                           fedprox_mu=SCENARIO_FEDPROX_MU)
        churn = dict(scenario="churn", scenario_params={"base": "gauss_markov", "corr": 0.9})
        lfull, lfull_s = checkpointed(logreg, lspec, lcfg, f"{d}/c_full", **churn)
        lstop, _ = checkpointed(logreg, lspec, lcfg, f"{d}/c_stop", _stop_after_round=4,
                                **churn)
        lresumed, _ = checkpointed(logreg, lspec, lcfg, f"{d}/c_stop", **churn)
        expected["aircomp_fused_batch"] += 2 * lspec.n_rounds
        report["c"] = {"cells": lspec.n_cells, "rounds": lspec.n_rounds,
                       "resumed_bitwise": lstop is None and bitwise(lfull, lresumed),
                       "finite": bool(np.isfinite(lfull.e_var).all()),
                       "cell_rounds_per_s": lspec.n_cells * lspec.n_rounds / lfull_s}
        if not report["c"]["resumed_bitwise"]:
            faults.append("(c) the resumed logreg scenario lattice is not bitwise")

        _, scen_task, scen_cfg = scenario_records["cnn"]
        sspec = scenario_cnn_spec()
        algs = [algorithm_id(a) for a in sspec.algorithms]
        engine = SimEngine(scen_task.loss_fn, scen_task.data, dataclasses.replace(
            scen_cfg, policy=FUSED_POLICY, local_algorithm=FUSED_ALGORITHM), device=dev,
            scenario=SCENARIO[0], scenario_params=SCENARIO[1])
        axes = cell_axes(sspec, algs, [policy_id(p) for p in sspec.policies])
        state = engine.lattice_start(scen_task.params0, **axes)
        state = state._replace(alg=type(state.alg)(*(torch.randn_like(f) for f in state.alg)))
        nbytes = sum(x.numel() * x.element_size() for _, x in leaves_with_paths(state)
                     if isinstance(x, torch.Tensor))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_pytree(f"{d}/d/carry", {"state": state}, metadata={"t_next": 0})
        write_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(f"{d}/d/carry.npz")
        t0 = time.perf_counter()
        back = load_pytree(f"{d}/d/carry", {"state": engine.lattice_start(
            scen_task.params0, **axes)})["state"]
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        same = all(torch.equal(x, y) for (_, x), (_, y) in
                   zip(leaves_with_paths(state), leaves_with_paths(back)))
        report["d"] = {"cells": sspec.n_cells, "carry_bytes": nbytes, "npz_bytes": file_bytes,
                       "write_seconds": write_s, "read_seconds": read_s,
                       "write_gb_per_s": file_bytes / write_s / 1e9,
                       "read_gb_per_s": file_bytes / read_s / 1e9, "bitwise": same}
        if not same:
            faults.append("(d) the CNN scenario lattice's carry did not come back bitwise")
        del state, back
    counts = {k: read_counts()[k] for k in expected}
    if counts != expected:
        faults.append(f"launches {counts}, expected {expected}")
    emit("checkpoint", d=cnn.dim, cells=spec.n_cells, rounds=spec.n_rounds, every=3,
         stop_after_round=4, fault=[fault_cell, fault_round], launches=counts, parts=report,
         deterministic_restored=torch.backends.cudnn.deterministic is False, faults=faults)
    if faults or torch.backends.cudnn.deterministic:
        raise AssertionError(f"checkpoint: {faults}")
    return counts


# -- the flash-attention kernel --------------------------------------------------


def check_attention(kernel, ref, dev) -> dict:
    """The flash kernel against its plain version over ``cases.CHECK_CASES``."""
    from repro_torch.kernels.attention.cases import CHECK_CASES, check_case

    errs = {}
    for i, name in enumerate(CHECK_CASES):
        err, share = check_case(name, kernel.flash_attention, ref, dev, seed=i)
        errs[name] = {"max_abs_err": err, "max_share_of_limit": share}
    emit("check", kernel="flash_attention",
         tolerance={"float32": "1e-5*max(1, max|ref|)",
                    "bfloat16": "2^-8*|ref| + 1e-5 element by element"},
         cases=errs)
    return errs


def attention_flops(b, s, h, dh) -> int:
    """The useful flops of one causal call at sq = sk = s: 4·dh for each of
    the b·h·s(s+1)/2 visible (query, key) pairs (q·k and p·v)."""
    return 4 * dh * b * h * s * (s + 1) // 2


def attention_bound(b, s, h, kv, dh, itemsize) -> tuple[float, str]:
    """The least time for one causal call at sq = sk = s: q, k, v read once
    and the output written once; its useful flops at the bf16 dense rate."""
    nbytes = itemsize * (2 * b * s * h * dh + 2 * b * s * kv * dh)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, attention_flops(b, s, h, dh) / BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_attention(kernel, ref, dev) -> dict:
    """The kernel, its bound, its plain version (not at 32k: the scores alone
    would take 60 GB) and ``scaled_dot_product_attention`` (timed here
    only, never called by the port) at the ATTN_TIME_SHAPES, bf16; the
    kernel's useful TFLOP/s, its time over the library's and its tensor-core
    passes (q·kᵀ once, P·V twice: P split into bf16 hi and lo)."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention.cases import attention_inputs

    flush = torch.empty(256 * 2**20 // 4, device=dev)  # 256 MiB > the 50 MB L2
    out = {}
    for name, (b, s, h, kv, dh) in ATTN_TIME_SHAPES.items():
        q, k, v = attention_inputs(b, s, s, h, kv, dh, torch.bfloat16, dev, seed=7)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # (b, heads, s, dh)
        bound_ms, bound_by = attention_bound(b, s, h, kv, dh, 2)
        out[name] = {
            "shape": [b, s, h, kv, dh], "dtype": "bfloat16", "causal": True,
            "ms": time_ms(lambda: kernel.flash_attention(q, k, v, causal=True), flush),
            "plain_ms": (time_ms(lambda: ref(q, k, v, causal=True), flush)
                         if s <= 2048 else None),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), flush),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        out[name]["ms_over_bound"] = out[name]["ms"] / bound_ms
        out[name]["ms_over_library"] = out[name]["ms"] / out[name]["library_ms"]
        out[name]["tflops"] = attention_flops(b, s, h, dh) / (out[name]["ms"] * 1e9)
    # mma_passes is the design's count, not a measurement: it stays out of
    # ``out``, which feeds the ``kernels`` line
    emit("times", kernel="flash_attention", library="scaled_dot_product_attention",
         mma_passes=3, **out)
    return out


# -- the SSD scan kernel ---------------------------------------------------------


def check_ssd(kernel, ref, dev) -> dict:
    """The SSD kernel against its plain version over ``cases.CHECK_CASES``."""
    from repro_torch.kernels.ssd.cases import CHECK_CASES, check_case

    errs = {}
    for i, name in enumerate(CHECK_CASES):
        err, share = check_case(name, kernel.ssd_scan, ref, dev, seed=i)
        errs[name] = {"max_abs_err": err, "max_share_of_limit": share}
    emit("check", kernel="ssd_scan",
         tolerance={"float32": "1e-5*max(1, max|ref|)",
                    "bfloat16": "2^-8*|ref| + 1e-5*max(1, max|ref|) element by element"},
         cases=errs)
    return errs


def ssd_bound(b, s, h, p, n, chunk, itemsize) -> tuple[float, str]:
    """The least time for one call: xdt, la, B, C read once and y written
    once; C Bᵀ once a chunk over its causal half, the masked decay product
    (a multiply and a p-long product a visible pair), the carried state's
    term and the state update (2·n·p each a row and head), at the dense
    rate of the inputs' type."""
    nbytes = itemsize * (2 * b * s * h * p + 2 * b * s * n) + 4 * b * s * h
    pairs = (s // chunk) * chunk * (chunk + 1) // 2
    flops = 2 * b * pairs * n + b * h * pairs * (2 * p + 1) + 4 * b * s * h * n * p
    rate = BF16_FLOPS if itemsize == 2 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_ssd(kernel, ref, dev) -> dict:
    """The kernel, its bound and its plain version on the same bf16 inputs
    (the CPU path's function) at the SSD_TIME_SHAPES. No PyTorch call
    computes the SSD scan: no library time."""
    from repro_torch.kernels.ssd.cases import ssd_inputs

    flush = torch.empty(256 * 2**20 // 4, device=dev)  # 256 MiB > the 50 MB L2
    out = {}
    for name, (b, s, h, p, n, chunk) in SSD_TIME_SHAPES.items():
        xdt, la, B, C = ssd_inputs(b, s, h, p, n, torch.bfloat16, dev, seed=7, strided=True)
        bound_ms, bound_by = ssd_bound(b, s, h, p, n, chunk, 2)
        out[name] = {
            "shape": [b, s, h, p, n, chunk], "dtype": "bfloat16",
            "ms": time_ms(lambda: kernel.ssd_scan(xdt, la, B, C, chunk=chunk), flush),
            "plain_ms": time_ms(lambda: ref(xdt, la, B, C, chunk), flush),
            "library_ms": None,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        out[name]["ms_over_bound"] = out[name]["ms"] / bound_ms
    emit("times", kernel="ssd_scan", library=None, **out)
    return out


# -- the serving paths -----------------------------------------------------------


def kernel_counters():
    """Every kernel's launch counter: ``{name: (module, attribute)}``."""
    from repro_torch.kernels.aircomp import kernel as aircomp
    from repro_torch.kernels.attention import kernel as attn
    from repro_torch.kernels.ssd import kernel as ssd

    return {"aircomp_fused": (aircomp, "launches"),
            "aircomp_fused_batch": (aircomp, "batch_launches"),
            "flash_attention": (attn, "launches"), "ssd_scan": (ssd, "launches")}


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in kernel_counters().items()}


def zero_counts() -> None:
    for mod, attr in kernel_counters().values():
        setattr(mod, attr, 0)


# per serving family: the kernel its prefill launches once a layer, the
# stages its breakdown sees (serve.* and serve.*/lm.*), and what the names of
# its kernels hold in the profiler (one call of ssd_scan runs three in bf16)
SERVE_KERNEL = {"dense": ("flash_attention", 4, "flash_fwd_kernel_bf16"),
                "ssm": ("ssd_scan", 3, "ssd_fwd_")}


def serve_setup(dev, arch):
    """``arch`` at full width: its config, a server of the serving shape on
    the card in bf16, the port's ``init_model`` weights cast once, and a
    seeded prompt (SERVE_BATCH × SERVE_PROMPT tokens)."""
    from repro_torch import configs
    from repro_torch.launch.serve import Server
    from repro_torch.models import api
    from repro_torch.models.config import InputShape

    cfg = configs.get_config(arch)
    shape = InputShape("serve", seq_len=SERVE_PROMPT + SERVE_NEW, global_batch=SERVE_BATCH,
                       kind="decode")
    server = Server(cfg, shape)  # the card, bf16: the defaults a user gets
    params = server.load_params(api.model_init(cfg, seed=0))
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), generator=gen)
    return cfg, server, params, {"tokens": tokens}


def arch_fields(cfg) -> dict:
    if cfg.arch_type == "ssm":
        s = cfg.ssm
        return {"ssm": {"d_state": s.d_state, "heads": s.n_heads(cfg.d_model),
                        "head_dim": s.head_dim, "conv": s.conv_kernel, "chunk": s.chunk_size}}
    return {"heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim]}


def serve_path(dev, setup, phase) -> dict:
    """Prefill, pad the cache (an SSM state stays as it is), decode
    greedily; the counts are zeroed just before and read just after."""
    from repro_torch.flatten_util import tree_leaves
    from repro_torch.models.cache import pad_cache

    cfg, server, params, batch = setup
    kname = SERVE_KERNEL[cfg.arch_type][0]
    total = SERVE_PROMPT + SERVE_NEW
    first, _, cache = server.prefill(params, batch)  # warm-up: cuBLAS's choices, the allocator
    server.decode(params, first, pad_cache(cache, total), SERVE_PROMPT, 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()  # zeroed just before
    t0 = time.perf_counter()
    first, logits, cache = server.prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_launches = read_counts()
    cache = pad_cache(cache, total)
    t0 = time.perf_counter()
    toks, cache = server.decode(params, first, cache, SERVE_PROMPT, SERVE_NEW)
    toks = toks.cpu()
    t_decode = time.perf_counter() - t0
    launches = read_counts()  # read just after
    steps = SERVE_NEW - 1
    expect = {name: cfg.n_layers if name == kname else 0 for name in launches}
    ok = (prefill_launches == expect and launches == expect
          and logits.shape == (SERVE_BATCH, 1, cfg.vocab_padded)
          and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
          and toks.shape == (SERVE_BATCH, SERVE_NEW) and int(toks.max()) < cfg.vocab_size
          and all(bool(torch.isfinite(c).all()) for c in cache if c.is_floating_point()))
    if cfg.arch_type == "dense":
        pos = torch.cat([torch.arange(total - 1), torch.tensor([-1])]).to(torch.int32)
        ok = ok and torch.equal(cache.pos.cpu(), pos)
    n_params = sum(p.numel() for p in tree_leaves(params))
    emit(phase, arch=cfg.name, d_model=cfg.d_model, n_layers=cfg.n_layers, **arch_fields(cfg),
         vocab_padded=cfg.vocab_padded, dtype="bfloat16", batch=SERVE_BATCH,
         prompt=SERVE_PROMPT, new_tokens=SERVE_NEW,
         params=n_params, param_count_of_config=cfg.param_count(),
         param_bytes=sum(p.numel() * p.element_size() for p in tree_leaves(params)),
         cache_bytes=sum(c.numel() * c.element_size() for c in cache),
         prefill_s=t_prefill, prefill_tokens_per_s=SERVE_BATCH * SERVE_PROMPT / t_prefill,
         decode_s=t_decode, decode_steps=steps, decode_ms_per_step=1e3 * t_decode / steps,
         decode_tokens_per_s=SERVE_BATCH * steps / t_decode,
         launches=launches, prefill_launches=prefill_launches,
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         tokens_row_0=toks[0].tolist())
    if not ok:
        raise AssertionError(f"{phase}: launches {launches} (prefill {prefill_launches}, "
                             f"expected {expect}), logits {tuple(logits.shape)}, tokens "
                             f"{tuple(toks.shape)}, or a non-finite cache")
    return launches


def serve_no_sync(dev, setup, phase) -> None:
    """A prefill and 4 decode steps at the serving shape with every
    device→host sync made an error."""
    from repro_torch.models.cache import pad_cache

    cfg, server, params, batch = setup
    tokens = batch["tokens"].to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first, _, cache = server.prefill(params, {"tokens": tokens})
        server.decode(params, first, pad_cache(cache, SERVE_PROMPT + 4), SERVE_PROMPT, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit(phase, arch=cfg.name, prefills=1, decode_steps=4, sync_debug_mode="error")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


def mamba2_dt_bias(params, cfg, seed=0):
    """``params`` with every layer's dt_bias drawn as Mamba2 initialises it
    (arXiv:2405.21060's code: dt log-uniform in [1e-3, 1e-1], dt_bias its
    inverse softplus) in place of the reference's zeros."""
    rng = np.random.default_rng(seed)
    dt = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1),
                            (cfg.n_layers, cfg.ssm.n_heads(cfg.d_model))))
    params["layers"]["mamba"]["dt_bias"] = torch.tensor(dt + np.log(-np.expm1(-dt)),
                                                        dtype=torch.float32)
    return params


def serve_parity(dev, arch, batch_size, prompt, phase) -> None:
    """All layers of ``arch`` in fp32 (TF32 off), card against the port's
    CPU path on one set of weights and tokens: the prefill's last-position
    logits and every float field of the cache (k and v, or the SSM state and
    conv window), then PARITY_NEW decode steps, both sides fed the CPU's
    greedy token, so a near-tie cannot send them down different paths. An
    ssm model's dt_bias is Mamba2's (:func:`mamba2_dt_bias`): at the
    reference's zeros the fp32 model itself drifts (``ssm_depth_drift``)."""
    from repro_torch import configs
    from repro_torch.flatten_util import tree_map
    from repro_torch.launch.serve import Server
    from repro_torch.models import api
    from repro_torch.models.cache import pad_cache
    from repro_torch.models.config import InputShape

    cfg = configs.get_config(arch)
    total = prompt + PARITY_NEW
    shape = InputShape("parity", seq_len=total, global_batch=batch_size, kind="decode")
    params = api.model_init(cfg, seed=2, device="cpu")
    if cfg.arch_type == "ssm":
        params = mamba2_dt_bias(params, cfg)
    gen = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (batch_size, prompt), generator=gen)}
    out, seconds = {}, {}
    for where in ("cpu", dev):
        server = Server(cfg, shape, where, dtype=torch.float32)
        p = params if where == "cpu" else tree_map(lambda x: x.to(dev), params)
        t0 = time.perf_counter()
        first, logits, cache = server.prefill(p, batch)
        out[str(where)] = (p, first.cpu(), logits.cpu(), pad_cache(cache, total))
        seconds[str(where)] = time.perf_counter() - t0
    (p_c, first_c, l_c, cache_c), (p_g, first_g, l_g, cache_g) = out["cpu"], out[str(dev)]
    vocab = cfg.vocab_size  # the pad columns (-1e30 on both sides) would swamp the norm
    fields = [f for f in cache_c._fields if getattr(cache_c, f).is_floating_point()]
    errs = {"prefill_logits": rel_l2(l_g[..., :vocab], l_c[..., :vocab]),
            **{f"cache_{f}": rel_l2(getattr(cache_g, f), getattr(cache_c, f)) for f in fields}}

    def margin(logits):  # the CPU's top-2 margin and its threshold
        top2 = logits[:, -1, :cfg.vocab_size].double().topk(2, dim=-1).values
        return (top2[:, 0] - top2[:, 1]).min().item(), ROUND_TOL * top2.abs().max().item()

    steps = [{"margin": margin(l_c)[0], "tokens_equal": torch.equal(first_g, first_c)}]
    checked = [margin(l_c)[0] <= margin(l_c)[1] or steps[0]["tokens_equal"]]
    tok = first_c
    step_errs = []
    for i in range(PARITY_NEW):
        l_c, cache_c = api.model_decode(p_c, cfg, tok, cache_c, prompt + i)
        l_g, cache_g = api.model_decode(p_g, cfg, tok.to(dev), cache_g, prompt + i)
        l_g = l_g.cpu()
        step_errs.append(rel_l2(l_g[..., :vocab], l_c[..., :vocab]))
        m, threshold = margin(l_c)
        tok = l_c[:, -1].argmax(dim=-1, keepdim=True)
        equal = torch.equal(l_g[:, -1].argmax(dim=-1, keepdim=True), tok)
        steps.append({"margin": m, "tokens_equal": equal})
        checked.append(m <= threshold or equal)
    errs["decode_logits_max"] = max(step_errs)
    for f in fields:
        errs[f"cache_{f}_after_decode"] = rel_l2(getattr(cache_g, f), getattr(cache_c, f))
    emit(phase, arch=arch, dtype="float32", batch=batch_size, prompt=prompt,
         decode_steps=PARITY_NEW, rel_l2_err=errs, tolerance=ROUND_TOL,
         decode_logits_rel_l2_err=step_errs, steps=steps,
         min_margin=min(s["margin"] for s in steps), prefill_seconds=seconds)
    if max(errs.values()) > ROUND_TOL or not all(checked):
        raise AssertionError(f"{phase}: card and CPU disagree: {errs}, steps {steps}")


def ssm_depth_drift(dev, batch_size, prompt) -> None:
    """How far the fp32 prefill's logits on the card drift from the CPU's
    with depth at the reference's init (dt_bias 0: decays to -54 a token,
    where La's rounding amplifies other sum orders), through the kernel and,
    as a yardstick, through the plain version on the card (its launches are
    not the main path's). Reported, not checked: ``ssm_serve_parity`` holds
    the model at Mamba2's dt init."""
    from unittest import mock

    from repro_torch import configs
    from repro_torch.flatten_util import tree_map
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref
    from repro_torch.models import api, transformer

    def plain(xdt, la, B, C, *, chunk):
        return ssd_chunked_ref(xdt, la, B, C, chunk)

    full = configs.get_config(SSM_ARCH)
    params = api.model_init(full, seed=2, device="cpu")
    on_card = tree_map(lambda x: x.to(dev), params)
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, full.vocab_size, (batch_size, prompt), generator=gen)
    vocab, out = full.vocab_size, {}
    for depth in SSM_DRIFT_DEPTHS:
        cfg = dataclasses.replace(full, n_layers=depth)
        cpu = transformer.prefill(params, cfg, tokens)[0][..., :vocab]
        kernel = transformer.prefill(on_card, cfg, tokens.to(dev))[0][..., :vocab]
        with mock.patch.object(transformer, "ssd", plain):
            plain_card = transformer.prefill(on_card, cfg, tokens.to(dev))[0][..., :vocab]
        out[depth] = {"kernel_vs_cpu": rel_l2(kernel, cpu),
                      "plain_on_card_vs_cpu": rel_l2(plain_card, cpu),
                      "kernel_vs_plain_on_card": rel_l2(kernel, plain_card)}
    emit("ssm_depth_drift", arch=SSM_ARCH, dtype="float32", batch=batch_size, prompt=prompt,
         dt_bias="reference init (zeros)", prefill_logits_rel_l2_err_by_depth=out)


def serve_breakdown(dev, setup, phase) -> None:
    """One prefill and BREAKDOWN_STEPS decode steps at the serving shape,
    each timed without the profiler, then traced; host and device ms per
    ``serve.*`` range and per ``lm.*`` range inside it, and the prefill
    kernel's share of the prefill's device time."""
    from repro_torch.models.cache import pad_cache

    cfg, server, params, batch = setup
    kname, n_stages, traced_name = SERVE_KERNEL[cfg.arch_type]
    holder = {}

    def prefill():
        holder["first"], _, cache = server.prefill(params, batch)
        holder["cache"] = pad_cache(cache, SERVE_PROMPT + BREAKDOWN_STEPS)

    def decode():  # rewrites the same slots (or the state) from the same start each time
        server.decode(params, holder["first"], holder["cache"], SERVE_PROMPT,
                      BREAKDOWN_STEPS + 1)

    out = {}
    for name, drive in (("prefill", prefill), ("decode", decode)):
        out[name] = profile_ranges(drive, 1, ("serve.", "lm."), n_stages, f"serve.{name}")
    pre = out["prefill"]  # the kernel is a ctypes launch: listed, not linked
    pre["kernel"] = kname
    pre["kernel_ms_by_name"] = {k: ms for k, ms in pre["unlinked_kernels_ms"].items()
                                if traced_name in k}
    pre["kernel_ms"] = sum(pre["kernel_ms_by_name"].values())
    pre["kernel_share_of_device_kernel_ms"] = pre["kernel_ms"] / pre["device_kernel_ms"]
    if pre["kernel_ms"] <= 0.0:
        raise AssertionError(f"{phase}: the profiler saw no {kname} kernel in the prefill")
    emit(phase, arch=cfg.name, batch=SERVE_BATCH, prompt=SERVE_PROMPT,
         decode_steps=BREAKDOWN_STEPS, **out)


def serving(dev, arch, prefix, parity_batch, parity_prompt) -> dict:
    """The serving phases of one architecture: ``<prefix>``, ``_no_sync``,
    ``_breakdown`` at the serving shape, then ``_parity``; → the main
    path's launch counts."""
    setup = serve_setup(dev, arch)
    launches = serve_path(dev, setup, prefix)
    serve_no_sync(dev, setup, f"{prefix}_no_sync")
    serve_breakdown(dev, setup, f"{prefix}_breakdown")
    del setup
    torch.cuda.empty_cache()
    serve_parity(dev, arch, parity_batch, parity_prompt, f"{prefix}_parity")
    if arch == SSM_ARCH:
        ssm_depth_drift(dev, parity_batch, parity_prompt)
    return launches


def kernel_entry(name, replaces, launches_by_phase, errs, times) -> dict:
    """One entry of the ``kernels`` line: the times at the path's larger
    shape, the other shape's beside them; ``launches`` sums the counts of
    the phases that drive the kernel's paths, each read on its own;
    ``max_abs_err`` over every check case, the float32 ones apart, and the
    bf16 cases' largest share of their limit."""
    big, small = times["cnn"], times["logreg"]
    return {
        "name": name,
        "route": "cuda",
        "source": "src/repro_torch/kernels/aircomp/csrc/aircomp.cu",
        "replaces": replaces,
        "launches": sum(launches_by_phase.values()),
        "launches_by_phase": launches_by_phase,
        "max_abs_err": max(e[0] for e in errs.values()),
        "max_abs_err_float32": max(e[0] for e in errs.values() if e[2] == "torch.float32"),
        "bf16_max_share_of_limit": max(e[1] for e in errs.values()
                                       if e[2] == "torch.bfloat16"),
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
        "shape": big["shape"],
        **{k: v for k, v in big.items() if k.startswith(("b_launches", "warm", "clean"))},
        **{k: v for k, v in times.items() if k in ("launch_floor_ms", "cnn_bf16")},
        "logreg": small,
    }


def lm_kernel_entry(name, source, replaces, launches, errs, times, cases) -> dict:
    """The ``kernels`` line's entry of a serving kernel: the times at the
    serving prefill's shape, the prefill_32k shape's beside them; ``cases``
    are its check cases (the dtype is the 7th field)."""
    big = times["prefill_2k"]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
        "max_abs_err_float32": max(e["max_abs_err"] for name, e in errs.items()
                                   if cases[name][6] == torch.float32),
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
        "shape": big["shape"],
        "dtype": big["dtype"],
        "prefill_32k": times["prefill_32k"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels.aircomp import kernel
    from repro_torch.kernels.aircomp.ref import aircomp_fused_batch_ref, aircomp_fused_ref
    from repro_torch.kernels.attention import kernel as attn_kernel
    from repro_torch.kernels.attention.cases import CHECK_CASES as ATTN_CASES
    from repro_torch.kernels.attention.ref import flash_attention_ref
    from repro_torch.kernels.build import ptxas_registers, sass_load_runs
    from repro_torch.kernels.ssd import kernel as ssd_kernel
    from repro_torch.kernels.ssd.cases import CHECK_CASES as SSD_CASES
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         tf32={"matmul": False, "cudnn": False})

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # one nvcc per source, started together
        jobs = {"aircomp": pool.submit(kernel.build),
                "flash_attention": pool.submit(attn_kernel.build),
                "ssd": pool.submit(ssd_kernel.build)}
        built = {name: job.result() for name, job in jobs.items()}
    emit("build", kernels=["aircomp_fused", "aircomp_fused_batch", "flash_attention", "ssd_scan"],
         seconds=time.perf_counter() - t0,
         libraries={name: {"seconds": b.seconds, "library": str(b.path.relative_to(ROOT)),
                           "registers": ptxas_registers(b), "ptxas": list(b.ptxas)}
                    for name, b in built.items()},
         # the aircomp kernel's loads in flight a thread, from its SASS
         aircomp_loads_before_ffma=sass_load_runs(built["aircomp"].path))

    errs = check_aircomp(kernel, aircomp_fused_ref, dev)
    batch_errs = check_aircomp_batch(kernel, aircomp_fused_batch_ref, aircomp_fused_ref, dev)
    times = time_aircomp(kernel, aircomp_fused_ref, dev)
    batch_times = time_aircomp_batch(kernel, aircomp_fused_batch_ref, dev)
    attn_errs = check_attention(attn_kernel, flash_attention_ref, dev)
    attn_times = time_attention(attn_kernel, flash_attention_ref, dev)
    ssd_errs = check_ssd(ssd_kernel, ssd_chunked_ref, dev)
    ssd_times = time_ssd(ssd_kernel, ssd_chunked_ref, dev)
    launches = main_path(dev)
    no_sync(dev)
    parity(dev)
    breakdown(dev)
    lattice_launches, lattice_records = lattice_path(dev)
    diverging(dev, lattice_records)
    lattice_no_sync(dev)
    lattice_parity(dev)
    lattice_breakdown(dev)
    scenario_launches, scenario_records = scenario_lattice(dev)
    scenario_diverging(dev, scenario_records)
    scenario_parity(dev)
    quarantine_launches = quarantine(dev, lattice_records, scenario_records)
    loop_launches = lattice_loops(dev, lattice_records, scenario_records)
    obs_launches = obs_phase(dev, lattice_records)
    checkpoint_launches = checkpoint_phase(dev, lattice_records, scenario_records)
    serve_launches = serving(dev, SERVE_ARCH, "serve", PARITY_BATCH, PARITY_PROMPT)
    ssm_launches = serving(dev, SSM_ARCH, "ssm_serve", SSM_PARITY_BATCH, SSM_PARITY_PROMPT)
    emit("total", seconds=time.perf_counter() - t_start)

    print(json.dumps({"kernels": [
        kernel_entry("aircomp_fused", "src/repro/kernels/aircomp/kernel.py:132",
                     {"main": launches["aircomp_fused"],
                      "scenario_lattice": scenario_launches["aircomp_fused"],
                      "quarantine": quarantine_launches["aircomp_fused"],
                      "lattice_loops": loop_launches["aircomp_fused"],
                      "obs": obs_launches["aircomp_fused"],
                      "checkpoint": checkpoint_launches["aircomp_fused"]},
                     errs, times),
        kernel_entry("aircomp_fused_batch", "src/repro/kernels/aircomp/kernel.py:82",
                     {"lattice": lattice_launches["aircomp_fused_batch"],
                      "scenario_lattice": scenario_launches["aircomp_fused_batch"],
                      "quarantine": quarantine_launches["aircomp_fused_batch"],
                      "lattice_loops": loop_launches["aircomp_fused_batch"],
                      "obs": obs_launches["aircomp_fused_batch"],
                      "checkpoint": checkpoint_launches["aircomp_fused_batch"]},
                     batch_errs, batch_times),
        lm_kernel_entry("flash_attention",
                        "src/repro_torch/kernels/attention/csrc/flash_attention.cu",
                        "src/repro/kernels/attention/kernel.py:103",
                        serve_launches["flash_attention"], attn_errs, attn_times, ATTN_CASES),
        lm_kernel_entry("ssd_scan", "src/repro_torch/kernels/ssd/csrc/ssd.cu",
                        "src/repro/kernels/ssd/kernel.py:65", ssm_launches["ssd_scan"],
                        ssd_errs, ssd_times, SSD_CASES),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
