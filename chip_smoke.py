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
             over the library call's and its 3 tensor-core passes; the flash
             and SSD kernels also at the zamba2 and olmoe prefills' shapes,
             the flash kernel also at seamless's non-causal encoder, its
             cross-attention from the prompt and from a decode step's one
             query, and internvl2's prefill)
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
             "skip" run with cuDNN's deterministic algorithms for the whole
             run (the port's local update runs its gradients in that mode in
             any case; with cuDNN's default ones two runs of one CNN lattice
             differ): the same flags, and every cell that stays finite within 1e-4 of its
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
             logreg lattices, as users run them); a CNN
             ``run_with_history`` with the taps (one one-round launch a round)
  checkpoint ``run_lattice_checkpointed``: the CNN lattice every 3 rounds, stopped after
             round 4 and resumed, bitwise the uninterrupted run, timed beside
             ``run_lattice``; the same with ``REPRO_FAULT_NAN`` on one cell
             under "skip" (only that flag new, every other cell bitwise); a
             logreg scenario lattice (4 algorithms × 3 policies × 2 seeds,
             K = 2, churn over Gauss-Markov) resumed bitwise; one npz write
             and read of the full-width CNN scenario lattice's carry (FedDyn
             h and SCAFFOLD c, 1.49 GB), timed, bitwise; the flag restored
  mesh       the lattice over many ranks (one line a sub-run): (a) the CNN
             lattice (15 cells, 3 rounds) with ``run_lattice(mesh=1)`` and
             ``mesh=(1, 1)`` on a one-rank NCCL group, bitwise ``mesh=None``;
             (b) ``python -m repro_torch.launch.distributed --procs 2
             --workload parity --device cuda``: two ranks sharing the card
             over gloo, the full-width CNN lattice as cells 8 + 7 (padded
             to 16) held round by round from the unsharded run's state (≤
             1e-5 relative, decisions exact), the launcher's logreg lattice
             over the whole run against this process's unsharded run (≤
             1e-5); (c) the same ranks as a (1, 2) model mesh: the CNN
             lattice and ``round_algorithm``'s model-sharded rounds held the
             same way, each rank's peak memory beside the unsharded run's;
             (d) the supervised ``resilient`` workload killed at
             ``REPRO_FAULT_KILL=1:2``: the merged npz bitwise a clean run
             of the same shards (in this process), one
             ``resilience.fault_kill``, ``supervisor.restart`` and
             ``resilience.resume`` event each; (e) cell-rounds/s of one rank
             against two ranks sharing the card. Counts zeroed after the
             unsharded run of (a); each rank counts around its sharded calls
             only; one launch a sharded round, or the phase fails
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
  hybrid_serve  zamba2-2.7b at full width and depth (54 Mamba2 layers, d
             2,560, d_state 64, 80 heads of 64; the shared attention + MLP
             block, 32 heads of 80, MHA, d_ff 10,240, before every 6th
             layer: 9 invocations), the same way: exactly 9 flash and 54 SSD
             launches a prefill, none in decode; the shared block's KV cache
             one slot a position as for qwen2
  moe_serve  olmoe-1b-7b at full width and depth (16 layers, d 2,048, 16
             heads of 128, 64 experts, top-8, d_ff_expert 1,024, vocab
             50,304), the same way: exactly 16 flash launches a prefill,
             none in decode; the experts run as plain batched products
  hybrid_serve_no_sync, moe_serve_no_sync, hybrid_serve_breakdown,
             moe_serve_breakdown  as for qwen2 (``lm.attention``,
             ``lm.mlp``, ``lm.mamba``; ``lm.attention``, ``lm.moe``; each
             kernel's share of the prefill's device time)
  hybrid_serve_parity, moe_serve_parity  full width at a cut depth in
             fp32 (zamba2: 12 layers, 2 invocations, batch 2, prompt 256,
             Mamba2's dt init; olmoe: 4 layers, batch 2, prompt 512: 1,024
             tokens, one routing group), card against CPU as for qwen2;
             olmoe's routing besides: every layer's experts equal at tokens
             whose top k + 1 probabilities are more than 1e-6 apart, and
             positions and drops equal wherever no other choice touched
             their expert
  encdec_serve  seamless-m4t-large-v2 at full width and depth (24 encoder
             and 24 decoder layers, d 1,024, 16 heads of 64, MHA, d_ff
             8,192, vocab 256,256 padded) over 1,024 random frame embeddings
             (the speech frontend is a stub) with a 256-token decoder
             prompt, the same batch and new tokens: exactly 72 flash
             launches a prefill (24 non-causal encoder, 24 causal decoder
             and 24 cross-attention calls) and 24 a decode step (the
             cross-attention's one query against the cached frames)
  vlm_serve  internvl2-76b's language backbone at full width (d 8,192, 64
             query / 8 kv heads of 128, d_ff 28,672, vocab 128,256, RoPE θ
             5e5) cut to 8 of its 80 layers, 256 random patch embeddings
             (the vision encoder is a stub) and 1,792 tokens (2,048
             positions), 32 greedy tokens from t = 2,048: exactly 8 flash
             launches a prefill, none in decode
  encdec_serve_no_sync, vlm_serve_no_sync, encdec_serve_breakdown,
             vlm_serve_breakdown  as for qwen2 (``lm.attention``,
             ``lm.cross_attention``, ``lm.mlp``; ``lm.attention``,
             ``lm.mlp``; the flash kernel's share of the prefill's and, for
             seamless, the decode's device time)
  encdec_serve_parity, vlm_serve_parity  full width at a cut depth in fp32
             (seamless: 2 + 2 layers, batch 2, 256 frames, a 64-token
             prompt; internvl2: 1 layer, batch 1, 8 patches and 56 tokens),
             card against CPU as for qwen2 (seamless's cross k and v too)
  train_grads  the flash and SSD kernels' autograd Functions at qwen2-0.5b's
             training attention (8, 2048, 14/2, 64, causal) and mamba2-370m's
             SSD scan (8, 2048, 32, 64, n 128, chunk 256), bf16 and fp32:
             primal, backward and jvp against autograd and
             ``torch.func.jvp`` of the plain version (relative L2 ≤ 1e-5 in
             fp32, 2^-7 in bf16); then one full-width, full-depth train step
             of each (bf16, remat, 8 × 2,048 over 8 FL devices, no noise):
             every gradient leaf fp32, finite and non-zero
  train_parity  one ``POFLTrainer`` round (sketch mode, 2 probes, sgd) of
             qwen2-0.5b and mamba2-370m at full width and 2 layers in fp32
             on the card against the CPU, from one set of weights and draws:
             stats, coeffs, noise_amp, e_com, a, loss, the gradients and the
             update within 1e-4, n_scheduled equal
  train      ``POFLTrainer`` on qwen2-0.5b at full width and depth (24
             layers, d 896, vocab 151,936) in bf16: 8 × 2,048 tokens over 8
             FL devices, 4 scheduled, pofl, sketch mode with 2 probes, σ_z²
             1e-10, ``adamw(cosine_schedule(3e-4, 12, warmup=2))``, 12
             rounds: tokens/s, ms a round, peak memory, e_com, |S| and the
             weighted loss each round; exactly 120 flash launches a round
             (24 in each of 3 JVP passes, 24 in the step's forward and 24 in
             remat's recompute); every value finite, the unweighted loss on
             a fixed batch lower after than before; then ``train.*`` host
             and device ms of one more round (``torch.profiler``)
  train_ranks  ``POFLTrainer`` over a (data, model) mesh of ranks, qwen2-0.5b
             at full width, 8 × 2,048 tokens over 8 FL devices: (a) a (1, 1)
             mesh of one NCCL rank (this process) against the one-card
             trainer on phase ``train``'s setting and draws, 2 rounds at
             full depth; (b) the (2, 1) and (c) the (1, 2) mesh of two ranks
             sharing the card over gloo (the launcher's ``train`` workload,
             ``sgd``, RANKS_LAYERS layers in RANKS_DTYPE, RANKS_ROUNDS
             rounds; on (c) qwen2 split tensor-parallel over the two model
             ranks, kernel 3 on 7 of 14 heads) against this process's
             one-rank trainer: every round's loss, e_com, a, coeffs and
             noise_amp, each rank's final blocks (and their update) within
             1e-4, decisions equal; (b) and (c) again in bf16 for one round
             within 2^-7; each rank's ms a round and its collectives'
             shares, peak memory, bytes of masters, optimizer state and
             compute weights (equal to the dry run's) and flash launches
             (L × 5 a round); (d) olmoe-1b-7b over (2, 1) and (e)
             mamba2-370m split by SSM heads over (1, 2) (kernel 4 on 16 of
             32 heads, L × 5 a round), held the same way to this process's
             one-card trainer at their depths
  serve_ranks  ``Server`` over a (data, model) mesh of ranks
             (``serve_ranks_plan``): (a) one NCCL rank bitwise the one-card
             server; (b) (2, 1) and (c) (1, 2) of two ranks sharing the card
             over gloo, one launch, qwen2-0.5b at decode_32k and
             mamba2-370m on both; on (c) qwen2 split tensor-parallel over
             the two model ranks (kernel 3 on 7 of 14 heads in every prefill
             layer) and mamba2 split by SSM heads (kernel 4 on 16 of 32
             heads, at a cut depth in fp32 and at full depth in bf16); every
             rank against one process (on (c) at full depth in bf16, both
             against one process's fp32 prefill of the same inputs), its
             collectives and weight bytes against the dry run's

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
# the mesh phase: the CNN lattice cut to 3 rounds (in-process and on the
# spawned ranks, round by round), the launcher's logreg parity lattice 4;
# spawned ranks pay for a torch import and a CUDA context, so the phase is
# cut in rounds, not in width
MESH_ROUNDS, MESH_LOGREG_ROUNDS = 3, 4
RESILIENT_ROUNDS = 6  # the supervised resilient sweep's rounds (checkpoints every 2)
MESH_TOL = 1e-5  # a sharded round against the unsharded one (ROADMAP C7's rule)
MESH_TIMEOUT = 300  # seconds a launcher's ranks get before they are killed
# the serving path: qwen2-0.5b at full width
SERVE_ARCH = "qwen2-0.5b"
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 2048, 32
PARITY_BATCH, PARITY_PROMPT, PARITY_NEW = 2, 256, 8
BREAKDOWN_STEPS = 8
# (b, sq, sk, h, kv, dh, causal) of the flash kernel's times, bf16: the
# serving prefills (and the prefill_32k sequence length), qwen2's on one of
# two model ranks; seamless's non-causal encoder, its cross-attention from
# the prompt and from a decode step's one token
ATTN_TIME_SHAPES = {"prefill_2k": (8, 2048, 2048, 14, 2, 64, True),
                    "prefill_2k_tp2": (8, 2048, 2048, 7, 1, 64, True),
                    "prefill_32k": (1, 32768, 32768, 14, 2, 64, True),
                    "zamba2_prefill": (8, 2048, 2048, 32, 32, 80, True),
                    "olmoe_prefill": (8, 2048, 2048, 16, 16, 128, True),
                    "seamless_encoder": (8, 1024, 1024, 16, 16, 64, False),
                    "seamless_cross_prefill": (8, 256, 1024, 16, 16, 64, False),
                    "seamless_cross_decode": (8, 1, 1024, 16, 16, 64, False),
                    "internvl2_prefill": (8, 2048, 2048, 64, 8, 128, True)}
# the second serving path: mamba2-370m at full width, the same batch, prompt
# and new tokens; its parity at two chunks
SSM_ARCH = "mamba2-370m"
SSM_PARITY_BATCH, SSM_PARITY_PROMPT = 2, 512
SSM_DRIFT_DEPTHS = (1, 12, 48)
# (b, s, h, p, n, chunk) of the SSD kernel's times, bf16: one layer of the
# serving prefill and the prefill_32k sequence length
SSD_TIME_SHAPES = {"prefill_2k": (8, 2048, 32, 64, 128, 256),
                   "prefill_32k": (1, 32768, 32, 64, 128, 256),
                   "zamba2_prefill": (8, 2048, 80, 64, 64, 256),
                   "prefill_2k_tp2": (8, 2048, 16, 64, 128, 256)}  # a model rank's heads
# the hybrid and MoE serving paths: zamba2-2.7b and olmoe-1b-7b at full width
# and depth, the same batch, prompt and new tokens; their parity at full width
# and a cut depth, (layers, batch, prompt): zamba2 with 2 shared-block
# invocations, olmoe's 1,024 tokens in one routing group (so tokens drop)
HYBRID_ARCH, MOE_ARCH = "zamba2-2.7b", "olmoe-1b-7b"
HYBRID_PARITY, MOE_PARITY = (12, 2, 256), (4, 2, 512)
# router probabilities closer than this make a token's top-k ill-defined: the
# MoE parity holds decisions exactly everywhere else
MOE_TIE = 1e-6
# the enc-dec and VLM serving paths, the same batch and new tokens:
# seamless-m4t-large-v2 at full width and depth over 1,024 frames with a
# 256-token decoder prompt; internvl2-76b's backbone at full width cut to 8
# of its 80 layers (the fp32 init and its bf16 copy of 80 would not fit one
# card), 256 patches + 1,792 tokens = 2,048 positions. Their parity at full
# width, (layers, batch, prompt tokens, frames or patches): seamless 2 + 2
# layers, internvl2 1 layer (about 12 GB of fp32 weights on each side)
ENCDEC_ARCH, VLM_ARCH = "seamless-m4t-large-v2", "internvl2-76b"
SERVE_LAYERS = {VLM_ARCH: 8}
ENCDEC_PROMPT = 256
ENCDEC_PARITY, VLM_PARITY = (2, 2, 64, 256), (1, 1, 56, 8)


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
    busy time. A kernel that a ctypes library launches (the port's own
    kernels link the CUDA runtime statically) is linked to the op that
    launched it only when that op is traced: the flash and SSD kernels are,
    inside their ``autograd.Function`` s, and count in the range around
    them; the aircomp kernels are listed by name under
    ``unlinked_kernels_ms`` and are in no range. ``kernels_ms_by_name``
    sums every device kernel by name, linked or not. The idle share is the
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
    by_name: dict = {}
    for e in device:
        ms = (e.time_range.end - e.time_range.start) / 1e3 / rounds
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        if e.name not in linked:
            unlinked[e.name] = unlinked.get(e.name, 0.0) + ms
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
        "kernels_ms_by_name": by_name, "stages": stages,
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
    """cuDNN's deterministic algorithms in the whole block (the port's
    scope, ``repro_torch.device.cudnn_deterministic``, which its local
    update runs every gradient under; so a run repeats without it too)."""
    from repro_torch.device import cudnn_deterministic as scoped

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
    for kind in ("cnn", "logreg"):  # as users run them (the port's deterministic gradients)
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


# -- the lattice over many ranks -------------------------------------------------


def launch(args: list, timeout: float = MESH_TIMEOUT, **env) -> str:
    """``python -m repro_torch.launch.distributed`` with ``args`` (its ranks
    killed after ``timeout`` seconds, the launcher a minute later) → its
    output; a failed launch ends the phase. The ranks run without TF32, as
    this process does (``NVIDIA_TF32_OVERRIDE=0``: torch's default lets
    cuDNN's convolutions use it)."""
    import os

    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.distributed", "--timeout", str(timeout),
         *map(str, args)],
        capture_output=True, text=True, cwd=ROOT, timeout=timeout + 60,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "NVIDIA_TF32_OVERRIDE": "0", **env})
    if done.returncode != 0:
        raise AssertionError(f"launch {args} failed (rc {done.returncode}):\n"
                             f"{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
    return done.stdout


def within(rounds: list, what: str) -> float:
    """The largest relative difference of a list of per-round
    ``launch.distributed._rel_diff``s; decisions must be equal in every
    round and every difference within MESH_TOL."""
    worst = 0.0
    for r in rounds:
        r = dict(r)
        if not r.pop("decisions_equal"):
            raise AssertionError(f"mesh {what}: decisions differ: {rounds}")
        worst = max([worst, *r.values()])
    if worst > MESH_TOL:
        raise AssertionError(f"mesh {what}: {worst:.3g} > {MESH_TOL}: {rounds}")
    return worst


def mesh_phase(dev) -> dict:
    """Phase ``mesh``: (a) the CNN lattice on a one-rank NCCL mesh, ``mesh=1``
    and ``(1, 1)``, bitwise ``mesh=None``; (b, c) the launcher's ``parity``
    workload on two ranks sharing the card over gloo: its logreg lattice
    over the whole run against this process's unsharded run, and the
    full-width CNN lattice (8 + 7 cells, and a (1, 2) model mesh with
    ``round_algorithm``'s model-sharded rounds) round by round from the
    unsharded state, each rank's peak memory in its sharded calls; (d) the
    supervised ``resilient`` workload killed at ``REPRO_FAULT_KILL=1:2``,
    merged bitwise to a clean run of the same shards in this process, one
    ``resilience.fault_kill``, ``supervisor.restart`` and
    ``resilience.resume`` event; (e) cell-rounds/s of one rank against two
    sharing the card → the launch counts of kernels 1 and 2 on the sharded
    paths only: (a)'s mesh runs, counted from zero after the unsharded run,
    and each rank's sharded calls, counted around them (a rank's unsharded
    twin rounds do not count). Each count must be one launch a sharded
    round."""
    import collections
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.distributed import (_RECORD_FIELDS, load_records, parity_records,
                                                resilient_shard, resilient_spec)
    from repro_torch.sim.multihost import ensure_process_group
    from repro_torch.sim.resilience import merge_shards

    task = lattice_tasks(dev)["cnn"]
    spec = lattice_spec("cnn", n_rounds=MESH_ROUNDS)
    cell_rounds = spec.n_cells * spec.n_rounds
    ensure_process_group()
    backend = dist.get_backend()
    torch.cuda.reset_peak_memory_stats(dev)
    want, none_s = timed_lattice(task, spec, lattice_cfg(), mesh=None)
    peak = torch.cuda.max_memory_allocated(dev)
    zero_counts()  # just before the mesh path: the unsharded run above is not on it
    # mesh=1 first: its call also makes the NCCL communicator, so (1, 1) is the warm rate
    got = [(m, *timed_lattice(task, spec, lattice_cfg(), mesh=m)) for m in (1, (1, 1))]
    launches = {k: read_counts()[k] for k in ("aircomp_fused", "aircomp_fused_batch")}
    dist.destroy_process_group()
    unequal = [f"{m}.{f}" for m, recs, _ in got for f in _RECORD_FIELDS
               if not np.array_equal(getattr(recs, f), getattr(want, f))] + [
        f"{m}.eval" for m, recs, _ in got
        if not all(np.array_equal(a, b) for a, b in zip(recs.eval, want.eval))]
    one_rank_launches = {"aircomp_fused": 0, "aircomp_fused_batch": len(got) * spec.n_rounds}
    if backend != "nccl" or unequal or launches != one_rank_launches:
        raise AssertionError(f"mesh one_rank: backend {backend}, differs in {unequal}, "
                             f"launches {launches} (expected {one_rank_launches})")
    rate = {name: cell_rounds / sec for name, (_, _, sec) in
            zip(("mesh_1_first", "mesh_1x1"), got)}
    emit("mesh", run="one_rank", backend=backend, cells=spec.n_cells, rounds=spec.n_rounds,
         bitwise=True, cell_rounds_per_s={"mesh_none": cell_rounds / none_s, **rate},
         launches=dict(launches), max_memory_allocated_unsharded=peak)

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "parity.npz")
        wall0, t0 = time.time(), time.perf_counter()
        launch(["--procs", 2, "--workload", "parity", "--device", "cuda", "--n-rounds",
                MESH_LOGREG_ROUNDS, "--cnn-rounds", MESH_ROUNDS, "--out", out])
        parity_s = time.perf_counter() - t0
        recs, meta = load_records(out)
    single = parity_records(MESH_LOGREG_ROUNDS, device=dev)
    whole = {f: float(np.abs(getattr(recs, f) - getattr(single, f)).max()
                      / max(float(np.abs(getattr(single, f)).max()), 1e-30))
             for f in _RECORD_FIELDS if f != "n_scheduled"}
    if not np.array_equal(recs.n_scheduled, single.n_scheduled) or \
            max(whole.values()) > MESH_TOL or meta["backend"] != "gloo":
        raise AssertionError(f"mesh logreg: backend {meta['backend']}, whole run {whole}")
    # a rank's sharded calls: one batch launch a lattice round on its block,
    # one one-round launch a model-sharded round_algorithm round
    per_round = {"cells": {"aircomp_fused": 0, "aircomp_fused_batch": 1},
                 "model": {"aircomp_fused": 0, "aircomp_fused_batch": 1},
                 "round_algorithm": {"aircomp_fused": 1, "aircomp_fused_batch": 0}}
    ranks = meta["per_rank"]
    for r, mine in enumerate(ranks):
        for part, one in per_round.items():
            expected = {k: v * MESH_ROUNDS for k, v in one.items()}
            if mine[part]["launches"] != expected:
                raise AssertionError(f"mesh rank {r} {part}: launches "
                                     f"{mine[part]['launches']}, expected {expected}")
            for k in launches:
                launches[k] += mine[part]["launches"][k]
    cnn = meta["cnn"]
    for name in ("cells", "model"):
        emit("mesh", run=f"two_ranks_{name}", backend=meta["backend"],
             mesh=[2] if name == "cells" else [1, 2], cells=spec.n_cells, rounds=MESH_ROUNDS,
             tolerance=MESH_TOL,
             cnn_rounds_from_state_max=within(cnn[name]["rounds_from_state"], f"cnn {name}"),
             cnn_rounds_from_state=cnn[name]["rounds_from_state"],
             round_algorithm_from_state_max=within(
                 cnn["model"]["round_algorithm_from_state"], "round_algorithm")
             if name == "model" else None,
             logreg_rounds_from_state_max=within(
                 meta["rounds_from_state" if name == "cells" else "model_rounds_from_state"],
                 f"logreg {name}"),
             logreg_whole_run=whole if name == "cells" else None,
             sharded_by_rank=[r[name] for r in ranks],
             round_algorithm_sharded_by_rank=[r["round_algorithm"] for r in ranks]
             if name == "model" else None,
             max_memory_allocated_unsharded=peak)
    # the sharded rounds of both ranks, which share the card, over the slower
    # rank's time; a rank's first round is its process's first convolution
    # (cuDNN's start-up), so the rounds after it
    warm = spec.n_cells * (MESH_ROUNDS - 1)
    two_ranks = warm / max(sum(r["cells"]["seconds_by_call"][1:]) for r in ranks)
    emit("mesh", run="rates", cells=spec.n_cells, rounds=MESH_ROUNDS,
         cell_rounds_per_s_one_rank=rate["mesh_1x1"],
         cell_rounds_per_s_two_ranks_one_card=two_ranks, ratio=two_ranks / rate["mesh_1x1"],
         parity_launch_seconds=parity_s,
         rank_reached_seconds=[{k: v - wall0 for k, v in r["stamps"].items()} for r in ranks])

    with tempfile.TemporaryDirectory() as d:
        sink = os.path.join(d, "obs")
        os.makedirs(sink)
        wall0, t0 = time.time(), time.perf_counter()
        launch(["--procs", 2, "--workload", "resilient", "--device", "cuda",
                "--checkpoint-every", 2, "--n-rounds", RESILIENT_ROUNDS,
                "--checkpoint-dir", os.path.join(d, "killed"),
                "--out", os.path.join(d, "killed.npz")],
               REPRO_FAULT_KILL="1:2", REPRO_OBS_DIR=sink)
        killed_s = time.perf_counter() - t0
        killed, _ = load_records(os.path.join(d, "killed.npz"))
        events = [json.loads(line) for p in Path(sink).glob("*.jsonl")
                  for line in p.read_text().splitlines()]
        t0 = time.perf_counter()
        clean_dir = os.path.join(d, "clean")
        for rank in range(2):  # the same shards, clean, one after the other
            resilient_shard(rank, 2, RESILIENT_ROUNDS, clean_dir, 2, dev)
        clean = merge_shards(resilient_spec(RESILIENT_ROUNDS),
                             [os.path.join(clean_dir, f"shard-r{r}.npz") for r in range(2)])
        clean_s = time.perf_counter() - t0
    bitwise = killed.axes == clean.axes and all(
        np.array_equal(getattr(killed, f), getattr(clean, f))
        for f in _RECORD_FIELDS + ("eval_rounds",))
    names = collections.Counter(e["name"] for e in events)
    counted = {k: names[k] for k in ("resilience.fault_kill", "supervisor.restart",
                                     "resilience.resume")}
    spans = collections.defaultdict(list)  # a worker's first and last event, from the launch
    for e in events:
        spans[e["pid"]].append(e["ts"] - wall0)
    emit("mesh", run="resilient", bitwise=bitwise, events=counted, killed_seconds=killed_s,
         clean_in_process_seconds=clean_s,
         worker_event_seconds=sorted([min(v), max(v)] for v in spans.values()))
    if not bitwise or set(counted.values()) != {1}:
        raise AssertionError(f"mesh resilient: bitwise {bitwise}, events {counted}")
    emit("mesh", run="launches", launches=launches)
    return launches


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


def visible_pairs(sq, sk, causal) -> int:
    """The (query, key) pairs one head of a call at q_offset 0 sees: sq·sk
    non-causal; causal, query i sees keys 0..min(i, sk - 1)."""
    if not causal:
        return sq * sk
    full = min(sq, sk)  # queries 0..full-1 see i + 1 keys, the rest all sk
    return full * (full + 1) // 2 + (sq - full) * sk


def attention_flops(b, sq, sk, h, dh, causal) -> int:
    """The useful flops of one call: 4·dh for each of the b·h visible
    (query, key) pairs of every head (q·k and p·v)."""
    return 4 * dh * b * h * visible_pairs(sq, sk, causal)


def attention_bound(b, sq, sk, h, kv, dh, causal, itemsize) -> tuple[float, str]:
    """The least time for one call: q, k, v read once and the output written
    once; its useful flops at the bf16 dense rate."""
    nbytes = itemsize * (2 * b * sq * h * dh + 2 * b * sk * kv * dh)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = attention_flops(b, sq, sk, h, dh, causal) / BF16_FLOPS
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
    for name, (b, sq, sk, h, kv, dh, causal) in ATTN_TIME_SHAPES.items():
        q, k, v = attention_inputs(b, sq, sk, h, kv, dh, torch.bfloat16, dev, seed=7)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # (b, heads, s, dh)
        bound_ms, bound_by = attention_bound(b, sq, sk, h, kv, dh, causal, 2)
        out[name] = {
            "shape": [b, sq, sk, h, kv, dh], "dtype": "bfloat16", "causal": causal,
            "ms": time_ms(lambda: kernel.flash_attention(q, k, v, causal=causal), flush),
            "plain_ms": (time_ms(lambda: ref(q, k, v, causal=causal), flush)
                         if sq <= 2048 else None),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), flush),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        out[name]["ms_over_bound"] = out[name]["ms"] / bound_ms
        out[name]["ms_over_library"] = out[name]["ms"] / out[name]["library_ms"]
        out[name]["tflops"] = (attention_flops(b, sq, sk, h, dh, causal)
                               / (out[name]["ms"] * 1e9))
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
    from repro_torch.launch.distributed import kernel_counters as counters

    return counters()


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in kernel_counters().items()}


def zero_counts() -> None:
    for mod, attr in kernel_counters().values():
        setattr(mod, attr, 0)


# what the names of the serving kernels hold in the profiler (one call of
# ssd_scan runs three kernels in bf16), and each family's lm.* ranges besides
# lm.logits
TRACED_NAMES = {"flash_attention": "flash_fwd_kernel_bf16", "ssd_scan": "ssd_fwd_"}
LM_RANGES = {"dense": ("lm.attention", "lm.mlp"), "vlm": ("lm.attention", "lm.mlp"),
             "ssm": ("lm.mamba",), "hybrid": ("lm.attention", "lm.mlp", "lm.mamba"),
             "moe": ("lm.attention", "lm.moe"),
             "encdec": ("lm.attention", "lm.cross_attention", "lm.mlp")}


def prefill_launches(cfg) -> dict:
    """The launches of one prefill of ``cfg``, by kernel: flash once an
    attention layer (a hybrid: once a shared-block invocation; an enc-dec
    model: once an encoder layer and twice a decoder layer, its self- and
    cross-attention), SSD once a Mamba2 layer, no other."""
    from repro_torch.models.cache import n_shared_invocations

    n = {name: 0 for name in kernel_counters()}
    if cfg.arch_type in ("dense", "vlm", "moe"):
        n["flash_attention"] = cfg.n_layers
    if cfg.arch_type in ("ssm", "hybrid"):
        n["ssd_scan"] = cfg.n_layers
    if cfg.arch_type == "hybrid":
        n["flash_attention"] = n_shared_invocations(cfg)
    if cfg.arch_type == "encdec":
        n["flash_attention"] = cfg.encdec.n_enc_layers + 2 * cfg.n_layers
    return n


def decode_launches(cfg) -> dict:
    """The launches of one decode step of ``cfg``, by kernel: an enc-dec
    model's cross-attention once a decoder layer (one query against the
    cached frames); no other family launches any."""
    n = {name: 0 for name in kernel_counters()}
    if cfg.arch_type == "encdec":
        n["flash_attention"] = cfg.n_layers
    return n


def serve_prompt(cfg, batch_size: int, n_tokens: int, n_extra: int, seed: int):
    """A seeded prompt of ``n_tokens`` tokens and, for a VLM, ``n_extra``
    patch embeddings or, for an enc-dec model, ``n_extra`` frame
    embeddings (standard normal, as the stub frontends give them) → (batch
    dict on the CPU, the positions the prompt takes in the KV cache: a
    VLM's patches and tokens, an enc-dec decoder's tokens)."""
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (batch_size, n_tokens), generator=gen)}
    if cfg.arch_type == "vlm":
        batch["embeds"] = torch.randn(batch_size, n_extra, cfg.d_model, generator=gen)
        return batch, n_extra + n_tokens
    if cfg.arch_type == "encdec":
        batch["frames"] = torch.randn(batch_size, n_extra, cfg.d_model, generator=gen)
    return batch, n_tokens


def cache_fields(cache, prefix: str = "") -> dict:
    """The float tensors of a cache by field name (a hybrid's as
    ``ssm.state``, ``attn.k``, …)."""
    out = {}
    for name in cache._fields:
        value = getattr(cache, name)
        if isinstance(value, tuple):
            out.update(cache_fields(value, f"{prefix}{name}."))
        elif value.is_floating_point():
            out[prefix + name] = value
    return out


def serve_setup(dev, arch):
    """``arch`` at full width (and its depth but SERVE_LAYERS's cut): its
    config, a server of the serving shape on the card in bf16, the port's
    ``init_model`` weights cast once, a seeded prompt (SERVE_BATCH ×
    SERVE_PROMPT positions: tokens, or a VLM's patches then tokens; an
    enc-dec model's ENCDEC_PROMPT tokens and its config's frames), the
    positions it takes and the peak memory of the fp32 init and its cast."""
    from repro_torch import configs
    from repro_torch.launch.serve import Server
    from repro_torch.models import api
    from repro_torch.models.config import InputShape

    cfg = configs.cut_depth(configs.get_config(arch), SERVE_LAYERS.get(arch))
    if cfg.arch_type == "encdec":
        batch, n_pos = serve_prompt(cfg, SERVE_BATCH, ENCDEC_PROMPT, cfg.encdec.n_enc_frames, 1)
    elif cfg.arch_type == "vlm":
        batch, n_pos = serve_prompt(cfg, SERVE_BATCH, SERVE_PROMPT - cfg.vlm.n_patches,
                                    cfg.vlm.n_patches, 1)
    else:
        batch, n_pos = serve_prompt(cfg, SERVE_BATCH, SERVE_PROMPT, 0, 1)
    shape = InputShape("serve", seq_len=n_pos + SERVE_NEW, global_batch=SERVE_BATCH,
                       kind="decode")
    server = Server(cfg, shape)  # the card, bf16: the defaults a user gets
    torch.cuda.reset_peak_memory_stats(dev)
    params = server.load_params(api.model_init(cfg, seed=0))
    return cfg, server, params, batch, n_pos, torch.cuda.max_memory_allocated(dev)


def arch_fields(cfg) -> dict:
    out = {}
    if cfg.ssm is not None:
        s = cfg.ssm
        out["ssm"] = {"d_state": s.d_state, "heads": s.n_heads(cfg.d_model),
                      "head_dim": s.head_dim, "conv": s.conv_kernel, "chunk": s.chunk_size}
    if cfg.arch_type != "ssm":
        out["heads"] = [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim]
    if cfg.hybrid is not None:
        from repro_torch.models.cache import n_shared_invocations

        out["shared_block"] = {"attn_every": cfg.hybrid.attn_every, "d_ff": cfg.d_ff,
                               "invocations": n_shared_invocations(cfg)}
    if cfg.moe is not None:
        m = cfg.moe
        out["moe"] = {"experts": m.n_experts, "top_k": m.top_k, "d_ff_expert": m.d_ff_expert,
                      "shared_experts": m.n_shared_experts, "capacity_factor": m.capacity_factor}
    if cfg.encdec is not None:
        out["encoder"] = {"layers": cfg.encdec.n_enc_layers, "frames": cfg.encdec.n_enc_frames}
    if cfg.vlm is not None:
        out["patches"] = cfg.vlm.n_patches
    return out


def serve_path(dev, setup, phase) -> dict:
    """Prefill, pad the cache (an SSM state stays as it is), decode
    greedily from the position after the prompt's; the counts are zeroed
    just before and read just after the prefill and after the decode: the
    prefill's launches are :func:`prefill_launches`, each decode step's
    :func:`decode_launches`."""
    from repro_torch.flatten_util import tree_leaves
    from repro_torch.models.cache import cache_leaves, pad_cache

    cfg, server, params, batch, n_pos, setup_peak = setup
    total = n_pos + SERVE_NEW
    first, _, cache = server.prefill(params, batch)  # warm-up: cuBLAS's choices, the allocator
    server.decode(params, first, pad_cache(cache, total), n_pos, 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()  # zeroed just before
    t0 = time.perf_counter()
    first, logits, cache = server.prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    prefill_launches_read = read_counts()
    cache = pad_cache(cache, total)
    t0 = time.perf_counter()
    toks, cache = server.decode(params, first, cache, n_pos, SERVE_NEW)
    toks = toks.cpu()
    t_decode = time.perf_counter() - t0
    launches = read_counts()  # read just after
    steps = SERVE_NEW - 1
    expect = prefill_launches(cfg)
    per_step = decode_launches(cfg)
    expect_all = {k: n + steps * per_step[k] for k, n in expect.items()}
    ok = (prefill_launches_read == expect and launches == expect_all
          and logits.shape == (SERVE_BATCH, 1, cfg.vocab_padded)
          and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
          and toks.shape == (SERVE_BATCH, SERVE_NEW) and int(toks.max()) < cfg.vocab_size
          and all(bool(torch.isfinite(c).all()) for c in cache_fields(cache).values()))
    if cfg.arch_type != "ssm":  # every slot written once, the last one empty
        pos = torch.cat([torch.arange(total - 1), torch.tensor([-1])]).to(torch.int32)
        kv = (cache.attn if cfg.arch_type == "hybrid"
              else cache.self_attn if cfg.arch_type == "encdec" else cache)
        ok = ok and torch.equal(kv.pos.cpu(), pos)
    n_params = sum(p.numel() for p in tree_leaves(params))
    extra = {}
    if "frames" in batch:
        extra["prefill_frames_per_s"] = batch["frames"][..., 0].numel() / t_prefill
    emit(phase, arch=cfg.name, d_model=cfg.d_model, n_layers=cfg.n_layers, **arch_fields(cfg),
         vocab_padded=cfg.vocab_padded, dtype="bfloat16", batch=SERVE_BATCH,
         prompt=batch["tokens"].shape[1], prompt_positions=n_pos, new_tokens=SERVE_NEW,
         params=n_params, param_count_of_config=cfg.param_count(),
         param_bytes=sum(p.numel() * p.element_size() for p in tree_leaves(params)),
         cache_bytes=sum(c.numel() * c.element_size() for c in cache_leaves(cache)),
         prefill_s=t_prefill, prefill_tokens_per_s=SERVE_BATCH * n_pos / t_prefill, **extra,
         decode_s=t_decode, decode_steps=steps, decode_ms_per_step=1e3 * t_decode / steps,
         decode_tokens_per_s=SERVE_BATCH * steps / t_decode,
         launches=launches, prefill_launches=prefill_launches_read,
         decode_launches_per_step=per_step,
         max_memory_allocated=torch.cuda.max_memory_allocated(dev),
         setup_max_memory_allocated=setup_peak, tokens_row_0=toks[0].tolist())
    if not ok:
        raise AssertionError(f"{phase}: launches {launches} (prefill {prefill_launches_read}, "
                             f"expected {expect_all}, prefill {expect}), logits "
                             f"{tuple(logits.shape)}, tokens {tuple(toks.shape)}, a cache "
                             f"position, or a non-finite cache")
    return launches


def serve_no_sync(dev, setup, phase) -> None:
    """A prefill and 4 decode steps at the serving shape with every
    device→host sync made an error."""
    from repro_torch.models.cache import pad_cache

    cfg, server, params, batch, n_pos, _ = setup
    on_card = {k: v.to(dev) for k, v in batch.items()}  # a copy from pageable memory syncs
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first, _, cache = server.prefill(params, on_card)
        server.decode(params, first, pad_cache(cache, n_pos + 4), n_pos, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    emit(phase, arch=cfg.name, prefills=1, decode_steps=4, sync_debug_mode="error")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


def mamba2_dt_bias(params, cfg, seed=0):
    """``params`` with every layer's dt_bias drawn as Mamba2 initialises it
    in place of the reference's zeros (``models.api.mamba2_dt_init``)."""
    from repro_torch.models.api import mamba2_dt_init

    return mamba2_dt_init(params, cfg, seed)


def moe_decisions(cpu_routes, card_routes) -> list:
    """Each MoE layer's prefill routing (``layers.moe_route``) on the card
    against the CPU's: the experts equal at every token whose k + 1 largest
    CPU probabilities are more than MOE_TIE apart; positions and drops
    equal at every (slot, token) whose expert no token with other experts
    chose in its group (a changed choice moves later positions in the
    experts it touches). → per layer counts (:func:`moe_decision_counts`);
    raises on any other difference."""
    out = moe_decision_counts(cpu_routes, card_routes)
    if any(r["experts_differ_past_a_tie"] or r["held_positions_or_drops_differ"] for r in out):
        raise AssertionError(f"MoE routing: card and CPU decide differently: {out}")
    return out


def moe_decision_counts(cpu_routes, card_routes) -> list:
    """:func:`moe_decisions`' counts a layer, ``cpu_routes`` the side whose
    probabilities define the ties; raises on nothing."""
    out = []
    for c, g in zip(cpu_routes, card_routes, strict=True):
        g = type(g)(*(x.cpu() if isinstance(x, torch.Tensor) else x for x in g))
        n_groups, gs, k = c.gate_idx.shape
        top = c.probs.sort(dim=-1, descending=True).values[..., :k + 1]
        tie = ((top[..., :-1] - top[..., 1:]) <= MOE_TIE).any(-1)  # (G, gs)
        differ = (c.gate_idx != g.gate_idx).any(-1)                # (G, gs)
        touched = torch.zeros((n_groups, c.probs.shape[-1]), dtype=torch.bool)
        for side in (c, g):
            for grp in range(n_groups):
                touched[grp, side.gate_idx[grp][differ[grp]].flatten()] = True
        held = ~touched.gather(1, c.gate_idx.transpose(1, 2).reshape(n_groups, -1))
        held = held.reshape(n_groups, k, gs)
        moved = held & ((c.pos != g.pos) | (c.within != g.within))
        out.append({"tokens": n_groups * gs, "groups": n_groups, "capacity": c.cap,
                    "near_ties": int(tie.sum()), "experts_differ": int(differ.sum()),
                    "experts_differ_past_a_tie": int((differ & ~tie).sum()),
                    "held_slots": int(held.sum()), "dropped_cpu": int((~c.within).sum()),
                    "dropped_card": int((~g.within).sum()),
                    "held_positions_or_drops_differ": int(moved.sum())})
    return out


def serve_parity(dev, arch, batch_size, prompt, phase, layers=None, n_extra=0) -> None:
    """``layers`` layers of ``arch`` (all by default; an enc-dec model's
    encoder too) at full width in fp32 (TF32 off), card against the port's
    CPU path on one set of weights (drawn on the card, copied to the CPU)
    and a prompt of ``prompt`` tokens (and ``n_extra`` patches or frames,
    :func:`serve_prompt`): the prefill's last-position logits and every
    float field of the cache (k and v; the SSM state and conv window; a
    hybrid's both; an enc-dec model's cross k and v), then PARITY_NEW decode
    steps from the position after the prompt's, both sides fed the CPU's
    greedy token, so a near-tie cannot send them down different paths. A
    model with Mamba2 layers takes Mamba2's dt_bias
    (:func:`mamba2_dt_bias`): at the reference's zeros the fp32 model itself
    drifts (``ssm_depth_drift``). A moe model's prefill routing
    (``layers.recorded_routes``) is held by :func:`moe_decisions`."""
    from repro_torch import configs
    from repro_torch.flatten_util import tree_map
    from repro_torch.launch.serve import Server
    from repro_torch.models import api
    from repro_torch.models import layers as lm_layers
    from repro_torch.models.cache import pad_cache
    from repro_torch.models.config import InputShape

    cfg = configs.cut_depth(configs.get_config(arch), layers)
    batch, n_pos = serve_prompt(cfg, batch_size, prompt, n_extra, 3)
    total = n_pos + PARITY_NEW
    shape = InputShape("parity", seq_len=total, global_batch=batch_size, kind="decode")
    params = tree_map(lambda x: x.cpu(), api.model_init(cfg, seed=2, device=dev))
    if cfg.ssm is not None:
        params = mamba2_dt_bias(params, cfg)
    out, seconds, routes = {}, {}, {}
    for where in ("cpu", dev):
        server = Server(cfg, shape, where, dtype=torch.float32)
        p = params if where == "cpu" else tree_map(lambda x: x.to(dev), params)
        t0 = time.perf_counter()
        with lm_layers.recorded_routes() as routes[str(where)]:
            first, logits, cache = server.prefill(p, batch)
        out[str(where)] = (p, first.cpu(), logits.cpu(), pad_cache(cache, total))
        seconds[str(where)] = time.perf_counter() - t0
    (p_c, first_c, l_c, cache_c), (p_g, first_g, l_g, cache_g) = out["cpu"], out[str(dev)]
    vocab = cfg.vocab_size  # the pad columns (-1e30 on both sides) would swamp the norm
    fields_c, fields_g = cache_fields(cache_c), cache_fields(cache_g)
    errs = {"prefill_logits": rel_l2(l_g[..., :vocab], l_c[..., :vocab]),
            **{f"cache_{f}": rel_l2(fields_g[f], fields_c[f]) for f in fields_c}}
    decisions = (moe_decisions(routes["cpu"], routes[str(dev)]) if cfg.arch_type == "moe"
                 else None)

    def margin(logits):  # the CPU's top-2 margin and its threshold
        top2 = logits[:, -1, :cfg.vocab_size].double().topk(2, dim=-1).values
        return (top2[:, 0] - top2[:, 1]).min().item(), ROUND_TOL * top2.abs().max().item()

    steps = [{"margin": margin(l_c)[0], "tokens_equal": torch.equal(first_g, first_c)}]
    checked = [margin(l_c)[0] <= margin(l_c)[1] or steps[0]["tokens_equal"]]
    tok = first_c
    step_errs = []
    for i in range(PARITY_NEW):
        l_c, cache_c = api.model_decode(p_c, cfg, tok, cache_c, n_pos + i)
        l_g, cache_g = api.model_decode(p_g, cfg, tok.to(dev), cache_g, n_pos + i)
        l_g = l_g.cpu()
        step_errs.append(rel_l2(l_g[..., :vocab], l_c[..., :vocab]))
        m, threshold = margin(l_c)
        tok = l_c[:, -1].argmax(dim=-1, keepdim=True)
        equal = torch.equal(l_g[:, -1].argmax(dim=-1, keepdim=True), tok)
        steps.append({"margin": m, "tokens_equal": equal})
        checked.append(m <= threshold or equal)
    errs["decode_logits_max"] = max(step_errs)
    fields_c, fields_g = cache_fields(cache_c), cache_fields(cache_g)
    for f in fields_c:
        errs[f"cache_{f}_after_decode"] = rel_l2(fields_g[f], fields_c[f])
    emit(phase, arch=arch, n_layers=cfg.n_layers, **arch_fields(cfg), dtype="float32",
         batch=batch_size, prompt=prompt, prompt_positions=n_pos,
         **{k: tuple(v.shape) for k, v in batch.items() if k != "tokens"},
         decode_steps=PARITY_NEW, rel_l2_err=errs, tolerance=ROUND_TOL,
         decode_logits_rel_l2_err=step_errs, steps=steps,
         min_margin=min(s["margin"] for s in steps), prefill_seconds=seconds,
         **({} if decisions is None else {"moe_decisions": decisions, "tie": MOE_TIE}))
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
    ``serve.*`` range and per ``lm.*`` range inside it, and each prefill
    kernel's share of the prefill's device time (``kernels``; every
    ``ssd_fwd_*`` kernel counts toward ``ssd_scan``)."""
    from repro_torch.models.cache import pad_cache

    cfg, server, params, batch, n_pos, _ = setup
    n_stages = 2 + len(LM_RANGES[cfg.arch_type])  # serve.*, its lm.* ranges, lm.logits
    holder = {}

    def prefill():
        holder["first"], _, cache = server.prefill(params, batch)
        holder["cache"] = pad_cache(cache, n_pos + BREAKDOWN_STEPS)

    def decode():  # rewrites the same slots (or the state) from the same start each time
        server.decode(params, holder["first"], holder["cache"], n_pos, BREAKDOWN_STEPS + 1)

    out = {}
    for name, drive in (("prefill", prefill), ("decode", decode)):
        out[name] = profile_ranges(drive, 1, ("serve.", "lm."), n_stages, f"serve.{name}")
    for name, launched in (("prefill", prefill_launches(cfg)),
                           ("decode", {k: n * BREAKDOWN_STEPS
                                       for k, n in decode_launches(cfg).items()})):
        part = out[name]
        part["kernels"] = {}
        for kname, n in launched.items():
            if not n:
                continue
            by_name = {k: ms for k, ms in part["kernels_ms_by_name"].items()
                       if TRACED_NAMES[kname] in k}
            ms = sum(by_name.values())
            part["kernels"][kname] = {"launches": n, "ms": ms, "ms_by_name": by_name,
                                      "share_of_device_kernel_ms": ms / part["device_kernel_ms"]}
            if ms <= 0.0:
                raise AssertionError(f"{phase}: the profiler saw no {kname} kernel in the {name}")
        part["kernel_ms"] = sum(k["ms"] for k in part["kernels"].values())
        part["kernel_share_of_device_kernel_ms"] = part["kernel_ms"] / part["device_kernel_ms"]
    emit(phase, arch=cfg.name, batch=SERVE_BATCH, prompt=batch["tokens"].shape[1],
         prompt_positions=n_pos, decode_steps=BREAKDOWN_STEPS, **out)


def serving(dev, arch, prefix, parity_batch, parity_prompt, parity_layers=None,
            parity_extra=0) -> dict:
    """The serving phases of one architecture: ``<prefix>``, ``_no_sync``,
    ``_breakdown`` at the serving shape, then ``_parity`` (at
    ``parity_layers`` layers, all by default, with ``parity_extra`` patches
    or frames); → the main path's launch counts."""
    setup = serve_setup(dev, arch)
    launches = serve_path(dev, setup, prefix)
    serve_no_sync(dev, setup, f"{prefix}_no_sync")
    serve_breakdown(dev, setup, f"{prefix}_breakdown")
    del setup
    torch.cuda.empty_cache()
    serve_parity(dev, arch, parity_batch, parity_prompt, f"{prefix}_parity", parity_layers,
                 parity_extra)
    if arch == SSM_ARCH:
        ssm_depth_drift(dev, parity_batch, parity_prompt)
    return launches


# -- the LM training path -----------------------------------------------------

TRAIN_ARCH, SSM_TRAIN_ARCH = "qwen2-0.5b", "mamba2-370m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_FL, TRAIN_SCHEDULED = 8, 2048, 8, 4
TRAIN_ROUNDS, TRAIN_PROBES, TRAIN_NOISE = 12, 2, 1e-10
# (layers, batch, tokens, FL devices) of the card-vs-CPU round, at full width
TRAIN_PARITY = {TRAIN_ARCH: (2, 4, 128, 4), SSM_TRAIN_ARCH: (2, 4, 256, 4)}
# the Functions' backward and jvp against autograd and ``torch.func.jvp`` of
# the plain version on the same inputs, and their primal against the plain
# version: relative L2 error of each output. In bf16 the backward sums dk
# and dv over two query chunks, each rounded to bf16 first (twice the
# plain version's one rounding)
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}


def function_rules(name, fn, plain, inputs, cotangent, tangents) -> dict:
    """One Function's primal, backward and jvp against the plain version's
    on the same inputs → relative L2 errors (each gradient, the tangent)."""
    dtype = inputs[0].dtype
    ins = [x.detach().clone().requires_grad_() for x in inputs]
    out = fn(*ins)
    if out.grad_fn is None:
        raise AssertionError(f"{name}: the kernel's output has no grad_fn")
    got = torch.autograd.grad(out, ins, cotangent)
    ref_ins = [x.detach().clone().requires_grad_() for x in inputs]
    ref_out = plain(*ref_ins)
    want = torch.autograd.grad(ref_out, ref_ins, cotangent)
    primal_t, tangent = torch.func.jvp(fn, tuple(inputs), tangents)
    ref_primal_t, ref_tangent = torch.func.jvp(plain, tuple(inputs), tangents)
    errs = {"primal": rel_l2(out.detach(), ref_out.detach()),
            "primal_under_jvp": rel_l2(primal_t, ref_primal_t),
            **{f"grad_{i}": rel_l2(g, w) for i, (g, w) in enumerate(zip(got, want))},
            "tangent": rel_l2(tangent, ref_tangent)}
    finite = all(bool(torch.isfinite(x).all()) for x in (*got, tangent))
    if not finite or max(errs.values()) > GRAD_TOL[dtype]:
        raise AssertionError(f"{name} {dtype}: rules disagree with the plain version: {errs}")
    return errs


def train_step_grads(dev, arch) -> dict:
    """One full-width train step of ``arch`` (bf16, remat, batch TRAIN_BATCH
    × TRAIN_SEQ over TRAIN_FL FL devices, no noise) through
    ``build_train_step``, the gradients seen by the optimizer: every leaf
    finite and non-zero, so no kernel's output cut the graph."""
    from repro_torch import configs
    from repro_torch.flatten_util import tree_leaves
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import api
    from repro_torch.models.config import InputShape
    from repro_torch.optim.optimizers import Optimizer, sgd

    cfg = configs.get_config(arch)
    seen, base = {}, sgd(0.0)

    def update(grads, state, params):
        seen["grads"] = grads
        return base.update(grads, state, params)

    shape = InputShape("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    bundle = build_train_step(cfg, shape, make_host_mesh(1, TRAIN_FL), Optimizer(base.init, update),
                              aircomp_noise=False)
    params = api.model_init(cfg, seed=3)
    if cfg.ssm is not None:
        params = mamba2_dt_bias(params, cfg)
        params["layers"]["mamba"]["dt_bias"] = params["layers"]["mamba"]["dt_bias"].to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), generator=gen,
                                     device=dev)}
    coeffs = torch.full((TRAIN_FL,), 1.0 / TRAIN_FL, device=dev)
    t0 = time.perf_counter()
    _, _, loss = bundle.fn(params, base.init(params), batch, coeffs,
                           torch.zeros((), device=dev), None)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    leaves = tree_leaves(seen["grads"])
    norms = [torch.linalg.vector_norm(g.float()).item() for g in leaves]
    bad = [i for i, (g, n) in enumerate(zip(leaves, norms))
           if g.dtype != torch.float32 or not math.isfinite(n) or n == 0.0]
    if bad or not math.isfinite(loss.item()):
        raise AssertionError(f"{arch}: {len(bad)} gradient leaves zero, non-finite or not "
                             f"fp32 (leaf indices {bad}), loss {loss.item()}")
    return {"leaves": len(leaves), "min_grad_norm": min(norms), "loss": loss.item(),
            "seconds": seconds}


def train_grads(dev) -> dict:
    """Phase ``train_grads``: the flash and SSD kernels' autograd Functions
    at the training shapes (qwen2-0.5b's attention, mamba2-370m's SSD scan
    at its serving shape) in bf16 and fp32, against the plain version; then
    one full-width train step of each model, every gradient leaf finite and
    non-zero. Counts zeroed just before the train steps and read just after
    (the Functions' checks are comparisons and do not count)."""
    from repro_torch.kernels.attention.autograd import FlashAttention
    from repro_torch.kernels.attention.cases import attention_inputs
    from repro_torch.kernels.attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd.autograd import SSDScan
    from repro_torch.kernels.ssd.cases import ssd_inputs
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    b, sq, sk, h, kv, dh, causal = ATTN_TIME_SHAPES["prefill_2k"]
    sb, ss, sh, sp, sn, chunk = SSD_TIME_SHAPES["prefill_2k"]
    rules = {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(11)
        q, k, v = attention_inputs(b, sq, sk, h, kv, dh, dtype, dev, seed=3)
        rules[f"flash_attention_{dtype}"] = function_rules(
            "flash_attention", lambda q, k, v: FlashAttention.apply(q, k, v, causal, None, 0),
            lambda q, k, v: flash_attention_ref(q, k, v, causal=causal), (q, k, v),
            torch.randn(q.shape, generator=gen, device=dev, dtype=dtype),
            tuple(torch.randn(x.shape, generator=gen, device=dev, dtype=dtype)
                  for x in (q, k, v)))
        del q, k, v
        xdt, la, B, C = ssd_inputs(sb, ss, sh, sp, sn, dtype, dev, seed=3)
        rules[f"ssd_scan_{dtype}"] = function_rules(
            "ssd_scan", lambda *a: SSDScan.apply(*a, chunk),
            lambda *a: ssd_chunked_ref(*a, chunk), (xdt, la, B, C),
            torch.randn(xdt.shape, generator=gen, device=dev, dtype=dtype),
            tuple(torch.randn(x.shape, generator=gen, device=dev, dtype=x.dtype)
                  for x in (xdt, la, B, C)))
        del xdt, la, B, C
        torch.cuda.empty_cache()
    zero_counts()
    steps = {arch: train_step_grads(dev, arch) for arch in (TRAIN_ARCH, SSM_TRAIN_ARCH)}
    launched = read_counts()
    torch.cuda.empty_cache()
    emit("train_grads", tolerance={str(k): v for k, v in GRAD_TOL.items()},
         attention_shape=[b, sq, sk, h, kv, dh], ssd_shape=[sb, ss, sh, sp, sn, chunk],
         rel_l2_err=rules, full_width_step=steps, launches=launched)
    return launched


def train_parity(dev) -> dict:
    """Phase ``train_parity``: one ``POFLTrainer`` round of each of
    TRAIN_PARITY (full width, cut depth, fp32, sketch mode with 2 probes,
    ``sgd``) on the card against the same round on the CPU, from one set of
    weights (drawn on the card, copied to the CPU; Mamba2's dt init) and
    one set of draws (probes, h, Gumbel vectors, noise: drawn once on the
    CPU, handed to both): the stats, coeffs, noise_amp, e_com, a, the loss
    and the gradients the optimizer sees within ROUND_TOL (relative; the
    gradients and the update by relative L2), n_scheduled equal. Counts
    zeroed just before the card's rounds and read just after."""
    from repro_torch import configs
    from repro_torch.core.channel import ChannelState
    from repro_torch.flatten_util import ravel_pytree, tree_map
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import POFLTrainer, TrainerConfig, TrainerDraws
    from repro_torch.models import api
    from repro_torch.models.config import InputShape
    from repro_torch.optim.optimizers import Optimizer, sgd

    out, launched = {}, {name: 0 for name in kernel_counters()}
    for arch, (layers, batch_size, seq, n_fl) in TRAIN_PARITY.items():
        cfg = configs.cut_depth(configs.get_config(arch), layers)
        params = tree_map(lambda x: x.cpu(), api.model_init(cfg, seed=4, device=dev))
        if cfg.ssm is not None:
            params = mamba2_dt_bias(params, cfg)
        gen = torch.Generator().manual_seed(6)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (batch_size, seq), generator=gen)}
        tcfg = TrainerConfig(n_scheduled=2, noise_power=TRAIN_NOISE, n_probes=TRAIN_PROBES,
                             dtype="float32", seed=1)
        shape = InputShape("parity", seq, batch_size, "train")
        cpu_draws = TrainerDraws(gen)
        given = {"probes": cpu_draws.probes(params, TRAIN_PROBES),
                 "gumbels": cpu_draws.gumbels(tcfg.n_scheduled, n_fl),
                 "noise": tree_map(lambda x: torch.randn(x.shape, generator=gen), params)}
        rounds = {}
        for where in ("cpu", dev):
            seen, base = {}, sgd(0.05)

            def update(grads, state, p, _seen=seen, _base=base):
                _seen["grads"] = grads
                return _base.update(grads, state, p)

            trainer = POFLTrainer(cfg, shape, make_host_mesh(1, n_fl, where), tcfg,
                                  optimizer=Optimizer(base.init, update))
            if where == "cpu":
                gains, h = trainer.channel.gains, trainer.draws.channel(trainer.channel)
            trainer.channel = ChannelState(trainer.channel.cfg, gains.to(where))
            trainer.draws = GivenDraws({**given, "h": h}, where)
            stats_fn, step_fn = trainer.stats_bundle.fn, trainer.train_bundle.fn

            def stats(*a, _seen=seen, _fn=stats_fn):
                _seen["stats"] = _fn(*a)
                return _seen["stats"]

            def step(*a, _seen=seen, _fn=step_fn):
                _seen["coeffs"], _seen["noise_amp"] = a[3], a[4]
                return _fn(*a)

            trainer.stats_bundle = trainer.stats_bundle._replace(fn=stats)
            trainer.train_bundle = trainer.train_bundle._replace(fn=step)
            p = tree_map(lambda x: x.to(where), params)
            if where != "cpu":
                zero_counts()
            t0 = time.perf_counter()
            new_p, _, diag = trainer.train_round(p, trainer.optimizer.init(p),
                                                 {"tokens": batch["tokens"].to(where)})
            if where != "cpu":
                torch.cuda.synchronize()
                for name, n in read_counts().items():
                    launched[name] += n
            seconds = time.perf_counter() - t0
            rounds[str(where)] = {
                "seconds": seconds, "diag": {k: v.cpu() for k, v in diag.items()},
                "stats": [x.cpu() for x in seen["stats"]],
                "coeffs": seen["coeffs"].cpu(), "noise_amp": seen["noise_amp"].cpu(),
                "grads": ravel_pytree(tree_map(lambda x: x.cpu(), seen["grads"]))[0],
                "update": (ravel_pytree(tree_map(lambda x: x.cpu(), new_p))[0]
                           - ravel_pytree(params)[0])}
            del trainer, new_p, p
        c, g = rounds["cpu"], rounds[str(dev)]

        def rel(a, b):
            return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

        errs = {**{f"stats_{f}": rel(x, y) for f, x, y in zip(("mean", "var", "norm"),
                                                              g["stats"], c["stats"])},
                "coeffs": rel(g["coeffs"], c["coeffs"]),
                "noise_amp": rel(g["noise_amp"], c["noise_amp"]),
                **{k: rel(g["diag"][k], c["diag"][k]) for k in ("e_com", "a", "loss")},
                "grads_rel_l2": rel_l2(g["grads"], c["grads"]),
                "update_rel_l2": rel_l2(g["update"], c["update"])}
        same = float(g["diag"]["n_scheduled"]) == float(c["diag"]["n_scheduled"])
        out[arch] = {"n_layers": layers, "batch": batch_size, "tokens": seq, "n_fl": n_fl,
                     "rel_err": errs, "n_scheduled": float(c["diag"]["n_scheduled"]),
                     "seconds": {k: v["seconds"] for k, v in rounds.items()}}
        if max(errs.values()) > ROUND_TOL or not same:
            raise AssertionError(f"train_parity {arch}: card and CPU disagree: {errs}, "
                                 f"n_scheduled equal {same}")
        del rounds
        torch.cuda.empty_cache()
    emit("train_parity", tolerance=ROUND_TOL, dtype="float32", launches=launched, **out)
    return launched


class GivenDraws:
    """A trainer's draws handed in: the probes, h, the Gumbel vectors and
    the noise leaves of ``given``, moved to ``device``."""

    def __init__(self, given: dict, device):
        from repro_torch.flatten_util import tree_map

        self.given = {k: (v.to(device) if isinstance(v, torch.Tensor)
                          else [tree_map(lambda x: x.to(device), p) for p in v]
                          if isinstance(v, list) else tree_map(lambda x: x.to(device), v))
                      for k, v in given.items()}

    def probes(self, params, n_probes):
        return self.given["probes"]

    def channel(self, channel):
        return self.given["h"]

    def gumbels(self, n_scheduled, n):
        return self.given["gumbels"]

    def noise(self, params):
        return self.given["noise"]


def train_phase(dev) -> dict:
    """Phase ``train``: ``POFLTrainer`` on qwen2-0.5b at full width and
    depth in bf16 through the user's entry points: batch TRAIN_BATCH ×
    TRAIN_SEQ over TRAIN_FL FL devices, TRAIN_SCHEDULED scheduled, policy
    pofl, sketch mode with TRAIN_PROBES probes, σ_z² TRAIN_NOISE,
    ``adamw(cosine_schedule(3e-4, TRAIN_ROUNDS, warmup=2))``, TRAIN_ROUNDS
    rounds on ``make_token_dataset`` batches as the reference's example
    takes them. Counts zeroed just before the rounds and read just after:
    the flash kernel once a layer in each of the 1 + TRAIN_PROBES JVP passes
    and twice a layer in the step (its forward, then remat's recompute).
    Every value finite, and the unweighted loss on a fixed batch lower after
    the rounds than before. Then ``torch.profiler`` over one more round:
    host and device ms of ``train.stats``, ``train.schedule``,
    ``train.step``."""
    from repro_torch import configs
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.flatten_util import tree_leaves
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import POFLTrainer, TrainerConfig
    from repro_torch.models import api
    from repro_torch.models.config import InputShape
    from repro_torch.optim.optimizers import adamw, cosine_schedule

    cfg = configs.base_config(TRAIN_ARCH)
    shape = InputShape("train_8x2048", TRAIN_SEQ, TRAIN_BATCH, "train")
    tcfg = TrainerConfig(policy="pofl", n_scheduled=TRAIN_SCHEDULED, noise_power=TRAIN_NOISE,
                         stats_mode="sketch", n_probes=TRAIN_PROBES)
    trainer = POFLTrainer(cfg, shape, make_host_mesh(model=1, n_devices=TRAIN_FL), tcfg,
                          optimizer=adamw(cosine_schedule(3e-4, TRAIN_ROUNDS, warmup=2)))
    corpus = make_token_dataset(TRAIN_BATCH * 8, TRAIN_SEQ, cfg.vocab_size,
                                torch.Generator(device=dev).manual_seed(0))

    def batch_fn(t):
        idx = torch.arange(TRAIN_BATCH, device=dev) + (t * TRAIN_BATCH) % (TRAIN_BATCH * 7)
        return {"tokens": corpus[idx]}

    def unweighted_loss(params):
        with torch.no_grad():
            return api.model_loss(params, cfg, batch_fn(0), dtype=torch.bfloat16)[0].item()

    torch.cuda.reset_peak_memory_stats(dev)
    params, opt_state = trainer.init_state(1)
    loss_before = unweighted_loss(params)
    rounds = []
    zero_counts()
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for t in range(TRAIN_ROUNDS):
        t0 = time.perf_counter()
        params, opt_state, diag = trainer.train_round(params, opt_state, batch_fn(t))
        torch.cuda.synchronize()
        rounds.append({"ms": (time.perf_counter() - t0) * 1e3,
                       **{k: v.item() for k, v in diag.items() if v.dim() == 0}})
    seconds = time.perf_counter() - t_all
    launched = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    loss_after = unweighted_loss(params)
    finite = (all(math.isfinite(v) for r in rounds for v in r.values())
              and all(bool(torch.isfinite(x).all()) for x in tree_leaves(params)))
    per_round = cfg.n_layers * (1 + TRAIN_PROBES) + 2 * cfg.n_layers
    want = {name: 0 for name in kernel_counters()}
    want["flash_attention"] = TRAIN_ROUNDS * per_round

    state = {"params": params, "opt": opt_state, "t": TRAIN_ROUNDS}

    def drive():
        state["params"], state["opt"], _ = trainer.train_round(state["params"], state["opt"],
                                                                batch_fn(state["t"]))
        state["t"] += 1

    split = profile_ranges(drive, 1, ("train.",), 3, "train.step")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = [r["ms"] for r in rounds[1:]]
    emit("train", arch=TRAIN_ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size, params=sum(x.numel() for x in tree_leaves(params)),
         param_count=cfg.param_count(), dtype="bfloat16", batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, fl_devices=TRAIN_FL, scheduled=TRAIN_SCHEDULED, probes=TRAIN_PROBES,
         noise_power=TRAIN_NOISE, rounds=TRAIN_ROUNDS, seconds=seconds,
         tokens_per_s=tokens * TRAIN_ROUNDS / seconds,
         tokens_per_s_after_round_0=tokens * len(steady) / (sum(steady) / 1e3),
         round_ms=[r["ms"] for r in rounds], e_com=[r["e_com"] for r in rounds],
         n_scheduled=[r["n_scheduled"] for r in rounds],
         weighted_loss=[r["loss"] for r in rounds],
         unweighted_loss_fixed_batch={"before": loss_before, "after": loss_after},
         peak_memory_bytes=peak, launches=launched, expected_launches=want,
         breakdown_one_round=split)
    if not finite or not loss_after < loss_before or launched != want:
        raise AssertionError(f"train: finite {finite}, fixed-batch loss {loss_before} -> "
                             f"{loss_after}, launches {launched} (expected {want})")
    return launched


# -- the LM trainer over ranks ------------------------------------------------

RANKS_ONE_ROUNDS = 2  # (a): the one-rank NCCL mesh against the one-card trainer
# (b), (c): two ranks sharing the card over gloo, against this process's
# one-card trainer: depth, rounds and compute dtype (full width)
RANKS_LAYERS, RANKS_ROUNDS, RANKS_DTYPE = 4, 3, "float32"
RANKS_TIMEOUT = 600  # seconds the launched ranks get
RANKS_MESHES = {"b": (2, 1), "c": (1, 2)}  # (data, model)
# (b) and (c) in bf16, the trainer's setting, at the same depth, and the
# limit (PERF.md §2: bf16 against its reference ≤ 2^-7 relative). One round
# runs every bf16 op of the rank path once from the same parameters; after
# an update each rank's bf16 weight gradients, rounded over half the
# batch (on (c): its split products), put the trajectories a bf16 rounding
# apart, and the sketch amplifies that (ROADMAP C), so the trajectory is
# held in fp32 above
RANKS_BF16_ROUNDS, RANKS_BF16_TOL = 1, 2.0**-7
# the round values held: the schedule, the loss and the sketched statistics
RANKS_FIELDS = ("loss", "e_com", "a", "coeffs", "noise_amp", "grad_mean", "grad_var",
                "grad_norm")
# (d): the MoE over the data ranks: olmoe-1b-7b at full width cut to 1 of its
# 16 layers on the (2, 1) mesh, RANKS_ROUNDS rounds in fp32 and
# RANKS_BF16_ROUNDS in bf16, held as (b) is. Each rank gathers the whole fp32
# masters (2.5 GB; its two probes and the noise are as large) and three
# processes share the card: at 2 layers an fp32 rank ran out of an H100's
# 80 GB in its JVP pass, and there gloo moved the masters at about 0.5 GB/s
# (PERF.md §6, the MoE over data ranks)
RANKS_MOE_ARCH, RANKS_MOE_LAYERS, RANKS_MOE_MESH = "olmoe-1b-7b", 1, (2, 1)
# (e): mamba2-370m at full width cut to RANKS_SSM_LAYERS of its 48 layers on
# the (1, 2) mesh, split by SSM heads over the two model ranks, RANKS_SSM_ROUNDS
# rounds in fp32 and RANKS_BF16_ROUNDS in bf16, held as (c) is (cut in depth
# and rounds to keep the script inside its time limit: PERF.md §6); dt_bias
# drawn as Mamba2 does, as phase train_parity draws it (ROADMAP C)
RANKS_SSM_ARCH, RANKS_SSM_LAYERS, RANKS_SSM_MESH, RANKS_SSM_ROUNDS = SSM_ARCH, 2, (1, 2), 2


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| / max |b| (relative to the reference's scale)."""
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def reckoned_state(cfg, shape, sizes, optimizer) -> dict:
    """The dry run's bytes a rank of masters and optimizer state on a
    (data, model) mesh of ``sizes`` (``launch.dryrun.state_bytes`` of the
    train step on the shape-only mesh)."""
    from repro_torch.launch.dryrun import state_bytes
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.launch.steps import build_train_step

    b = state_bytes(build_train_step(cfg, shape, ShapeMesh(("data", "model"), sizes), optimizer))
    return {"params_bytes": b["params"], "opt_state_bytes": b["opt_state"]}


def reckoned_collectives(cfg, shape, sizes, optimizer, gather: str, n_fl: int,
                         n_rounds: int, dtype: str) -> dict:
    """The dry run's collectives of ``n_rounds`` trainer rounds a rank on a
    (data, model) mesh of ``sizes`` with TRAIN_PROBES probes in ``dtype``
    (``launch.dryrun.rank_collectives``): ``{op: {"calls", "bytes"}}``."""
    from repro_torch.launch.dryrun import rank_collectives
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import DTYPES

    mesh = ShapeMesh(("data", "model"), sizes)
    per_round = rank_collectives(cfg, build_train_step(cfg, shape, mesh, optimizer), mesh,
                                 gather, n_fl, dtype=DTYPES[dtype], n_probes=TRAIN_PROBES)
    return {op: {k: v * n_rounds for k, v in c.items()} for op, c in per_round.items()}


def reckoned_compute_bytes(cfg, sizes) -> int:
    """The dry run's bytes a rank of the fp32 weights its steps
    differentiate on a (data, model) mesh of ``sizes``
    (``launch.dryrun.compute_weight_bytes``: TP blocks where the model
    ranks split a dense model)."""
    from repro_torch.launch.dryrun import compute_weight_bytes
    from repro_torch.launch.mesh import ShapeMesh

    return compute_weight_bytes(cfg, ShapeMesh(("data", "model"), sizes))


def rank_costs(round_ms: list, collectives: dict) -> dict:
    """A rank's rounds and collectives (``launch.distributed.counted_collectives``:
    calls, wire bytes and seconds by op), and the collectives' share of its
    rounds' time, all and by op."""
    total = sum(round_ms)
    seconds = sum(c["seconds"] for c in collectives.values())
    return {"round_ms": round_ms, "collectives": collectives,
            "collective_share": seconds * 1e3 / total,
            "share_by_op": {op: c["seconds"] * 1e3 / total for op, c in collectives.items()}}


def calls_and_bytes(collectives: dict) -> dict:
    """The calls and bytes of a rank's collectives (their seconds left out)."""
    return {op: {"calls": c["calls"], "bytes": c["bytes"]} for op, c in collectives.items()}


def one_rank(dev) -> tuple[dict, int]:
    """(a): ``POFLTrainer`` on a (1, 1) mesh of one NCCL rank (this
    process) against the one-card ``HostMesh`` trainer, on phase ``train``'s
    setting (qwen2-0.5b at full width and depth, bf16, AdamW) and the same
    draws, RANKS_ONE_ROUNDS rounds → (the comparison, the rank run's flash
    launches)."""
    import torch.distributed as dist

    from repro_torch.flatten_util import tree_leaves
    from repro_torch.launch.distributed import (
        counted_collectives, tensor_bytes, train_rounds, train_setup,
    )
    from repro_torch.launch.mesh import make_host_mesh, make_rank_mesh
    from repro_torch.launch.train import POFLTrainer
    from repro_torch.obs.registry import reset_metrics

    cfg, shape, tcfg, opt, batch_fn = train_setup(TRAIN_ARCH, 0, TRAIN_FL, TRAIN_BATCH,
                                                  TRAIN_SEQ, "adamw", "bfloat16",
                                                  TRAIN_ROUNDS, dev)
    trainer = POFLTrainer(cfg, shape, make_host_mesh(1, TRAIN_FL, dev), tcfg, optimizer=opt)
    want_p, _, want, _ = train_rounds(trainer, batch_fn, RANKS_ONE_ROUNDS)
    del trainer
    torch.cuda.empty_cache()
    try:
        mesh = make_rank_mesh(model=1, n_fl=TRAIN_FL, timed=True)
        trainer = POFLTrainer(cfg, shape, mesh, tcfg, optimizer=opt)
        reset_metrics("span.ranks.")
        reset_metrics("ranks.")
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        got_p, got_s, got, round_ms = train_rounds(trainer, batch_fn, RANKS_ONE_ROUNDS)
        launched = read_counts()
        backend = mesh.backend
        costs = rank_costs(round_ms, counted_collectives())
    finally:
        dist.destroy_process_group()
    bitwise = (all(np.array_equal(got[k], want[k]) for k in want)
               and all(torch.equal(a, b) for a, b in zip(tree_leaves(got_p), tree_leaves(want_p))))
    errs = {**{k: rel(torch.as_tensor(got[k]), torch.as_tensor(want[k])) for k in want},
            "params": max(rel(a, b) for a, b in zip(tree_leaves(got_p), tree_leaves(want_p)))}
    state = {"params_bytes": tensor_bytes(got_p), "opt_state_bytes": tensor_bytes(got_s)}
    reckoned = reckoned_state(cfg, shape, (1, 1), opt)
    coll = reckoned_collectives(cfg, shape, (1, 1), opt, "all-gather", TRAIN_FL,
                                RANKS_ONE_ROUNDS, "bfloat16")
    per_round = cfg.n_layers * (1 + TRAIN_PROBES) + 2 * cfg.n_layers
    out = {"backend": backend, "n_layers": cfg.n_layers, "rounds": RANKS_ONE_ROUNDS,
           "bitwise": bitwise, "rel_err": errs, **costs,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(dev), **state,
           "reckoned": reckoned, "reckoned_collectives": coll,
           "flash_launches": launched["flash_attention"],
           "flash_launches_a_round": launched["flash_attention"] / RANKS_ONE_ROUNDS}
    del got_p, got_s, want_p
    torch.cuda.empty_cache()
    ok = (bitwise and state == reckoned and calls_and_bytes(costs["collectives"]) == coll
          and backend == "nccl" and launched["flash_attention"] == RANKS_ONE_ROUNDS * per_round)
    if not ok:
        raise AssertionError(f"train_ranks (a): {out}")
    return out, launched["flash_attention"]


def ranks_run(runs: list) -> tuple[list, dict]:
    """(b) to (e): the launcher's ``train`` workload on two ranks
    sharing the card over gloo, one launch running one run for each
    ``(sizes, ref, tol)`` of ``runs`` (a plan: ``ref``'s model at its depth
    on the (data, model) mesh of ``sizes``, in its dtype for its rounds,
    each from its model's initial weights), each held to this process's
    one-card run ``ref`` within ``tol`` (:func:`ranks_hold`) → (a list of
    (the comparison, both ranks' flash launches), the launch's seconds: its
    wall time, each run's own (set-up to outputs, rank 0) and the rest,
    what the launch costs once whatever it runs)."""
    import tempfile

    from repro_torch.launch.distributed import plan_out

    with tempfile.TemporaryDirectory() as tmp:
        out, plan = str(Path(tmp) / "train.npz"), Path(tmp) / "plan.json"
        plan.write_text(json.dumps([{"arch": ref["arch"], "layers": ref["layers"],
                                     "model": sizes[1], "dtype": ref["dtype"],
                                     "n_rounds": ref["rounds"], "dt_init": ref["dt_init"]}
                                    for sizes, ref, _ in runs]))
        t0 = time.perf_counter()
        launch(["--procs", 2, "--workload", "train", "--device", "cuda", "--plan", plan,
                "--out", out, "--save-blocks"], timeout=RANKS_TIMEOUT)
        seconds = time.perf_counter() - t0
        got = []
        for i, (_, ref, _) in enumerate(runs):
            out_i = plan_out(out, i, len(runs))
            data = np.load(out_i)
            got.append((json.loads(str(data["meta"])), {k: data[k] for k in ref["records"]},
                        [torch.load(f"{out_i}.rank{r}.pt") for r in range(2)]))
    run_s = [meta["seconds"] for meta, _, _ in got]
    timing = {"seconds": seconds, "runs_seconds": run_s, "fixed_seconds": seconds - sum(run_s)}
    return [ranks_hold(sizes, ref, tol, *g) for (sizes, ref, tol), g in zip(runs, got)], timing


def ranks_hold(sizes: tuple, ref: dict, tol: float, meta: dict, got: dict,
               blocks: list) -> tuple[dict, int]:
    """One run of :func:`ranks_run` (its ``meta``, records and each rank's
    final ``blocks``) against the one-card run ``ref`` within ``tol``:
    every round's RANKS_FIELDS and every rank's final blocks and their
    update, decisions equal, each rank's bytes and collectives the dry
    run's, its launches of the family's kernel (flash, or SSD for an SSM
    model: L × (1 + TRAIN_PROBES + 2) a round) → (the comparison, both
    ranks' launches by kernel). Round 0 starts both sides from the same
    parameters, so its gaps are the rounding of the ranks' split work
    alone."""
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.launch.sharding import Sharding

    n_rounds = ref["rounds"]
    want = ref["records"]
    kernel = "ssd_scan" if ref["cfg"].arch_type == "ssm" else "flash_attention"
    errs = {k: rel(torch.as_tensor(got[k]), torch.as_tensor(want[k])) for k in RANKS_FIELDS}
    round0 = {k: rel(torch.as_tensor(got[k][0]), torch.as_tensor(want[k][0]))
              for k in RANKS_FIELDS}
    decisions = (np.array_equal(got["n_scheduled"], want["n_scheduled"])
                 and np.array_equal(got["coeffs"] > 0, want["coeffs"] > 0))
    mesh = ShapeMesh(("data", "model"), sizes)
    ranks, worst_update, worst_params = [], 0.0, 0.0
    for r, rank in enumerate(meta["per_rank"]):
        coords = rank["coordinates"]
        d_got, d_want = [], []
        for name, spec in ref["specs"][sizes].items():
            index = Sharding(mesh, spec).index(coords, ref["final"][name].shape)
            final, init = ref["final"][name][index], ref["init"][name][index]
            worst_params = max(worst_params, rel(blocks[r][name], final))
            d_got.append((blocks[r][name] - init).reshape(-1))
            d_want.append((final - init).reshape(-1))
        worst_update = max(worst_update, rel_l2(torch.cat(d_got), torch.cat(d_want)))
        ranks.append({**rank_costs(rank["round_ms"], rank["collectives"]),
                      "coordinates": coords, "peak_memory_bytes": rank["peak_memory_bytes"],
                      "params_bytes": rank["params_bytes"],
                      "opt_state_bytes": rank["opt_state_bytes"],
                      "compute_weight_bytes": rank["compute_weight_bytes"],
                      f"{kernel}_launches_a_round": rank["launches"][kernel] / n_rounds})
    errs.update(params=worst_params, update_rel_l2=worst_update)
    reckoned = {**reckoned_state(ref["cfg"], ref["shape"], sizes, ref["optimizer"]),
                "compute_weight_bytes": reckoned_compute_bytes(ref["cfg"], sizes)}
    # gloo gathers CUDA tensors by a zero-filled all-reduce
    coll = reckoned_collectives(ref["cfg"], ref["shape"], sizes, ref["optimizer"], "all-reduce",
                                ref["n_fl"], n_rounds, ref["dtype"])
    per_round = ref["cfg"].n_layers * (1 + TRAIN_PROBES) + 2 * ref["cfg"].n_layers
    launched = [rank["launches"][kernel] for rank in meta["per_rank"]]
    out = {"arch": ref["arch"], "n_layers": ref["layers"], "mesh": sizes, "dtype": ref["dtype"],
           "rounds": n_rounds, "tolerance": tol,
           "backend": meta["backend"], "rel_err": errs, "round_0_rel_err": round0,
           "decisions_equal": decisions, "ranks": ranks, "reckoned": reckoned,
           "reckoned_collectives": coll}
    ok = (max(errs.values()) <= tol and decisions and meta["backend"] == "gloo"
          and all({k: r[k] for k in reckoned} == reckoned for r in ranks)
          and all(calls_and_bytes(r["collectives"]) == coll for r in ranks)
          and launched == [n_rounds * per_round] * 2)
    if not ok:
        raise AssertionError(f"train_ranks {ref['arch']} {sizes} {ref['dtype']}: {out}")
    return out, {kernel: sum(launched)}


def one_card_reference(dev, dtype: str, n_rounds: int, arch: str = TRAIN_ARCH,
                       layers: int = RANKS_LAYERS,
                       meshes: tuple = tuple(RANKS_MESHES.values()),
                       dt_init: str = "zeros") -> dict:
    """This process's one-card trainer on the launcher's ``train`` workload
    cell, ``arch`` at ``layers`` layers in ``dtype`` from weights drawn
    with ``dt_init`` (``models.api.model_init``): its records, initial and
    final parameters (on the host) and the specs of the rank meshes
    ``meshes``."""
    from repro_torch.launch import distributed
    from repro_torch.launch.distributed import flat_tree, train_rounds, train_setup
    from repro_torch.launch.mesh import ShapeMesh, make_host_mesh
    from repro_torch.launch.sharding import params_pspecs
    from repro_torch.launch.steps import params_structs
    from repro_torch.launch.train import POFLTrainer
    from repro_torch.models import api

    n_fl = distributed.TRAIN_FL
    cfg, shape, tcfg, opt, batch_fn = train_setup(arch, layers, n_fl, distributed.TRAIN_BATCH,
                                                  distributed.TRAIN_SEQ, "sgd", dtype, n_rounds,
                                                  dev)
    trainer = POFLTrainer(cfg, shape, make_host_mesh(1, n_fl, dev), tcfg, optimizer=opt)
    final, _, records, round_ms = train_rounds(trainer, batch_fn, n_rounds, dt_init)
    ref = {"arch": arch, "layers": layers, "cfg": cfg, "shape": shape, "optimizer": opt,
           "records": records, "dtype": dtype, "dt_init": dt_init,
           "rounds": n_rounds, "n_fl": n_fl, "round_ms": round_ms,
           "final": {k: v.cpu() for k, v in flat_tree(final).items()},
           "init": {k: v.cpu() for k, v in
                    flat_tree(api.model_init(cfg, tcfg.seed + 1, device=dev,
                                             dt_init=dt_init)).items()},
           "specs": {sizes: flat_tree(params_pspecs(params_structs(cfg),
                                                    ShapeMesh(("data", "model"), sizes)))
                     for sizes in meshes}}
    del trainer, final
    torch.cuda.empty_cache()
    return ref


def train_ranks_phase(dev) -> dict:
    """Phase ``train_ranks``: the LM trainer over a (data, model) mesh of
    ranks. (a) one NCCL rank against the one-card trainer, bitwise
    (:func:`one_rank`); then this process's one-card trainer at
    RANKS_LAYERS layers, ``sgd``, and (b) the (2, 1) and (c) the (1, 2)
    mesh of two ranks sharing the card over gloo, each held to it
    (:func:`ranks_run`) in fp32 within ROUND_TOL and
    for a round in bf16 within RANKS_BF16_TOL: every round's RANKS_FIELDS and every
    rank's final blocks and their update, decisions equal, each rank's
    bytes of masters, optimizer state and compute weights (on (c) its
    tensor-parallel blocks) and its collectives' calls and wire bytes
    equal to the dry run's, the flash kernel L × (1 + TRAIN_PROBES + 2)
    times a rank a round; (d): olmoe-1b-7b at RANKS_MOE_LAYERS layers
    on the (2, 1) mesh held the same way to this process's one-card trainer
    at that depth (its routing groups and load-balance loss over both data
    ranks), in fp32 and in bf16; and (e): mamba2-370m at RANKS_SSM_LAYERS
    layers on the (1, 2) mesh, split by SSM heads (kernel 4 on each rank's
    16 heads), RANKS_SSM_ROUNDS rounds in fp32 and one in bf16, held the
    same way. One launch runs (b) to (e)."""
    one, launched = one_rank(dev)
    out = {"a": one}
    refs = {"float32": one_card_reference(dev, RANKS_DTYPE, RANKS_ROUNDS),
            "bfloat16": one_card_reference(dev, "bfloat16", RANKS_BF16_ROUNDS)}
    for dtype, rounds in (("float32", RANKS_ROUNDS), ("bfloat16", RANKS_BF16_ROUNDS)):
        refs[f"moe_{dtype}"] = one_card_reference(dev, dtype, rounds, RANKS_MOE_ARCH,
                                                  RANKS_MOE_LAYERS, (RANKS_MOE_MESH,))
    for dtype, rounds in (("float32", RANKS_SSM_ROUNDS), ("bfloat16", RANKS_BF16_ROUNDS)):
        refs[f"ssm_{dtype}"] = one_card_reference(dev, dtype, rounds, RANKS_SSM_ARCH,
                                                  RANKS_SSM_LAYERS, (RANKS_SSM_MESH,),
                                                  "mamba2")
    # one launch (PERF.md §6: a launch's fixed seconds): each part's fp32
    # run and its bf16 round
    runs = {}
    for part, sizes, model in ([(part, sizes, "") for part, sizes in RANKS_MESHES.items()]
                               + [("d", RANKS_MOE_MESH, "moe_"), ("e", RANKS_SSM_MESH, "ssm_")]):
        runs[part] = (sizes, refs[f"{model}float32"], ROUND_TOL)
        runs[f"{part}_bf16"] = (sizes, refs[f"{model}bfloat16"], RANKS_BF16_TOL)
    held, out["launch"] = ranks_run(list(runs.values()))
    counts = {name: 0 for name in kernel_counters()}
    counts["flash_attention"] = launched
    for key, (comparison, n) in zip(runs, held, strict=True):
        out[key] = {**comparison, "launches": n}
        for name, k in n.items():
            counts[name] += k
    out["one_card_reference"] = {
        name: {"arch": r["arch"], "n_layers": r["cfg"].n_layers, "round_ms": r["round_ms"],
               "records": {k: v.tolist() for k, v in r["records"].items()}}
        for name, r in refs.items()}
    emit("train_ranks", arch=TRAIN_ARCH, tolerance=ROUND_TOL, bf16_tolerance=RANKS_BF16_TOL,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, fl_devices=TRAIN_FL, ranks_layers=RANKS_LAYERS,
         ranks_rounds=RANKS_ROUNDS, moe_arch=RANKS_MOE_ARCH, moe_layers=RANKS_MOE_LAYERS,
         ssm_arch=RANKS_SSM_ARCH, ssm_layers=RANKS_SSM_LAYERS, ssm_rounds=RANKS_SSM_ROUNDS,
         card=nvidia_smi(), **out)
    return counts


# -- serving over ranks -------------------------------------------------------

# (b) and (c): two ranks sharing the card over gloo on these (data, model)
# meshes, one launch running serve_ranks_plan()'s runs on both in one
# process group
SERVE_RANKS_MESHES = {"b": (2, 1), "c": (1, 2)}
SERVE_RANKS_TIMEOUT = 600  # seconds the launched ranks get
SERVE_RANKS_STEPS = 8
# the holds: last-position logits against one process, relative L2 (PERF.md
# §2's bf16 limit; 1e-5 in fp32)
SERVE_RANKS_TOL = {"bfloat16": 2.0**-7, "float32": 1e-5}
# the bf16 runs at full depth, whose decode logits are not held to
# SERVE_RANKS_TOL against one process over the whole batch: with random
# weights a changed rounding in an early layer grows with depth (a product
# over half the rows rounds otherwise; PERF.md §6, serving over ranks).
# There the tokens are held by the margin rule, a data rank's decode
# bitwise to one process's over the same rows and its prefill within
# SERVE_RANKS_TOL (bitwise: its rows round as one process's), and the bf16
# logits within SERVE_RANKS_TOL at a cut depth ("bf16_cut", "ssm_cut").
# Over model ranks the split products round otherwise than one GEMM from
# layer 0 on, so there the full-depth bf16 prefill is held by its distance
# from one process's prefill in fp32 on the same inputs (fp32_yardstick),
# logits and cache layer by layer: at most SERVE_RANKS_SPLIT_RATIO times one
# process's bf16 prefill's distance from it (ROADMAP C); the split is also
# held at full depth in fp32 ("fp32_deep")
SERVE_RANKS_DEEP = ("bf16", "ssm", "moe")
SERVE_RANKS_SPLIT_RATIO = 1.5
# olmoe-1b-7b on (b), its rows routed in the whole batch's groups over both
# data ranks: a fp32 run cut to SERVE_RANKS_MOE_CUT layers and a full-depth
# bf16 run, each a prefill of SERVE_BATCH × SERVE_PROMPT (a rank's rows hold
# whole groups of 1,024) and 8 steps of 128 rows from a seeded cache of
# SERVE_RANKS_MOE_CACHE slots (one group of 128 tokens a layer spans both
# ranks at a capacity of 20, so tokens drop)
SERVE_RANKS_MOE = ("moe_cut", "moe")
SERVE_RANKS_MOE_CUT, SERVE_RANKS_MOE_CACHE = 2, 256
# mamba2-370m split by SSM heads on (c): "ssm_tp", fp32 at a cut depth of
# SERVE_RANKS_SSM_TP_CUT layers, held to one process within 1e-5, and the
# full-depth bf16 "ssm" run, held as qwen2's split is (on (b) "ssm_tp" does
# not run: the data ranks' split is held by "ssm_cut" and "ssm"). Both draw
# dt_bias as Mamba2 does (``dt_init="mamba2"``): at the reference's zeros
# the fp32 model is ill-conditioned over 2,048 tokens (ROADMAP C). Even so
# the fp32 state amplifies the split's changed rounding with depth: its
# cache read 2.1e-5 from one process's at 4 layers, 8.3e-6 at 2 (the logits
# 2.8e-6 and 1.5e-6; PERF.md §6, ROADMAP C)
SERVE_RANKS_SSM_SPLIT = ("ssm_tp", "ssm")
SERVE_RANKS_SSM_TP_CUT = 2


def serve_ranks_entries(plan) -> list:
    """The (mesh part, run name) pairs of the ranks' one launch: every run
    on (b) but "ssm_tp"; qwen2-0.5b's and SERVE_RANKS_SSM_SPLIT's on (c)
    (olmoe serves over data ranks only, and (c)'s bf16 mamba2 cut depth
    would add time and no hold "ssm_tp" lacks)."""
    def runs_on(sizes, name):
        if sizes[1] == 1:
            return name != "ssm_tp"
        return plan[name].arch == SERVE_ARCH or name in SERVE_RANKS_SSM_SPLIT

    return [(part, name) for part, sizes in SERVE_RANKS_MESHES.items() for name in plan
            if name != "a" and runs_on(sizes, name)]


def serve_ranks_plan():
    """The runs (``launch.distributed.ServeRun``) of phase ``serve_ranks``:
    (a) the serve phase's shape, its cache grown by 8 slots; qwen2-0.5b at
    full width and depth in bf16, a prefill of SERVE_BATCH × SERVE_PROMPT
    and 8 steps at decode_32k's capacity (128 × 32,768, filled from a
    seed), and the same cut to 1 layer; the same at 4 layers in fp32 on a
    128 × 4,096 cache, and at full depth in fp32 on a 2 × 512 prompt,
    2 steps from its prefill; mamba2-370m at the ssm_serve shape (decoding
    from its prefill), at full depth and cut to 16 of 48 layers over data
    ranks (the cut depths: PERF.md §6, serving over ranks), and split over
    model ranks in fp32 at SERVE_RANKS_SSM_TP_CUT layers and at full depth
    in bf16 (:func:`serve_ranks_entries`); olmoe-1b-7b over data
    ranks (SERVE_RANKS_MOE): a prefill of SERVE_BATCH × SERVE_PROMPT and 8
    steps of 128 rows from a seeded cache, in fp32 at SERVE_RANKS_MOE_CUT
    layers and at full depth in bf16."""
    from repro_torch.launch.distributed import ServeRun
    from repro_torch.models.config import INPUT_SHAPES

    d32k = INPUT_SHAPES["decode_32k"]
    common = dict(batch=SERVE_BATCH, prompt=SERVE_PROMPT, steps=SERVE_RANKS_STEPS)
    big = dict(cache_batch=d32k.global_batch, cache_len=d32k.seq_len, **common)
    # each cut run comes first, so the full-depth prefill after it finds
    # cuBLAS, the kernels' libraries and gloo's connections warm in the
    # launched ranks, as the one process finds them (c′)
    return {"a": ServeRun(SERVE_ARCH, 0, "bfloat16", **common),
            "bf16_cut": ServeRun(SERVE_ARCH, 1, "bfloat16", **big),
            "bf16": ServeRun(SERVE_ARCH, 0, "bfloat16", **big),
            "fp32": ServeRun(SERVE_ARCH, 4, "float32", cache_batch=d32k.global_batch,
                             cache_len=4096, **common),
            "fp32_deep": ServeRun(SERVE_ARCH, 0, "float32", batch=2, prompt=512, steps=2),
            "ssm_tp": ServeRun(SSM_ARCH, SERVE_RANKS_SSM_TP_CUT, "float32", dt_init="mamba2",
                               **common),
            "ssm_cut": ServeRun(SSM_ARCH, 16, "bfloat16", **common),
            "ssm": ServeRun(SSM_ARCH, 0, "bfloat16", dt_init="mamba2", **common),
            "moe_cut": ServeRun(MOE_ARCH, SERVE_RANKS_MOE_CUT, "float32", cache_batch=128,
                                cache_len=SERVE_RANKS_MOE_CACHE, **common),
            "moe": ServeRun(MOE_ARCH, 0, "bfloat16", cache_batch=128,
                            cache_len=SERVE_RANKS_MOE_CACHE, **common)}


def step_hold(got_logits, want_logits, got_tokens, want_tokens, step) -> tuple[float, float,
                                                                              list, list]:
    """One step's last-position logits (rows × vocab) against one
    process's → (relative L2, max |gap|, the rows whose greedy tokens
    differ where the one process's top-2 margin exceeds twice that gap,
    the rows whose tokens differ within it), each row reported with its
    margin."""
    g, w = got_logits.float(), want_logits.float()
    gap = (g - w).abs().max().item()
    top2 = w.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    bad, outside = [], []
    for j in (got_tokens != want_tokens).nonzero().squeeze(1).tolist():
        entry = {"row": j, "step": step, "margin": float(margin[j]), "gap": gap}
        (bad if margin[j] > 2 * gap else outside).append(entry)
    return rel_l2(g, w), gap, bad, outside


def decode_hold(got: dict, want: dict, vocab: int) -> dict:
    """A rank's decode against one process's on its rows, step by step
    (:func:`step_hold`), each step over the rows whose tokens so far agree
    (a first token that differs was held by the prefill's rule): a row
    whose token differs within the margin rule leaves the later steps'
    comparison."""
    n_steps = want["tokens"].shape[1]
    agree = got["tokens"][:, 0] == want["tokens"][:, 0]
    worst, gap_max, bad, outside = 0.0, 0.0, [], []
    for i in range(n_steps - 1):
        rows = agree.nonzero().squeeze(1)
        err, gap, b, o = step_hold(got["logits"][rows, i, :vocab], want["logits"][rows, i, :vocab],
                                   got["tokens"][rows, i + 1], want["tokens"][rows, i + 1], i)
        worst, gap_max = max(worst, err), max(gap_max, gap)
        for entry in b + o:
            entry["row"] = int(rows[entry["row"]])
            agree[entry["row"]] = False
        bad += b
        outside += o
    return {"logits_rel_l2": worst, "max_logit_gap": gap_max, "tokens_against_rule": bad,
            "tokens_outside_rule": outside,
            "first_equal": torch.equal(got["tokens"][:, 0], want["tokens"][:, 0])}


def fp32_yardstick(run, dev) -> dict:
    """``run``'s prefill in one process in fp32 arithmetic on the same
    inputs: its prompt, and the weights it serves (every fp32 leaf but the
    ``FP32_LEAVES`` rounded to ``run.dtype``, as ``Server.load_params``
    casts them) → the last-position logits and the whole cache, on the
    host. The full-depth bf16 prefills of one process and of the split are
    each measured against it."""
    from repro_torch import configs
    from repro_torch.launch.distributed import serve_inputs, serve_weights
    from repro_torch.launch.serve import Server
    from repro_torch.launch.sharding import FP32_LEAVES
    from repro_torch.models.config import InputShape

    dtype = getattr(torch, run.dtype)
    cfg = configs.cut_depth(configs.base_config(run.arch), run.layers or None)

    def rounded(node, key=""):
        if isinstance(node, dict):
            return {k: rounded(v, k) for k, v in node.items()}
        if node.dtype != torch.float32 or key in FP32_LEAVES:
            return node
        return node.to(dtype).float()

    server = Server(cfg, InputShape("prompt", run.prompt + run.steps, run.batch, "decode"),
                    dev, torch.float32)
    params = server.load_params(rounded(serve_weights(run, cfg, dev)))
    tokens, _ = serve_inputs(run, cfg)
    _, logits, cache = server.prefill(params, {"tokens": tokens})
    out = {"logits": logits[:, -1].cpu(), "cache": type(cache)(*(x.cpu() for x in cache))}
    del params, cache, logits
    torch.cuda.empty_cache()
    return out


def rank_blocks(whole, mesh, coords):
    """The rank at ``coords``' blocks of a whole attention cache."""
    from repro_torch.launch.sharding import cache_shardings

    return type(whole)(*(x[sh.index(coords, x.shape)]
                         for x, sh in zip(whole, cache_shardings(whole, mesh))))


def split_against_fp32(p_got, p_want, fp32, rows, vocab, mesh, coords) -> tuple[dict, bool]:
    """A model rank's bf16 prefill and one process's over the same rows and
    cache block, each against the fp32 prefill of the same inputs
    (:func:`fp32_yardstick`): relative L2 of the last-position logits and
    of each layer's cache → (the figures, whether the split's distance is
    at most SERVE_RANKS_SPLIT_RATIO times one process's, the logits' and
    every layer's). A split that rounds as one GEMM keeps to one process's
    distance; a wrong one (a head, a block or a partial sum misplaced)
    lands far from both."""
    ref = rows(fp32["logits"])[:, :vocab]
    logits = {"split": rel_l2(p_got["logits"][:, :vocab], ref),
              "one_process": rel_l2(rows(p_want["logits"])[:, :vocab], ref)}
    layers = {"split": layer_blocks_hold(p_got["cache"], fp32["cache"], mesh, coords),
              "one_process": layer_blocks_hold(rank_blocks(p_want["cache"], mesh, coords),
                                               fp32["cache"], mesh, coords)}
    ratio = [s / o for s, o in zip(layers["split"], layers["one_process"], strict=True)]
    out = {"logits_rel_l2": logits, "logits_ratio": logits["split"] / logits["one_process"],
           "cache_rel_l2_by_layer": layers, "cache_ratio_by_layer": ratio,
           "ratio_limit": SERVE_RANKS_SPLIT_RATIO}
    return out, (out["logits_ratio"] <= SERVE_RANKS_SPLIT_RATIO
                 and max(ratio) <= SERVE_RANKS_SPLIT_RATIO)


def layer_blocks_hold(got, want_whole, mesh, coords) -> list:
    """A cache's blocks against one process's, layer by layer: the worst
    relative L2 of each layer's float leaves (k and v, or an SSM cache's
    state and conv window; a layer's cache depends only on the layers
    before it, so this is the error's growth with depth)."""
    from repro_torch.launch.sharding import cache_shardings
    from repro_torch.models.cache import cache_leaves

    pairs = [(g, w[sh.index(coords, w.shape)]) for g, w, sh in
             zip(cache_leaves(got), cache_leaves(want_whole),
                 cache_leaves(cache_shardings(want_whole, mesh)), strict=True)
             if g.is_floating_point()]
    return [max(rel_l2(g[i], w[i]) for g, w in pairs) for i in range(pairs[0][0].shape[0])]


def serve_blocks_hold(got, want_whole, mesh, coords) -> float:
    """The worst relative L2 of a rank's cache blocks against the specs'
    blocks of one process's whole cache; positions must be equal (else
    ``inf``)."""
    from repro_torch.launch.sharding import cache_shardings
    from repro_torch.models.cache import cache_leaves

    worst = 0.0
    for g, w, sh in zip(cache_leaves(got), cache_leaves(want_whole),
                        cache_leaves(cache_shardings(want_whole, mesh)), strict=True):
        w = w[sh.index(coords, w.shape)]
        if tuple(g.shape) != tuple(w.shape):
            return float("inf")
        if g.is_floating_point():
            worst = max(worst, rel_l2(g, w))
        elif not torch.equal(g, w):
            return float("inf")
    return worst


def serve_rank_hold(run, got: dict, want: dict, sizes, coords, gather: str,
                    deep: bool, fp32=None) -> tuple[dict, bool]:
    """One rank's run against one process's: the prefill's first tokens
    (the margin rule), last-position logits and cache blocks, the decode
    (:func:`decode_hold`) and, from the prefill's cache, the decode's final
    blocks, within SERVE_RANKS_TOL (the decode's logits and final blocks
    only reported where ``deep``: SERVE_RANKS_DEEP; there over model ranks
    the prefill is held against one process's by their distances from
    ``fp32``, :func:`split_against_fp32`); the positions written; each
    kernel's
    launches (the prefill's :func:`prefill_launches`, none in the decode);
    the bytes of the weights the rank serves (its TP blocks over model
    ranks) and the collectives of the prefill, of the decode with the
    gathers of its logits and tokens equal to the dry run's (``gather``:
    how the ranks gather; gloo gathers CUDA tensors by a zero-filled
    all-reduce) → (the figures, whether every hold held)."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import rank_collectives
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.launch.sharding import Sharding, _batched, served_bytes
    from repro_torch.launch.steps import build_prefill_step, build_serve_step, params_structs
    from repro_torch.models.config import InputShape

    tol = SERVE_RANKS_TOL[run.dtype]
    dtype = getattr(torch, run.dtype)
    cfg = configs.cut_depth(configs.base_config(run.arch), run.layers or None)
    mesh = ShapeMesh(("data", "model"), sizes)

    def rows(x, b):
        return x[Sharding(mesh, (_batched(b, mesh),)).index(coords, (b,))[0]]

    p_got, p_want = got["prefill"], want["prefill"]
    v = cfg.vocab_size
    p_err, _, p_bad, p_outside = step_hold(p_got["logits"][:, :v],
                                           rows(p_want["logits"], run.batch)[:, :v],
                                           p_got["first"][:, 0],
                                           rows(p_want["first"], run.batch)[:, 0], "prefill")
    b_dec = run.cache_batch if run.cache_len else run.batch
    d_want = {k: rows(want["decode"][k], b_dec) for k in ("tokens", "logits")}
    decode = decode_hold(got["decode"], d_want, v)
    out = {"prefill_logits_rel_l2": p_err, "prefill_tokens_against_rule": p_bad,
           "prefill_tokens_outside_rule": p_outside,
           "prefill_cache_rel_l2": serve_blocks_hold(p_got["cache"], p_want["cache"], mesh,
                                                     coords),
           "prefill_cache_rel_l2_by_layer": layer_blocks_hold(p_got["cache"], p_want["cache"],
                                                              mesh, coords),
           **{f"decode_{k}": v for k, v in decode.items()},
           "positions_written": got["decode"]["positions_written"]}
    if got["decode"]["cache"] is not None:
        out["decode_cache_rel_l2"] = serve_blocks_hold(got["decode"]["cache"],
                                                       want["decode"]["cache"], mesh, coords)
    shape = InputShape("decode", run.cache_len or run.prompt + run.steps, b_dec, "decode")
    serve = build_serve_step(cfg, shape, mesh, dtype)
    reckoned = rank_collectives(cfg, serve, mesh, gather, n_tokens=run.steps + 1, logits=True)
    prefill = build_prefill_step(cfg, InputShape("prompt", run.prompt, run.batch, "prefill"),
                                 mesh, dtype)
    reckoned_prefill = rank_collectives(cfg, prefill, mesh, gather, logits=True, dtype=dtype)
    weight_bytes = served_bytes(params_structs(cfg), serve.in_shardings["params"], dtype)
    counted = calls_and_bytes(got["decode"]["collectives"])
    counted_prefill = calls_and_bytes(got["prefill"]["collectives"])
    expect = prefill_launches(cfg)
    out.update(reckoned_collectives=reckoned, collectives=got["decode"]["collectives"],
               reckoned_prefill_collectives=reckoned_prefill,
               prefill_collectives=got["prefill"]["collectives"],
               weight_bytes=got["weight_bytes"], reckoned_weight_bytes=weight_bytes,
               launches={"prefill": got["prefill"]["launches"],
                         "decode": got["decode"]["launches"]})
    held = []
    if not (deep and sizes[1] > 1):
        held += [out["prefill_logits_rel_l2"], out["prefill_cache_rel_l2"]]
    if not deep:
        held += [out["decode_logits_rel_l2"], out.get("decode_cache_rel_l2", 0.0)]
    out["held_to_tolerance"] = ("prefill and decode" if not deep else
                                "prefill" if held else
                                "the prefill against fp32, the tokens by the margin rule")
    split_ok = True
    if deep and sizes[1] > 1:
        out["prefill_against_fp32"], split_ok = split_against_fp32(
            p_got, p_want, fp32, lambda x: rows(x, run.batch), v, mesh, coords)
    ok = (max(held, default=0.0) <= tol and split_ok
          and not p_bad and not decode["tokens_against_rule"]
          and (decode["first_equal"] or run.cache_len == 0) and out["positions_written"]
          and counted == reckoned and counted_prefill == reckoned_prefill
          and got["weight_bytes"] == weight_bytes
          and got["prefill"]["launches"] == expect
          and not any(got["decode"]["launches"].values()))
    return out, ok


def one_process_rows(run, dev, sizes, coords) -> dict:
    """This process's one-card ``Server`` on the rows that the rank at
    ``coords`` of a (data, 1) mesh of ``sizes`` holds, from the same
    weights, prompt rows, seeded cache rows and first tokens as that rank's
    :func:`launch.distributed.serve_run` → its decode's tokens and each
    step's logits (and, decoding from the prefill, its final cache), on the
    host: what the rank must equal bitwise, the same code over the same
    rows."""
    from repro_torch import configs
    from repro_torch.launch.distributed import (
        _on_host, seeded_cache, serve_inputs, serve_weights,
    )
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.launch.serve import Server
    from repro_torch.launch.sharding import Sharding, _batched
    from repro_torch.models.config import InputShape

    class Placed(ShapeMesh):  # a shape-only mesh that answers one rank's place
        def coordinates(self, rank=None):
            return coords

    mesh = Placed(("data", "model"), sizes)
    cfg = configs.cut_depth(configs.base_config(run.arch), run.layers or None)
    dtype = getattr(torch, run.dtype)
    tokens, first = serve_inputs(run, cfg)

    def rows(x):
        return Sharding(mesh, (_batched(x.shape[0], mesh),) + (None,) * (x.dim() - 1)).block(x)

    b = (run.cache_batch if run.cache_len else run.batch) // sizes[0]
    server = Server(cfg, InputShape("rows", run.cache_len or run.prompt + run.steps, b, "decode"),
                    dev, dtype)
    params = server.load_params(serve_weights(run, cfg, dev))
    if run.cache_len:
        start = run.cache_len - run.steps
        cache = seeded_cache(cfg, run.cache_batch, run.cache_len, start, dtype, dev, run.seed,
                             mesh)
        first = rows(first)
    else:
        start = run.prompt
        first, _, cache = server.prefill(params, {"tokens": rows(tokens)},
                                         pad_to=run.prompt + run.steps)
    toks, cache, logits = server.decode(params, first, cache, start, run.steps + 1,
                                        keep_logits=True)
    out = {"tokens": toks.cpu(), "logits": logits.cpu(),
           "cache": None if run.cache_len else _on_host(cache)}
    del cache, params
    torch.cuda.empty_cache()
    return out


def rows_bitwise(got: dict, want: dict) -> bool:
    """A rank's decode equal to :func:`one_process_rows`' bitwise."""
    from repro_torch.models.cache import cache_leaves

    pairs = [(got[k], want[k]) for k in ("tokens", "logits")]
    if want["cache"] is not None:
        pairs += list(zip(cache_leaves(got["cache"]), cache_leaves(want["cache"])))
    return all(torch.equal(a, b) for a, b in pairs)


def moe_rows_prefill(run, dev, sizes, coords) -> dict:
    """This process's one-card prefill of the rows the rank at ``coords`` of
    a (data, 1) mesh of ``sizes`` holds, from the same weights and prompt
    rows as that rank's ``launch.distributed.serve_run`` → its first
    tokens, last-position logits, cache and each layer's routing, on the
    host: a rank whose rows hold whole routing groups routes them as one
    process does, so it must equal this bitwise."""
    from repro_torch import configs
    from repro_torch.launch.distributed import (
        _on_host, _routes_on_host, serve_inputs, serve_weights,
    )
    from repro_torch.launch.serve import Server
    from repro_torch.models.config import InputShape
    from repro_torch.models.layers import recorded_routes

    cfg = configs.cut_depth(configs.base_config(run.arch), run.layers or None)
    tokens, _ = serve_inputs(run, cfg)
    n = run.batch // sizes[0]
    rows = tokens[coords["data"] * n:(coords["data"] + 1) * n]
    server = Server(cfg, InputShape("rows", run.prompt + run.steps, n, "decode"), dev,
                    getattr(torch, run.dtype))
    params = server.load_params(serve_weights(run, cfg, dev))
    with recorded_routes() as routes:
        first, logits, cache = server.prefill(
            params, {"tokens": rows}, pad_to=None if run.cache_len else run.prompt + run.steps)
    out = {"first": first.cpu(), "logits": logits[:, -1].cpu(), "cache": _on_host(cache),
           "routes": _routes_on_host(routes)}
    del params, cache, logits
    torch.cuda.empty_cache()
    return out


def whole_groups(run, sizes) -> bool:
    """Whether a data rank's rows of ``run``'s prompt on a (data, 1) mesh
    of ``sizes`` hold whole routing groups of the batch's
    (``layers._moe_group_size``)."""
    from repro_torch.models.layers import _moe_group_size

    tokens = run.batch // sizes[0] * run.prompt
    return tokens % _moe_group_size(sizes[0] * tokens) == 0


def prefill_bitwise(got: dict, want: dict) -> bool:
    """A rank's prefill equal to :func:`moe_rows_prefill`'s bitwise, its
    routing too."""
    from repro_torch.models.cache import cache_leaves

    pairs = [(got[k], want[k]) for k in ("first", "logits")]
    pairs += list(zip(cache_leaves(got["cache"]), cache_leaves(want["cache"])))
    pairs += [(a, b) for g, w in zip(got["routes"], want["routes"], strict=True)
              for a, b in zip(g[:5], w[:5])]
    return all(torch.equal(a, b) for a, b in pairs)


def recounted(route) -> bool:
    """Whether a whole route's positions are the counts of its experts'
    earlier choices in each group, slot outer (numpy, apart from the
    port's ``layers._slot_positions``), and its drops those at or past the
    capacity."""
    g, gs, k = route.gate_idx.shape
    e_tok = route.gate_idx.transpose(1, 2).reshape(g, k * gs).numpy()
    onehot = np.eye(route.probs.shape[-1], dtype=np.int64)[e_tok]
    pos = ((np.cumsum(onehot, 1) * onehot).sum(-1) - 1).reshape(g, k, gs)
    return np.array_equal(route.pos.numpy(), pos) and np.array_equal(
        route.within.numpy(), pos < route.cap)


def moe_routes_hold(run, gots: list, want: dict, exact: bool) -> tuple[dict, bool]:
    """A MoE run's routing over the data ranks: every layer's routes of the
    prefill and of each decode step, the ranks' joined in the whole batch's
    groups (``layers.whole_route``), their positions and drops recounted
    from their experts (:func:`recounted`), against one process's over the
    whole batch (:func:`moe_decision_counts`; held where ``exact``: the
    fp32 run at a cut depth, where both sides' probabilities agree far
    inside MOE_TIE; at full depth in bf16 reported, since the ranks' rows
    round otherwise than the whole batch's from the first layer on and the
    decode's tokens may part by the margin rule) and the decode's dropped
    (slot, token) count, above 0 in a decode of 128 rows →
    (the figures, whether every hold held)."""
    from repro_torch.models.layers import whole_route

    parts = {part: [whole_route([g[part]["routes"][i] for g in gots])
                    for i in range(len(gots[0][part]["routes"]))]
             for part in ("prefill", "decode")}
    out = {"recounted": all(recounted(r) for rs in parts.values() for r in rs),
           "capacity": {part: rs[0].cap for part, rs in parts.items()},
           "group_size": {part: rs[0].gate_idx.shape[1] for part, rs in parts.items()},
           "dropped": {part: sum(int((~r.within).sum()) for r in rs)
                       for part, rs in parts.items()},
           "decisions_held": exact}
    ok = out["recounted"] and (run.cache_batch != 128 or run.cache_len == 0
                               or out["dropped"]["decode"] > 0)
    for part, rs in parts.items():
        counts = moe_decision_counts(want[part]["routes"], rs)
        out[f"{part}_decisions"] = {
            key: sum(c[key] for c in counts)
            for key in ("tokens", "near_ties", "experts_differ", "experts_differ_past_a_tie",
                        "held_slots", "dropped_cpu", "dropped_card",
                        "held_positions_or_drops_differ")}
        if exact:
            ok = ok and not (out[f"{part}_decisions"]["experts_differ_past_a_tie"]
                             or out[f"{part}_decisions"]["held_positions_or_drops_differ"])
    return out, ok


def serve_costs(got: dict, run) -> dict:
    """A rank's serving figures: the prefill's ms and tokens/s, ms a decode
    step, the whole batch's tokens/s, peak GB, cache GB, weight GB, each
    collective span's share of the decode steps (its seconds, the card
    synchronised around each, over the steps' seconds: ``reduce`` holds the
    combine's and the split products' all-reduces, ``gather`` the q, k, v
    and greedy gathers) and the seconds of the gathers after the steps
    (the logits' and the tokens')."""
    dec = got["decode"]
    steps, coll = dec["steps_collectives"], dec["collectives"]
    decode_s = dec["ms_per_step"] * run.steps / 1e3
    prefill = got["prefill"]
    return {"prefill_ms": prefill["ms"],
            "prefill_tokens_per_s": prefill["first"].shape[0] * run.prompt * 1e3 / prefill["ms"],
            "decode_ms_per_step": dec["ms_per_step"],
            "tokens_per_s": dec["tokens_per_s"],
            "peak_gb": (dec["peak_memory_bytes"] or 0) / 1e9,
            "cache_gb": dec["cache_bytes"] / 1e9,
            "weight_gb": got["weight_bytes"] / 1e9,
            "span_share": {op: c["seconds"] / decode_s for op, c in steps.items()},
            "prefill_span_s": {op: c["seconds"] for op, c in prefill["collectives"].items()},
            "gather_after_steps_s": coll["gather"]["seconds"] - steps["gather"]["seconds"]}


def serve_ranks_one(dev, run, want) -> tuple[dict, int]:
    """(a): the run on a (1, 1) mesh of one NCCL rank (this process)
    against this process's one-card ``Server`` ``want``: every output
    bitwise → (the figures, the rank run's flash launches)."""
    import torch.distributed as dist

    from repro_torch.launch.distributed import serve_run
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models.cache import cache_leaves

    try:
        mesh = make_rank_mesh(model=1, timed=True)
        backend = mesh.backend
        got = serve_run(run, mesh)
    finally:
        dist.destroy_process_group()
    pairs = [(got["prefill"][k], want["prefill"][k]) for k in ("first", "logits")]
    pairs += [(got["decode"][k], want["decode"][k]) for k in ("tokens", "logits")]
    for part in ("prefill", "decode"):
        pairs += list(zip(cache_leaves(got[part]["cache"]), cache_leaves(want[part]["cache"])))
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    none = {op: {"calls": 0, "bytes": 0} for op in ("gather", "reduce", "broadcast")}
    out = {"backend": backend, "bitwise": bitwise, **serve_costs(got, run),
           "one_card": serve_costs(want, run), "collectives": got["decode"]["collectives"],
           "launches": {"prefill": got["prefill"]["launches"],
                        "decode": got["decode"]["launches"]}}
    cfg_launches = prefill_launches_of(run)
    ok = (bitwise and backend == ("nccl" if dev.type == "cuda" else "gloo")
          and calls_and_bytes(got["decode"]["collectives"]) == none
          and got["prefill"]["launches"] == cfg_launches
          and not any(got["decode"]["launches"].values()))
    if not ok:
        raise AssertionError(f"serve_ranks (a): {out}")
    return out, got["prefill"]["launches"]["flash_attention"]


def prefill_launches_of(run) -> dict:
    from repro_torch import configs

    return prefill_launches(configs.cut_depth(configs.base_config(run.arch), run.layers or None))


def serve_ranks_phase(dev) -> dict:
    """Phase ``serve_ranks``: the ``Server`` over a (data, model) mesh of
    ranks (:func:`serve_ranks_plan`). (a) one NCCL rank against the
    one-card server, bitwise (:func:`serve_ranks_one`); then this process's
    one-card runs of the other runs (the decode_32k one's whole cache freed
    before the ranks start), and (b) the (2, 1) and (c) the (1, 2) mesh of
    two ranks sharing the card over gloo, one launch each
    (``launch.distributed``'s ``serve`` workload with a plan), every rank
    held to them (:func:`serve_rank_hold`; the runs on each mesh:
    :func:`serve_ranks_entries`). On (c) qwen2-0.5b is split
    tensor-parallel over the two model ranks: each holds its TP blocks,
    runs kernel 3 on 7 of the 14 heads in every prefill layer, and each
    run's 8 × 2,048 prefill (c′) is timed against one process's; mamba2-370m
    is split by SSM heads, kernel 4 on 16 of the 32 heads in every prefill
    layer of both ranks. The figures of the full-depth bf16 runs are the
    phase's performance ones."""
    import tempfile

    from repro_torch.launch.distributed import serve_run

    plan = serve_ranks_plan()
    torch.cuda.empty_cache()  # the one-process decode_32k run needs most of the card
    a_want = serve_run(plan["a"], dev)
    out = {"a": None}
    out["a"], launched_flash = serve_ranks_one(dev, plan["a"], a_want)
    del a_want
    launched = {"flash_attention": launched_flash, "ssd_scan": 0}
    wants = {}
    for name in [n for n in plan if n != "a"]:
        wants[name] = serve_run(plan[name], dev)
        torch.cuda.empty_cache()
    out["one_process"] = {name: serve_costs(w, plan[name]) for name, w in wants.items()}
    # one launch runs every mesh's runs (a launched rank is slow to reach
    # its group)
    entries = serve_ranks_entries(plan)
    fp32 = {name: fp32_yardstick(plan[name], dev) for part, name in entries
            if name in SERVE_RANKS_DEEP and SERVE_RANKS_MESHES[part][1] > 1}  # the splits
    with tempfile.TemporaryDirectory() as tmp:
        plan_file = Path(tmp) / "plan.json"
        plan_file.write_text(json.dumps([
            dataclasses.asdict(dataclasses.replace(plan[name], model=SERVE_RANKS_MESHES[part][1]))
            for part, name in entries]))
        t0 = time.perf_counter()
        launch(["--procs", 2, "--workload", "serve", "--device", "cuda", "--plan", plan_file,
                "--out", Path(tmp) / "serve"], timeout=SERVE_RANKS_TIMEOUT)
        out["launch_s"] = time.perf_counter() - t0
        ranks = [torch.load(Path(tmp) / f"serve.rank{r}.pt", weights_only=False)
                 for r in range(2)]
    failed = [("backend", ranks[0]["backend"])] if ranks[0]["backend"] != "gloo" else []
    for i, (part, name) in enumerate(entries):
        sizes, run = SERVE_RANKS_MESHES[part], plan[name]
        per_rank = []
        for rank in ranks:
            got = rank["runs"][i]
            held, ok = serve_rank_hold(run, got, wants[name], sizes, got["coordinates"],
                                       "all-reduce" if dev.type == "cuda" else "all-gather",
                                       name in SERVE_RANKS_DEEP, fp32.get(name))
            if name in SERVE_RANKS_MOE:
                if whole_groups(run, sizes):  # its rows' prefill routes as one process's rows
                    held["prefill_bitwise_one_process_rows"] = prefill_bitwise(
                        got["prefill"], moe_rows_prefill(run, dev, sizes, got["coordinates"]))
                    ok = ok and held["prefill_bitwise_one_process_rows"]
            elif name in SERVE_RANKS_DEEP and sizes[1] == 1:
                held["decode_bitwise_one_process_rows"] = rows_bitwise(
                    got["decode"], one_process_rows(run, dev, sizes, got["coordinates"]))
                ok = ok and held["decode_bitwise_one_process_rows"]
            per_rank.append({"coordinates": got["coordinates"], **serve_costs(got, run),
                             "prefill_ms_over_one_process": (got["prefill"]["ms"]
                                                             / wants[name]["prefill"]["ms"]),
                             **held})
            ok = ok and got["mesh"] == dict(zip(("data", "model"), sizes))
            if not ok:
                failed.append((part, name, got["coordinates"]))
            for k in launched:
                launched[k] += got["prefill"]["launches"][k]
        out.setdefault(part, {"mesh": sizes})[name] = {
            "run": dataclasses.asdict(run), "tolerance": SERVE_RANKS_TOL[run.dtype],
            "ranks": per_rank}
        if name in SERVE_RANKS_MOE:
            gots = [rank["runs"][i] for rank in ranks]
            routing, ok = moe_routes_hold(run, gots, wants[name], name == "moe_cut")
            out[part][name]["routing"] = routing
            if not ok:
                failed.append((part, name, "routing"))
    emit("serve_ranks", card=nvidia_smi(), steps=SERVE_RANKS_STEPS, **out)
    if failed:
        raise AssertionError(f"serve_ranks: holds failed on {failed}")
    counts = {name: 0 for name in kernel_counters()}
    counts.update(launched)
    return counts


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


def lm_kernel_entry(name, source, replaces, launches_by_phase, errs, times, cases) -> dict:
    """The ``kernels`` line's entry of a serving kernel: the times at the
    first serving prefill's shape, its other shapes' beside them;
    ``launches`` sums the serving phases' counts, each read on its own;
    ``cases`` are its check cases (the dtype is the 7th field)."""
    big = times["prefill_2k"]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sum(launches_by_phase.values()),
        "launches_by_phase": launches_by_phase,
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
        **{shape: t for shape, t in times.items() if shape != "prefill_2k"},
    }


PHASE_SECONDS: dict = {}  # each step of main's, its seconds, for the ``total`` line


def timed_phase(name, fn, *args):
    """``fn(*args)``, its seconds kept under ``name`` in PHASE_SECONDS."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    return out


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

    step = timed_phase
    errs = step("check_aircomp", check_aircomp, kernel, aircomp_fused_ref, dev)
    batch_errs = step("check_aircomp_batch", check_aircomp_batch, kernel,
                      aircomp_fused_batch_ref, aircomp_fused_ref, dev)
    times = step("time_aircomp", time_aircomp, kernel, aircomp_fused_ref, dev)
    batch_times = step("time_aircomp_batch", time_aircomp_batch, kernel,
                       aircomp_fused_batch_ref, dev)
    attn_errs = step("check_attention", check_attention, attn_kernel, flash_attention_ref, dev)
    attn_times = step("time_attention", time_attention, attn_kernel, flash_attention_ref, dev)
    ssd_errs = step("check_ssd", check_ssd, ssd_kernel, ssd_chunked_ref, dev)
    ssd_times = step("time_ssd", time_ssd, ssd_kernel, ssd_chunked_ref, dev)
    launches = step("main", main_path, dev)
    step("no_sync", no_sync, dev)
    step("parity", parity, dev)
    step("breakdown", breakdown, dev)
    lattice_launches, lattice_records = step("lattice", lattice_path, dev)
    step("diverging", diverging, dev, lattice_records)
    step("lattice_no_sync", lattice_no_sync, dev)
    step("lattice_parity", lattice_parity, dev)
    step("lattice_breakdown", lattice_breakdown, dev)
    scenario_launches, scenario_records = step("scenario_lattice", scenario_lattice, dev)
    step("scenario_diverging", scenario_diverging, dev, scenario_records)
    step("scenario_parity", scenario_parity, dev)
    quarantine_launches = step("quarantine", quarantine, dev, lattice_records, scenario_records)
    loop_launches = step("lattice_loops", lattice_loops, dev, lattice_records, scenario_records)
    obs_launches = step("obs", obs_phase, dev, lattice_records)
    checkpoint_launches = step("checkpoint", checkpoint_phase, dev, lattice_records,
                               scenario_records)
    mesh_launches = step("mesh", mesh_phase, dev)
    serve_launches = step("serve", serving, dev, SERVE_ARCH, "serve", PARITY_BATCH,
                          PARITY_PROMPT)
    ssm_launches = step("ssm_serve", serving, dev, SSM_ARCH, "ssm_serve", SSM_PARITY_BATCH,
                        SSM_PARITY_PROMPT)
    hybrid_layers, hybrid_batch, hybrid_prompt = HYBRID_PARITY
    hybrid_launches = step("hybrid_serve", serving, dev, HYBRID_ARCH, "hybrid_serve",
                           hybrid_batch, hybrid_prompt, hybrid_layers)
    moe_layers, moe_batch, moe_prompt = MOE_PARITY
    moe_launches = step("moe_serve", serving, dev, MOE_ARCH, "moe_serve", moe_batch,
                        moe_prompt, moe_layers)
    encdec_launches = step("encdec_serve", serving, dev, ENCDEC_ARCH, "encdec_serve",
                           *ENCDEC_PARITY[1:3], ENCDEC_PARITY[0], ENCDEC_PARITY[3])
    vlm_launches = step("vlm_serve", serving, dev, VLM_ARCH, "vlm_serve", *VLM_PARITY[1:3],
                        VLM_PARITY[0], VLM_PARITY[3])
    train_grads_launches = step("train_grads", train_grads, dev)
    train_parity_launches = step("train_parity", train_parity, dev)
    train_launches = step("train", train_phase, dev)
    ranks_launches = step("train_ranks", train_ranks_phase, dev)
    serve_ranks_launches = step("serve_ranks", serve_ranks_phase, dev)
    emit("total", seconds=time.perf_counter() - t_start, phase_seconds=PHASE_SECONDS)

    print(json.dumps({"kernels": [
        kernel_entry("aircomp_fused", "src/repro/kernels/aircomp/kernel.py:132",
                     {"main": launches["aircomp_fused"],
                      "scenario_lattice": scenario_launches["aircomp_fused"],
                      "quarantine": quarantine_launches["aircomp_fused"],
                      "lattice_loops": loop_launches["aircomp_fused"],
                      "obs": obs_launches["aircomp_fused"],
                      "checkpoint": checkpoint_launches["aircomp_fused"],
                      "mesh": mesh_launches["aircomp_fused"]},
                     errs, times),
        kernel_entry("aircomp_fused_batch", "src/repro/kernels/aircomp/kernel.py:82",
                     {"lattice": lattice_launches["aircomp_fused_batch"],
                      "scenario_lattice": scenario_launches["aircomp_fused_batch"],
                      "quarantine": quarantine_launches["aircomp_fused_batch"],
                      "lattice_loops": loop_launches["aircomp_fused_batch"],
                      "obs": obs_launches["aircomp_fused_batch"],
                      "checkpoint": checkpoint_launches["aircomp_fused_batch"],
                      "mesh": mesh_launches["aircomp_fused_batch"]},
                     batch_errs, batch_times),
        lm_kernel_entry("flash_attention",
                        "src/repro_torch/kernels/attention/csrc/flash_attention.cu",
                        "src/repro/kernels/attention/kernel.py:103",
                        {"serve": serve_launches["flash_attention"],
                         "hybrid_serve": hybrid_launches["flash_attention"],
                         "moe_serve": moe_launches["flash_attention"],
                         "encdec_serve": encdec_launches["flash_attention"],
                         "vlm_serve": vlm_launches["flash_attention"],
                         "train_grads": train_grads_launches["flash_attention"],
                         "train_parity": train_parity_launches["flash_attention"],
                         "train": train_launches["flash_attention"],
                         "train_ranks": ranks_launches["flash_attention"],
                         "serve_ranks": serve_ranks_launches["flash_attention"]},
                        attn_errs, attn_times, ATTN_CASES),
        lm_kernel_entry("ssd_scan", "src/repro_torch/kernels/ssd/csrc/ssd.cu",
                        "src/repro/kernels/ssd/kernel.py:65",
                        {"ssm_serve": ssm_launches["ssd_scan"],
                         "hybrid_serve": hybrid_launches["ssd_scan"],
                         "train_grads": train_grads_launches["ssd_scan"],
                         "train_parity": train_parity_launches["ssd_scan"],
                         "train": train_launches["ssd_scan"],
                         "train_ranks": ranks_launches["ssd_scan"],
                         "serve_ranks": serve_ranks_launches["ssd_scan"]},
                        ssd_errs, ssd_times, SSD_CASES),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
