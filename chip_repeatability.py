#!/usr/bin/env python3
"""How far two runs of the port's CNN lattices repeat on one CUDA card.

    python3 chip_repeatability.py

With TF32 off, as in ``chip_smoke.py``:

  repeat     the CNN scenario lattice (``chip_smoke.py``'s
             ``scenario_lattice``: 24 cells, K = 2, 6 rounds) and the CNN
             lattice (phase ``lattice``: 15 cells, 10 rounds), each run twice
             with cuDNN's default algorithms and twice with its
             deterministic ones (``torch.backends.cudnn.deterministic``),
             and the scenario lattice once more under
             ``on_nonfinite="skip"`` in each mode
  loop       the scenario lattice's per-algorithm loop
             (``fuse_algorithms=False``) against the fused grid, 3 rounds, in
             deterministic mode, and FedAvg alone (its static dispatch)
             against the fused grid's FedAvg cells

Each line gives the cell-rounds/s of its runs and, between two runs, over
the cells finite in both: the largest relative difference (each field of
each cell against its largest value), by field and by round, and each
cell's first round that differs. It checks nothing; without a card it exits
non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys

import numpy as np
import torch

import chip_smoke as smoke


def compare(got, want, spec) -> dict:
    """Two ``LatticeRecords`` of one spec, over the cells finite in both."""
    got_f, want_f = smoke.record_rounds(got), smoke.record_rounds(want)
    cells = [c for c in np.ndindex(want.e_com.shape[:-1])
             if not smoke.nonfinite_rounds(want_f, c) and not smoke.nonfinite_rounds(got_f, c)]
    diff, by_field = smoke.max_rel_diff(got_f, want_f, cells)
    per_round = np.zeros(want.e_com.shape[-1])
    first = {}
    for c in cells:
        for f in ("e_com", "e_var", "grad_norm"):
            g, w = getattr(got, f)[c], getattr(want, f)[c]
            per_round = np.maximum(per_round, np.abs(g - w) / max(np.abs(w).max(), 1e-30))
        differs = [t for t in range(want.e_com.shape[-1]) if any(
            getattr(got, f)[c][t] != getattr(want, f)[c][t]
            for f in ("e_com", "e_var", "grad_norm", "n_scheduled"))]
        first[smoke.cell_name(spec, c)] = differs[0] if differs else None
    return {"finite_cells": len(cells), "max_rel_diff": diff, "by_field": by_field,
            "by_round": per_round.tolist(), "first_round_that_differs": first}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_repeatability: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.kernels.aircomp import kernel
    from repro_torch.sim.lattice import LatticeSpec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernel.build()
    smoke.emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smoke.nvidia_smi())
    scenario = dict(zip(("scenario", "scenario_params"), smoke.SCENARIO))
    noises, rounds, every = smoke.LATTICES["cnn"]
    lattices = {
        "cnn_scenario_lattice": (smoke.scenario_cnn_task(dev), smoke.scenario_cnn_spec(),
                                 smoke.scenario_cnn_cfg(), scenario),
        "cnn_lattice": (smoke.lattice_tasks(dev)["cnn"],
                        LatticeSpec(policies=smoke.POLICIES, noise_powers=noises,
                                    alphas=(0.1,), seeds=smoke.LATTICE_SEEDS, n_rounds=rounds,
                                    eval_every=every),
                        smoke.lattice_cfg(), {}),
    }
    for task, spec, cfg, kw in lattices.values():  # first calls off the clock
        smoke.timed_lattice(task, dataclasses.replace(spec, n_rounds=1), cfg, **kw)
    for name, (task, spec, cfg, kw) in lattices.items():
        skip = name == "cnn_scenario_lattice"
        for mode in ("default", "deterministic"):
            with smoke.cudnn_deterministic() if mode == "deterministic" else \
                    contextlib.nullcontext():
                a, a_s = smoke.timed_lattice(task, spec, cfg, **kw)
                b, b_s = smoke.timed_lattice(task, spec, cfg, **kw)
                runs = {"a": a_s, "b": b_s}
                out = {"b_against_a": compare(b, a, spec)}
                if skip:
                    c, runs["skip"] = smoke.timed_lattice(
                        task, spec, dataclasses.replace(cfg, on_nonfinite="skip"), **kw)
                    out["skip_against_a"] = compare(c, a, spec)
            smoke.emit("repeat", lattice=name, cudnn=mode, cells=spec.n_cells,
                       rounds=spec.n_rounds,
                       cell_rounds_per_s={k: spec.n_cells * spec.n_rounds / v
                                          for k, v in runs.items()}, **out)

    task, spec, cfg, kw = lattices["cnn_scenario_lattice"]
    spec = dataclasses.replace(spec, n_rounds=smoke.LOOP_ROUNDS)
    one = dataclasses.replace(spec, algorithms=("fedavg",))
    with smoke.cudnn_deterministic():
        fused, _ = smoke.timed_lattice(task, spec, cfg, **kw)
        loop, _ = smoke.timed_lattice(task, spec, cfg, fuse_algorithms=False, **kw)
        alone, _ = smoke.timed_lattice(task, one, cfg, **kw)
    fedavg = fused._replace(**{f: getattr(fused, f)[:1] for f in (
        "e_com", "e_var", "grad_norm", "n_scheduled", "loss", "acc")}, eval=None)
    smoke.emit("loop", lattice="cnn_scenario_lattice", cudnn="deterministic",
               rounds=spec.n_rounds, loop_against_fused=compare(loop, fused, spec),
               fedavg_alone_against_fused=compare(alone._replace(eval=None), fedavg, one))
    return 0


if __name__ == "__main__":
    sys.exit(main())
