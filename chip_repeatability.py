#!/usr/bin/env python3
"""How far two runs of the port's CNN lattices repeat on one CUDA card.

    python3 chip_repeatability.py [scopes]

With TF32 off, as in ``chip_smoke.py``:

  repeat     the CNN scenario lattice (``chip_smoke.py``'s
             ``scenario_lattice``: 24 cells, K = 2, 6 rounds) and the CNN
             lattice (phase ``lattice``: 15 cells, 10 rounds), each run twice
             as the port runs by default (its local update's gradients under
             cuDNN's deterministic algorithms) and twice with the
             deterministic algorithms for the whole run
             (``torch.backends.cudnn.deterministic``), and the scenario
             lattice once more under ``on_nonfinite="skip"`` in each mode
  loop       the scenario lattice's per-algorithm loop
             (``fuse_algorithms=False``) against the fused grid, 3 rounds, in
             deterministic mode, and FedAvg alone (its static dispatch)
             against the fused grid's FedAvg cells

  scopes     (alone with ``scopes``) which operation makes two runs differ:
             the ops ``torch.use_deterministic_algorithms(True,
             warn_only=True)`` warns of over one round of each CNN lattice,
             then two 3-round runs of each CNN lattice with cuDNN's
             deterministic algorithms on in one scope only (the convolution's
             forward, its data gradient, its weight gradient, its whole
             backward, the local update's gradients: the port's default, the
             whole run), and the cost of the port's default, the backward
             alone and the whole run against cuDNN's default algorithms
             everywhere, in alternating turns: the CNN lattice, the CNN
             scenario lattice and ``run_pofl`` CNN

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
import time

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


def scoped_conv(where: frozenset):
    """The CNN's 3×3 convolution + ReLU with cuDNN's deterministic
    algorithms on only in the passes named in ``where`` (``forward``,
    ``data``: the input gradient, ``weight``: the weight gradient)."""
    import torch.nn.functional as F

    def det(name):
        return smoke.cudnn_deterministic() if name in where else contextlib.nullcontext()

    class Conv(torch.autograd.Function):
        generate_vmap_rule = True

        @staticmethod
        def forward(x, w):
            with det("forward"):
                return F.conv2d(x, w, padding=1)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(*inputs)

        @staticmethod
        def backward(ctx, gy):
            x, w = ctx.saved_tensors
            args = (gy, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1)
            with det("data"):
                gx = torch.ops.aten.convolution_backward(*args, (True, False, False))[0]
            with det("weight"):
                gw = torch.ops.aten.convolution_backward(*args, (False, True, False))[1]
            return gx, gw

    def conv(x, p):
        return F.relu(Conv.apply(x, p["w"].permute(3, 2, 0, 1)) + p["b"][:, None, None])

    return conv


@contextlib.contextmanager
def scope(name: str):
    """cuDNN's deterministic algorithms in the scope ``name`` only:
    ``local_update`` is the port as it is (its local update's gradients in
    that mode); every other scope turns that off first, so ``default`` is
    cuDNN's default algorithms everywhere and ``split`` the same with the
    backward as the two calls the pass scopes make it."""
    from repro_torch.core import local_update
    from repro_torch.models import small

    passes = {"split": (), "forward": ("forward",), "data_grad": ("data",),
              "weight_grad": ("weight",), "backward": ("data", "weight")}
    conv, scoped = small._conv, local_update.cudnn_deterministic
    if name != "local_update":
        local_update.cudnn_deterministic = lambda device: contextlib.nullcontext()
    if name in passes:
        small._conv = scoped_conv(frozenset(passes[name]))
    try:
        with smoke.cudnn_deterministic() if name == "run" else contextlib.nullcontext():
            yield
    finally:
        small._conv, local_update.cudnn_deterministic = conv, scoped


def scopes(lattices, dev) -> None:
    """The ``scopes`` lines (module docstring)."""
    import warnings

    from repro_torch.core.pofl import POFLConfig, run_pofl

    for name, (task, spec, cfg, kw) in lattices.items():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                smoke.timed_lattice(task, dataclasses.replace(spec, n_rounds=1), cfg, **kw)
            finally:
                torch.use_deterministic_algorithms(False)
        smoke.emit("scopes_warnings", lattice=name,
                   warnings=sorted({str(w.message).split("\n")[0] for w in caught}))
    three = {name: (task, dataclasses.replace(spec, n_rounds=3), cfg, kw)
             for name, (task, spec, cfg, kw) in lattices.items()}
    for where in ("default", "split", "forward", "data_grad", "weight_grad", "backward",
                  "local_update", "run"):
        out = {}
        for name, (task, spec, cfg, kw) in three.items():
            with scope(where):
                a, _ = smoke.timed_lattice(task, spec, cfg, **kw)
                b, _ = smoke.timed_lattice(task, spec, cfg, **kw)
            out[name] = compare(b, a, spec)
        smoke.emit("scopes_repeat", scope=where, rounds=3,
                   bitwise={k: v["max_rel_diff"] == 0.0 for k, v in out.items()}, **out)

    cnn = lattices["cnn_lattice"][0]
    pofl_cfg = POFLConfig(n_devices=smoke.N_DEVICES, n_scheduled=smoke.N_SCHEDULED,
                          noise_power=1e-10, backend="pallas_fused")

    def pofl_run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_pofl(cnn.loss_fn, cnn.params0, cnn.data, pofl_cfg, smoke.CNN_ROUNDS)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    modes = ("default", "local_update", "backward", "run")
    rates = {m: {"cnn_lattice": [], "cnn_scenario_lattice": [], "run_pofl_cnn": []}
             for m in modes}
    for turn in range(4):
        for m in modes if turn % 2 == 0 else modes[::-1]:
            with scope(m):
                for name, (task, spec, cfg, kw) in lattices.items():
                    _, sec = smoke.timed_lattice(task, spec, cfg, **kw)
                    rates[m][name].append(spec.n_cells * spec.n_rounds / sec)
                rates[m]["run_pofl_cnn"].append(smoke.CNN_ROUNDS / pofl_run())
    smoke.emit("scopes_cost", turns=4, order="alternating", units={
        "cnn_lattice": "cell-rounds/s", "cnn_scenario_lattice": "cell-rounds/s",
        "run_pofl_cnn": "rounds/s"}, rates=rates,
        median_vs_default={m: {k: float(np.median(v) / np.median(rates["default"][k]))
                               for k, v in r.items()} for m, r in rates.items()})


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
    if sys.argv[1:] == ["scopes"]:
        scopes(lattices, dev)
        return 0
    for name, (task, spec, cfg, kw) in lattices.items():
        skip = name == "cnn_scenario_lattice"
        for mode in ("port_default", "deterministic"):
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
