"""How far the K-step FedDyn/SCAFFOLD state of one lattice round sits from
its float64 value: on the card in fp32, on the CPU in fp32 and in bf16.

    PYTHONPATH=src python -m repro_torch.sim.precision [--out FILE]

The state carries each device's K-step drift w_K − w0 (FedDyn's h) or its
Δ (SCAFFOLD's c) unweighted. w_K − w0 is a difference of two weights that
agree to a few digits, so its fp32 error relative to its own norm is set
by |w| / |w_K − w0|, not by the card: the card's fp32 state is held to the
CPU's float64 one, at :data:`STATE_TOL`. This sweep sets that limit: over
the CNN at full width (D = 258,634), N = 30 and N = 6 devices on
Dirichlet-sized shards, every channel process and several seeds, it reads
each changed field (the FedDyn cell's h, the SCAFFOLD cell's c) of the
fp32 state on the card and on the CPU, and of a bf16 state on the CPU,
against the float64 state from the same params, rows and starting state.
One JSON line a case, then a summary line (the largest fp32 reading, the
smallest bf16 one, the limit between them) and the card's name and power
limit. TF32 is off, as ``chip_smoke.py`` and the card tests run.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.core.local_update import ALGORITHM_IDS, AlgState, local_update_stage_cells
from repro_torch.core.pofl import POFLConfig
from repro_torch.flatten_util import tree_map

# the card's fp32 K-step state against the CPU's float64 one, relative L2 of
# each changed field: near the geometric middle of the sweep's largest fp32
# reading (6.4e-4, on the card) and its smallest bf16 one (1.6e-2), about 5x
# from each (NVIDIA H100 80GB HBM3, 700 W; measured by main() below)
STATE_TOL = 3e-3
SCENARIOS = {"static_rayleigh": {}, "gauss_markov": {"corr": 0.9},
             "mobility": {"speed": 5.0},
             "dropout": {"base": "gauss_markov", "corr": 0.9, "p_drop": 0.1},
             "churn": {"p_depart": 0.3, "p_arrive": 0.3}}
SEEDS = (0, 1, 2)
DEVICE_COUNTS = (30, 6)
# {name: (cell, AlgState field)} of the fields the round changes
CHANGED = {"feddyn_h": (ALGORITHM_IDS["feddyn"], 0),
           "scaffold_c": (ALGORITHM_IDS["scaffold"], 1)}


def k_step_state(task, cfg, rows, t, alg0, dtype, device) -> AlgState:
    """The new state of one lattice round's local-update stage for the four
    algorithms (one a cell, all from ``task.params0`` and the (4, N, D)
    state ``alg0``), on ``rows`` (K, N, B) shared by the cells or (4, K, N,
    B) one a cell, computed in ``dtype`` on ``device``."""
    cells = len(ALGORITHM_IDS)
    data = task.data.to(device)
    data = data._replace(features=data.features.to(dtype))
    params = tree_map(lambda p: p.to(device, dtype).expand(cells, *p.shape).clone(),
                      task.params0)
    rows_c = rows.to(device).expand(cells, *rows.shape[-3:])
    _, state = local_update_stage_cells(
        task.loss_fn, data, cfg, params, rows_c, t,
        alg_state_c=AlgState(*(f.to(device, dtype) for f in alg0)),
        algorithm_id_c=torch.tensor(list(ALGORITHM_IDS.values()), device=device))
    return state


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖ / ‖b‖ in float64 on the CPU."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


def state_errors(got: AlgState, want: AlgState) -> dict:
    """Each changed field of ``got`` against ``want``: {field: rel L2}."""
    return {name: rel_l2(got[field][cell], want[field][cell])
            for name, (cell, field) in CHANGED.items()}


def sweep_case(n_devices, scenario, seed, card) -> dict:
    """One case of the sweep: the draws of ``scenario``'s engine at
    ``seed``, the state after round 1 from a non-zero state."""
    from repro_torch.sim.engine import FUSED_ALGORITHM, FUSED_POLICY, SimEngine
    from repro_torch.sim.tasks import make_model_task

    task = make_model_task("cnn", n_devices=n_devices, partition="dirichlet_sized", beta=0.4,
                           n_train=20 * n_devices, n_test=10, seed=seed, channel_bias=1.0,
                           device="cpu")
    cfg = POFLConfig(n_devices=n_devices, n_scheduled=min(10, n_devices // 2),
                     policy=FUSED_POLICY, local_algorithm=FUSED_ALGORITHM, local_steps=2,
                     fedprox_mu=0.1)
    engine = SimEngine(task.loss_fn, task.data, cfg, device="cpu", scenario=scenario,
                       scenario_params=SCENARIOS[scenario])
    rows = next(engine.draws(seed, task.dim)).batch_idx
    gen = torch.Generator().manual_seed(100 + seed)
    alg0 = AlgState(*(1e-3 * torch.randn(len(ALGORITHM_IDS), n_devices, task.dim,
                                         generator=gen) for _ in AlgState._fields))
    want = k_step_state(task, cfg, rows, 1, alg0, torch.float64, "cpu")
    states = {"fp32_card": k_step_state(task, cfg, rows, 1, alg0, torch.float32, card),
              "fp32_cpu": k_step_state(task, cfg, rows, 1, alg0, torch.float32, "cpu"),
              "bf16_cpu": k_step_state(task, cfg, rows, 1, alg0, torch.bfloat16, "cpu")}
    return {"n": n_devices, "scenario": scenario, "seed": seed, "d": task.dim,
            **{k: state_errors(s, want) for k, s in states.items()}}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write the lines to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("precision: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.device("cuda")
    lines = []
    for n in DEVICE_COUNTS:
        for scenario in SCENARIOS:
            for seed in SEEDS:
                lines.append(sweep_case(n, scenario, seed, card))
                print(json.dumps(lines[-1]), flush=True)
    fp32 = max(v for line in lines for k in ("fp32_card", "fp32_cpu")
               for v in line[k].values())
    bf16 = min(v for line in lines for v in line["bf16_cpu"].values())
    summary = {"cases": len(lines), "fp32_max": fp32, "bf16_min": bf16,
               "state_tol": STATE_TOL, "between": fp32 < STATE_TOL < bf16}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    lines += [summary, {"nvidia_smi": smi.strip()}]
    print(json.dumps(summary))
    print(smi.strip())
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)


if __name__ == "__main__":
    main()
