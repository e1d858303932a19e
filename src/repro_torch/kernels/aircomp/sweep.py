"""Time the aircomp kernel over its launch choices on one CUDA card.

    PYTHONPATH=src python -m repro_torch.kernels.aircomp.sweep

Kernel 1 at one CNN round (30, 258,634) and one logreg round (30, 7,850),
kernel 2 at the CNN lattice (15, 30, 258,634) and logreg's (30, 30, 7,850):
each (threads a block, rows a group) of {64, 128, 256} × {8, 16}, and the
choice of :func:`kernel.launch_geometry`, with L2 flushed before each call
by writing 256 MiB (as ``chip_smoke.py`` times) and by reading them (which
leaves no dirty lines for the call to write back), beside the launch floor
(one trivial op on a one-element tensor). CUDA events, median of 50 calls.
One JSON line a shape, then the card's name and power limit.
"""
from __future__ import annotations

import functools
import json
import statistics
import subprocess

import torch

from repro_torch.kernels.aircomp import kernel
from repro_torch.kernels.aircomp.cases import batch_inputs, round_inputs

SHAPES = {  # name: (trials, N, D, batch entry)
    "k1_cnn": (1, 30, 258_634, False), "k1_logreg": (1, 30, 7850, False),
    "k2_cnn": (15, 30, 258_634, True), "k2_logreg": (30, 30, 7850, True),
}


def _time_ms(fn, before, reps=50) -> float:
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        before()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep: no CUDA device is available")
    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    flushes = {"write": flush.zero_, "read": flush.sum}
    one = torch.zeros(1, device=dev)
    chosen = kernel.launch_geometry
    print(json.dumps({"launch_floor_ms": {
        how: _time_ms(lambda: one.add_(1.0), before) for how, before in flushes.items()}}))
    for name, (trials, n, d, batch) in SHAPES.items():
        if batch:
            call = functools.partial(kernel.aircomp_fused_batch,
                                     *batch_inputs(trials, n, d, dev, seed=7))
        else:
            call = functools.partial(kernel.aircomp_fused, *round_inputs(n, d, dev, seed=7))
        # (threads, rows) that launch_geometry picks: D = 2 (mod 4), 8-byte loads
        out = {"shape": [trials, n, d], "chosen": chosen(trials, d, 2)[:2]}
        try:
            for threads in (64, 128, 256):
                for rows in (8, 16):
                    kernel.launch_geometry = lambda t, dd, vec, th=threads, r=rows: (
                        th, r, -(-(dd // vec) // th), min(t, kernel.MAX_GRID_Y))
                    out[f"t{threads}_r{rows}"] = {
                        how: _time_ms(call, before) for how, before in flushes.items()}
        finally:
            kernel.launch_geometry = chosen
        out["chosen_ms"] = {how: _time_ms(call, before) for how, before in flushes.items()}
        print(json.dumps({name: out}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
