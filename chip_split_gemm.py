#!/usr/bin/env python3
"""The row-split products of tensor-parallel serving on one CUDA card.

    PYTHONPATH=src python3 chip_split_gemm.py

qwen2-0.5b split over two model ranks multiplies, in every layer, its
block of the attention output by its rows of ``wo`` (inner dim 448 of 896)
and its block of the MLP by its rows of ``w_out`` (2,432 of 4,864), and the
group sums the two partials (``models.layers.row_split_matmul``). For
each product, at a prefill's 8 × 2,048 rows and a decode step's 128, in
bf16 from a seeded generator, with TF32 off as in ``chip_smoke.py``:

  rounding  the share of the output's elements that differ from the exact
            product (float64) rounded once to bf16: one bf16 GEMM over the
            whole inner dim (with cuBLAS's reduced-precision reduction
            allowed, and not), two partials each taken in fp32 and summed
            then rounded once (by fp32 copies of both operands, and by
            ``mm``'s ``out_dtype`` from bf16), and two bf16 partials summed
  time      ms a call (CUDA events, median of 50, L2 flushed before each)
            of one rank's partial: ``row_split_matmul`` as it runs (its
            group's sum left out), the fp32 copies and fp32 GEMM it ran
            before, and the bf16 GEMM of the same block (bf16 out); and one
            process's whole bf16 GEMM

then, a prefill's 24 layers of both products on one rank, each way. It
checks nothing; without a card it exits non-zero. One JSON line a product,
then the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

LAYERS, D_MODEL = 24, 896
PRODUCTS = {"wo": 896, "w_out": 4864}  # whole inner dim; a rank takes half
ROWS = {"prefill": 8 * 2048, "decode": 128}


def time_ms(fn, flush: torch.Tensor, reps: int = 50) -> float:
    """Median device time of one call, L2 flushed before each."""
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


def off_exact(got: torch.Tensor, exact: torch.Tensor) -> float:
    """The share of ``got``'s elements that differ from ``exact`` rounded
    once to ``got``'s type."""
    return (got != exact.to(got.dtype)).double().mean().item()


def product(name: str, k: int, rows: int, dev, flush) -> dict:
    from repro_torch.models.layers import ModelGroup, row_split_matmul

    gen = torch.Generator(device=dev).manual_seed(0)
    a = (torch.randn(rows, k, generator=gen, device=dev) * 0.5).bfloat16()
    w = (torch.randn(k, D_MODEL, generator=gen, device=dev) * k ** -0.5).bfloat16()
    h = k // 2
    blocks = [(a[:, r * h:(r + 1) * h].contiguous(), w[r * h:(r + 1) * h].contiguous())
              for r in range(2)]
    exact = a.double() @ w.double()
    mm = torch.backends.cuda.matmul
    reduced = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = True
    whole_reduced = a @ w
    mm.allow_bf16_reduced_precision_reduction = False
    whole = a @ w
    mm.allow_bf16_reduced_precision_reduction = reduced
    copies = sum(x.float() @ y.float() for x, y in blocks).bfloat16()
    accum = sum(torch.mm(x, y, out_dtype=torch.float32) for x, y in blocks).bfloat16()
    partials = blocks[0][0] @ blocks[0][1] + blocks[1][0] @ blocks[1][1]
    rounding = {"whole_bf16_reduced_allowed": off_exact(whole_reduced, exact),
                "whole_bf16": off_exact(whole, exact),
                "fp32_partials_by_copies": off_exact(copies, exact),
                "fp32_partials_by_out_dtype": off_exact(accum, exact),
                "bf16_partials_summed": off_exact(partials, exact)}
    x, y = blocks[0]
    no_sum = ModelGroup(0, 2, None, lambda t: None, None)
    times = {"row_split_matmul": time_ms(lambda: row_split_matmul(x, y, torch.bfloat16, no_sum),
                                         flush),
             "fp32_copies_then_fp32_gemm": time_ms(lambda: x.float() @ y.float(), flush),
             "bf16_gemm_of_the_block": time_ms(lambda: x @ y, flush),
             "whole_bf16_gemm_one_process": time_ms(lambda: a @ w, flush)}
    return {"product": name, "rows": rows, "inner_dim_whole": k, "inner_dim_rank": h,
            "off_exact_share": rounding, "ms": times}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_split_gemm.py: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    per_prefill = {}
    for phase, rows in ROWS.items():
        for name, k in PRODUCTS.items():
            rec = product(name, k, rows, dev, flush)
            print(json.dumps(rec), flush=True)
            if phase == "prefill":
                for way, ms in rec["ms"].items():
                    per_prefill[way] = per_prefill.get(way, 0.0) + LAYERS * ms
    print(json.dumps({"prefill_rank_ms_of_wo_and_w_out_24_layers": per_prefill}))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
