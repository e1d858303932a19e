"""Inputs of the SSD kernel's checks, shared by ``chip_smoke.py`` and the
card tests (``tests/test_torch_cuda.py``): one list of cases, one maker.

Tolerances against the plain version run in fp32 on the same inputs:
fp32 within ``1e-5·max(1, max|ref|)`` (sum order), the rule of kernels
1–3. bf16 element by element within ``2^-8·|ref| + 1e-5·max(1, max|ref|)``:
both sides accumulate in fp32 and the kernel rounds y to bf16 once, and one
rounding to bf16's 8 significant bits moves a value by at most 2^-8 of
itself. The fp32 limit needs both sides to form La = cumsum(la) bitwise
alike: one ulp of |La| ≈ 400 (a chunk of 256 at the reference test's
decays) is 3e-5 of a decay weight. The kernels add in the plain version's
order, the reference's (``ref.py::cumsum``: XLA's blocks of 16;
``csrc/ssd.cu``).
"""
from __future__ import annotations

import torch

TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2.0**-8}
ABS = 1e-5  # × max(1, max|ref|): the fp32 difference before the bf16 rounding

# decay ranges of la: -uniform(lo, hi). "ref" is the reference test's
# (tests/test_kernels.py:128), "near_0" barely decays, "strong" underflows
# exp(La) within a few rows.
DECAYS = {"ref": (0.01, 3.0), "near_0": (0.0, 0.01), "strong": (19.0, 21.0)}

# name: (b, s, h, p, n, chunk, dtype, decay, strided). The mamba2-370m
# prefill in both types (one layer's call), chunk 16, 64 and 256, one chunk
# and many, h 1, 3, 32 and 80, n 16, 64 and 128, p 32 and 64 (and 48, padded), a
# chunk that is no multiple of the 64-row tile, the three decay ranges, and
# B and C as strided slices of one fused projection, as the model passes them.
# The bf16 twins of the fp32 feature cases (appended, so every earlier case
# keeps its seed, its index here) hold the tensor-core path to the same
# features, plus batch 1 over 16 chunks and the full width at two chunks.
CHECK_CASES = {
    "serving_bf16": (8, 2048, 32, 64, 128, 256, torch.bfloat16, "ref", True),
    "serving_fp32": (8, 2048, 32, 64, 128, 256, torch.float32, "ref", True),
    "one_chunk": (2, 256, 3, 64, 128, 256, torch.float32, "ref", False),
    "chunk_16": (2, 128, 3, 32, 16, 16, torch.float32, "ref", False),
    "chunk_64": (2, 512, 32, 64, 128, 64, torch.float32, "ref", False),
    "h_1": (2, 768, 1, 64, 128, 256, torch.float32, "ref", False),
    "n_16_p_32": (3, 512, 8, 32, 16, 256, torch.float32, "ref", False),
    "p_48_chunk_100": (2, 400, 3, 48, 128, 100, torch.float32, "ref", True),
    "near_0": (2, 1024, 4, 64, 128, 256, torch.float32, "near_0", False),
    "strong_decay": (2, 512, 4, 64, 128, 256, torch.float32, "strong", False),
    "small_bf16": (2, 256, 3, 32, 16, 64, torch.bfloat16, "ref", False),
    "chunk_16_bf16": (2, 128, 3, 32, 16, 16, torch.bfloat16, "ref", False),
    "chunk_64_bf16": (2, 512, 32, 64, 128, 64, torch.bfloat16, "ref", False),
    "p_48_chunk_100_bf16": (2, 400, 3, 48, 128, 100, torch.bfloat16, "ref", True),
    "h_1_bf16": (2, 768, 1, 64, 128, 256, torch.bfloat16, "ref", False),
    "near_0_bf16": (2, 1024, 4, 64, 128, 256, torch.bfloat16, "near_0", False),
    "strong_decay_bf16": (2, 512, 4, 64, 128, 256, torch.bfloat16, "strong", False),
    "batch_1_16_chunks_bf16": (1, 4096, 2, 64, 128, 256, torch.bfloat16, "ref", False),
    "full_width_bf16": (1, 512, 32, 64, 128, 256, torch.bfloat16, "ref", True),
    # zamba2-2.7b: d_state 64, 80 heads (10 groups of 8 in the bf16 outputs
    # stage): its serving prefill's call, a small n 64 case in both types,
    # and its fp32 parity prefill's call
    "zamba2_serving_bf16": (8, 2048, 80, 64, 64, 256, torch.bfloat16, "ref", True),
    "n_64": (2, 512, 5, 64, 64, 256, torch.float32, "ref", True),
    "n_64_bf16": (2, 512, 5, 64, 64, 256, torch.bfloat16, "ref", True),
    "zamba2_parity_fp32": (2, 256, 80, 64, 64, 256, torch.float32, "ref", True),
    # mamba2-370m split over two model ranks: a rank's 16 of 32 heads in its
    # serving prefill (bf16) and its fp32 run's
    "mamba2_prefill_tp2_bf16": (8, 2048, 16, 64, 128, 256, torch.bfloat16, "ref", True),
    "mamba2_prefill_tp2_fp32": (8, 2048, 16, 64, 128, 256, torch.float32, "ref", True),
}


def ssd_inputs(b, s, h, p, n, dtype, dev, decay="ref", seed=0, strided=False):
    """``(xdt, la, B, C)`` drawn from a seeded generator: xdt, B and C
    standard normal in ``dtype``, la = -uniform(DECAYS[decay]) in fp32;
    ``strided`` cuts B and C out of one (b, s, h·p + 2n) tensor."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = DECAYS[decay]
    xdt = torch.randn(b, s, h, p, generator=gen, device=dev).to(dtype)
    la = -(lo + (hi - lo) * torch.rand(b, s, h, generator=gen, device=dev))
    if strided:
        fused = torch.randn(b, s, h * p + 2 * n, generator=gen, device=dev).to(dtype)
        B, C = fused[..., h * p:h * p + n], fused[..., h * p + n:]
    else:
        B = torch.randn(b, s, n, generator=gen, device=dev).to(dtype)
        C = torch.randn(b, s, n, generator=gen, device=dev).to(dtype)
    return xdt, la, B, C


def check_case(name: str, kernel, ref, dev, seed: int = 0) -> tuple[float, float]:
    """Run one case through ``kernel`` and ``ref`` (the plain version, in
    fp32 on the same inputs) → (max |kernel − ref|, the largest share of its
    limit that an element uses). Raises when the output has the wrong shape,
    type or is non-finite, or when an element's error exceeds its limit."""
    b, s, h, p, n, chunk, dtype, decay, strided = CHECK_CASES[name]
    xdt, la, B, C = ssd_inputs(b, s, h, p, n, dtype, dev, decay, seed=seed, strided=strided)
    got = kernel(xdt, la, B, C, chunk=chunk)
    want = ref(xdt.float(), la, B.float(), C.float(), chunk)
    if got.shape != (b, s, h, p) or got.dtype != dtype or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"ssd_scan {name}: bad shape, type or non-finite output")
    diff = (got.float() - want).abs()
    floor = ABS * max(1.0, want.abs().max().item())
    if dtype == torch.bfloat16:
        limit = TOLERANCE[dtype] * want.abs() + floor
    else:
        limit = torch.full_like(want, TOLERANCE[dtype] * max(1.0, want.abs().max().item()))
    share = (diff / limit).max().item()
    if share > 1.0:
        i = int((diff / limit).argmax())
        raise AssertionError(f"ssd_scan {name}: error {diff.flatten()[i].item()} > "
                             f"limit {limit.flatten()[i].item()} at element {i}")
    return diff.max().item(), share
