"""Inputs of the flash kernel's checks, shared by ``chip_smoke.py`` and the
card tests (``tests/test_torch_cuda.py``): one list of cases, one maker.

Tolerances against the plain version on the same inputs: fp32 within
``1e-5·max(1, max|ref|)`` (sum order). bf16 is held element by element
against the plain version run in fp32 on the same bf16 inputs:
``|got − ref| ≤ 2^-8·|ref| + 1e-5``. Both sides see the same inputs and
accumulate in fp32, so they differ by one bf16 rounding of the output plus
the fp32 sum order. bf16 keeps 8 significant bits, so one rounding moves a
value by at most ``2^-8`` of itself (half a unit in the last place at the
bottom of a binade); the 1e-5 covers the fp32 difference before rounding,
which stays below 5e-7 in the fp32 cases.
"""
from __future__ import annotations

import torch

TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 2.0**-8}
BF16_ABS = 1e-5  # the bf16 limit's absolute part: the fp32 difference

# name: (b, sq, sk, h, kv, dh, dtype, causal, sliding_window, q_offset, strided).
# The qwen2-0.5b prefill shape in both types, ragged sq/sk, GQA 7:1 and
# 1:1, dh 32, 80 (Zamba2's shared block) and 128 (phi4-mini, qwen2.5), a
# sliding window, non-causal, a q_offset tail with sq < sk, rows that see no
# key (a negative offset: they must give 0), and q, k, v as strided views of
# one fused projection. bf16 runs another kernel (tensor cores) than fp32
# (CUDA cores), so each feature has a bf16 twin (``*_bf16``); there dh is
# padded with zeros to 64, 80 or 128, so dh 32 and 40 pad into the 64 tile
# and dh 112 into the 128 one.
CHECK_CASES = {
    "prefill_bf16": (8, 2048, 2048, 14, 2, 64, torch.bfloat16, True, None, 0, False),
    "prefill_fp32": (8, 2048, 2048, 14, 2, 64, torch.float32, True, None, 0, False),
    "ragged": (2, 1000, 1000, 14, 2, 64, torch.float32, True, None, 0, False),
    "ragged_bf16": (3, 77, 77, 14, 2, 64, torch.bfloat16, True, None, 0, False),
    "gqa_1_1": (2, 256, 256, 8, 8, 64, torch.float32, True, None, 0, False),
    "dh_32": (1, 130, 130, 4, 2, 32, torch.float32, True, None, 0, False),
    "dh_80": (2, 300, 300, 32, 32, 80, torch.float32, True, None, 0, False),
    "dh_128": (2, 257, 257, 24, 8, 128, torch.float32, True, None, 0, False),
    "dh_128_bf16": (2, 512, 512, 24, 8, 128, torch.bfloat16, True, None, 0, False),
    "window": (2, 1024, 1024, 14, 2, 64, torch.float32, True, 200, 0, False),
    "non_causal": (2, 200, 333, 14, 2, 64, torch.float32, False, None, 0, False),
    "q_offset_tail": (2, 100, 1000, 14, 2, 64, torch.float32, True, None, 900, False),
    "rows_see_no_key": (2, 200, 200, 14, 2, 64, torch.float32, True, None, -50, False),
    "strided_views": (2, 300, 300, 14, 2, 64, torch.float32, True, None, 0, True),
    "gqa_1_1_bf16": (2, 256, 256, 8, 8, 64, torch.bfloat16, True, None, 0, False),
    "dh_32_bf16": (1, 130, 130, 4, 2, 32, torch.bfloat16, True, None, 0, False),
    "dh_40_bf16": (2, 200, 200, 8, 2, 40, torch.bfloat16, True, None, 0, False),
    "dh_80_bf16": (2, 300, 300, 32, 32, 80, torch.bfloat16, True, None, 0, False),
    "window_bf16": (2, 1024, 1024, 14, 2, 64, torch.bfloat16, True, 200, 0, False),
    "non_causal_bf16": (2, 200, 333, 14, 2, 64, torch.bfloat16, False, None, 0, False),
    "q_offset_tail_bf16": (2, 100, 1000, 14, 2, 64, torch.bfloat16, True, None, 900, False),
    "rows_see_no_key_bf16": (2, 200, 200, 14, 2, 64, torch.bfloat16, True, None, -50, False),
    "strided_views_bf16": (2, 300, 300, 14, 2, 64, torch.bfloat16, True, None, 0, True),
    "dh_112_bf16": (1, 150, 150, 4, 4, 112, torch.bfloat16, True, None, 0, False),
    # the serving prefills of zamba2-2.7b's shared block (32 heads of 80,
    # MHA) and of olmoe-1b-7b (16 heads of 128, MHA)
    "zamba2_prefill_bf16": (8, 2048, 2048, 32, 32, 80, torch.bfloat16, True, None, 0, False),
    "olmoe_prefill_bf16": (8, 2048, 2048, 16, 16, 128, torch.bfloat16, True, None, 0, False),
    # seamless-m4t-large-v2 (16 heads of 64, MHA): the encoder's non-causal
    # self-attention over 1,024 frames, the decoder's cross-attention to them
    # from a 256-token prompt and from the one token of a decode step; and
    # internvl2-76b's causal prefill (GQA 8:1 at dh 128), each in both types
    "seamless_encoder_bf16": (8, 1024, 1024, 16, 16, 64, torch.bfloat16, False, None, 0, False),
    "seamless_encoder_fp32": (8, 1024, 1024, 16, 16, 64, torch.float32, False, None, 0, False),
    "seamless_cross_prefill_bf16": (8, 256, 1024, 16, 16, 64, torch.bfloat16, False, None, 0,
                                    False),
    "seamless_cross_prefill_fp32": (8, 256, 1024, 16, 16, 64, torch.float32, False, None, 0,
                                    False),
    "seamless_cross_decode_bf16": (8, 1, 1024, 16, 16, 64, torch.bfloat16, False, None, 0, False),
    "seamless_cross_decode_fp32": (8, 1, 1024, 16, 16, 64, torch.float32, False, None, 0, False),
    "internvl2_prefill_bf16": (8, 2048, 2048, 64, 8, 128, torch.bfloat16, True, None, 0, False),
    "internvl2_prefill_fp32": (8, 2048, 2048, 64, 8, 128, torch.float32, True, None, 0, False),
    # qwen2-0.5b's prefill on one of two model ranks (tensor-parallel
    # serving: 7 of its 14 query heads and 1 of its 2 kv heads), and the
    # same rank's fp32 training forward (tensor-parallel training)
    "qwen2_prefill_tp2_bf16": (8, 2048, 2048, 7, 1, 64, torch.bfloat16, True, None, 0, False),
    "qwen2_train_tp2_fp32": (8, 2048, 2048, 7, 1, 64, torch.float32, True, None, 0, False),
    # olmoe-1b-7b on one of two data ranks (4 of its 8 rows): the rank's
    # prefill and its fp32 training forward
    "olmoe_prefill_dp2_bf16": (4, 2048, 2048, 16, 16, 128, torch.bfloat16, True, None, 0, False),
    "olmoe_train_dp2_fp32": (4, 2048, 2048, 16, 16, 128, torch.float32, True, None, 0, False),
}


def attention_inputs(b, sq, sk, h, kv, dh, dtype, dev, seed=0, strided=False):
    """``(q, k, v)`` drawn from a seeded generator; ``strided`` cuts them
    out of one (b, s, h + 2·kv, dh) tensor, as a fused QKV projection would."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if strided:
        if sq != sk:
            raise ValueError("strided views share one sequence length")
        qkv = torch.randn(b, sq, h + 2 * kv, dh, generator=gen, device=dev).to(dtype)
        return qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
    q = torch.randn(b, sq, h, dh, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, sk, kv, dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, sk, kv, dh, generator=gen, device=dev).to(dtype)
    return q, k, v


def check_case(name: str, kernel, ref, dev, seed: int = 0) -> tuple[float, float]:
    """Run one case through ``kernel`` and ``ref`` (the plain version, in
    fp32 on the same inputs) → (max |kernel − ref|, the largest share of its
    limit that an element uses). Raises when the output has the wrong shape,
    type or is non-finite, when the rows that see no key are not exactly 0,
    or when an element's error exceeds its limit (``TOLERANCE``)."""
    b, sq, sk, h, kv, dh, dtype, causal, window, offset, strided = CHECK_CASES[name]
    q, k, v = attention_inputs(b, sq, sk, h, kv, dh, dtype, dev, seed=seed, strided=strided)
    kw = dict(causal=causal, sliding_window=window, q_offset=offset)
    got = kernel(q, k, v, **kw)
    want = ref(q.float(), k.float(), v.float(), **kw)
    if got.shape != (b, sq, h, dh) or got.dtype != dtype or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash_attention {name}: bad shape, type or non-finite output")
    if offset < 0 and bool(got[:, :-offset].any()):
        raise AssertionError(f"flash_attention {name}: rows that see no key are not 0")
    diff = (got.float() - want).abs()
    if dtype == torch.bfloat16:
        limit = TOLERANCE[dtype] * want.abs() + BF16_ABS
    else:
        limit = torch.full_like(want, TOLERANCE[dtype] * max(1.0, want.abs().max().item()))
    share = (diff / limit).max().item()
    if share > 1.0:
        i = int((diff / limit).argmax())
        raise AssertionError(f"flash_attention {name}: error {diff.flatten()[i].item()} > "
                             f"limit {limit.flatten()[i].item()} at element {i}")
    return diff.max().item(), share
