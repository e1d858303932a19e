"""Why the bf16 flash kernel splits P into two bf16 halves, on the CPU.

The tensor-core kernel (``kernels/attention/csrc/flash_attention.cu``)
multiplies P·V on bf16 operands. Its check (``kernels/attention/cases.py``)
holds each bf16 output element to ``2^-8·|ref| + 1e-5`` against the plain
version in fp32, and one rounding of the output already takes about 0.99 of
that. Here the kernel's arithmetic is emulated in plain torch on the
inputs of the bf16 check cases: q·kᵀ on the bf16 values summed in fp32,
the online softmax over 64-key tiles in fp32 on the unscaled scores with
the scale and log2(e) entering exp2's argument, the row sum taken from the
fp32 P, then P·V with P as ``P_hi = bf16(P)`` plus
``P_lo = bf16(P − P_hi)`` (two passes, as the kernel issues them) or with P
rounded once to bf16. The split must pass ``cases.check_case`` unchanged;
a single rounding must not: the check is what keeps the split.

Also here: the wrapper's alignment rule for the bf16 kernel (16-byte
starts, strides in multiples of 8 elements), which every bf16 case meets.
"""
from __future__ import annotations

import math

import pytest
import torch

from repro_torch.kernels.attention import kernel as attn_kernel
from repro_torch.kernels.attention.cases import CHECK_CASES, attention_inputs, check_case
from repro_torch.kernels.attention.ref import NEG_INF, attention_scores_mask, flash_attention_ref

TILE = 64  # keys of the kernel's kv tile


def emulate_bf16_kernel(q, k, v, *, causal=True, sliding_window=None, q_offset=0,
                        split=True):
    """The bf16 kernel's arithmetic in plain fp32 torch → (b, sq, h, dh) bf16."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, kv, h // kv, dh)
    s_all = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float())
    scale_log2e = torch.tensor(1.0 / math.sqrt(dh) * math.log2(math.e), dtype=torch.float32)
    mask = attention_scores_mask(sq, sk, q_offset, causal, sliding_window)
    vf = v.float()
    m = torch.full((*s_all.shape[:-1], 1), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((*s_all.shape[:-1], dh))
    for k0 in range(0, sk, TILE):
        seen = mask[:, k0:k0 + TILE]
        s = s_all[..., k0:k0 + TILE].masked_fill(~seen, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * scale_log2e)
        p = torch.exp2(s * scale_log2e - m_new * scale_log2e)  # 0 where masked: m_new is finite
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        p_hi = p.bfloat16().float()
        v_t = vf[:, k0:k0 + TILE]
        pv = torch.einsum("bgrqk,bkgd->bgrqd", p_hi, v_t)
        if split:
            p_lo = (p - p_hi).bfloat16().float()
            pv = pv + torch.einsum("bgrqk,bkgd->bgrqd", p_lo, v_t)
        acc = alpha * acc + pv
        m = m_new
    out = acc / torch.where(l > 0, l, 1.0)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).bfloat16()


# causal GQA 7:1 ragged, 1:1, dh 40 (pads to 64) and 80 (5 k-steps), a
# q_offset tail, non-causal with sq ≠ sk, and the one query of an enc-dec
# decode step's cross-attention against 1,024 frames
PRECISION_CASES = ["ragged_bf16", "gqa_1_1_bf16", "dh_40_bf16", "dh_80_bf16",
                   "q_offset_tail_bf16", "non_causal_bf16", "seamless_cross_decode_bf16"]


def _seed(name):
    return list(CHECK_CASES).index(name)  # the seed chip_smoke.py and the card tests use


@pytest.mark.parametrize("case", PRECISION_CASES)
def test_split_p_passes_the_unchanged_bf16_check(case):
    _, share = check_case(case, emulate_bf16_kernel, flash_attention_ref, "cpu",
                          seed=_seed(case))
    assert share <= 1.0


@pytest.mark.parametrize("case", PRECISION_CASES)
def test_single_bf16_p_fails_the_bf16_check(case):
    def single(q, k, v, **kw):
        return emulate_bf16_kernel(q, k, v, split=False, **kw)

    with pytest.raises(AssertionError, match="> limit"):
        check_case(case, single, flash_attention_ref, "cpu", seed=_seed(case))


def test_rows_that_see_no_key_give_exactly_zero_under_the_split():
    _, share = check_case("rows_see_no_key_bf16", emulate_bf16_kernel, flash_attention_ref,
                          "cpu", seed=_seed("rows_see_no_key_bf16"))
    assert share <= 1.0


@pytest.mark.parametrize(
    "case", [name for name, c in CHECK_CASES.items() if c[6] == torch.bfloat16])
def test_every_bf16_case_meets_the_kernels_alignment(case):
    b, sq, sk, h, kv, dh, dtype, _, _, _, strided = CHECK_CASES[case]
    if b * max(sq, sk) * (h + 2 * kv) * dh > 2**24:  # the 2k prefill: contiguous all the same
        b = 1
    for x in attention_inputs(b, sq, sk, h, kv, dh, dtype, "cpu", strided=strided):
        assert attn_kernel.cp_async_aligned(x)


def test_misaligned_bf16_views_are_not_aligned():
    flat = torch.zeros(16 * 4 * 64 + 8, dtype=torch.bfloat16)
    assert attn_kernel.cp_async_aligned(flat[:16 * 4 * 64].view(1, 16, 4, 64))
    assert not attn_kernel.cp_async_aligned(flat[1:16 * 4 * 64 + 1].view(1, 16, 4, 64))
    padded = torch.zeros(1, 16, 4, 68, dtype=torch.bfloat16)[..., :64]  # head stride 68
    assert not attn_kernel.cp_async_aligned(padded)
