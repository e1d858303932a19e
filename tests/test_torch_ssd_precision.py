"""Why the bf16 SSD kernels split three operands into two bf16 halves, on the CPU.

The tensor-core path (``kernels/ssd/csrc/ssd.cu``) multiplies on bf16
operands. B, C and xdt are bf16 inputs, so C·Bᵀ is exact; three products
have an fp32 operand: w·B against xdt (the chunk states, w = exp(La_last −
La_t)), C against the state entering the chunk, and the masked, decayed
scores C·Bᵀ ⊙ exp(La_q − La_k) against xdt. The check
(``kernels/ssd/cases.py``) holds each bf16 output element to
``2^-8·|ref| + 1e-5·max(1, max|ref|)`` against the plain version in fp32,
and y's one rounding to bf16 already takes about 0.97–0.99 of that.

Here the kernels' arithmetic is emulated in plain fp32 torch on the inputs
of the bf16 check cases: La in ``ref.py::cumsum``'s order; the chunk states
from w·B and xdt, kept in fp32 (the workspace); the fp32 pass over the
chunks; then per 64-key tile of each chunk the decayed scores against xdt,
after the carried state's term. Products of bf16 values are exact in fp32
and summed in fp32, as on the tensor cores. Each fp32 operand enters either
as ``hi = bf16(v)`` plus ``lo = bf16(v − hi)`` (two passes, as the kernels
issue them) or rounded once to bf16. The split of all three must pass
``cases.check_case`` unchanged; rounding any one of them once instead must
not: the check is what keeps each split.

Also here: the wrapper's alignment rule for the bf16 path (16-byte starts,
strides in multiples of 8 elements), which every bf16 case meets, and the
size of the workspace it allocates.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd.cases import CHECK_CASES, check_case, ssd_inputs
from repro_torch.kernels.ssd.ref import cumsum, ssd_chunked_ref

TILE = 64  # rows of the kernels' q and kv tiles
SPLIT = ("w_b", "s_in", "scores")  # the fp32 operands of the three products


def _parts(v: torch.Tensor, split: bool) -> list[torch.Tensor]:
    """``v`` as the bf16 operands the kernels feed the tensor cores, in fp32."""
    hi = v.bfloat16().float()
    return [hi, (v - hi).bfloat16().float()] if split else [hi]


def emulate_bf16_kernel(xdt, la, B, C, *, chunk, split=SPLIT):
    """The bf16 kernels' arithmetic in plain fp32 torch → (b, s, h, p) bf16;
    the operands named in ``split`` go in as hi + lo, the others rounded once."""
    b, s, h, p = xdt.shape
    n, nc, q = B.shape[-1], s // chunk, chunk
    x = xdt.float().reshape(b, nc, q, h, p)
    Bc, Cc = (m.float().reshape(b, nc, q, n) for m in (B, C))
    La = cumsum(la.reshape(b, nc, q, h), dim=2)

    # stage 1: S_c = (w B)ᵀ xdt, into the fp32 workspace
    wb = Bc[..., None] * torch.exp(La[:, :, -1:, :] - La)[:, :, :, None, :]  # (b,c,q,n,h)
    s_c = sum(torch.einsum("bcqnh,bcqhp->bchnp", part, x)
              for part in _parts(wb, "w_b" in split))
    # stage 2: the state entering each chunk, in fp32
    decay = torch.exp(La[:, :, -1, :])
    carry = torch.zeros(b, h, n, p)
    s_in = []
    for c in range(nc):
        s_in.append(carry)
        carry = decay[:, c, :, None, None] * carry + s_c[:, c]
    s_in = torch.stack(s_in, dim=1)
    # stage 3: exp(La_q) C_q S_in, then each kv tile's decayed scores against xdt
    y = torch.exp(La)[..., None] * sum(torch.einsum("bcqn,bchnp->bcqhp", Cc, part)
                                       for part in _parts(s_in, "s_in" in split))
    causal = torch.tril(torch.ones(q, q, dtype=torch.bool))
    for k0 in range(0, q, TILE):
        k1 = min(q, k0 + TILE)
        scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc[:, :, k0:k1])
        diff = La[:, :, :, None, :] - La[:, :, None, k0:k1, :]
        diff = torch.where(causal[None, None, :, k0:k1, None], diff, -torch.inf)
        m = scores[..., None] * torch.exp(diff)  # (b,c,q,k,h), masked before the exp
        y = y + sum(torch.einsum("bcqkh,bckhp->bcqhp", part, x[:, :, k0:k1])
                    for part in _parts(m, "scores" in split))
    return y.reshape(b, s, h, p).bfloat16()


# every bf16 case but the serving prefills (8 × 2,048 × 32, 80 or a model
# rank's 16 heads: gigabytes on the CPU); full_width_bf16 is mamba2's width
# at two chunks, n_64_bf16 zamba2's d_state
SERVING_CASES = ("serving_bf16", "zamba2_serving_bf16", "mamba2_prefill_tp2_bf16")
PRECISION_CASES = [name for name, c in CHECK_CASES.items()
                   if c[6] == torch.bfloat16 and name not in SERVING_CASES]
# where one rounding of each operand is tested: many chunks, near-0 decay
# (the state sums a thousand tokens) and the full width
FAIL_CASES = ["chunk_64_bf16", "near_0_bf16", "full_width_bf16"]


def _seed(name):
    return list(CHECK_CASES).index(name)  # the seed chip_smoke.py and the card tests use


def test_precision_cases_are_the_bf16_twins():
    assert {"chunk_16_bf16", "chunk_64_bf16", "p_48_chunk_100_bf16", "h_1_bf16",
            "near_0_bf16", "strong_decay_bf16", "batch_1_16_chunks_bf16",
            "full_width_bf16", "small_bf16", "n_64_bf16"} == set(PRECISION_CASES)


@pytest.mark.parametrize("case", PRECISION_CASES)
def test_split_operands_pass_the_unchanged_bf16_check(case):
    _, share = check_case(case, emulate_bf16_kernel, ssd_chunked_ref, "cpu", seed=_seed(case))
    assert share <= 1.0


@pytest.mark.parametrize("case", FAIL_CASES)
@pytest.mark.parametrize("operand", SPLIT)
def test_one_bf16_rounding_of_any_split_operand_fails_the_check(operand, case):
    def single(xdt, la, B, C, *, chunk):
        return emulate_bf16_kernel(xdt, la, B, C, chunk=chunk,
                                   split=tuple(o for o in SPLIT if o != operand))

    with pytest.raises(AssertionError, match="> limit"):
        check_case(case, single, ssd_chunked_ref, "cpu", seed=_seed(case))


@pytest.mark.parametrize(
    "case", [name for name, c in CHECK_CASES.items() if c[6] == torch.bfloat16])
def test_every_bf16_case_meets_the_kernels_alignment(case):
    b, s, h, p, n, chunk, dtype, decay, strided = CHECK_CASES[case]
    if b * s * h * p > 2**24:  # the serving prefill: its layout at batch 1
        b = 1
    for x in ssd_inputs(b, s, h, p, n, dtype, "cpu", decay, strided=strided):
        if x.dtype == torch.bfloat16:
            assert ssd_kernel.cp_async_aligned(x)


def test_misaligned_bf16_views_are_not_aligned():
    flat = torch.zeros(16 * 4 * 64 + 8, dtype=torch.bfloat16)
    assert ssd_kernel.cp_async_aligned(flat[:16 * 4 * 64].view(1, 16, 4, 64))
    assert not ssd_kernel.cp_async_aligned(flat[1:16 * 4 * 64 + 1].view(1, 16, 4, 64))
    fused = torch.zeros(1, 16, 2 * 64 + 2 * 20, dtype=torch.bfloat16)  # n 20: row stride 168
    assert ssd_kernel.cp_async_aligned(fused[..., 128:148])
    assert not ssd_kernel.cp_async_aligned(fused[..., 132:152])  # starts 8 bytes past 16
    assert not ssd_kernel.cp_async_aligned(torch.zeros(1, 16, 4, 68, dtype=torch.bfloat16)[..., :64])


def test_workspace_is_one_padded_fp32_state_per_batch_chunk_and_head():
    # the mamba2-370m prefill: 8 × 8 chunks × 32 heads × 128 × 64 fp32 = 64 MiB
    assert ssd_kernel.workspace_numel(8, 2048, 32, 64, 128, 256) * 4 == 64 * 2**20
    assert ssd_kernel.workspace_numel(2, 400, 3, 48, 128, 100) == 2 * 4 * 3 * 128 * 64
    assert ssd_kernel.workspace_numel(2, 128, 3, 32, 16, 16) == 2 * 8 * 3 * 16 * 32
    assert ssd_kernel.workspace_numel(1, 64, 1, 8, 20, 64) == 32 * 32
