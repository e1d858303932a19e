"""Tensor-parallel serving over the "model" ranks, its parts alone, on the CPU.

The split layers (``models/layers.py``: ``attention_fwd``, ``mlp_fwd``,
``embed_lookup``, ``greedy``, ``attention_decode``; ``transformer``'s
``logits_from_hidden``) run on each model rank's TP blocks
(``launch/sharding.py::tp_pspecs``) with the ranks as threads of this
process sharing a :class:`ModelGroup` (:class:`ThreadRanks`), and are held
to the one-process port on the whole weights: fp32 within 1e-5 of the
one-process values, lookups, greedy tokens, positions and the cache slots
the new token does not touch exactly. Reduced qwen2 (4 query heads, 2 kv
heads, d_ff 512, vocab 512), biases perturbed from the init's zeros.

Besides: where the model ranks do not divide a split dimension the TP
layout, the serving steps and ``Server`` raise ``ValueError`` naming it,
and the dry run records such a serving case as skipped; it reckons
qwen2-0.5b's decode_32k step and an 8 × 2,048 prefill on (1, 2) exactly,
and a rank's served weight bytes. The rank runs themselves (gloo, against
the reference) are ``tests/test_torch_serve_ranks.py``.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from _torch_parity import assert_close

from repro_torch import configs
from repro_torch.flatten_util import tree_leaves
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import RankMesh, ShapeMesh
from repro_torch.launch.sharding import NotDivisible, Sharding, served_bytes, tp_pspecs
from repro_torch.launch.steps import build_prefill_step, build_serve_step, params_structs
from repro_torch.models import api, transformer
from repro_torch.models import layers as L
from repro_torch.models.config import INPUT_SHAPES, InputShape

M = 2


class ThreadRanks:
    """``m`` model ranks as threads of this process: :meth:`group` is rank
    r's ``ModelGroup``, whose collectives exchange the ranks' tensors
    through a barrier and reduce them in rank order."""

    def __init__(self, m: int):
        self.m = m
        self.barrier = threading.Barrier(m, timeout=60)
        self.slots = [None] * m

    def group(self, r: int) -> L.ModelGroup:
        def exchange(x):
            self.slots[r] = x.clone()
            self.barrier.wait()
            every = list(self.slots)
            self.barrier.wait()
            return every

        def all_sum(x):
            every = exchange(x)
            total = every[0]
            for y in every[1:]:
                total = total + y
            x.copy_(total)

        def all_max(x):
            x.copy_(torch.stack(exchange(x)).amax(dim=0))

        def all_gather(x, dim):
            return torch.cat(exchange(x), dim=dim)

        return L.ModelGroup(r, self.m, all_max, all_sum, all_gather)

    def run(self, fn):
        """``fn(rank, group)`` on every rank at once → the results by rank."""
        with ThreadPoolExecutor(self.m) as pool:
            futures = [pool.submit(fn, r, self.group(r)) for r in range(self.m)]
            return [f.result(timeout=120) for f in futures]


def _cfg(**kw):
    return dataclasses.replace(configs.reduced_config("qwen2-0.5b"), **kw)


def _params(cfg, seed=0):
    """The port's fp32 weights with the biases and norm scales drawn."""
    params = api.model_init(cfg, seed, "cpu")
    gen = torch.Generator().manual_seed(seed + 1)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key in ("bq", "bk", "bv"):
            return torch.randn(node.shape, generator=gen) * 0.1
        if key == "scale":
            return 1.0 + torch.randn(node.shape, generator=gen) * 0.1
        return node

    return walk(params)


def _tp_blocks(params, cfg, m: int, r: int):
    """Rank r's TP blocks of whole weights (``tp_pspecs`` on a (1, m) mesh)."""
    mesh = ShapeMesh(("data", "model"), (1, m))
    specs = tp_pspecs(params_structs(cfg), cfg, mesh)

    def cut(node, spec):
        if isinstance(node, dict):
            return {k: cut(node[k], spec[k]) for k in node}
        return node[Sharding(mesh, spec).index({"data": 0, "model": r}, node.shape)].clone()

    return cut(params, specs)


def _layer(params, part: str):
    return transformer.layer_params(params, 0)[part]


def test_tp_blocks_are_the_heads_columns_rows_and_vocab_blocks():
    """Rank r's blocks: query heads' and kv heads' columns of wq, wk, wv and
    their biases, wo's rows of its query heads, the MLP's columns and
    w_out's rows, embed's vocabulary rows; the norms whole."""
    cfg = _cfg()
    params = _params(cfg)
    dq, dkv = cfg.n_heads * cfg.head_dim // M, cfg.n_kv_heads * cfg.head_dim // M
    f, v = cfg.d_ff // M, cfg.vocab_padded // M
    for r in range(M):
        got = _tp_blocks(params, cfg, M, r)
        lay, blk = params["layers"], got["layers"]
        assert torch.equal(blk["attn"]["wq"], lay["attn"]["wq"][..., r * dq:(r + 1) * dq])
        assert torch.equal(blk["attn"]["bq"], lay["attn"]["bq"][..., r * dq:(r + 1) * dq])
        for name in ("wk", "wv", "bk", "bv"):
            assert torch.equal(blk["attn"][name], lay["attn"][name][..., r * dkv:(r + 1) * dkv])
        assert torch.equal(blk["attn"]["wo"], lay["attn"]["wo"][:, r * dq:(r + 1) * dq])
        for name in ("w_gate", "w_in"):
            assert torch.equal(blk["mlp"][name], lay["mlp"][name][..., r * f:(r + 1) * f])
        assert torch.equal(blk["mlp"]["w_out"], lay["mlp"]["w_out"][:, r * f:(r + 1) * f])
        assert torch.equal(got["embed"], params["embed"][r * v:(r + 1) * v])
        for norm in (blk["ln1"], blk["ln2"], got["final_norm"]):
            assert norm["scale"].shape[-1] == cfg.d_model


def test_served_weight_bytes_are_a_share_of_the_split_leaves_plus_the_norms():
    """A rank's bf16 bytes: 1/M of every split leaf, the fp32 norms whole."""
    cfg = _cfg()
    structs = params_structs(cfg)
    mesh = ShapeMesh(("data", "model"), (1, M))
    sh = build_serve_step(cfg, InputShape("d", 32, 4, "decode"), mesh).in_shardings["params"]
    norms = 4 * cfg.d_model * (2 * cfg.n_layers + 1)
    split = sum(x.numel() for x in
                [structs["embed"], *structs["layers"]["attn"].values(),
                 *structs["layers"]["mlp"].values()])
    assert served_bytes(structs, sh, torch.bfloat16) == 2 * split // M + norms
    whole = ShapeMesh(("data", "model"), (2, 1))
    one = build_serve_step(cfg, InputShape("d", 32, 4, "decode"), whole).in_shardings["params"]
    assert served_bytes(structs, one, torch.bfloat16) == 2 * split + norms


def test_attention_fwd_over_model_ranks_matches_one_process():
    """Each rank's attention on its heads, ``wo``'s rows summed over the
    group: the one-process output; the k and v it returns are its kv
    heads of the one-process ones."""
    cfg = _cfg()
    params = _params(cfg)
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(3))
    want, (k, v) = L.attention_fwd(_layer(params, "attn"), x, cfg, return_kv=True)
    kv = cfg.n_kv_heads // M

    def rank(r, group):
        return L.attention_fwd(_layer(_tp_blocks(params, cfg, M, r), "attn"), x, cfg,
                               return_kv=True, group=group)

    for r, (out, (k_r, v_r)) in enumerate(ThreadRanks(M).run(rank)):
        assert_close(out, want)
        assert_close(k_r, k[:, :, r * kv:(r + 1) * kv])
        assert_close(v_r, v[:, :, r * kv:(r + 1) * kv])


def test_mlp_fwd_over_model_ranks_matches_one_process():
    cfg = _cfg()
    params = _params(cfg)
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(4))
    want = L.mlp_fwd(_layer(params, "mlp"), x)
    outs = ThreadRanks(M).run(lambda r, g: L.mlp_fwd(
        _layer(_tp_blocks(params, cfg, M, r), "mlp"), x, group=g))
    for out in outs:
        assert_close(out, want)


def test_row_split_product_rounds_once_to_the_serving_type():
    """In bf16 each rank's partial is summed in fp32 and rounded once: the
    fp32 product of the same bf16 inputs rounded to bf16, bitwise."""
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(4, 64, generator=gen).bfloat16()
    w = torch.randn(64, 32, generator=gen).bfloat16()
    outs = ThreadRanks(M).run(lambda r, g: L.row_split_matmul(
        a[:, r * 32:(r + 1) * 32], w[r * 32:(r + 1) * 32], torch.bfloat16, g))
    want = (a[:, :32].float() @ w[:32].float() + a[:, 32:].float() @ w[32:].float()).bfloat16()
    for out in outs:
        assert out.dtype == torch.bfloat16 and torch.equal(out, want)


def test_vocab_split_lookup_is_the_whole_lookup_exactly():
    cfg = _cfg()
    params = _params(cfg)
    tokens = torch.tensor([[0, 255, 256, 511], [300, 7, 7, 400]])
    for dtype in (torch.float32, torch.bfloat16):
        want = L.embed_lookup(params["embed"], tokens, dtype)
        outs = ThreadRanks(M).run(lambda r, g: L.embed_lookup(
            _tp_blocks(params, cfg, M, r)["embed"], tokens, dtype, g))
        for out in outs:
            assert out.dtype == dtype and torch.equal(out, want)


def test_vocab_split_logits_hold_their_block_and_the_pad_columns():
    """With vocab 500 padded to 512 the pad columns (−1e30) lie in rank 1's
    block; each rank's logits are its block of the one-process logits."""
    cfg = _cfg(vocab_size=500)
    assert cfg.vocab_padded == 512
    params = _params(cfg)
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator().manual_seed(6))
    want = transformer.logits_from_hidden(params, cfg, x, torch.float32)
    n = cfg.vocab_padded // M
    outs = ThreadRanks(M).run(lambda r, g: transformer.logits_from_hidden(
        _tp_blocks(params, cfg, M, r), cfg, x, torch.float32, g))
    for r, out in enumerate(outs):
        assert_close(out, want[..., r * n:(r + 1) * n])
    assert (outs[1][..., 500 - n:] == L.NEG_INF).all() and (outs[0] > L.NEG_INF).all()


def test_greedy_combine_breaks_exact_ties_as_argmax_does():
    """Exact ties across the ranks' blocks and within one: the lowest index
    wins, as ``argmax`` over the whole row; bf16 ties too."""
    logits = torch.zeros(5, 8)
    logits[0, [2, 6]] = 3.0          # a tie across ranks
    logits[1, [5, 7]] = 2.0          # a tie within rank 1
    logits[2, 6] = 1.0               # rank 1 alone
    logits[3, [0, 1, 4, 5]] = 4.0    # ties within both ranks
    # row 4: every value equal
    for dtype in (torch.float32, torch.bfloat16):
        x = logits.to(dtype)
        want = x.argmax(dim=-1, keepdim=True)
        outs = ThreadRanks(M).run(lambda r, g: L.greedy(x[:, r * 4:(r + 1) * 4], g))
        for out in outs:
            assert out.dtype == torch.int64 and torch.equal(out, want)
    assert want[:, 0].tolist() == [2, 5, 6, 0, 0]


@pytest.mark.parametrize("slots", [16, 15])
def test_attention_decode_over_model_ranks_matches_one_process(slots):
    """One decode step: each rank projects its heads, the group gathers
    them, attends (over its slots of a sequence-split cache, 16 slots; over
    the whole cache on every rank where 15 slots do not split) and sums
    ``wo``'s rows: the one-process output, the new k and v in the owner's
    slot and every position written."""
    cfg = _cfg()
    params = _params(cfg)
    gen = torch.Generator().manual_seed(7)
    b, t = 2, 11
    k = torch.randn(b, slots, cfg.n_kv_heads, cfg.head_dim, generator=gen)
    v = torch.randn(b, slots, cfg.n_kv_heads, cfg.head_dim, generator=gen)
    pos = torch.arange(slots, dtype=torch.int32).masked_fill(torch.arange(slots) >= t, -1)
    x = torch.randn(b, 1, cfg.d_model, generator=gen)
    whole = (k.clone(), v.clone(), pos.clone())
    want, (wk, wv, wpos) = L.attention_decode(_layer(params, "attn"), x, cfg, *whole, t)
    split = slots % M == 0
    n = slots // M if split else slots

    def rank(r, group):
        lo = r * n if split else 0
        cache = (k[:, lo:lo + n].clone(), v[:, lo:lo + n].clone(), pos.clone())
        out, cache = L.attention_decode(_layer(_tp_blocks(params, cfg, M, r), "attn"), x, cfg,
                                        *cache, t, group=group)
        return out, cache, lo

    for out, (ck, cv, cpos), lo in ThreadRanks(M).run(rank):
        assert_close(out, want)
        assert_close(ck, wk[:, lo:lo + n])
        assert_close(cv, wv[:, lo:lo + n])
        assert torch.equal(cpos, wpos)
        untouched = [i for i in range(n) if lo + i != t]
        assert torch.equal(ck[:, untouched], k[:, [lo + i for i in untouched]])


def test_model_ranks_that_do_not_divide_raise_naming_the_dimension():
    """3 model ranks divide neither reduced qwen2's 4 heads, 2 kv heads,
    d_ff 512 nor its vocab 512; 4 do not divide qwen2-0.5b's 14 heads and 2
    kv heads. The TP layout, both serving steps and ``Server`` raise
    ``ValueError`` naming them."""
    from repro_torch.launch.serve import Server

    cfg = _cfg()
    with pytest.raises(ValueError, match="3 model ranks do not divide n_heads = 4, "
                                         "n_kv_heads = 2, d_ff = 512, vocab_padded = 512"):
        tp_pspecs(params_structs(cfg), cfg, ShapeMesh(("data", "model"), (1, 3)))
    base = configs.base_config("qwen2-0.5b")
    mesh = ShapeMesh(("data", "model"), (1, 4))
    for build, shape in ((build_serve_step, "decode_32k"), (build_prefill_step, "prefill_32k")):
        with pytest.raises(NotDivisible, match="n_heads = 14, n_kv_heads = 2$"):
            build(base, INPUT_SHAPES[shape], mesh)
    wide = _cfg(n_heads=6, n_kv_heads=2)  # heads divide 2 ways, the vocab 3 ways not
    with pytest.raises(ValueError, match="vocab_padded = 512"):
        Server(wide, InputShape("d", 16, 2, "decode"),
               RankMesh(("data", "model"), (1, 3), device=torch.device("cpu")))


def test_dry_run_reckons_tensor_parallel_serving_of_qwen2():
    """qwen2-0.5b on (1, 2), bf16: an 8 × 2,048 prefill runs the
    embedding's all-reduce, two fp32 all-reduces of (8, 2,048, 896) and one
    gather of the layer's k and v a layer, and the greedy token's gather; a
    decode_32k step (128 rows) the embedding's all-reduce, a layer the
    q, k, v gather, the combine's three all-reduces and two fp32
    all-reduces of (128, 896), and the greedy gather. A rank serves half of
    the split leaves' bf16 bytes and the fp32 norms. On (1, 4) both are
    skipped: 4 ranks divide neither the heads nor the kv heads."""
    L_, rows, s, d = 24, 8, 2048, 896
    prefill = dryrun.run_one("qwen2-0.5b", "prefill_32k", mesh="1x2", batch=rows, seq=s,
                             flops=False, verbose=False)
    coll = prefill["collectives"]
    assert coll["reduce"] == {"calls": 1 + 2 * L_,
                              "bytes": rows * s * d * 2 + 2 * L_ * rows * s * d * 4}
    assert coll["gather"] == {"calls": L_ + 1,
                              "bytes": L_ * 2 * rows * s * 2 * 64 * 2 // 2 + 2 * rows * 16 // 2}
    decode = dryrun.run_one("qwen2-0.5b", "decode_32k", mesh="1x2", flops=False, verbose=False)
    coll, rows = decode["collectives"], 128
    combine = 458_752 + 7_168 + 7_168
    assert coll["reduce"] == {"calls": 1 + 5 * L_,
                              "bytes": rows * d * 2 + L_ * (combine + 2 * rows * d * 4)}
    assert coll["gather"] == {"calls": L_ + 1,
                              "bytes": L_ * rows * (14 + 4) * 64 * 2 // 2 + 2 * rows * 16 // 2}
    structs = params_structs(configs.base_config("qwen2-0.5b"))
    norms = d * (2 * L_ + 1)
    split = sum(x.numel() for x in tree_leaves(structs)) - norms
    assert decode["served_weight_bytes"] == prefill["served_weight_bytes"] == (
        split * 2 // 2 + norms * 4)
    assert math.isclose(decode["served_weight_bytes"] / 1e9, 0.494, abs_tol=1e-3)
    for shape in ("prefill_32k", "decode_32k"):
        rec = dryrun.run_one("qwen2-0.5b", shape, mesh="1x4", flops=False, verbose=False)
        assert rec["status"] == "skipped"
        assert rec["reason"].endswith("4 model ranks do not divide n_heads = 14, n_kv_heads = 2")
