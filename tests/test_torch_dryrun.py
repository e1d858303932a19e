"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

- Per-rank bytes, for every arch × supported shape on both production
  meshes: each argument of the step (parameters, AdamW state, batch or
  token and cache) held to the arithmetic of the REFERENCE's specs on
  ``jax.sharding.AbstractMesh`` (each leaf's block by its spec, in the
  dtype of the port's ``arg_structs``), and the residual carries to the
  reference's ``auto_microbatches`` formula. Exact. A dense or SSM
  model's serving steps split tensor-parallel over "model" instead
  (``sharding.tp_pspecs``), which 16 model ranks cannot do for any dense
  config: those records are skipped, naming the dimension, and their
  weight bytes by the specs' blocks are still held to the reference's;
  mamba2-370m's 32 heads split 16 ways, so its serving records hold a
  rank's TP blocks, held to their own arithmetic.
- FLOPs: ``FlopCounterMode`` over a reduced step on meta tensors equals the
  count over the same step on real CPU tensors (train steps of four
  families, a decode step).
- The CLI writes one ``ok`` or ``skipped`` record per arch × shape × mesh,
  the one-card mesh names no card here, and a train record's collectives
  are a round of the port's rank trainer (``rank_collectives``; the rank
  runs hold the same counts in ``tests/test_torch_train_ranks.py``).
"""
from __future__ import annotations

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.launch import sharding as jsharding
from repro.launch import steps as jsteps
from repro.optim.optimizers import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch.flatten_util import tree_leaves, tree_map
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_serve_step, build_train_step, params_structs
from repro_torch.models.cache import cache_leaves
from repro_torch.models.config import INPUT_SHAPES, InputShape
from repro_torch.optim.optimizers import adamw

PRODUCTION = {"16x16": (("data", "model"), (16, 16)),
              "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _block_bytes(ref_shape, spec, sizes: dict, itemsize: int) -> int:
    """A leaf's bytes a rank by a reference spec: each named dim divided by
    the product of its axes' sizes."""
    n = 1
    for d, dim in enumerate(ref_shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        n *= dim // math.prod(sizes[a] for a in axes)
    return n * itemsize


def _sum_bytes(ref_leaves, spec_leaves, port_leaves, sizes) -> int:
    assert len(ref_leaves) == len(spec_leaves) == len(port_leaves)
    total = 0
    for r, s, p in zip(ref_leaves, spec_leaves, port_leaves, strict=True):
        assert tuple(r.shape) == tuple(p.shape)
        total += _block_bytes(r.shape, tuple(s), sizes, p.element_size())
    return total


def _reference_bytes(arch: str, shape_name: str, names, sizes) -> dict:
    """Each argument's bytes a rank by the reference's specs, in the port's
    dtypes, and the residual carries by its formula."""
    import jax
    from jax.sharding import PartitionSpec as P

    shape = INPUT_SHAPES[shape_name]
    jmesh = AbstractMesh(sizes, names)
    axes = dict(zip(names, sizes))
    jcfg, tcfg = jconfigs.get_config(arch, shape), tconfigs.get_config(arch, shape)
    jp = jsteps.params_structs(jcfg)
    p_specs = jsharding.params_pspecs(jp, jmesh, jsharding.moe_strategy(jcfg, shape, jmesh))
    is_p = lambda x: isinstance(x, P)  # noqa: E731
    from repro_torch.launch.steps import params_structs

    tp = tree_leaves(params_structs(tcfg))
    spec_leaves = jax.tree.leaves(p_specs, is_leaf=is_p)
    out = {"params": _sum_bytes(jax.tree.leaves(jp), spec_leaves, tp, axes)}
    jspecs, tspecs = jconfigs.input_specs(jcfg, shape), tconfigs.input_specs(tcfg, shape)
    residual = 0
    if shape.kind == "train":
        opt = jadamw(1e-4)
        o = jsteps.opt_structs(opt, jp)
        o_specs = jsteps.opt_pspecs(p_specs, o)
        t_opt = adamw(1e-4).init(params_structs(tcfg))
        out["opt_state"] = _sum_bytes(
            jax.tree.leaves(o), jax.tree.leaves(o_specs, is_leaf=is_p),
            [t_opt.step, *tree_leaves(t_opt.mu), *tree_leaves(t_opt.nu)], axes)
        mesh_ns = SimpleNamespace(devices=np.empty(sizes), axis_names=names,
                                  shape=dict(zip(names, sizes)))
        m = jsteps.auto_microbatches(jcfg, shape, mesh_ns)
        n_layers = jcfg.n_layers + (jcfg.encdec.n_enc_layers if jcfg.encdec else 0)
        residual = (n_layers * shape.global_batch * shape.seq_len * jcfg.d_model * 2
                    // (math.prod(sizes) * m))
    if shape.kind in ("train", "prefill"):
        b_specs = jsharding.batch_pspecs(jspecs["batch"], jmesh)
        keys = sorted(jspecs["batch"])
        out["batch"] = _sum_bytes([jspecs["batch"][k] for k in keys],
                                  [b_specs[k] for k in keys],
                                  [tspecs["batch"][k] for k in keys], axes)
    else:
        c_specs = jsharding.cache_pspecs(jspecs["cache"], jmesh)
        out["cache"] = _sum_bytes(jax.tree.leaves(jspecs["cache"]),
                                  jax.tree.leaves(c_specs, is_leaf=is_p),
                                  cache_leaves(tspecs["cache"]), axes)
        b = jspecs["token"].shape[0]
        tok = (jsharding._batched(b, jmesh), None)
        out["token"] = _sum_bytes([jspecs["token"]], [tok], [tspecs["token"]], axes)
        out["t"] = tspecs["t"].element_size()
    return out, residual


def _ssm_tp_params_bytes(cfg, models: int) -> int:
    """A rank's fp32 bytes of an SSM model's TP blocks over ``models``
    model ranks: 1/M of every leaf but the B and C columns of ``in_proj``
    and channels of ``conv_w`` and ``conv_b`` and the ``ln1`` and final
    norms, which it holds whole."""
    s, d, n_l = cfg.ssm, cfg.d_model, cfg.n_layers
    whole = n_l * 2 * s.d_state * (d + s.conv_kernel + 1) + d * (n_l + 1)
    total = sum(x.numel() for x in tree_leaves(params_structs(cfg)))
    return 4 * ((total - whole) // models + whole)


def _tp_undivided(arch, shape_name, models) -> bool:
    """Whether ``models`` model ranks cannot split ``arch``'s serving step
    tensor-parallel (a dense model's heads, kv heads, MLP width or
    vocabulary; ``sharding.tp_pspecs``)."""
    cfg = tconfigs.get_config(arch, INPUT_SHAPES[shape_name])
    return (INPUT_SHAPES[shape_name].kind != "train" and cfg.arch_type == "dense"
            and any(getattr(cfg, d) % models
                    for d in ("n_heads", "n_kv_heads", "d_ff", "vocab_padded")))


@pytest.mark.parametrize("arch", list(tconfigs.ARCH_IDS))
def test_per_rank_bytes_match_the_reference_specs(arch):
    for shape_name in INPUT_SHAPES:
        for mesh_name, (names, sizes) in PRODUCTION.items():
            rec = dryrun.run_one(arch, shape_name, mesh=mesh_name, flops=False, verbose=False)
            if not tconfigs.supports_shape(arch, shape_name):
                assert rec["status"] == "skipped"
                continue
            if _tp_undivided(arch, shape_name, sizes[-1]):
                # the port serves a dense model tensor-parallel: where the 16 model
                # ranks do not divide its heads, kv heads, MLP or vocabulary it skips
                assert rec["status"] == "skipped"
                assert "model ranks do not divide" in rec["reason"]
                want, _ = _reference_bytes(arch, shape_name, names, sizes)
                assert rec["spec_params_bytes"] == want["params"], (arch, shape_name, mesh_name)
                continue
            assert rec["status"] == "ok" and rec["n_devices"] == math.prod(sizes)
            want, residual = _reference_bytes(arch, shape_name, names, sizes)
            cfg = tconfigs.get_config(arch, INPUT_SHAPES[shape_name])
            if cfg.arch_type == "ssm" and INPUT_SHAPES[shape_name].kind != "train":
                want["params"] = _ssm_tp_params_bytes(cfg, sizes[-1])  # served split
            mem = rec["memory"]
            by_argument = {k: v for k, v in mem["by_argument"].items()
                           if k not in ("coeffs", "noise_amp", "noise")}
            assert by_argument == want, (arch, shape_name, mesh_name)
            assert mem["residual_bytes"] == residual
            assert mem["temp_bytes"] is None and mem["peak_bytes"] is None
            assert mem["reckoned_bytes"] == mem["argument_bytes"] + residual


def _real(x):
    """CPU tensors like the meta ones of ``x`` (a tensor, or a dict or
    NamedTuple of them; small values: the FLOPs do not depend on them)."""
    if x is None:
        return None
    if isinstance(x, dict):
        return tree_map(_real, x)
    if isinstance(x, tuple):
        return type(x)(*map(_real, x))
    if x.dtype in (torch.int64, torch.int32):
        return torch.zeros(x.shape, dtype=x.dtype)
    return torch.randn(x.shape, dtype=x.dtype) * 0.02


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-370m", "olmoe-1b-7b",
                                  "seamless-m4t-large-v2"])
def test_meta_flops_of_a_reduced_train_step_match_real_tensors(arch):
    cfg = tconfigs.reduced_config(arch)
    bundle = build_train_step(cfg, InputShape("t", 32, 4, "train"), make_host_mesh(1, 2, "cpu"),
                              adamw(1e-3))
    meta = dryrun.step_flops(bundle, 32)
    real = {k: _real(v) for k, v in bundle.arg_structs.items()}
    real["coeffs"] = torch.full((2,), 0.5)
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        bundle.fn(**real)
    assert meta == counter.get_total_flops() > 0


def test_meta_flops_of_a_decode_step_match_real_tensors():
    cfg = tconfigs.reduced_config("qwen2-0.5b")
    bundle = build_serve_step(cfg, InputShape("d", 64, 2, "decode"), make_host_mesh(1, 1, "cpu"))
    meta = dryrun.step_flops(bundle, 64)
    from repro_torch.models.cache import init_cache
    from torch.utils.flop_counter import FlopCounterMode

    args = dict(params=_real(bundle.arg_structs["params"]),
                token=torch.zeros((2, 1), dtype=torch.int64),
                cache=init_cache(cfg, 2, 64, torch.bfloat16, device="cpu"),
                t=torch.tensor(63, dtype=torch.int32))
    with FlopCounterMode(display=False) as counter:
        bundle.fn(**args)
    assert meta == counter.get_total_flops() > 0


def test_cli_writes_a_record_per_arch_shape_and_mesh(tmp_path, capsys):
    """One arch, every shape, both production meshes, 16 data ranks and one
    card: every record ``ok`` or ``skipped``; without a card the one-card
    records name none; a train round's collectives on 16x1, where the SSM
    model computes whole (two gathers of every split master, the
    statistics' gather, every gradient leaf and the loss all-reduced, one
    broadcast), on 16x16 split tensor-parallel over 16 model ranks (32
    heads: every serving record's collectives reckoned too), on one card the
    broadcast alone, none on the pod mesh, and a serving step on one card
    none."""
    out = tmp_path / "dry.jsonl"
    rc = dryrun.main(["--arch", "mamba2-370m", "--shape", "all", "--both-meshes",
                      "--mesh", "16x1", "--mesh", "1x1", "--no-flops", "--json", str(out)])
    assert rc == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == 4 * 4 and {r["status"] for r in recs} == {"ok"}
    assert "16 ok, 0 skipped, 0 failed" in capsys.readouterr().out
    one = [r for r in recs if r["mesh"] == "1x1"]
    assert all(r["card"] is None and r["fits"] is None for r in one)
    train = next(r for r in recs if r["mesh"] == "16x1" and r["shape"] == "train_4k")
    cfg = tconfigs.get_config("mamba2-370m", "train_4k")
    structs = tree_leaves(params_structs(cfg))
    coll = train["collectives"]
    assert train["compute_layout"] == "whole"
    assert coll["reduce"]["calls"] == len(structs) + 1 and coll["broadcast"]["calls"] == 1
    assert 0 < coll["gather"]["calls"] <= 2 * len(structs) + 1
    assert coll["gather"]["calls"] % 2 == 1  # the statistics' gather beside two of each leaf
    # every fp32 gradient leaf all-reduced over 16 data ranks, the loss too
    assert coll["reduce"]["bytes"] == sum(2 * n * 15 // 16 for n in
                                          [x.numel() * 4 for x in structs] + [4])
    assert train["collective_bytes_per_device"] == sum(c["bytes"] for c in coll.values())
    one_train = next(r for r in one if r["shape"] == "train_4k")
    assert one_train["collectives"] == {"gather": {"calls": 0, "bytes": 0},
                                        "reduce": {"calls": 0, "bytes": 0},
                                        "broadcast": {"calls": 1, "bytes": 8 * (1 + 4)}}
    assert all(r["collectives"] is None for r in recs if r["mesh"] == "2x16x16")
    split = [r for r in recs if r["mesh"] == "16x16"]
    assert all(r["collectives"]["reduce"]["calls"] > 0 for r in split)
    assert {r["compute_layout"] for r in split} == {"tensor-parallel", None}
    assert all(r["served_weight_bytes"] is not None for r in split if r["shape"] != "train_4k")
    none = {op: {"calls": 0, "bytes": 0} for op in ("gather", "reduce", "broadcast")}
    assert all(r["collectives"] == none for r in one if r["shape"] != "train_4k")
    skipped = dryrun.run_one("qwen2.5-14b", "long_500k", mesh="16x16", flops=False,
                             verbose=False)
    assert skipped["status"] == "skipped" and not tconfigs.supports_shape("qwen2.5-14b",
                                                                          "long_500k")


def test_dry_run_reckons_a_tensor_parallel_train_round():
    """qwen2-0.5b cut to 4 layers, 8 × 2,048 tokens on (1, 2), fp32, two
    probes: the rank trainer splits it tensor-parallel, and a round's
    all-reduces over "model" are each JVP pass's (the embedding's and each
    layer's two row-split SUMs, primal and tangent; each of the two CE
    chunks' MAX and its two SUMs, primal and tangent), the step's forward,
    its remat recompute and its backward's (each layer's two and each
    chunk's head copy summing their gradient); beside the two gathers of
    every split master it gathers the gradients of ``wo``, ``w_out`` and
    the q, k, v biases over "model". A rank computes on half of every
    split leaf. On the production mesh 16 model ranks do not divide the
    heads: the record keeps its bytes by the specs and names the
    dimensions, with no collectives. mamba2-370m on (1, 2) trains split
    too (its reckoning: :func:`test_dry_run_reckons_tensor_parallel_mamba2`)."""
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.launch.sharding import params_pspecs, sharded_bytes, to_shardings
    from repro_torch.models.transformer import CE_CHUNK

    cfg = tconfigs.cut_depth(tconfigs.base_config("qwen2-0.5b"), 4)
    mesh = ShapeMesh(("data", "model"), (1, 2))
    shape = InputShape("t", 2048, 8, "train")
    bundle = build_train_step(cfg, shape, mesh, adamw(1e-4), dtype=torch.float32)
    coll = dryrun.rank_collectives(cfg, bundle, mesh, "all-gather", 8, dtype=torch.float32,
                                   n_probes=2)
    L_, rows, s, d, chunk = 4, 8, 2048, 896, CE_CHUNK
    act, ce = rows * s * d * 4, rows * chunk * 4  # one all-reduce's bytes (= its wire bytes)
    jvp = 2 * act + 4 * L_ * act + 2 * 5 * ce
    step = act + 2 * L_ * act + 2 * 3 * ce  # the forward
    step += 2 * L_ * act + 2 * 3 * ce  # the recompute
    step += 2 * L_ * act + 2 * rows * chunk * d * 4  # the copies' gradients
    assert coll["reduce"] == {"calls": 3 * (2 + 4 * L_ + 10) + (1 + 2 * L_ + 6)
                              + (2 * L_ + 6) + (2 * L_ + 2), "bytes": 3 * jvp + step}
    structs = tree_leaves(params_structs(cfg))
    masters = tree_leaves(to_shardings(params_pspecs(params_structs(cfg), mesh), mesh))
    split = [x for x, sh in zip(structs, masters) if not sh.replicated()]
    per_layer = {"wo": 896 * 896, "w_out": 4864 * 896, "bq": 896, "bk": 128, "bv": 128}
    assert coll["gather"] == {
        "calls": 2 * len(split) + 5,
        "bytes": sum(x.numel() * 4 // 2 for x in split) * 2
        + sum(L_ * n * 4 // 2 for n in per_layer.values())}
    assert coll["broadcast"] == {"calls": 1, "bytes": 8 * (8 + 4)}
    norms = d * (2 * L_ + 1)
    assert dryrun.compute_weight_bytes(cfg, mesh) == (
        (sum(x.numel() for x in structs) - norms) * 4 // 2 + norms * 4)
    rec = dryrun.run_one("qwen2-0.5b", "train_4k", mesh="1x2", flops=False, verbose=False)
    assert rec["compute_layout"] == "tensor-parallel" and rec["collectives"]["reduce"]["calls"]
    prod = dryrun.run_one("qwen2-0.5b", "train_4k", mesh="16x16", flops=False, verbose=False)
    assert prod["status"] == "ok" and prod["collectives"] is None
    assert prod["compute_weight_bytes"] is None
    assert prod["compute_layout"].endswith(
        "16 model ranks do not divide n_heads = 14, n_kv_heads = 2")
    big = tconfigs.get_config("qwen2-0.5b", INPUT_SHAPES["train_4k"])
    pmesh = ShapeMesh(("data", "model"), (16, 16))
    assert prod["memory"]["by_argument"]["params"] == sharded_bytes(
        params_structs(big), to_shardings(params_pspecs(params_structs(big), pmesh), pmesh))
    ssm_rec = dryrun.run_one("mamba2-370m", "train_4k", mesh="1x2", flops=False, verbose=False)
    ssm = tconfigs.get_config("mamba2-370m", INPUT_SHAPES["train_4k"])
    assert ssm_rec["compute_layout"] == "tensor-parallel"
    assert ssm_rec["compute_weight_bytes"] == _ssm_tp_params_bytes(ssm, 2) == 4 * 216_415_488


def test_dry_run_reckons_a_moe_over_data_ranks():
    """olmoe-1b-7b at 2 layers on (2, 1), 8 × 2,048 tokens, fp32, two
    probes: a rank's 8,192 tokens hold 8 whole groups of 1,024, so a round
    adds only the aux's SUM of the 64 first-choice counts a layer in the
    step's forward and its recompute (4 all-reduces of 256 B), no expert
    gather; at 8 × 16 tokens a group of 128 spans the ranks, and each of the
    3 JVP passes, the forward and the recompute gather the (8, 64) int32
    experts a layer. Served on (2, 1), a decode step of 128 rows gathers
    them a layer (16 a step at full depth); an 8 × 2,048 prefill none, an
    8 × 64 one a layer. On (1, 2) a MoE model serves nowhere: no
    collectives."""
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.launch.steps import build_prefill_step, build_serve_step

    cfg = tconfigs.cut_depth(tconfigs.base_config("olmoe-1b-7b"), 2)
    mesh = ShapeMesh(("data", "model"), (2, 1))
    leaves = tree_leaves(params_structs(cfg))

    def train(seq):
        bundle = build_train_step(cfg, InputShape("t", seq, 8, "train"), mesh, adamw(1e-4),
                                  dtype=torch.float32)
        return dryrun.rank_collectives(cfg, bundle, mesh, "all-gather", 8, dtype=torch.float32,
                                       n_probes=2)

    whole, spans = train(2048), train(16)
    grads = sum(2 * x.numel() * 4 // 2 for x in leaves) + 2 * 4 // 2  # the leaves, the loss
    assert whole["reduce"] == {"calls": len(leaves) + 1 + 4, "bytes": grads + 4 * 256}
    assert spans["reduce"] == whole["reduce"]
    experts = 2 * 8 * 64 * 4 // 2  # one all-gather's wire bytes: (8, 64) int32 a rank
    assert spans["gather"]["calls"] == whole["gather"]["calls"] + 5 * 2
    assert spans["gather"]["bytes"] - whole["gather"]["bytes"] == 5 * 2 * experts
    full = tconfigs.base_config("olmoe-1b-7b")

    def serve(build, shape, sizes=(2, 1)):
        m = ShapeMesh(("data", "model"), sizes)
        return dryrun.rank_collectives(full, build(full, shape, m), m, "all-gather", n_tokens=9)

    decode = serve(build_serve_step, InputShape("d", 256, 128, "decode"))
    assert decode["gather"] == {"calls": 8 * 16 + 1,
                                "bytes": 8 * 16 * (2 * 8 * 64 * 4 // 2) + 128 * 9 * 8 // 2}
    assert decode["reduce"]["calls"] == 0
    assert serve(build_prefill_step, InputShape("p", 2048, 8, "prefill"))["gather"]["calls"] == 0
    short = serve(build_prefill_step, InputShape("p", 64, 8, "prefill"))
    assert short["gather"] == {"calls": 16, "bytes": 16 * (2 * 8 * 256 * 4 // 2)}
    assert serve(build_serve_step, InputShape("d", 256, 128, "decode"), (1, 2)) is None


def test_dry_run_reckons_tensor_parallel_mamba2():
    """mamba2-370m on (1, 2), bf16: an 8 × 2,048 prefill runs the
    embedding's all-reduce, a layer its norm statistic's (fp32, a value a
    token) and out_proj's fp32 all-reduce and the gather of the conv
    window's last 3 rows of every rank's x channels, and the greedy
    token's gather; a decode_32k step (128 rows) the embedding's
    all-reduce, a layer the gather of every rank's conv cache block and new
    x channels (3 × 2,304 + 2,048 values a row) and the same two
    all-reduces, and the greedy gather. A rank serves 433,032,704 bytes. A
    train round at 2 layers (8 × 2,048, fp32, two probes) adds to the
    dense reckoning's pattern each layer's norm statistic and, in the
    backward, the input's, the statistic's and the B/C weight slices'
    copies; it gathers every Mamba2 gradient leaf over "model". On the
    production mesh the 16 model ranks split the 32 heads: the records are
    reckoned, not skipped."""
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.launch.sharding import params_pspecs, to_shardings
    from repro_torch.models.transformer import CE_CHUNK

    L_, rows, s, d, di, n = 48, 8, 2048, 1024, 2048, 128
    prefill = dryrun.run_one("mamba2-370m", "prefill_32k", mesh="1x2", batch=rows, seq=s,
                             flops=False, verbose=False)
    coll = prefill["collectives"]
    assert coll["reduce"] == {"calls": 1 + 2 * L_,
                              "bytes": rows * s * d * 2 + L_ * (rows * s * 4 + rows * s * d * 4)}
    assert coll["gather"] == {"calls": L_ + 1,
                              "bytes": L_ * rows * 3 * di * 2 // 2 + 2 * rows * 16 // 2}
    decode = dryrun.run_one("mamba2-370m", "decode_32k", mesh="1x2", flops=False,
                            verbose=False)
    coll, rows = decode["collectives"], 128
    assert coll["reduce"] == {"calls": 1 + 2 * L_,
                              "bytes": rows * d * 2 + L_ * (rows * 4 + rows * d * 4)}
    assert coll["gather"] == {"calls": L_ + 1, "bytes": L_ * rows * (3 * (di + 2 * n) + di) * 2
                              // 2 + 2 * rows * 16 // 2}
    assert decode["served_weight_bytes"] == prefill["served_weight_bytes"] == 433_032_704

    cfg = tconfigs.cut_depth(tconfigs.base_config("mamba2-370m"), 2)
    mesh = ShapeMesh(("data", "model"), (1, 2))
    bundle = build_train_step(cfg, InputShape("t", 2048, 8, "train"), mesh, adamw(1e-4),
                              dtype=torch.float32)
    coll = dryrun.rank_collectives(cfg, bundle, mesh, "all-gather", 8, dtype=torch.float32,
                                   n_probes=2)
    L_, rows = 2, 8
    act, stat, ce = rows * s * d * 4, rows * s * 4, rows * CE_CHUNK * 4
    layer = stat + act  # the norm statistic and out_proj
    jvp = 2 * act + 2 * L_ * layer + 2 * 5 * ce
    copies = act + stat + (d * 2 * n + 4 * 2 * n + 2 * n) * 4
    step = (act + L_ * layer + 2 * 3 * ce) + (L_ * layer + 2 * 3 * ce) + (
        L_ * copies + 2 * rows * CE_CHUNK * d * 4)
    assert coll["reduce"] == {"calls": 3 * (2 + 4 * L_ + 10) + (1 + 2 * L_ + 6) + (2 * L_ + 6)
                              + (5 * L_ + 2), "bytes": 3 * jvp + step}
    structs = params_structs(cfg)
    masters = tree_leaves(to_shardings(params_pspecs(structs, mesh), mesh))
    split = [x for x, sh in zip(tree_leaves(structs), masters) if not sh.replicated()]
    assert len(split) == 5  # embed, lm_head, in_proj, conv_w, out_proj
    per_head, w = 16, di // 2  # a rank's heads, its x channels
    blocks = {"in_proj": d * (2 * w + 2 * n + per_head), "conv_w": 4 * (w + 2 * n),
              "conv_b": w + 2 * n, "A_log": per_head, "dt_bias": per_head, "D": per_head,
              "norm": w, "out_proj": w * d}
    assert coll["gather"] == {"calls": 2 * len(split) + len(blocks),
                              "bytes": sum(x.numel() * 4 // 2 for x in split) * 2
                              + sum(L_ * b * 4 for b in blocks.values())}
    for shape in ("prefill_32k", "decode_32k", "train_4k"):
        rec = dryrun.run_one("mamba2-370m", shape, mesh="16x16", flops=False, verbose=False)
        assert rec["status"] == "ok" and rec["collectives"]["reduce"]["calls"] > 0
