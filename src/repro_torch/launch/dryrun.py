"""Dry run: what each step needs a rank, on meta tensors, nothing allocated
(the port's counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles every (architecture × input shape ×
mesh) step against 512 placeholder CPU devices and reads XLA's memory and
cost analyses. The port compiles nothing. For every combination it builds
the step (``launch.steps.build_step``: train_step for train shapes,
prefill / serve_step for inference shapes) on a shape-only mesh
(``launch.mesh.make_production_mesh``, or ``DxM``, ``PxDxM``) and reports:

  * per-rank bytes, from the ported specs (``launch.sharding``): the
    parameters and the optimizer state in the dtypes of the step's
    ``arg_structs``, the batch (train, prefill) or the token and cache
    (decode), and for training the remat-saved residual carries by
    ``auto_microbatches``' own formula (n_layers · B·S·D · 2 bytes / chips
    / microbatches);
  * the step's global FLOPs, by ``torch.utils.flop_counter.FlopCounterMode``
    over the step's function on meta tensors (the kernels' plain versions
    run there: a meta tensor never reaches a kernel);
  * for training, the collectives of one trainer round a rank as the
    port's rank steps issue them on a (data, model) mesh of ranks
    (:func:`rank_collectives`, sketch mode): a gather of every split fp32
    master in the stats step and again in the train step, the gather of
    the sketched statistics, the schedule's broadcast, and the all-reduce
    of every gradient (a rank's compute block of it) and the loss over the
    data ranks; over R > 1 data ranks a MoE model's collectives over
    "data" (:func:`moe_collectives`: the load-balance loss's SUM of the
    first-choice counts a layer in each pass that takes it, and the gather
    of the top-k experts a layer wherever a routing group spans ranks);
    over M > 1 model ranks a dense or SSM model's tensor-parallel
    all-reduces over "model" (the forward's, the remat recompute's, the
    backward's and each JVP pass's primal and tangent ones, the loss's
    three a CE chunk; an SSM model's B/C weight-gradient SUMs) and the
    gathers of the gradients whose compute block does not hold the master
    block; their wire bytes by the reference's ring rule
    (``launch.mesh.wire_bytes``). A train record also holds a rank's
    compute-weight bytes (``compute_weight_bytes``: the fp32 blocks its
    steps differentiate, ``steps.compute_shardings``) and the layout they
    take (``compute_layout``: "tensor-parallel" or "whole"); on a mesh
    whose model ranks do not divide a model's split dimensions
    the rank trainer refuses it (``sharding.NotDivisible``): the record
    keeps its bytes by the specs and names the dimension there, with no
    collectives and no compute-weight bytes;
  * for serving, the collectives of ``Server`` over ranks
    (:func:`serve_collectives`): over M > 1 model ranks a prefill's and a
    decode step's tensor-parallel all-reduces and gathers over "model"
    (the embedding, two row-split products a layer, the prefill's kv
    re-layout, the decode's q, k, v gather and its attention combine where
    the KV cache is split by sequence; a Mamba2 layer's norm statistic, its
    ``out_proj`` and its conv window's gather; the greedy token's
    combine), a MoE
    model's gather of the top-k experts over "data" a layer where a routing
    group spans ranks, the gather of the tokens over "data", and the
    gathers of loading spec blocks; a prefill record reckons one prefill, a decode
    record one step. ``--gather all-reduce`` reckons gloo's gather of CUDA
    tensors (a zero-filled all-reduce of the whole) in place of an
    all-gather. The counts and bytes are those the rank mesh counts as it
    runs (``ranks.<op>.calls`` and ``ranks.<op>.bytes``). A serving record
    also holds a rank's bytes of the weights it serves in bf16
    (``served_weight_bytes``, ``sharding.served_bytes`` of its TP blocks).

What it does NOT estimate: the reference reads XLA's temporaries
(``temp_bytes``) and so a transient peak from the compiled program; the
port has no compiled program and does not estimate them (``temp_bytes``
and ``peak_bytes`` are ``None``). Nor the collectives of a mesh with a pod
axis (the rank mesh is (data, model)) or of a serving case the rank
``Server`` refuses (``launch.steps.check_rank_serving``: a MoE model over
model ranks among them): ``collectives`` is ``None`` there. A
serving case of a dense model on a mesh whose model ranks do not divide its
heads, kv heads, MLP width or vocabulary (``sharding.NotDivisible``) is
recorded ``skipped``, with the dimension that does not divide and a
rank's weight bytes by the specs' blocks (``spec_params_bytes``:
``params_pspecs``, the layout GSPMD would serve them in). On the one-card
mesh ``1x1`` a record holds the card's memory (``torch.cuda.mem_get_info``)
when a card is present, and ``fits`` compares the reckoned bytes
(transients left out) with it; without a card both are ``None``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod] \\
      [--both-meshes] [--json out.jsonl]
  python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape prefill_32k \\
      --mesh 1x1 --batch 8 --seq 2048          # one card, a serving shape
  python -m repro_torch.launch.dryrun --arch internvl2-76b --shape prefill_32k \\
      --mesh 1x1 --batch 8 --seq 2048 --layers 12
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time

NOT_ESTIMATED = ("temp_bytes and peak_bytes: the reference reads XLA's temporaries from its "
                 "compiled program; the port compiles no program and does not estimate its "
                 "transient peak. collectives: none for a mesh with a pod axis, a dense "
                 "or SSM model training over model ranks that do not divide its split "
                 "dimensions "
                 "(sharding.NotDivisible), or a serving case the rank Server refuses (the "
                 "rank mesh is (data, model); launch.steps.check_rank_serving: MoE over "
                 "model ranks among them)")


def make_mesh(name: str):
    """A shape-only mesh from its name: ``DxM`` → (data, model), ``PxDxM``
    → (pod, data, model); ``16x16`` and ``2x16x16`` are the production
    meshes, ``1x1`` one card."""
    from repro_torch.launch.mesh import ShapeMesh

    sizes = tuple(int(n) for n in name.split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(sizes))
    if names is None:
        raise ValueError(f"mesh {name!r}: give DxM or PxDxM")
    return ShapeMesh(names, sizes)


def residual_bytes(cfg, shape, mesh) -> int:
    """A rank's remat-saved residual carries of a train step:
    ``auto_microbatches``' formula (n_layers · B·S·D · 2 bytes over the
    mesh's chips) over its microbatch count."""
    from repro_torch.launch.steps import auto_microbatches

    n_layers = cfg.n_layers + (cfg.encdec.n_enc_layers if cfg.encdec is not None else 0)
    total = n_layers * shape.global_batch * shape.seq_len * cfg.d_model * 2
    return total // (mesh.devices.size * auto_microbatches(cfg, shape, mesh))


def state_bytes(bundle) -> dict:
    """A rank's bytes of each argument of a step bundle built on a
    shape-only mesh (its ``arg_structs`` laid out by its ``in_shardings``)."""
    from repro_torch.launch.sharding import sharded_bytes

    return {name: sharded_bytes(bundle.arg_structs[name], sh)
            for name, sh in bundle.in_shardings.items()}


def _reckoner(mesh, gather: str):
    """→ (``{op: {"calls", "bytes"}}`` zeroed, ``add(op, ring_op, result, g)``,
    ``gather_of(shape, itemsize, sharding)``): a gather runs over every
    rank, as an all-gather of the blocks or (``gather="all-reduce"``) an
    all-reduce of a zero-filled whole."""
    from repro_torch.launch.mesh import wire_bytes

    n = mesh.size()
    out = {op: {"calls": 0, "bytes": 0} for op in ("gather", "reduce", "broadcast")}

    def add(op, ring_op, result, g):
        out[op]["calls"] += 1
        out[op]["bytes"] += wire_bytes(ring_op, result, g)

    def gather_of(shape, itemsize, sh):
        if sh.replicated():
            return
        if gather == "all-gather":
            add("gather", "all-gather", n * math.prod(sh.block_shape(shape)) * itemsize, n)
        else:
            add("gather", "all-reduce", math.prod(shape) * itemsize, n)

    return out, add, gather_of


def moe_collectives(cfg, add, gather: str, r_data: int, tokens: int, want_aux: bool) -> None:
    """``add`` a MoE model's collectives over R = ``r_data`` data ranks in
    one pass of ``tokens`` tokens a rank (``layers.moe_fwd``), each layer:
    with ``want_aux`` the SUM of the E first-choice counts (fp32), and
    where the whole batch's routing group (``_moe_group_size(R ·
    tokens)``) does not divide the rank's tokens the gather of every rank's
    top-k experts ((k, tokens) int32 a rank; ``gather`` as
    :func:`rank_collectives` takes it)."""
    from repro_torch.models.layers import _moe_group_size

    if cfg.moe is None or r_data == 1:
        return
    spans = tokens % _moe_group_size(r_data * tokens) != 0
    for _ in range(cfg.n_layers):
        if want_aux:
            add("reduce", "all-reduce", cfg.moe.n_experts * 4, r_data)
        if spans:
            add("gather", gather, r_data * cfg.moe.top_k * tokens * 4, r_data)


def serve_collectives(cfg, bundle, mesh, gather: str = "all-gather", n_tokens: int = 2,
                      load_blocks: bool = False, logits: bool = False,
                      dtype=None) -> dict | None:
    """The collectives a rank of ``launch.serve.Server`` runs on a mesh of
    ranks shaped like ``mesh`` (``bundle``: the serve step built on it, or
    the prefill step): ``{op: {"calls", "bytes"}}``. Over M > 1 model ranks
    each collective of the group runs over them, M ranks.

    * ``load_blocks``: loading this rank's blocks of the fp32 parameters
      (``params_pspecs``) as its TP blocks, one gather a split leaf;
    * a prefill step's bundle: one ``Server.prefill`` of this rank's rows
      of the bundle's batch (R rows × S tokens), over M > 1 model ranks the
      embedding's all-reduce (R·S·d in ``dtype``), each dense layer's two
      row-split products' all-reduces (R·S·d in fp32) and its kv re-layout
      (a gather of every kv head's k and v, 2·R·S·KV·dh in ``dtype``), each
      Mamba2 layer's norm statistic (R·S fp32), ``out_proj``'s all-reduce
      (R·S·d fp32) and its conv window's gather (the last min(K − 1, S)
      rows of every rank's x channels, R·min(K − 1, S)·di in ``dtype``),
      and the greedy token's gather of every rank's (value, index) pair
      (M·R·2 float64);
    * a serve step's bundle: ``n_tokens − 1`` decode steps, each over M > 1
      model ranks the embedding's all-reduce, each dense layer's gather of
      the new token's q, k and v heads (R·(H + 2·KV)·dh in ``dtype``), its
      attention combine where the KV cache's sequence is split over
      "model" (three all-reduces of fp32 per row and head: the row max, 4
      B, the softmax's sum l, 4 B, and the output o, 4 · dh B) and its two
      row-split products' all-reduces, each Mamba2 layer's conv window
      gather (every rank's cache block where its channels split, and its
      new x channels: R·((K − 1)·(di + 2n) + di) in ``dtype``, or R·di),
      norm statistic (R fp32) and ``out_proj``'s all-reduce, and the greedy
      token's gather; then the gather of the (B, n_tokens) int64 tokens
      over the ranks;
    * ``logits``: :meth:`Server.gather_logits` of what the call kept (the
      prefill's (R, 1, V) logits, or the decode's (R, n_tokens − 1, V)).

    ``dtype`` is the serving type (the serve step's cache's by default,
    else bf16). ``None`` where the rank ``Server`` refuses the case
    (``launch.steps.check_rank_serving``) or the mesh is not (data, model).
    """
    import torch

    from repro_torch.flatten_util import tree_leaves
    from repro_torch.launch.sharding import Sharding, params_pspecs, to_shardings
    from repro_torch.launch.steps import check_rank_serving
    from repro_torch.models.cache import cache_leaves

    if tuple(mesh.axis_names) != ("data", "model"):
        return None
    try:
        check_rank_serving(cfg, mesh)
    except ValueError:
        return None
    out, add, gather_of = _reckoner(mesh, gather)
    models = mesh.shape["model"]
    if load_blocks:  # a MoE model serves over one model rank: its expert split is moot
        specs = to_shardings(params_pspecs(bundle.arg_structs["params"], mesh, None), mesh)
        for x, sh in zip(tree_leaves(bundle.arg_structs["params"]), tree_leaves(specs),
                         strict=True):
            gather_of(x.shape, x.element_size(), sh)
    decode = "cache" in bundle.arg_structs
    if dtype is None:
        dtype = cache_leaves(bundle.arg_structs["cache"])[0].dtype if decode else torch.bfloat16
    size = dtype.itemsize

    def reduce_over_model(nbytes):
        add("reduce", "all-reduce", nbytes, models)

    def gather_over_model(result):  # the whole result a rank gets
        add("gather", "all-gather" if gather == "all-gather" else "all-reduce", result, models)

    d, dh, kv = cfg.d_model, cfg.head_dim, cfg.n_kv_heads
    ssm = cfg.arch_type == "ssm"
    if not decode:
        tokens = bundle.arg_structs["batch"]["tokens"]
        rows, s = bundle.in_shardings["batch"]["tokens"].block_shape(tokens.shape)
        moe_collectives(cfg, add, gather, tokens.shape[0] // rows, rows * s, want_aux=False)
        if models > 1:
            reduce_over_model(rows * s * d * size)
            for _ in range(cfg.n_layers):
                if ssm:  # the conv window's x channels, the norm, out_proj
                    window = min(cfg.ssm.conv_kernel - 1, s)
                    gather_over_model(rows * window * cfg.ssm.d_inner(d) * size)
                    reduce_over_model(rows * s * 4)
                else:
                    gather_over_model(2 * rows * s * kv * dh * size)
                    reduce_over_model(rows * s * d * 4)
                reduce_over_model(rows * s * d * 4)
            gather_over_model(models * rows * 2 * 8)
            if logits:
                gather_over_model(rows * cfg.vocab_padded * size)
        return out
    token = bundle.arg_structs["token"]
    rows = bundle.in_shardings["token"].block_shape(token.shape)[0]
    split_seq = (cfg.arch_type == "dense"
                 and not Sharding(mesh, (bundle.in_shardings["cache"].k.spec[2],)).replicated())
    for _ in range(n_tokens - 1):
        moe_collectives(cfg, add, gather, token.shape[0] // rows, rows, want_aux=False)
        if models > 1:
            reduce_over_model(rows * d * size)
        for _ in range(cfg.n_layers):
            if models > 1 and ssm:  # the conv window, the norm, out_proj
                gather_over_model(rows * _window_payload(cfg, bundle) * size)
                reduce_over_model(rows * 4)
                reduce_over_model(rows * d * 4)
                continue
            if models > 1:
                gather_over_model(rows * (cfg.n_heads + 2 * kv) * dh * size)
            if split_seq:
                for width in (1, 1, dh):  # m, l, o
                    reduce_over_model(rows * cfg.n_heads * width * 4)
            if models > 1:
                reduce_over_model(rows * d * 4)
                reduce_over_model(rows * d * 4)
        if models > 1:
            gather_over_model(models * rows * 2 * 8)
    if logits and models > 1:
        gather_over_model(rows * (n_tokens - 1) * cfg.vocab_padded * size)
    gather_of((token.shape[0], n_tokens), 8, bundle.in_shardings["token"])
    return out


def _window_payload(cfg, bundle) -> int:
    """The values a decode step's conv window gather takes from a rank a
    row (``layers._decode_window``), every rank's together: its new x
    channels, di in all, and, where the cache splits the window's channels
    over "model", its cache block, (K − 1)·(di + 2n) in all."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    conv = bundle.in_shardings["cache"].conv
    return di + (0 if conv.replicated() else (s.conv_kernel - 1) * (di + 2 * s.d_state))


def rank_collectives(cfg, bundle, mesh, gather: str = "all-gather",
                     n_fl: int | None = None, dtype=None, n_probes: int = 4,
                     **serving) -> dict | None:
    """The collectives of one trainer round a rank in sketch mode, as the
    port's rank steps issue them on a mesh of ranks shaped like ``mesh``
    (``bundle`` the train step built on it) over ``n_fl`` FL devices (the
    bundle's: one a data rank), with ``n_probes`` probes and the compute
    type ``dtype`` (bf16 by default, the trainer's): ``{op: {"calls",
    "bytes"}}`` for ``gather``, ``reduce`` and ``broadcast``, the bytes a
    rank's wire bytes by the ring rule. A gather runs over every rank, as
    an all-gather of the blocks or (``gather="all-reduce"``) an all-reduce
    of a zero-filled whole. ``None`` where the rank trainer does not run, a
    mesh other than (data, model); a dense model over model ranks that do
    not divide its split dimensions raises ``sharding.NotDivisible``, as
    the rank steps do. A serving bundle (no
    ``coeffs``) is reckoned by :func:`serve_collectives`, which takes
    ``dtype`` and ``serving``'s keywords.

    Over M > 1 model ranks a dense or SSM model trains tensor-parallel
    (``steps.tp_trains``), and each rank runs these all-reduces over
    "model" (R rows of S tokens a data rank, d the width, CE chunks of C =
    min(CE_CHUNK, S − 1) rows, n_c of them): in each of the 1 + n_probes
    JVP passes the embedding's SUM (R·S·d in ``dtype``), each dense
    layer's two row-split SUMs (R·S·d fp32), each Mamba2 layer's norm
    statistic (R·S fp32) and ``out_proj``'s SUM (R·S·d fp32), and each
    chunk's MAX, SUM of exponentials and target SUM (R·C fp32 each), every
    SUM once for the primal and once for the tangent; in the train step, a
    microbatch of R/m rows at a time, the forward's (the same, primal
    only), the remat recompute's (each layer's SUMs and each chunk's three
    reductions again: the step runs its checkpoints without early stop)
    and the backward's, where each dense layer's two ``copy_to_group`` and
    each chunk's head one sum their gradient (R·S·d and R·C·d in
    ``dtype``), and each Mamba2 layer's input copy (R·S·d in ``dtype``),
    its norm statistic's copy (R·S fp32) and its B and C weight slices'
    copies (``in_proj`` d·2n, ``conv_w`` K·2n, ``conv_b`` 2n, in
    ``dtype``).

    Over R > 1 data ranks a MoE model (:func:`moe_collectives`) runs each
    layer's gather of the top-k experts (where a routing group spans ranks)
    in each JVP pass, and in the train step, a microbatch at a time, that
    gather and the load-balance loss's SUM in the forward and again in the
    remat recompute."""
    import torch

    from repro_torch.flatten_util import tree_leaves
    from repro_torch.launch.sharding import Sharding
    from repro_torch.launch.steps import auto_microbatches, compute_shardings, tp_trains
    from repro_torch.models.config import InputShape
    from repro_torch.models.transformer import CE_CHUNK

    if "coeffs" not in bundle.arg_structs:
        return serve_collectives(cfg, bundle, mesh, gather, dtype=dtype, **serving)
    if tuple(mesh.axis_names) != ("data", "model"):
        return None
    r_data, models, n = mesh.shape["data"], mesh.shape["model"], mesh.size()
    n_fl = n_fl or bundle.arg_structs["coeffs"].shape[0]
    size = (dtype or torch.bfloat16).itemsize
    p_structs = bundle.arg_structs["params"]
    structs = tree_leaves(p_structs)
    masters = tree_leaves(bundle.in_shardings["params"])
    computed = tree_leaves(compute_shardings(cfg, mesh, p_structs))
    out, add, gather_of = _reckoner(mesh, gather)

    def over_model(nbytes: int) -> None:
        add("reduce", "all-reduce", nbytes, models)

    for _step in ("stats", "train"):  # each step gathers the whole masters
        for x, sh in zip(structs, masters, strict=True):
            gather_of(x.shape, x.element_size(), sh)
    if tp_trains(cfg, mesh):
        b, s = bundle.arg_structs["batch"]["tokens"].shape
        rows, d = b // r_data, cfg.d_model
        chunk = min(CE_CHUNK, s - 1)
        n_chunks = -(-(s - 1) // chunk)
        ssm = cfg.arch_type == "ssm"

        def layer(r: int) -> None:  # a layer's forward SUMs, primal or tangent
            over_model(r * s * (4 if ssm else d * 4))  # the norm statistic, or a row split
            over_model(r * s * d * 4)

        def forward(r: int, sums: int) -> None:  # sums: 2 with a tangent, else 1
            for _ in range(sums):
                over_model(r * s * d * size)
            for _ in range(cfg.n_layers * sums):
                layer(r)
            for _ in range(n_chunks * (1 + 2 * sums)):
                over_model(r * chunk * 4)

        def copies(r: int) -> None:  # a layer's copy_to_group gradients
            if not ssm:
                for _ in range(2):
                    over_model(r * s * d * size)
                return
            n, k = cfg.ssm.d_state, cfg.ssm.conv_kernel
            for nbytes in (r * s * d * size, r * s * 4, d * 2 * n * size, k * 2 * n * size,
                           2 * n * size):  # x, the norm, in_proj's, conv_w's, conv_b's B, C
                over_model(nbytes)

        for _pass in range(1 + n_probes):
            forward(rows, 2)
        n_micro = auto_microbatches(cfg, InputShape("train", s, b, "train"), mesh)
        r = rows // n_micro
        for _micro in range(n_micro):
            forward(r, 1)
            for _ in range(cfg.n_layers):  # the recompute's SUMs
                layer(r)
            for _ in range(n_chunks * 3):
                over_model(r * chunk * 4)
            for _ in range(cfg.n_layers):  # the copies' gradients
                copies(r)
            for _ in range(n_chunks):
                over_model(r * chunk * d * size)
    if cfg.moe is not None and r_data > 1:
        b, s = bundle.arg_structs["batch"]["tokens"].shape
        for _pass in range(1 + n_probes):
            moe_collectives(cfg, add, gather, r_data, b // r_data * s, want_aux=False)
        n_micro = auto_microbatches(cfg, InputShape("train", s, b, "train"), mesh)
        for _micro in range(n_micro):
            for _run in ("forward", "recompute"):
                moe_collectives(cfg, add, gather, r_data, b // r_data // n_micro * s, True)
    # the sketched (mean, var, norm) of each FL device, split over the data ranks
    gather_of((3, n_fl), 4, Sharding(mesh, (None, "data")))
    if r_data > 1:
        for x, tp in zip(structs, computed):  # the fp32 gradients' compute blocks, the loss
            add("reduce", "all-reduce", math.prod(tp.block_shape(x.shape)) * 4, r_data)
        add("reduce", "all-reduce", 4, r_data)
    for x, tp, sh in zip(structs, computed, masters):  # gradients gathered over "model"
        if not tp.holds(sh):
            result = models * math.prod(tp.block_shape(x.shape)) * 4
            add("gather", "all-gather" if gather == "all-gather" else "all-reduce", result,
                models)
    add("broadcast", "broadcast", 8 * (n_fl + 4), n)  # coeffs, ν, e_com, a, |S| in float64
    return out


def compute_weight_bytes(cfg, mesh) -> int:
    """A rank's bytes of the fp32 weights its training steps differentiate
    (``steps.compute_shardings``: a dense or SSM model's TP blocks over M > 1
    model ranks, else the whole model); raises ``sharding.NotDivisible``
    where the model ranks do not divide a split dimension."""
    from repro_torch.launch.sharding import sharded_bytes
    from repro_torch.launch.steps import compute_shardings, params_structs

    structs = params_structs(cfg)
    return sharded_bytes(structs, compute_shardings(cfg, mesh, structs))


def step_flops(bundle, seq_len: int) -> int:
    """The step's global FLOPs: ``FlopCounterMode`` over its function on
    its meta ``arg_structs`` (a decode step's position ``t``, a host
    integer to the model, at the cache's last slot ``seq_len − 1``)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    args = dict(bundle.arg_structs)
    if "t" in args:
        args["t"] = torch.tensor(seq_len - 1, dtype=args["t"].dtype)
    with FlopCounterMode(display=False) as counter:
        bundle.fn(**args)
    return int(counter.get_total_flops())


def card_memory() -> dict | None:
    """The card's name and memory when one is present, else ``None``."""
    import torch

    if not torch.cuda.is_available():
        return None
    return {"name": torch.cuda.get_device_name(0),
            "memory_bytes": int(torch.cuda.mem_get_info(0)[1])}


def run_one(arch: str, shape_name: str, multi_pod: bool = False, verbose: bool = True, *,
            mesh: str | None = None, layers: int | None = None, batch: int | None = None,
            seq: int | None = None, flops: bool = True, flops_cache: dict | None = None,
            gather: str = "all-gather"):
    """The record of one (arch × shape × mesh): ``mesh`` names it (default:
    the production mesh, ``multi_pod`` picking which); ``layers``, ``batch``
    and ``seq`` cut the model's depth and the shape. ``flops_cache`` keeps
    a FLOP count across meshes (it does not depend on the mesh); ``gather``
    how the ranks gather (:func:`rank_collectives`)."""
    import torch

    from repro_torch import configs
    from repro_torch.launch.sharding import NotDivisible, served_bytes, sharded_bytes, to_shardings
    from repro_torch.launch.steps import _param_specs, build_step, params_structs, tp_trains
    from repro_torch.models.config import INPUT_SHAPES

    mesh_name = mesh or ("2x16x16" if multi_pod else "16x16")
    shape = INPUT_SHAPES[shape_name]
    if not configs.supports_shape(arch, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skipped",
                "reason": "pure full-attention arch — no long_500k variant (DESIGN §4)"}
    shape = dataclasses.replace(shape, global_batch=batch or shape.global_batch,
                                seq_len=seq or shape.seq_len)
    cfg = configs.cut_depth(configs.get_config(arch, shape), layers)
    smesh = make_mesh(mesh_name)
    t0 = time.time()
    try:
        bundle = build_step(cfg, shape, smesh)
    except NotDivisible as e:  # the model ranks cannot split this model's serving step
        # beside the reason, a rank's weight bytes by the specs' blocks
        # (``params_pspecs``, the layout the trainer's masters take)
        spec_sh = to_shardings(_param_specs(cfg, shape, smesh), smesh)
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skipped",
                "reason": str(e),
                "spec_params_bytes": sharded_bytes(params_structs(cfg), spec_sh)}
    train = shape.kind == "train"
    args = state_bytes(bundle)
    residual = residual_bytes(cfg, shape, smesh) if train else 0
    compute, layout = None, None
    try:
        coll = rank_collectives(cfg, bundle, smesh, gather)
        if train:
            compute = compute_weight_bytes(cfg, smesh)
            layout = "tensor-parallel" if tp_trains(cfg, smesh) else "whole"
    except NotDivisible as e:  # the rank trainer refuses it; its bytes stay the specs'
        coll, layout = None, str(e)
    t_reckon = time.time() - t0
    key = (arch, shape, layers)
    if flops and flops_cache is not None and key in flops_cache:
        n_flops = flops_cache[key]
    elif flops:
        n_flops = step_flops(bundle, shape.seq_len)
        if flops_cache is not None:
            flops_cache[key] = n_flops
    else:
        n_flops = None
    argument = sum(args.values())
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "status": "ok",
        "n_devices": smesh.devices.size,
        "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
        "n_layers": cfg.n_layers,
        "memory": {
            "argument_bytes": argument,
            "by_argument": args,
            "residual_bytes": residual,
            "reckoned_bytes": argument + residual,
            "temp_bytes": None,
            "peak_bytes": None,
        },
        "not_estimated": NOT_ESTIMATED,
        "cost": {"flops_global": n_flops},
        "collectives": coll,
        "collective_bytes_per_device": (None if coll is None else
                                        sum(v["bytes"] for v in coll.values())),
        "served_weight_bytes": (None if train or coll is None else
                                served_bytes(bundle.arg_structs["params"],
                                             bundle.in_shardings["params"], torch.bfloat16)),
        "compute_weight_bytes": compute,
        "compute_layout": layout,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "reckon_s": round(t_reckon, 2),
        "seconds": round(time.time() - t0, 2),
    }
    if smesh.devices.size == 1:
        card = card_memory()
        rec["card"] = card
        rec["fits"] = None if card is None else argument + residual <= card["memory_bytes"]
    if verbose:
        flops_txt = "n/a" if n_flops is None else f"{n_flops:.3e}"
        coll_bytes = rec["collective_bytes_per_device"]
        coll_txt = "n/a" if coll_bytes is None else f"{coll_bytes / 2**20:9.1f} MiB/dev"
        print(f"[dryrun] {arch:>22s} × {shape_name:<12s} mesh={mesh_name:>8s}"
              f"  reckoned={rec['memory']['reckoned_bytes'] / 2**30:9.2f} GiB/dev"
              f"  flops={flops_txt}"
              f"  coll={coll_txt}"
              f"  ({rec['seconds']:.1f}s)", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="both production meshes (16x16 and 2x16x16)")
    ap.add_argument("--mesh", action="append", default=[],
                    help="a mesh by name (DxM or PxDxM; 1x1 is one card); repeatable")
    ap.add_argument("--layers", type=int, default=None, help="cut every model to this depth")
    ap.add_argument("--batch", type=int, default=None, help="the shapes' global batch")
    ap.add_argument("--seq", type=int, default=None, help="the shapes' sequence length")
    ap.add_argument("--no-flops", action="store_true", help="skip the FLOP count")
    ap.add_argument("--gather", default="all-gather", choices=("all-gather", "all-reduce"),
                    help="how the ranks gather: all-gather (NCCL, gloo on the CPU) or a "
                         "zero-filled all-reduce (gloo with CUDA tensors)")
    ap.add_argument("--json", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.models.config import INPUT_SHAPES

    archs = list(configs.ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = list(args.mesh)
    if args.both_meshes:
        meshes = ["16x16", "2x16x16"] + meshes
    elif not meshes:
        meshes = ["2x16x16" if args.multi_pod else "16x16"]

    records = []
    failures = 0
    flops_cache: dict = {}
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                try:
                    rec = run_one(arch, shape, mesh=mesh, layers=args.layers, batch=args.batch,
                                  seq=args.seq, flops=not args.no_flops,
                                  flops_cache=flops_cache, gather=args.gather)
                except Exception as e:  # noqa: BLE001 — report and continue
                    rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                    print(f"[dryrun] FAIL {arch} × {shape} × {mesh}: {rec['error']}",
                          flush=True)
                records.append(rec)
                if args.json:
                    with open(args.json, "a") as f:
                        f.write(json.dumps(rec) + "\n")

    ok = sum(1 for r in records if r["status"] == "ok")
    sk = sum(1 for r in records if r["status"] == "skipped")
    print(f"[dryrun] done: {ok} ok, {sk} skipped, {failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
