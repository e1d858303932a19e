"""The LM's step functions: train_step / stats_step / prefill_step / serve_step.

Port of ``repro.launch.steps``. Each ``build_*`` returns a
:class:`StepBundle` ``(fn, arg_structs, in_shardings, out_shardings)``:
``fn`` is a plain function (eager PyTorch, nothing compiled) and
``arg_structs`` are meta-device tensors of its arguments (shapes and
types, no storage: :func:`repro_torch.configs.input_specs`). The
shardings depend on the mesh (:mod:`repro_torch.launch.mesh`):

  * one card (``HostMesh``): ``None``, everything whole;
  * the shape-only production mesh: the reference's layout
    (:mod:`repro_torch.launch.sharding`: ``params_pspecs``, ``opt_pspecs``,
    ``batch_pspecs``, ``cache_pspecs`` through ``to_shardings``), which
    the dry run reads; ``fn`` is the global step, whole tensors in and out;
  * a mesh of ranks (``RankMesh``): the same layout, and ``fn`` takes and
    returns THIS rank's blocks (the serving steps take a dense or SSM
    model's TP blocks, ``sharding.tp_pspecs``: :func:`build_prefill_step`,
    :func:`build_serve_step`; the training steps cut them from the
    masters: :func:`build_train_step`, :func:`build_stats_step`).

PO-FL at model scale:
  * FL device = one slice of the global batch, FL-device-major: examples
    ``d · b/n_fl … (d + 1) · b/n_fl − 1`` are device d's; n_fl =
    :func:`repro_torch.launch.mesh.batch_ways`. Over ranks, data rank r
    holds FL devices r·n_fl/R … (r + 1)·n_fl/R − 1 and their examples.
  * The AirComp weighted superposition Σ_d c_d · g_d is realised as
    per-example loss weights c_d · n_fl: the mean gradient over the batch
    then equals the PO-FL aggregate (over ranks: the mean over the data
    ranks of each rank's mean gradient).
  * Receiver noise (Eq. 16): ν · z added to every gradient leaf after the
    backward, ν = √V_g / a · σ_z from the round's schedule and channel.

A train step over ranks, on each rank: gather the whole fp32 masters,
run the weighted backward on its data rank's slice of the batch, all-reduce
the gradients (and the loss) over the data ranks and divide by their
count, keep this rank's block, add ν·z on the block and run the optimizer
on the blocks. Over M > 1 model ranks a dense or SSM model is split
tensor-parallel (:func:`tp_trains`): each rank cuts its TP blocks
(``sharding.tp_pspecs``) from the gathered masters and differentiates the
loss on them over its model group (:func:`model_group`: the layers'
collectives carry their backward and tangent rules), so each rank's
gradient is its TP block's; a TP block that holds the rank's master block
gives it directly, any other (``wo``, ``w_out`` and ``out_proj``, whose
masters split their last dim where TP splits their rows, Mamba2's
segmented ``in_proj``, ``conv_w`` and ``conv_b``, and leaves the spec
keeps whole) is gathered whole over "model" first (:func:`master_grads`).
The other families still compute the same gradients whole on every model
rank (what ROADMAP A14.9 holds: the hybrid over model ranks).
Over R > 1 data ranks a MoE model routes each rank's rows in the whole
batch's routing groups over its data group (:func:`data_group`;
``layers.moe_fwd``), and each rank's loss carries its share of the batch's
load-balance loss, so the mean over the data ranks is the batch's. The
collectives are plain ``torch.distributed`` calls that run on NCCL and
gloo (:meth:`repro_torch.launch.sharding.Sharding.gather`).

Gradients come from ``torch.autograd.grad`` (``torch.func.grad`` refuses
the checkpoints of ``remat`` and the chunked CE), the statistics from
``torch.func.jvp`` (:mod:`repro_torch.core.sketch`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro_torch import configs
from repro_torch.core.sketch import sketch_device_stats
from repro_torch.flatten_util import tree_leaves, tree_map, tree_unflatten
from repro_torch.launch.mesh import HostMesh, RankMesh, batch_ways, wire_bytes
from repro_torch.launch.sharding import (
    TP_FAMILIES, Sharding, _batched, batch_pspecs, cache_shardings, moe_strategy,
    params_pspecs, tensor_bytes, to_shardings, tp_pspecs,
)
from repro_torch.models import api, encdec, transformer
from repro_torch.models.cache import init_attn_cache, init_ssm_cache
from repro_torch.models.layers import DataGroup, ModelGroup, greedy
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.obs.registry import gauge_set
from repro_torch.optim.optimizers import OptState, Optimizer, adamw


class StepBundle(NamedTuple):
    fn: object            # the step function
    arg_structs: dict     # meta tensors of its keyword arguments
    in_shardings: object  # None on one card, else a Sharding tree an argument
    out_shardings: object


def params_structs(cfg: ModelConfig):
    """``cfg``'s parameters as meta tensors."""
    gen, meta = torch.Generator(), torch.device("meta")
    if cfg.arch_type == "encdec":
        return encdec.init_encdec(cfg, gen, device=meta)
    return transformer.init_model(cfg, gen, device=meta)


def opt_structs(optimizer: Optimizer, p_structs):
    return optimizer.init(p_structs)


def opt_pspecs(p_specs, o_structs):
    """The optimizer state's specs mirror the parameters' (FSDP: mu and nu
    shard with p); the step count is replicated."""
    mu = p_specs if o_structs.mu is not None else None
    nu = p_specs if o_structs.nu is not None else None
    return OptState(step=(), mu=mu, nu=nu)


def _param_specs(cfg, shape, mesh):
    return params_pspecs(params_structs(cfg), mesh, moe_strategy(cfg, shape, mesh))


def _replicated(structs, mesh):
    """A whole-on-every-rank Sharding for each tensor of a dict tree."""
    return tree_map(lambda x: Sharding(mesh, (None,) * x.dim()), structs)


def _cast(params, dtype):
    """The float32 leaves cast to ``dtype`` (the compute weights)."""
    return tree_map(lambda x: x.to(dtype) if x.dtype == torch.float32 else x, params)


def gather_params(blocks, shardings):
    """The whole parameters from every rank's blocks (one gather a leaf)."""
    return tree_unflatten(blocks, [sh.gather(x) for x, sh in
                                   zip(tree_leaves(blocks), tree_leaves(shardings))])


def block_of(whole, shardings):
    """This rank's blocks of a whole dict tree."""
    return tree_unflatten(whole, [sh.block(x) for x, sh in
                                  zip(tree_leaves(whole), tree_leaves(shardings))])


class _RankSlice(NamedTuple):
    """A data rank's FL devices: ``lo … lo + n_local − 1`` of ``n_fl``."""

    data_ranks: int
    lo: int
    n_local: int


def _rank_slice(mesh: RankMesh) -> _RankSlice:
    """This rank's FL devices, every family's (a MoE model's routing groups
    and load-balance loss span the whole batch: its steps route over the
    data group, :func:`data_group`)."""
    r_data = mesh.shape["data"]
    n_local = mesh.n_fl // r_data
    return _RankSlice(r_data, mesh.coordinates()["data"] * n_local, n_local)


def _mean_over_data(x: torch.Tensor, mesh: RankMesh, r_data: int) -> torch.Tensor:
    """The mean of ``x`` over the data ranks (in place; every rank gets it)."""
    import torch.distributed as dist

    if r_data == 1:
        return x
    with mesh.collective("reduce", wire_bytes("all-reduce", x.numel() * x.element_size(),
                                              r_data)):
        dist.all_reduce(x, group=mesh.get_group("data"))
    return x.div_(r_data)


def tp_trains(cfg: ModelConfig, mesh) -> bool:
    """Whether the rank steps split ``cfg`` tensor-parallel over ``mesh``'s
    model ranks: a dense or SSM model over M > 1 of them. The other
    families compute whole on every model rank (ROADMAP A14.9 holds their
    split)."""
    return cfg.arch_type in TP_FAMILIES and mesh.shape["model"] > 1


def compute_shardings(cfg: ModelConfig, mesh, p_structs):
    """The Shardings of the weights a rank's training steps compute on: a
    dense or SSM model's TP blocks over M > 1 model ranks (``sharding.tp_pspecs``,
    which raises ``sharding.NotDivisible`` naming each dimension M does not
    divide), elsewhere every leaf whole (:func:`tp_trains`)."""
    if not tp_trains(cfg, mesh):
        return _replicated(p_structs, mesh)
    return to_shardings(tp_pspecs(p_structs, cfg, mesh), mesh)


def compute_layout(cfg: ModelConfig, mesh: RankMesh, p_structs):
    """:func:`compute_shardings` and the model group the steps compute
    over (:func:`model_group`; ``None`` where they compute whole)."""
    tp_sh = compute_shardings(cfg, mesh, p_structs)
    return tp_sh, model_group(mesh) if tp_trains(cfg, mesh) else None


def _tp_dim(sh: Sharding) -> int:
    """The dim a TP Sharding splits over "model"."""
    return next(d for d, e in enumerate(sh.spec) if e is not None)


def _whole_over_model(g: torch.Tensor, tp: Sharding, shape, group: ModelGroup) -> torch.Tensor:
    """The whole tensor of ``shape`` from every model rank's TP block ``g``
    (one all-gather along the TP dim, each rank's block then placed at its
    index: a contiguous block or a ``Segments`` one alike)."""
    d = _tp_dim(tp)
    whole = g.new_empty(shape)
    coords = tp.mesh.coordinates()
    for r, part in enumerate(group.all_gather(g, d).chunk(group.size, d)):
        whole[tp.index({**coords, "model": r}, shape)] = part
    return whole


def master_grads(grads: list, p_structs, tp_sh, p_sh, group: ModelGroup | None) -> list:
    """This rank's master blocks (``p_sh``) of the gradients it took on its
    compute blocks (``tp_sh``; both trees like ``p_structs``, the grads in
    their sorted-key leaf order). A compute block that holds the master
    block (``Sharding.holds``: the vocabulary, head and MLP column blocks,
    the whole norms) gives it by a cut; any other is gathered whole over
    the model group first (``wo``, ``w_out`` and ``out_proj``, whose
    masters split the last dim where TP splits the rows, the segmented
    Mamba2 leaves, and the leaves the spec keeps whole but TP splits, as
    the q, k and v biases and Mamba2's per-head leaves)."""
    out = []
    for g, x, tp, sh in zip(grads, tree_leaves(p_structs), tree_leaves(tp_sh),
                            tree_leaves(p_sh), strict=True):
        if tp.holds(sh):
            out.append(tp.cut(sh, g, x.shape))
        else:
            out.append(sh.block(_whole_over_model(g, tp, x.shape, group)))
    return out


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------


def auto_microbatches(cfg: ModelConfig, shape: InputShape, mesh,
                      budget_gib: float = 4.0) -> int:
    """Gradient-accumulation factor: split the global batch until the
    remat-saved residual carries (n_layers · B·S·D · 2 bytes / chips) fit
    ``budget_gib``. Powers of two; keeps ≥ 1 example an FL slice. The
    reference's budget, whose calibration is for its TPU target."""
    n_chips = mesh.devices.size
    n_fl = batch_ways(mesh)
    n_layers = cfg.n_layers + (cfg.encdec.n_enc_layers if cfg.encdec is not None else 0)
    act_gib = n_layers * shape.global_batch * shape.seq_len * cfg.d_model * 2 / n_chips / 2**30
    m = 1
    while act_gib / m > budget_gib and shape.global_batch // (m * 2) >= n_fl:
        m *= 2
    return m


def add_noise(grads, noise_amp: torch.Tensor, z):
    """Eq. 16's receiver noise: ν · z added to every gradient leaf (z a dict
    like the grads)."""
    return tree_unflatten(grads, [g + noise_amp.to(g.dtype) * zl
                                  for g, zl in zip(tree_leaves(grads), tree_leaves(z))])


def _weighted_grads(cfg, dtype, remat, n_micro, group: ModelGroup | None = None,
                    data: DataGroup | None = None):
    """``fn(params, batch, w, n_dev) → (loss, grads list)``: the weighted
    loss of a batch of ``n_dev`` FL devices (FL-device-major) and its
    gradients in sorted-key leaf order. With microbatches the batch is
    interleaved so every microbatch holds b/(m · n_dev) examples of every
    FL device, and the grads (and the loss) are averaged over them.
    ``group``: the model ranks a dense model is split over, ``params``
    this rank's TP blocks; ``data``: the data ranks a MoE model's rows are
    split over (each microbatch routes over them on its own, as the
    reference's scan routes each microbatch). With either the remat's
    recompute runs every layer and CE chunk to its end (checkpoint early
    stop off), so it issues every forward collective again, as
    ``launch.dryrun`` reckons it."""

    def run(params, batch, w, n_dev):
        b = w.shape[0]
        p = tree_map(lambda x: x.detach().requires_grad_(), params)
        leaves = tree_leaves(p)

        def loss_grads(mb, mw):
            whole_recompute = (contextlib.nullcontext() if group is None and data is None
                               else set_checkpoint_early_stop(False))
            with whole_recompute:
                loss, aux = api.model_loss(_cast(p, dtype), cfg, mb, dtype=dtype, remat=remat,
                                           loss_weights=mw, group=group, data=data)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        if n_micro == 1:
            return loss_grads(batch, w)

        def to_micro(x):
            per = b // n_dev
            x = x.reshape((n_dev, n_micro, per // n_micro) + tuple(x.shape[1:]))
            return x.movedim(1, 0).reshape((n_micro, b // n_micro) + tuple(x.shape[3:]))

        mbs = {k: to_micro(v) for k, v in batch.items()}
        mws = to_micro(w)
        grads = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in leaves]
        loss = torch.zeros((), device=w.device)
        for i in range(n_micro):
            l_i, g_i = loss_grads({k: v[i] for k, v in mbs.items()}, mws[i])
            grads = [acc + g for acc, g in zip(grads, g_i)]
            loss = loss + l_i
        return loss / n_micro, [g / n_micro for g in grads]

    return run


def build_train_step(
    cfg: ModelConfig,
    shape: InputShape,
    mesh,
    optimizer: Optimizer,
    dtype=torch.bfloat16,
    remat: bool = True,
    aircomp_noise: bool = True,
    n_microbatches: int | None = None,
) -> StepBundle:
    """``fn(params, opt_state, batch, coeffs, noise_amp, noise) →
    (params, opt_state, loss)``: the weighted backward (the AirComp
    superposition), Eq. 16 noise (``noise``: the z leaves, a dict like the
    params, :func:`add_noise`) and the optimizer's update.

    The weights are fp32 masters; the differentiated function casts them
    to ``dtype`` inside, so the grads arrive in fp32. On a mesh of ranks
    ``params``, ``opt_state``, ``batch`` and ``noise`` are this rank's
    blocks (``in_shardings``) and so are the new params and state; the
    loss is the whole batch's.
    """
    n_fl = batch_ways(mesh)
    batch_struct = configs.input_specs(cfg, shape, dtype)["batch"]
    b = batch_struct["tokens"].shape[0]
    if b % n_fl:
        raise ValueError(f"global batch {b} does not split over {n_fl} FL devices")
    n_micro = n_microbatches or auto_microbatches(cfg, shape, mesh)
    if b % (n_micro * n_fl):
        raise ValueError(f"global batch {b} does not split into {n_micro} microbatches "
                         f"of {n_fl} FL devices")
    grads_of = _weighted_grads(cfg, dtype, remat, n_micro)

    p_structs = params_structs(cfg)
    o_structs = opt_structs(optimizer, p_structs)
    meta = torch.device("meta")
    arg_structs = dict(
        params=p_structs,
        opt_state=o_structs,
        batch=batch_struct,
        coeffs=torch.empty((n_fl,), device=meta),
        noise_amp=torch.empty((), device=meta),
        noise=p_structs,
    )

    def train_step(params, opt_state, batch, coeffs, noise_amp, noise):
        # per-example weights: examples of FL device d get c_d · n_fl, so the
        # mean gradient over the batch is Σ_d c_d · g_d (the PO-FL aggregate)
        w = torch.repeat_interleave(coeffs * n_fl, b // n_fl)
        loss, grads = grads_of(params, batch, w, n_fl)
        grads = tree_unflatten(params, grads)
        if aircomp_noise:
            grads = add_noise(grads, noise_amp, noise)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, loss

    if isinstance(mesh, HostMesh):
        return StepBundle(train_step, arg_structs, None, None)

    p_specs = _param_specs(cfg, shape, mesh)
    p_sh = to_shardings(p_specs, mesh)
    in_sh = dict(
        params=p_sh,
        opt_state=to_shardings(opt_pspecs(p_specs, o_structs), mesh),
        batch=to_shardings(batch_pspecs(batch_struct, mesh), mesh),
        coeffs=Sharding(mesh, (None,)),
        noise_amp=Sharding(mesh, ()),
        noise=p_sh,
    )
    out_sh = (in_sh["params"], in_sh["opt_state"], Sharding(mesh, ()))
    if not isinstance(mesh, RankMesh):
        return StepBundle(train_step, arg_structs, in_sh, out_sh)

    tp_sh, group = compute_layout(cfg, mesh, p_structs)
    part = _rank_slice(mesh)
    b_local = b // part.data_ranks
    rank_grads_of = _weighted_grads(cfg, dtype, remat, n_micro, group, moe_group(cfg, mesh))

    def rank_train_step(params, opt_state, batch, coeffs, noise_amp, noise):
        blocks = block_of(gather_params(params, p_sh), tp_sh)
        gauge_set("ranks.compute_weight_bytes", tensor_bytes(blocks), emit_event=False)
        local = coeffs[part.lo:part.lo + part.n_local]
        w = torch.repeat_interleave(local * n_fl, b_local // part.n_local)
        loss, grads = rank_grads_of(blocks, batch, w, part.n_local)
        del blocks
        loss = _mean_over_data(loss.clone(), mesh, part.data_ranks)
        grads = master_grads([_mean_over_data(g, mesh, part.data_ranks) for g in grads],
                             p_structs, tp_sh, p_sh, group)
        grads = tree_unflatten(params, grads)
        if aircomp_noise:
            grads = add_noise(grads, noise_amp, noise)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, loss

    return StepBundle(rank_train_step, arg_structs, in_sh, out_sh)


# --------------------------------------------------------------------------
# per-device statistics (the Algorithm-1 "upload M_i, V_i, ||g_i||" pass)
# --------------------------------------------------------------------------


def build_stats_step(
    cfg: ModelConfig,
    shape: InputShape,
    mesh,
    dtype=torch.bfloat16,
    n_probes: int = 4,
    remat: bool = True,
) -> StepBundle:
    """``fn(params, batch, probes) → (mean, var, norm)``, each (n_fl,): the
    JVP sketch (:func:`repro_torch.core.sketch.sketch_device_stats`) of the
    per-example losses reshaped to (n_fl, b / n_fl) and averaged. ``probes``
    is a list of ``n_probes`` param-shaped dicts. ``remat`` is passed on, but forward mode takes no
    backward, so the model runs its layers and CE chunks as plain calls
    (``models.transformer.remat_call``): the same values either way.

    On a mesh of ranks ``params`` and ``batch`` are this rank's blocks and
    the probes whole: each data rank sketches its own FL devices, and the
    three (n_fl,) results are gathered in FL order. Over M > 1 model ranks
    a dense or SSM model's passes run on this rank's TP blocks of the gathered
    parameters and of each probe (the tangent of ones is ones on the
    blocks), over its model group, D the whole model's count
    (:func:`compute_layout`); any other model computes them whole. Over
    R > 1 data ranks a MoE model's passes route over the data group
    (:func:`data_group`): its per-example losses depend on the batch's
    drops, though the pass drops the aux."""
    n_fl = batch_ways(mesh)
    batch_struct = configs.input_specs(cfg, shape, dtype)["batch"]
    b = batch_struct["tokens"].shape[0]

    def sketch(params, batch, probes, n_dev, group=None, dim=None, data=None):
        def per_device_loss(p):
            per_ex, _ = api.model_loss(p, cfg, batch, dtype=dtype, remat=remat, reduce=False,
                                       group=group, data=data)
            return per_ex.reshape(n_dev, -1).mean(dim=1)

        return sketch_device_stats(per_device_loss, params, probes, dim)

    def stats_step(params, batch, probes):
        s = sketch(params, batch, probes, n_fl)
        return s.mean, s.var, s.norm

    p_structs = params_structs(cfg)
    arg_structs = dict(params=p_structs, batch=batch_struct, probes=[p_structs] * n_probes)
    if isinstance(mesh, HostMesh):
        return StepBundle(stats_step, arg_structs, None, None)

    p_sh = to_shardings(_param_specs(cfg, shape, mesh), mesh)
    in_sh = dict(params=p_sh, batch=to_shardings(batch_pspecs(batch_struct, mesh), mesh),
                 probes=[_replicated(p_structs, mesh)] * n_probes)
    out_sh = (Sharding(mesh, (None,)),) * 3
    if not isinstance(mesh, RankMesh):
        return StepBundle(stats_step, arg_structs, in_sh, out_sh)

    tp_sh, group = compute_layout(cfg, mesh, p_structs)
    part = _rank_slice(mesh)
    by_fl = Sharding(mesh, (None, "data"))  # (3, n_fl): the FL devices over the data ranks
    dim = sum(x.numel() for x in tree_leaves(p_structs))
    data = moe_group(cfg, mesh)

    def rank_stats_step(params, batch, probes):
        blocks = block_of(gather_params(params, p_sh), tp_sh)
        s = sketch(blocks, batch, [block_of(v, tp_sh) for v in probes], part.n_local, group, dim,
                   data)
        mean, var, norm = by_fl.gather(torch.stack([s.mean, s.var, s.norm]))
        return mean, var, norm

    return StepBundle(rank_stats_step, arg_structs, in_sh, out_sh)


# --------------------------------------------------------------------------
# prefill / decode (serving)
# --------------------------------------------------------------------------


def _serving_mesh(mesh) -> bool:
    """Whether a serving step lays its arguments out by the specs (the
    production mesh, a mesh of ranks) or holds them whole (one card: a
    ``HostMesh``, or no mesh)."""
    return mesh is not None and not isinstance(mesh, HostMesh)


# what serving over ranks does not take yet, by family (ROADMAP A14.10 holds it)
_NOT_OVER_RANKS = {
    "hybrid": "a hybrid model (its attention cache and Mamba2 state together are not held "
              "over ranks yet: its shared block and HybridCache wait for the split of its "
              "Mamba2 layers and its attention together)",
    "encdec": "an enc-dec model (cache_pspecs also splits cross_k / cross_v over \"model\": "
              "kernel 3 must return its row log-sum-exp for the combine)",
    "vlm": "a VLM",
}


def _rank_serves(cfg: ModelConfig, mesh) -> bool:
    """Whether ranks serve ``cfg`` on ``mesh``: a dense or SSM model on any
    mesh (its products split over "model"), a MoE model over data ranks
    only (its rows routed in the whole batch's groups)."""
    return cfg.arch_type in TP_FAMILIES or (cfg.arch_type == "moe"
                                            and mesh.shape["model"] == 1)


def check_rank_serving(cfg: ModelConfig, mesh) -> None:
    """Serving over a (data, model) mesh of ranks takes a dense or SSM
    model on any mesh (its products split over "model") and a MoE model
    over data ranks only (:func:`_rank_serves`); raise ``ValueError`` for
    any other case, naming what ROADMAP A14.10 still holds."""
    if _rank_serves(cfg, mesh):
        return
    models = mesh.shape["model"]
    why = _NOT_OVER_RANKS.get(cfg.arch_type) or (
        f"a MoE model over {models} model ranks (its experts wait for the expert split, EP: "
        "moe_strategy)")
    raise ValueError(f"{cfg.name}: serving over ranks does not take {why} yet "
                     "(ROADMAP A14.10)")


def row_ways(mesh, global_batch: int) -> int:
    """The ways a batch of ``global_batch`` rows splits over ``mesh``'s
    batch axes (``sharding._batched``): a rank holds ``global_batch`` over
    that many of them."""
    entry = _batched(global_batch, mesh)
    return global_batch // Sharding(mesh, (entry,)).block_shape((global_batch,))[0]


def _axis_collectives(mesh: RankMesh, axis: str):
    """→ (this rank's place on ``axis``, the ranks along it, ``all_reduce(op)``
    → ``fn(x)`` in place, ``all_gather(x, dim)``): collectives over this
    rank's group along ``axis``, each counted (``ranks.reduce``,
    ``ranks.gather``) with its wire bytes by :meth:`RankMesh.collective`.
    gloo takes no all-gather of a CUDA tensor: there each rank writes its
    block into a zero-filled stack of every rank's and the stacks are
    summed by an all-reduce (exact, at twice the all-gather's wire bytes),
    as ``Sharding.gather`` does."""
    import torch.distributed as dist

    n = mesh.shape[axis]
    group = mesh.get_group(axis)
    rank = mesh.coordinates()[axis]

    def all_reduce(op):
        def run(x: torch.Tensor) -> None:
            with mesh.collective("reduce", wire_bytes("all-reduce", x.numel() * x.element_size(),
                                                      n)):
                dist.all_reduce(x, op=op, group=group)
        return run

    def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
        x = x.contiguous()
        result = n * x.numel() * x.element_size()
        if mesh.backend == "nccl" or x.device.type == "cpu":
            with mesh.collective("gather", wire_bytes("all-gather", result, n)):
                parts = [torch.empty_like(x) for _ in range(n)]
                dist.all_gather(parts, x, group=group)
        else:
            with mesh.collective("gather", wire_bytes("all-reduce", result, n)):
                stack = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
                stack[rank] = x
                dist.all_reduce(stack, group=group)
                parts = stack.unbind(0)
        return torch.cat(parts, dim=dim)

    return rank, n, all_reduce, all_gather


def model_group(mesh: RankMesh) -> ModelGroup | None:
    """This rank's model group as a :class:`~repro_torch.models.layers.ModelGroup`:
    its all-reduces (MAX and SUM) and all-gathers run over "model"
    (:func:`_axis_collectives`). ``None`` with one rank a group."""
    import torch.distributed as dist

    if mesh.shape["model"] == 1:
        return None
    rank, n, all_reduce, all_gather = _axis_collectives(mesh, "model")
    return ModelGroup(rank, n, all_reduce(dist.ReduceOp.MAX), all_reduce(dist.ReduceOp.SUM),
                      all_gather)


def data_group(mesh: RankMesh) -> DataGroup | None:
    """This rank's data group as a :class:`~repro_torch.models.layers.DataGroup`:
    its all-reduces by SUM and all-gathers run over "data"
    (:func:`_axis_collectives`: the ranks of one model place, whose rows
    make up the batch). ``None`` with one data rank."""
    import torch.distributed as dist

    if mesh.shape["data"] == 1:
        return None
    rank, n, all_reduce, all_gather = _axis_collectives(mesh, "data")
    return DataGroup(rank, n, all_reduce(dist.ReduceOp.SUM), all_gather)


def moe_group(cfg: ModelConfig, mesh: RankMesh,
              global_batch: int | None = None) -> DataGroup | None:
    """The data group a MoE model's steps route over (:func:`data_group`).
    ``None`` for any other family: none issues a collective over "data"
    inside a layer, so its checkpoints keep their early stop. ``None`` too
    for a serving batch of ``global_batch`` rows that every data rank holds
    whole (:func:`row_ways`)."""
    if cfg.moe is None or (global_batch is not None and row_ways(mesh, global_batch) == 1):
        return None
    return data_group(mesh)


def _serving_params(cfg: ModelConfig, shape: InputShape, mesh):
    """The parameters' shardings of a serving step off one card: the TP
    blocks a rank serves where ranks serve the model (:func:`_rank_serves`;
    ``tp_pspecs``: a dense or SSM model's split, every leaf whole with one
    model rank); elsewhere, on the shape-only mesh, the reference's spec blocks
    (``params_pspecs``). Raises ``sharding.NotDivisible`` where the model
    ranks do not divide a dimension the split needs."""
    structs = params_structs(cfg)
    if _rank_serves(cfg, mesh):
        return to_shardings(tp_pspecs(structs, cfg, mesh), mesh)
    return to_shardings(_param_specs(cfg, shape, mesh), mesh)


def build_prefill_step(cfg: ModelConfig, shape: InputShape, mesh,
                       dtype=torch.bfloat16) -> StepBundle:
    """``fn(params, batch) → (last-position logits, cache)``, every float32
    leaf cast to ``dtype`` first.

    On a mesh of ranks (:func:`check_rank_serving`) ``params`` are this
    rank's TP blocks (:func:`_serving_params`), ``batch`` is this data
    rank's rows (``batch_pspecs``), and the step runs them through
    ``model_prefill`` over the model group (:func:`model_group`; kernel 3
    on this rank's heads in a dense model, kernel 4 on its SSM heads in an
    SSM model) and a MoE model's over the data group
    (:func:`moe_group`): → this rank's vocabulary block of the logits and its
    blocks of the cache (``cache_pspecs``: a KV cache's sequence over
    "model", an SSM state's heads and its conv window's channels).
    The residual stays whole on every model rank: ``activation_specs``
    splits a prefill's sequence over "model", which the port leaves (the
    residual of a serving prefill is small against its cache).
    """
    if isinstance(mesh, RankMesh):
        check_rank_serving(cfg, mesh)

    def prefill_step(params, batch):
        return api.model_prefill(_cast(params, dtype), cfg, batch, dtype)

    p_structs = params_structs(cfg)
    arg_structs = dict(params=p_structs,
                       batch=configs.input_specs(cfg, shape, dtype)["batch"])
    if not _serving_mesh(mesh):
        return StepBundle(prefill_step, arg_structs, None, None)
    in_sh = dict(params=_serving_params(cfg, shape, mesh),
                 batch=to_shardings(batch_pspecs(arg_structs["batch"], mesh), mesh))
    if not isinstance(mesh, RankMesh):
        return StepBundle(prefill_step, arg_structs, in_sh, None)
    group, data = model_group(mesh), moe_group(cfg, mesh, shape.global_batch)

    def rank_prefill_step(params, batch):
        return api.model_prefill(_cast(params, dtype), cfg, batch, dtype, group=group, data=data)

    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    if cfg.arch_type == "ssm":
        cache_struct = init_ssm_cache(cfg, b, dtype, meta)
    else:  # a prefill keeps every prompt slot, window or not
        cache_struct = init_attn_cache(dataclasses.replace(cfg, sliding_window=None), b, s,
                                       dtype=dtype, device=meta)
    out_sh = (Sharding(mesh, (_batched(b, mesh), None, "model")),
              cache_shardings(cache_struct, mesh))
    return StepBundle(rank_prefill_step, arg_structs, in_sh, out_sh)


def build_serve_step(cfg: ModelConfig, shape: InputShape, mesh,
                     dtype=torch.bfloat16) -> StepBundle:
    """One decode step, ``fn(params, token, cache, t) → (next greedy token
    (B, 1), cache)``, against a seq_len-deep cache updated in place.

    On a mesh of ranks ``params`` are this rank's TP blocks
    (:func:`_serving_params`) and ``token`` and ``cache`` this rank's rows
    and blocks (``batch_pspecs``, ``cache_pspecs``: a dense model's KV
    cache split by sequence over "model", an SSM model's state by heads);
    the step runs over the model group (:func:`model_group`: this rank's
    heads, MLP columns and vocabulary block, the attention combined over
    the group, the conv window gathered), a MoE
    model's over the data group (:func:`moe_group`), and returns its rows'
    greedy token, combined over the vocabulary blocks (``layers.greedy``),
    and its cache blocks."""
    if isinstance(mesh, RankMesh):
        check_rank_serving(cfg, mesh)
    specs = configs.input_specs(cfg, shape, dtype)

    def serve_step(params, token, cache, t):
        logits, cache = api.model_decode(_cast(params, dtype), cfg, token, cache, t, dtype)
        return logits[:, -1].argmax(dim=-1, keepdim=True), cache

    p_structs = params_structs(cfg)
    arg_structs = dict(params=p_structs, token=specs["token"], cache=specs["cache"],
                       t=specs["t"])
    if not _serving_mesh(mesh):
        return StepBundle(serve_step, arg_structs, None, None)
    tok = Sharding(mesh, batch_pspecs({"token": specs["token"]}, mesh)["token"])
    cache_sh = cache_shardings(specs["cache"], mesh)
    in_sh = dict(params=_serving_params(cfg, shape, mesh), token=tok, cache=cache_sh,
                 t=Sharding(mesh, ()))
    if not isinstance(mesh, RankMesh):
        return StepBundle(serve_step, arg_structs, in_sh, (tok, cache_sh))
    group, data = model_group(mesh), moe_group(cfg, mesh, shape.global_batch)

    def rank_serve_step(params, token, cache, t):
        logits, cache = api.model_decode(_cast(params, dtype), cfg, token, cache, t, dtype,
                                         group=group, data=data)
        return greedy(logits[:, -1], group), cache

    return StepBundle(rank_serve_step, arg_structs, in_sh, (tok, cache_sh))


def build_step(cfg: ModelConfig, shape: InputShape, mesh, dtype=torch.bfloat16,
               optimizer: Optimizer | None = None) -> StepBundle:
    """Dispatch on the shape kind: train / prefill / decode."""
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, optimizer or adamw(1e-4))
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, dtype)
    return build_serve_step(cfg, shape, mesh, dtype)

