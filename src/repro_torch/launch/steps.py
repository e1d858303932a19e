"""The LM's step functions: train_step / stats_step / prefill_step / serve_step.

Port of ``repro.launch.steps`` for one card. Each ``build_*`` returns a
:class:`StepBundle` ``(fn, arg_structs, in_shardings, out_shardings)``:
``fn`` is a plain function (eager PyTorch, nothing compiled),
``arg_structs`` are meta-device tensors of its arguments (shapes and
types, no storage: :func:`repro_torch.configs.input_specs`), and the
shardings are ``None``: one card holds everything whole.

PO-FL at model scale:
  * FL device = one slice of the global batch, FL-device-major: examples
    ``d · b/n_fl … (d + 1) · b/n_fl − 1`` are device d's; n_fl =
    :func:`repro_torch.launch.mesh.batch_ways`.
  * The AirComp weighted superposition Σ_d c_d · g_d is realised as
    per-example loss weights c_d · n_fl: the mean gradient over the batch
    then equals the PO-FL aggregate.
  * Receiver noise (Eq. 16): ν · z added to every gradient leaf after the
    backward, ν = √V_g / a · σ_z from the round's schedule and channel.

Gradients come from ``torch.autograd.grad`` (``torch.func.grad`` refuses
the checkpoints of ``remat`` and the chunked CE), the statistics from
``torch.func.jvp`` (:mod:`repro_torch.core.sketch`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import configs
from repro_torch.core.sketch import sketch_device_stats
from repro_torch.flatten_util import tree_leaves, tree_map, tree_unflatten
from repro_torch.launch.mesh import batch_ways
from repro_torch.models import api, encdec, transformer
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.optim.optimizers import OptState, Optimizer, adamw


class StepBundle(NamedTuple):
    fn: object            # the step function
    arg_structs: dict     # meta tensors of its keyword arguments
    in_shardings: object  # None on one card
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
    """The optimizer state's specs mirror the parameters' (on one card every
    spec is ``None``)."""
    mu = p_specs if o_structs.mu is not None else None
    nu = p_specs if o_structs.nu is not None else None
    return OptState(step=None, mu=mu, nu=nu)


def _cast(params, dtype):
    """The float32 leaves cast to ``dtype`` (the compute weights)."""
    return tree_map(lambda x: x.to(dtype) if x.dtype == torch.float32 else x, params)


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
    to ``dtype`` inside, so the grads arrive in fp32. With microbatches the
    batch is interleaved so every microbatch holds b/(m · n_fl) examples of
    every FL device, and the grads (and the loss) are averaged over them.
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

    def to_micro(x):
        per = b // n_fl
        x = x.reshape((n_fl, n_micro, per // n_micro) + tuple(x.shape[1:]))
        return x.movedim(1, 0).reshape((n_micro, b // n_micro) + tuple(x.shape[3:]))

    def train_step(params, opt_state, batch, coeffs, noise_amp, noise):
        # per-example weights: examples of FL device d get c_d · n_fl, so the
        # mean gradient over the batch is Σ_d c_d · g_d (the PO-FL aggregate)
        w = torch.repeat_interleave(coeffs * n_fl, b // n_fl)
        p = tree_map(lambda x: x.detach().requires_grad_(), params)
        leaves = tree_leaves(p)

        def loss_grads(mb, mw):
            loss, aux = api.model_loss(_cast(p, dtype), cfg, mb, dtype=dtype, remat=remat,
                                       loss_weights=mw)
            return loss.detach(), torch.autograd.grad(loss, leaves)

        if n_micro == 1:
            loss, grads = loss_grads(batch, w)
        else:
            mbs = {k: to_micro(v) for k, v in batch.items()}
            mws = to_micro(w)
            grads = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                     for x in leaves]
            loss = torch.zeros((), device=w.device)
            for i in range(n_micro):
                l_i, g_i = loss_grads({k: v[i] for k, v in mbs.items()}, mws[i])
                grads = [acc + g for acc, g in zip(grads, g_i)]
                loss = loss + l_i
            grads = [g / n_micro for g in grads]
            loss = loss / n_micro
        grads = tree_unflatten(params, grads)
        if aircomp_noise:
            grads = add_noise(grads, noise_amp, noise)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, loss

    p_structs = params_structs(cfg)
    meta = torch.device("meta")
    arg_structs = dict(
        params=p_structs,
        opt_state=opt_structs(optimizer, p_structs),
        batch=batch_struct,
        coeffs=torch.empty((n_fl,), device=meta),
        noise_amp=torch.empty((), device=meta),
        noise=p_structs,
    )
    return StepBundle(train_step, arg_structs, None, None)


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
    (``models.transformer.remat_call``): the same values either way."""
    n_fl = batch_ways(mesh)
    batch_struct = configs.input_specs(cfg, shape, dtype)["batch"]
    b = batch_struct["tokens"].shape[0]

    def stats_step(params, batch, probes):
        def per_device_loss(p):
            per_ex, _ = api.model_loss(p, cfg, batch, dtype=dtype, remat=remat, reduce=False)
            return per_ex.reshape(n_fl, b // n_fl).mean(dim=1)

        s = sketch_device_stats(per_device_loss, params, probes)
        return s.mean, s.var, s.norm

    p_structs = params_structs(cfg)
    arg_structs = dict(params=p_structs, batch=batch_struct, probes=[p_structs] * n_probes)
    return StepBundle(stats_step, arg_structs, None, None)


# --------------------------------------------------------------------------
# prefill / decode (serving)
# --------------------------------------------------------------------------


def build_prefill_step(cfg: ModelConfig, shape: InputShape, mesh,
                       dtype=torch.bfloat16) -> StepBundle:
    """``fn(params, batch) → (last-position logits, cache)``, every float32
    leaf cast to ``dtype`` first."""
    del mesh

    def prefill_step(params, batch):
        return api.model_prefill(_cast(params, dtype), cfg, batch, dtype)

    arg_structs = dict(params=params_structs(cfg),
                       batch=configs.input_specs(cfg, shape, dtype)["batch"])
    return StepBundle(prefill_step, arg_structs, None, None)


def build_serve_step(cfg: ModelConfig, shape: InputShape, mesh,
                     dtype=torch.bfloat16) -> StepBundle:
    """One decode step, ``fn(params, token, cache, t) → (next greedy token
    (B, 1), cache)``, against a seq_len-deep cache updated in place."""
    del mesh
    specs = configs.input_specs(cfg, shape, dtype)

    def serve_step(params, token, cache, t):
        logits, cache = api.model_decode(_cast(params, dtype), cfg, token, cache, t, dtype)
        return logits[:, -1].argmax(dim=-1, keepdim=True), cache

    arg_structs = dict(params=params_structs(cfg), token=specs["token"], cache=specs["cache"],
                       t=specs["t"])
    return StepBundle(serve_step, arg_structs, None, None)


def build_step(cfg: ModelConfig, shape: InputShape, mesh, dtype=torch.bfloat16,
               optimizer: Optimizer | None = None) -> StepBundle:
    """Dispatch on the shape kind: train / prefill / decode."""
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, optimizer or adamw(1e-4))
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, dtype)
    return build_serve_step(cfg, shape, mesh, dtype)

