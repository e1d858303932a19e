"""Unified model API dispatching on architecture family.

Port of ``repro.models.api``. The batch dict holds "tokens" (B, S) int64
always, "embeds" (B, n_patches, d) for a VLM's patch embeddings and
"frames" (B, n_frames, d) for an enc-dec model's frame embeddings.
``init_cache`` gives a dense, vlm or moe model an ``AttnCache``, an ssm
model an ``SSMCache``, a hybrid a ``HybridCache`` and an enc-dec model an
``EncDecCache``. ``model_loss`` is the training loss of every family.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.cache import init_cache, pad_cache
from repro_torch.models.config import ModelConfig


DT_INITS = ("zeros", "mamba2")


def model_init(cfg: ModelConfig, seed: int = 0, device=None, dt_init: str = "zeros") -> dict:
    """Random fp32 parameters from a ``torch.Generator`` seeded with
    ``seed``, on the card unless ``device`` says otherwise. ``dt_init``: a
    Mamba2 layer's dt_bias, the reference's zeros or, "mamba2", Mamba2's
    own draw (:func:`mamba2_dt_init` from ``seed``)."""
    if dt_init not in DT_INITS:
        raise ValueError(f"dt_init {dt_init!r}: one of {DT_INITS}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.arch_type == "encdec":
        return encdec.init_encdec(cfg, gen, device=dev)
    params = transformer.init_model(cfg, gen, device=dev)
    if dt_init == "mamba2" and cfg.ssm is not None:
        params = mamba2_dt_init(params, cfg, seed)
    return params


def mamba2_dt_init(params, cfg: ModelConfig, seed: int = 0) -> dict:
    """``params`` with every layer's dt_bias drawn as Mamba2 initialises it
    (arXiv:2405.21060's code: dt log-uniform in [1e-3, 1e-1] from numpy's
    generator seeded with ``seed``, dt_bias its inverse softplus) in place
    of the reference's zeros, on that leaf's device. At the reference's
    zeros an fp32 Mamba2 is ill-conditioned over a long prompt (ROADMAP C)."""
    rng = np.random.default_rng(seed)
    dt = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1),
                            (cfg.n_layers, cfg.ssm.n_heads(cfg.d_model))))
    mixer = params["layers"]["mamba"]
    mixer["dt_bias"] = torch.tensor(dt + np.log(-np.expm1(-dt)), dtype=torch.float32,
                                    device=mixer["dt_bias"].device)
    return params


def model_loss(params, cfg: ModelConfig, batch: dict, dtype=torch.float32,
               remat: bool = False, loss_weights=None, reduce: bool = True,
               logits_sharding=None, aux_coeff: float = 0.01, group=None, data=None):
    """Returns (loss, aux); with ``reduce=False``, (per_example (B,), aux).
    ``group`` (a ``layers.ModelGroup``): the model ranks a dense or SSM model is
    split over, ``params`` this rank's TP blocks (``transformer.lm_loss``);
    ``data`` (a ``layers.DataGroup``): the data ranks a MoE model's rows are
    split over, the loss and aux this rank's shares; ``None`` on one card."""
    if cfg.arch_type == "encdec":
        if group is not None or data is not None:
            raise ValueError(f"{cfg.name}: an enc-dec loss takes no model group or "
                             "data group")
        return encdec.encdec_loss(
            params, cfg, batch["tokens"], batch["frames"], dtype, remat,
            loss_weights=loss_weights, reduce=reduce,
            logits_sharding=logits_sharding, aux_coeff=aux_coeff,
        )
    return transformer.lm_loss(
        params, cfg, batch["tokens"], batch.get("embeds"), dtype, remat,
        loss_weights=loss_weights, reduce=reduce,
        logits_sharding=logits_sharding, aux_coeff=aux_coeff, group=group, data=data,
    )


def model_prefill(params, cfg: ModelConfig, batch: dict, dtype=torch.float32, group=None,
                  pad_to: int | None = None, data=None):
    """→ (last-position logits, cache); ``pad_to`` grows the cache to that
    many slots (``cache.pad_cache``). ``group`` (a ``layers.ModelGroup``):
    the model ranks a dense or SSM model is split over, ``params`` this rank's TP
    blocks; the logits are then this rank's vocabulary block and the cache
    its block (``transformer.prefill``). ``data`` (a ``layers.DataGroup``):
    the data ranks a MoE model's rows are split over, routed in the whole
    batch's groups. ``None`` on one card."""
    if cfg.arch_type == "encdec":
        if group is not None or data is not None:
            raise ValueError(f"{cfg.name}: an enc-dec prefill takes no model group or "
                             "data group")
        logits, cache = encdec.prefill_encdec(params, cfg, batch["tokens"], batch["frames"],
                                              dtype)
        return logits, cache if pad_to is None else pad_cache(cache, pad_to)
    return transformer.prefill(params, cfg, batch["tokens"], batch.get("embeds"), dtype,
                               group, pad_to, data)


def model_decode(params, cfg: ModelConfig, token, cache, t: int, dtype=torch.float32,
                 group=None, data=None):
    """One decode step; ``group`` (a ``layers.ModelGroup``): the model ranks
    a dense or SSM model is split over (``transformer.decode_step``); ``data`` (a
    ``layers.DataGroup``): the data ranks a MoE model's rows are split over;
    ``None`` on one card."""
    if cfg.arch_type == "encdec":
        if group is not None or data is not None:
            raise ValueError(f"{cfg.name}: an enc-dec decode step takes no model group or "
                             "data group")
        return encdec.decode_step_encdec(params, cfg, token, cache, t, dtype)
    return transformer.decode_step(params, cfg, token, cache, t, dtype, group, data)


__all__ = ["model_init", "model_loss", "model_prefill", "model_decode", "init_cache",
           "mamba2_dt_init"]
