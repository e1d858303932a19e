"""Carry the reference's weights into the port.

The port keeps the JAX package's parameter layouts (dict trees; logreg ``w``
is (dim, classes), conv kernels HWIO), so converting is a copy, leaf by
leaf, with no transpose: both sides then compute the same function. An
optimizer state crosses the same way (:func:`opt_state_from_jax`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.flatten_util import tree_map


def params_from_jax(tree, device=None):
    """A nested dict of arrays (numpy, or anything ``np.asarray`` reads,
    such as the reference's arrays) → float32 port params on ``device``."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=dev), tree
    )


def lm_params_from_jax(tree, cfg, device=None):
    """The reference's ``model_init`` tree of any LM config (numpy arrays,
    or anything ``np.asarray`` reads) → float32 port params on ``device``.

    The port keeps the reference's LM layout: ``embed`` (vocab_padded, d),
    every ``layers`` leaf (and an enc-dec model's ``enc_layers`` leaf)
    stacked over its layers as ``lax.scan`` reads it, ``x @ w`` with ``w`` as
    (d_in, d_out). So this, too, is a copy, with the family's shapes checked
    against ``cfg``.
    """
    params = params_from_jax(tree, device)
    d, lyr, n_l = cfg.d_model, params["layers"], cfg.n_layers
    q_dim, kv_dim = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    if cfg.arch_type in ("ssm", "hybrid"):
        s = cfg.ssm
        di = s.d_inner(d)
        want = {
            "in_proj": (lyr["mamba"]["in_proj"], (n_l, d, 2 * di + 2 * s.d_state + s.n_heads(d))),
            "out_proj": (lyr["mamba"]["out_proj"], (n_l, di, d)),
        }
        if cfg.arch_type == "hybrid":
            want["shared_block.attn.wq"] = (params["shared_block"]["attn"]["wq"], (d, q_dim))
    elif cfg.arch_type == "moe":
        m = cfg.moe
        want = {
            "wq": (lyr["attn"]["wq"], (n_l, d, q_dim)),
            "moe.router": (lyr["moe"]["router"], (n_l, d, m.n_experts)),
            "moe.w_gate": (lyr["moe"]["w_gate"], (n_l, m.n_experts, d, m.d_ff_expert)),
        }
    elif cfg.arch_type == "encdec":
        enc, n_e = params["enc_layers"], cfg.encdec.n_enc_layers
        want = {
            "enc_layers.attn.wq": (enc["attn"]["wq"], (n_e, d, q_dim)),
            "enc_layers.mlp.w_out": (enc["mlp"]["w_out"], (n_e, cfg.d_ff, d)),
            "self_attn.wq": (lyr["self_attn"]["wq"], (n_l, d, q_dim)),
            "cross_attn.wk": (lyr["cross_attn"]["wk"], (n_l, d, kv_dim)),
            "ln_x": (lyr["ln_x"]["scale"], (n_l, d)),
            "w_out": (lyr["mlp"]["w_out"], (n_l, cfg.d_ff, d)),
            "enc_norm": (params["enc_norm"]["scale"], (d,)),
            "lm_head": (params["lm_head"], (d, cfg.vocab_padded)),
        }
    else:
        want = {
            "wq": (lyr["attn"]["wq"], (n_l, d, q_dim)),
            "w_out": (lyr["mlp"]["w_out"], (n_l, cfg.d_ff, d)),
        }
        if cfg.arch_type == "vlm":
            want["vis_proj"] = (params["vis_proj"], (d, d))
    want["embed"] = (params["embed"], (cfg.vocab_padded, d))
    for name, (leaf, shape) in want.items():
        if tuple(leaf.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(leaf.shape)}, expected {shape} for {cfg.name}")
    return params


def opt_state_from_jax(state, device=None):
    """The reference's ``OptState`` (step, mu, nu: arrays, or anything
    ``np.asarray`` reads; nu None for sgd) → the port's, on ``device``:
    step int32, mu and nu float32 trees, so a round can start from a
    shared optimizer state."""
    from repro_torch.optim.optimizers import OptState

    dev = resolve_device(device)
    return OptState(
        step=torch.tensor(np.asarray(state.step), dtype=torch.int32, device=dev),
        mu=params_from_jax(state.mu, dev),
        nu=None if state.nu is None else params_from_jax(state.nu, dev),
    )
