"""Architecture registry: the 10 assigned architectures × 4 input shapes.

The port's own copy of ``repro.configs`` (all ten configurations are data).
``input_specs`` gives tensors on the ``meta`` device where the reference
gives JAX ``ShapeDtypeStruct`` stand-ins: shapes and types, no storage.

Public API:
  ARCH_IDS                      — the assigned architecture identifiers
  get_config(arch_id, shape)    — full-size config (shape-aware: long_500k
                                  swaps in the sliding-window variant)
  reduced_config(arch_id)       — CPU-smoke-sized variant of the same family
  supports_shape(arch_id, shape)— long_500k/decode applicability
  cut_depth(cfg, layers)        — a config cut to fewer layers, full width
  input_specs(cfg, shape, dtype)— meta tensors of every input of a step
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

ARCH_IDS = (
    "zamba2-2.7b",
    "olmoe-1b-7b",
    "internvl2-76b",
    "qwen2-0.5b",
    "mistral-large-123b",
    "llama4-scout-17b-a16e",
    "seamless-m4t-large-v2",
    "qwen2.5-14b",
    "phi4-mini-3.8b",
    "mamba2-370m",
)

_MODULES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "internvl2-76b": "internvl2_76b",
    "qwen2-0.5b": "qwen2_0p5b",
    "mistral-large-123b": "mistral_large_123b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2.5-14b": "qwen2p5_14b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "mamba2-370m": "mamba2_370m",
}

# Archs whose long_500k decode runs via a sliding-window variant (W=8192
# ring-buffer cache). Pure full-attention archs with no variant are skipped
# for long_500k.
LONG_CONTEXT_WINDOW = 8192
LONG_CONTEXT_VIA_WINDOW = (
    "olmoe-1b-7b",
    "qwen2-0.5b",
    "llama4-scout-17b-a16e",
    "phi4-mini-3.8b",
)
LONG_CONTEXT_SKIP = (
    "internvl2-76b",
    "mistral-large-123b",
    "qwen2.5-14b",
    "seamless-m4t-large-v2",
)


def base_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.config()


def get_config(arch_id: str, shape: InputShape | str | None = None) -> ModelConfig:
    """Full-size config for ``arch_id``; long_500k selects the sliding-window
    variant for the dense/MoE archs that support it."""
    cfg = base_config(arch_id)
    if shape is None:
        return cfg
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    if shape.name == "long_500k":
        if arch_id in LONG_CONTEXT_SKIP:
            raise ValueError(
                f"{arch_id} is pure full-attention — long_500k is skipped "
                "(DESIGN.md §4 Arch-applicability)"
            )
        if arch_id in LONG_CONTEXT_VIA_WINDOW:
            cfg = dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def supports_shape(arch_id: str, shape: InputShape | str) -> bool:
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    if shape.name == "long_500k":
        return arch_id not in LONG_CONTEXT_SKIP
    return True


def reduced_config(arch_id: str) -> ModelConfig:
    """Smoke variant of the same family: ≤2 layers, d_model ≤ 512, ≤4 experts."""
    cfg = base_config(arch_id)
    updates = dict(
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
    )
    if cfg.moe is not None:
        updates["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=128
        )
    if cfg.ssm is not None:
        updates["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=32, chunk_size=16
        )
    if cfg.hybrid is not None:
        updates["hybrid"] = dataclasses.replace(cfg.hybrid, attn_every=2)
    if cfg.encdec is not None:
        updates["encdec"] = dataclasses.replace(
            cfg.encdec, n_enc_layers=2, n_enc_frames=16
        )
    if cfg.vlm is not None:
        updates["vlm"] = dataclasses.replace(cfg.vlm, n_patches=8)
    return dataclasses.replace(cfg, **updates)


def cut_depth(cfg: ModelConfig, layers: int | None) -> ModelConfig:
    """``cfg`` cut to ``layers`` layers (an enc-dec model's encoder too);
    ``None`` leaves it whole."""
    if layers is None:
        return cfg
    if cfg.encdec is not None:
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(cfg.encdec,
                                                                  n_enc_layers=layers))
    return dataclasses.replace(cfg, n_layers=layers)


def input_specs(cfg: ModelConfig, shape: InputShape | str, dtype=torch.bfloat16) -> dict:
    """Meta tensors for every input of the step the shape exercises.

    train/prefill → {"batch": {tokens, [embeds|frames]}}
    decode        → {"token", "cache", "t"}  (cache sized to shape.seq_len)

    Tokens are int64, the port's index type, where the reference's are
    int32.
    """
    from repro_torch.models.cache import init_cache

    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def spec(dims, dt):
        return torch.empty(dims, dtype=dt, device=meta)

    if shape.kind in ("train", "prefill"):
        batch = {}
        if cfg.arch_type == "vlm":
            n_p = cfg.vlm.n_patches
            batch["tokens"] = spec((b, s - n_p), torch.int64)
            batch["embeds"] = spec((b, n_p, cfg.d_model), dtype)
        elif cfg.arch_type == "encdec":
            batch["tokens"] = spec((b, s), torch.int64)
            batch["frames"] = spec((b, cfg.encdec.n_enc_frames, cfg.d_model), dtype)
        else:
            batch["tokens"] = spec((b, s), torch.int64)
        return {"batch": batch}
    return {
        "token": spec((b, 1), torch.int64),
        "cache": init_cache(cfg, b, s, dtype, device=meta),
        "t": spec((), torch.int32),
    }


__all__ = [
    "ARCH_IDS",
    "LONG_CONTEXT_SKIP",
    "LONG_CONTEXT_VIA_WINDOW",
    "base_config",
    "cut_depth",
    "get_config",
    "input_specs",
    "reduced_config",
    "supports_shape",
]
