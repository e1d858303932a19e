"""Model configuration dataclasses for every supported architecture family.

The port's own copy of ``repro.models.config`` (the port imports nothing of
the JAX package); the values and properties are the same.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0      # llama4-style always-on shared expert
    capacity_factor: float = 1.25  # GShard-style dispatch capacity


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk_size: int = 256  # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: Mamba2 backbone + one *shared* attention block invoked
    every ``attn_every`` layers (weights shared across invocations)."""

    attn_every: int = 6


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int
    n_enc_frames: int = 1024  # precomputed speech-frame embeddings (stub input)


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 256  # precomputed ViT patch embeddings (stub input)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # ring-buffer window for long-context
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    source: str = ""  # citation for the config numbers

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 so logits shard over 16-way axes."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def has_attention(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if decode with a 500k context is sub-quadratic / bounded-state:
        native for SSM/hybrid, via sliding window otherwise."""
        return self.arch_type in ("ssm", "hybrid") or self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D roofline)."""
        d, v = self.d_model, self.vocab_padded
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        per_layer = 0
        dh = self.head_dim
        attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh + self.n_heads * dh * d
        dense_mlp = 3 * d * self.d_ff  # SwiGLU
        if self.arch_type in ("dense", "vlm"):
            per_layer = attn + dense_mlp
        elif self.arch_type == "moe":
            moe = self.moe
            expert = 3 * d * moe.d_ff_expert
            per_layer = attn + moe.n_experts * expert + d * moe.n_experts
            per_layer += moe.n_shared_experts * expert
        elif self.arch_type == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            per_layer = d * (2 * di + 2 * s.d_state + nh) + di * s.conv_kernel + di * d
        elif self.arch_type == "hybrid":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            per_layer = d * (2 * di + 2 * s.d_state + nh) + di * s.conv_kernel + di * d
        elif self.arch_type == "encdec":
            # decoder layer: self-attn + cross-attn + mlp
            per_layer = 2 * attn + dense_mlp
        n += self.n_layers * per_layer
        if self.arch_type == "hybrid":
            n += attn + dense_mlp  # one shared block
        if self.arch_type == "encdec":
            n += self.encdec.n_enc_layers * (attn + dense_mlp)
        n += 2 * d * self.n_layers  # norms (approx)
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (= param_count except MoE, where only
        top_k of n_experts experts fire) — the N in MODEL_FLOPS = 6·N·D."""
        if self.arch_type != "moe":
            return self.param_count()
        moe = self.moe
        expert = 3 * self.d_model * moe.d_ff_expert
        inactive = (moe.n_experts - moe.top_k) * expert
        return self.param_count() - self.n_layers * inactive


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
