"""llama4-scout-17b-a16e — 16-expert top-1 MoE with a shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E]. Early-fusion multimodality is out of
the assigned backbone scope (text tokens only here)."""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        arch_type="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        rope_theta=500000.0,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared_experts=1),
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
