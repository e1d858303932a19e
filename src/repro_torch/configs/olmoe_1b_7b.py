"""olmoe-1b-7b — 64-expert top-8 MoE [arXiv:2409.02060].

16 layers, d_model=2048, per-expert d_ff=1024 (1B active / 7B total).
"""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        arch_type="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
        source="arXiv:2409.02060",
    )
