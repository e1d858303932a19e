"""zamba2-2.7b — Mamba2 backbone + shared attention block [arXiv:2411.15242].

54 Mamba2 layers, d_model=2560, one *shared* (weight-tied) attention+MLP
block invoked every 6 layers (simplification of Zamba2's shared-block-with-
LoRA design; the sharing pattern and cost structure are preserved).
"""
from repro_torch.models.config import HybridConfig, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        arch_type="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,  # MHA in the shared block
        d_ff=10240,
        vocab_size=32000,
        ssm=SSMConfig(d_state=64),
        hybrid=HybridConfig(attn_every=6),
        source="arXiv:2411.15242",
    )
