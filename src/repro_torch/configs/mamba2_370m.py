"""mamba2-370m — attention-free SSD state-space model [arXiv:2405.21060].

48 layers, d_model=1024, d_state=128, head_dim=64 (d_inner=2048, 32 heads).
"""
from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        arch_type="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=16,   # unused (attention-free); kept for config uniformity
        n_kv_heads=16,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMConfig(d_state=128),
        source="arXiv:2405.21060",
    )
