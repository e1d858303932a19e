"""qwen2.5-14b — dense GQA with QKV bias [hf:Qwen/Qwen2.5-14B]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        arch_type="dense",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=13824,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1000000.0,
        source="hf:Qwen/Qwen2.5-0.5B (family card); 14B dims per model card",
    )
