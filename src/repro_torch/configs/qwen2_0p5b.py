"""qwen2-0.5b — dense GQA with QKV bias, tied embeddings [arXiv:2407.10671]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        arch_type="dense",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab_size=151936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1000000.0,
        source="arXiv:2407.10671",
    )
