"""internvl2-76b — InternViT + Llama-3-70B-style LLM backbone [arXiv:2404.16821].

The assignment covers the language backbone: 80 layers, d_model=8192, GQA
kv=8, vocab=128256. The InternViT vision encoder + MLP projector is a stub:
input_specs() supplies precomputed patch embeddings (B, 256, d_model).
"""
from repro_torch.models.config import ModelConfig, VLMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        arch_type="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        rope_theta=500000.0,
        vlm=VLMConfig(n_patches=256),
        source="arXiv:2404.16821",
    )
