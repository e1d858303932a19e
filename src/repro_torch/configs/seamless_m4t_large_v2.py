"""seamless-m4t-large-v2 — speech enc / text dec [arXiv:2308.11596].

24 encoder + 24 decoder layers, d_model=1024, vocab=256206 (padded to 256256
for 16-way sharding). The conformer speech frontend is a stub: input_specs()
supplies precomputed frame embeddings (B, 1024, d_model).
"""
from repro_torch.models.config import EncDecConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        arch_type="encdec",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        encdec=EncDecConfig(n_enc_layers=24, n_enc_frames=1024),
        source="arXiv:2308.11596",
    )
