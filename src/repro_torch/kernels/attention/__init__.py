"""Flash attention: CUDA kernel, plain versions, dispatch."""
from repro_torch.kernels.attention.kernel import flash_attention
from repro_torch.kernels.attention.ops import attention
from repro_torch.kernels.attention.ref import flash_attention_ref, mha_ref

__all__ = ["attention", "flash_attention", "flash_attention_ref", "mha_ref"]
