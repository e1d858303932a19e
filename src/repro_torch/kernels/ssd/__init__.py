"""Mamba2 SSD chunked scan: CUDA kernel, plain versions, dispatch."""
from repro_torch.kernels.ssd.kernel import ssd_scan
from repro_torch.kernels.ssd.ops import ssd, ssd_pallas
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_naive

__all__ = ["ssd", "ssd_chunked_ref", "ssd_naive", "ssd_pallas", "ssd_scan"]
