"""Public op: the chunked SSD scan, dispatched by the device of ``xdt``.

A CPU tensor (or a meta one: shapes only, as the dry run counts FLOPs)
goes to the kernel's plain PyTorch version, which autograd
and ``torch.func.jvp`` differentiate as they find it; a CUDA tensor goes to
the hand-written kernel through
:data:`~repro_torch.kernels.ssd.autograd.SSDScan`, whose backward and jvp
are the plain version's, or the call raises. The reference's
``use_pallas="auto"`` has no counterpart: nothing can quietly choose the
plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.autograd import SSDScan
from repro_torch.kernels.ssd.ref import ssd_chunked_ref


def ssd(xdt, la, B, C, *, chunk: int = 256) -> torch.Tensor:
    """y = SSD(xdt, la, B, C) → (b, s, h, p) in xdt's type; ``s % chunk == 0``."""
    if xdt.device.type in ("cpu", "meta"):  # meta: shapes only (the dry run)
        return ssd_chunked_ref(xdt, la, B, C, chunk)
    if xdt.device.type == "cuda":
        return SSDScan.apply(xdt, la, B, C, chunk)
    raise ValueError(f"ssd: no path for device {xdt.device}")


def ssd_pallas(xdt, la, B, C, *, chunk: int = 256) -> torch.Tensor:
    """The reference's name for the kernel entry: the CUDA kernel on a
    CUDA tensor, its plain version on a CPU one (as :func:`ssd`)."""
    return ssd(xdt, la, B, C, chunk=chunk)
