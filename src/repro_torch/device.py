"""Device resolution for the port's entry points, and the convolutions'
deterministic scope on a card."""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the caller's, else the CUDA card.

    With no card and no ``device`` given this raises: the port never falls
    back to the CPU on its own. ``device="cpu"`` runs the plain PyTorch path
    (the CPU tests do). A rank of a process group (``torch.distributed``)
    runs on the current device, which ``sim.multihost.initialize_distributed``
    sets to ``cuda:{local rank % torch.cuda.device_count()}``: one rank a
    card, and ranks beyond the cards share them.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dist.is_available() and dist.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda")


@contextlib.contextmanager
def cudnn_deterministic(device):
    """cuDNN's deterministic algorithms inside the block when ``device`` is
    a CUDA device (the flag's old value restored on exit, also after an
    exception); nothing changes on the CPU.

    The local update runs its gradients in this scope on a card
    (``core.local_update``): with cuDNN's default algorithms both the data
    gradient and the weight gradient of the CNN's convolutions differ run to
    run, so two runs of one CNN lattice part from round 0 on; with the
    deterministic ones in the convolutions' backward alone they repeat
    bitwise (``chip_repeatability.py scopes``). The backward alone costs no
    less than the whole local update in this mode, so the scope is the
    gradient computation, around ``torch.func.grad``.
    """
    if torch.device(device).type != "cuda":
        yield
        return
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before
