"""Port of ``repro.checkpoint``: crash-atomic npz checkpoints of tensor trees."""
from repro_torch.checkpoint.npz import load_pytree, restore, save, save_pytree

__all__ = ["save", "restore", "save_pytree", "load_pytree"]
