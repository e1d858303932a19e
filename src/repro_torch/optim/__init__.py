"""Port of ``repro.optim``: optimizers as functional (init, update) pairs."""
from repro_torch.optim.optimizers import (
    Optimizer,
    OptState,
    adamw,
    cosine_schedule,
    paper_decay_schedule,
    sgd,
)

__all__ = ["OptState", "Optimizer", "adamw", "sgd", "cosine_schedule", "paper_decay_schedule"]
