"""Port of ``repro.core``: the PO-FL round (Algorithm 1) on tensors.

The exports are the reference's names of the modules below the round;
the round itself (``POFLConfig``, ``round_algorithm``, ``run_pofl``, ...)
is imported from ``repro_torch.core.pofl``, which imports the kernels, whose
plain versions import ``repro_torch.core.numerics``: exporting it here would
make that a cycle.
"""
from repro_torch.core.channel import ChannelConfig, ChannelState
from repro_torch.core.local_update import (
    ALGORITHM_IDS,
    ALGORITHMS,
    AlgState,
    algorithm_id,
    init_state,
    local_gradient_stage,
    local_update_stage,
)
from repro_torch.core.numerics import EPS, eps_guard, safe_div
from repro_torch.core.scheduling import POLICIES, Schedule, scheduling_probs

__all__ = [
    "ALGORITHM_IDS",
    "ALGORITHMS",
    "AlgState",
    "ChannelConfig",
    "ChannelState",
    "EPS",
    "POLICIES",
    "Schedule",
    "algorithm_id",
    "eps_guard",
    "init_state",
    "local_gradient_stage",
    "local_update_stage",
    "safe_div",
    "scheduling_probs",
]
