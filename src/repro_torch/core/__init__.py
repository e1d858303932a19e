"""Port of ``repro.core``: the PO-FL round (Algorithm 1) on tensors, with
the reference's exports and the diagnostics taps (``RoundDiagnostics``,
``diagnostics_taps``)."""
from repro_torch.core.channel import ChannelConfig, ChannelState
from repro_torch.core.local_update import (
    ALGORITHM_IDS,
    ALGORITHMS,
    AlgState,
    algorithm_id,
    init_state,
    local_update_stage,
)
from repro_torch.core.metrics import RoundDiagnostics, diagnostics_taps
from repro_torch.core.numerics import EPS, eps_guard, safe_div
from repro_torch.core.pofl import (
    BACKENDS,
    AggregationBackend,
    DeviceData,
    History,
    POFLConfig,
    aggregation_stage,
    apply_update_stage,
    local_gradient_stage,
    make_round_step,
    round_algorithm,
    run_pofl,
    scheduling_stage,
)
from repro_torch.core.scheduling import POLICIES, Schedule, scheduling_probs

__all__ = [
    "ALGORITHM_IDS",
    "ALGORITHMS",
    "AggregationBackend",
    "AlgState",
    "BACKENDS",
    "ChannelConfig",
    "ChannelState",
    "DeviceData",
    "EPS",
    "History",
    "POFLConfig",
    "POLICIES",
    "RoundDiagnostics",
    "Schedule",
    "aggregation_stage",
    "algorithm_id",
    "apply_update_stage",
    "diagnostics_taps",
    "eps_guard",
    "init_state",
    "local_gradient_stage",
    "local_update_stage",
    "make_round_step",
    "round_algorithm",
    "run_pofl",
    "safe_div",
    "scheduling_probs",
    "scheduling_stage",
]
