"""Port of ``repro.sim``: channel processes, model tasks, the round engine
and the scenario lattice. The exports are the reference's names that are
ported so far (ROADMAP queue A lists the rest: the resilience, multi-host
and compile-cache modules)."""
from repro_torch.sim.engine import FUSED_ALGORITHM, FUSED_POLICY, SimEngine, SimState
from repro_torch.sim.lattice import LatticeRecords, LatticeSpec, run_lattice
from repro_torch.sim.scenario import (
    CHANNEL_SCENARIOS,
    PARTITIONS,
    make_channel_process,
    make_partition,
)
from repro_torch.sim.tasks import TASKS, EvalRecord, ModelTask, TaskEval, make_model_task

__all__ = [
    "CHANNEL_SCENARIOS",
    "EvalRecord",
    "FUSED_ALGORITHM",
    "FUSED_POLICY",
    "LatticeRecords",
    "LatticeSpec",
    "ModelTask",
    "PARTITIONS",
    "SimEngine",
    "SimState",
    "TASKS",
    "TaskEval",
    "make_channel_process",
    "make_model_task",
    "make_partition",
    "run_lattice",
]
