"""Port of ``repro.sim``: channel processes, model tasks, the round engine,
the scenario lattice and its checkpointed, sharded sweeps. The exports are
the reference's names that are ported so far (ROADMAP queue A lists the
rest: the multi-host, mesh and compile-cache modules), and
``shard_bounds``."""
from repro_torch.sim.engine import FUSED_ALGORITHM, FUSED_POLICY, SimEngine, SimState
from repro_torch.sim.lattice import LatticeRecords, LatticeSpec, run_lattice
from repro_torch.sim.resilience import (
    CheckpointConfig,
    latest_checkpoint,
    merge_shards,
    run_lattice_checkpointed,
    run_worker_shard,
    shard_bounds,
)
from repro_torch.sim.scenario import (
    CHANNEL_SCENARIOS,
    PARTITIONS,
    make_channel_process,
    make_partition,
)
from repro_torch.sim.tasks import TASKS, EvalRecord, ModelTask, TaskEval, make_model_task

__all__ = [
    "CHANNEL_SCENARIOS",
    "CheckpointConfig",
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
    "latest_checkpoint",
    "make_channel_process",
    "make_model_task",
    "make_partition",
    "merge_shards",
    "run_lattice",
    "run_lattice_checkpointed",
    "run_worker_shard",
    "shard_bounds",
]
