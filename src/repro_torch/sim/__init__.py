"""Port of ``repro.sim``: channel processes, model tasks, the round engine,
the scenario lattice, its checkpointed and sharded sweeps, and the
multi-rank plumbing (``sim.multihost``: one rank a device over
``torch.distributed``). The exports are the reference's names but the
compile cache's (ROADMAP queue A item 17: the port compiles no program),
and ``shard_bounds``."""
from repro_torch.sim.engine import FUSED_ALGORITHM, FUSED_POLICY, SimEngine, SimState
from repro_torch.sim.lattice import (
    LatticeRecords,
    LatticeSpec,
    make_cell_mesh,
    make_cell_model_mesh,
    run_lattice,
)
from repro_torch.sim.multihost import (
    DistributedConfig,
    distributed_env,
    initialize_distributed,
    make_global_cell_mesh,
    make_global_cell_model_mesh,
    mesh_spans_processes,
)
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
    "DistributedConfig",
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
    "distributed_env",
    "initialize_distributed",
    "latest_checkpoint",
    "make_cell_mesh",
    "make_cell_model_mesh",
    "make_channel_process",
    "make_global_cell_mesh",
    "make_global_cell_model_mesh",
    "make_model_task",
    "make_partition",
    "merge_shards",
    "mesh_spans_processes",
    "run_lattice",
    "run_lattice_checkpointed",
    "run_worker_shard",
    "shard_bounds",
]
