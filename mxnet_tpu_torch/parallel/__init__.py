"""Training of the PyTorch port over ``torch.distributed``: the
process-group runtime (:mod:`.dist`), the device mesh, sharding rules
and Megatron tensor parallelism, ``ShardedTrainer`` (dp / tp, with
int8/fp8 gradient compression), ring attention and the GPipe pipeline,
its optimizers, ``functionalize`` (a Gluon block as a function of
tensors, and as the ``nn.Module`` the trainer runs), MoE expert
parallelism over ``ep`` (:mod:`.expert`), and its durability —
checkpoints (sharded across ranks), the step watchdog and the
supervisor — and the serving replica layer's placement
(``replica_groups``, ``replica_mesh``)."""
from . import dist
from .checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from .functional import GluonModule, functionalize
from .mesh import Mesh, make_mesh, mesh_axis_size
from .optim import adamw_init, adamw_update, sgd_init, sgd_update
from .pipeline import make_pipeline_mesh, pipeline_apply
from .placement import ReplicaMesh, replica_groups, replica_mesh
from .ring_attention import ring_attention, ring_self_attention
from .sharding import (MEGATRON_RULES, P, PartitionSpec, ShardingRules,
                       partition_params)
from .supervisor import (CrashLoopError, StepWatchdog, TrainingSupervisor,
                         TrainStepTimeoutError, run_with_deadline)
from .trainer import ShardedTrainer

__all__ = ["Mesh", "make_mesh", "replica_groups",
           "replica_mesh", "ReplicaMesh", "ShardingRules", "MEGATRON_RULES",
           "PartitionSpec", "P", "partition_params", "ShardedTrainer",
           "ring_attention", "ring_self_attention", "pipeline_apply",
           "make_pipeline_mesh", "CheckpointManager", "save_checkpoint",
           "load_checkpoint", "TrainingSupervisor", "StepWatchdog",
           "run_with_deadline", "TrainStepTimeoutError", "CrashLoopError",
           "functionalize", "GluonModule", "dist", "mesh_axis_size",
           "sgd_init", "sgd_update", "adamw_init", "adamw_update"]
