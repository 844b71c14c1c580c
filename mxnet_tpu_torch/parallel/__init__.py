"""Training of the PyTorch port: the one-card ``ShardedTrainer``, its
mesh and its optimizers, and its durability — checkpoints, the step
watchdog and the supervisor (the dp = 1 slice of ``mxnet_tpu.parallel``)
— and the serving replica layer's placement (``replica_groups``,
``replica_mesh``)."""
from .checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from .mesh import Mesh, make_mesh
from .placement import ReplicaMesh, replica_groups, replica_mesh
from .supervisor import (CrashLoopError, StepWatchdog, TrainingSupervisor,
                         TrainStepTimeoutError, run_with_deadline)
from .trainer import ShardedTrainer

__all__ = ["Mesh", "make_mesh", "replica_groups", "replica_mesh",
           "ReplicaMesh", "ShardedTrainer",
           "CheckpointManager", "save_checkpoint", "load_checkpoint",
           "TrainingSupervisor", "StepWatchdog", "run_with_deadline",
           "TrainStepTimeoutError", "CrashLoopError"]
