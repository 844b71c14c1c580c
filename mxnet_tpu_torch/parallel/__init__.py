"""Training of the PyTorch port: the one-card ``ShardedTrainer``, its
mesh and its optimizers (the dp = 1 slice of ``mxnet_tpu.parallel``)."""
from .mesh import Mesh, make_mesh
from .trainer import ShardedTrainer

__all__ = ["Mesh", "make_mesh", "ShardedTrainer"]
