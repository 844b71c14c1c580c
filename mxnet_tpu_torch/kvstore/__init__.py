"""kvstore of the PyTorch port: gradient aggregation across contexts and
processes (reference: python/mxnet/kvstore/)."""
from .base import KVStoreBase
from .kvstore import KVStore, create

__all__ = ["KVStoreBase", "KVStore", "create"]
