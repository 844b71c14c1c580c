"""KVStoreBase plugin registry of the PyTorch port (reference:
python/mxnet/kvstore/base.py).

The counterpart of ``mxnet_tpu.kvstore.base``: a communication backend
registers a subclass under a name and ``create()`` dispatches to it;
the built-in tiers ('local', 'device', 'xla', 'dist_sync') register
through the same mechanism.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["KVStoreBase"]


class KVStoreBase:
    """Abstract communication backend.

    Subclasses implement the v1.7+ minimal surface (``broadcast``,
    ``pushpull``) and declare capabilities; the classic ``KVStore`` API
    (init/push/pull) is layered on top in kvstore.py.
    """

    kv_registry = {}

    # capability names (reference: KVStoreBase.OPTIMIZER)
    OPTIMIZER = "optimizer"

    # ------------------------------------------------------------ registry
    @staticmethod
    def register(klass):
        """Class decorator: register under the lowercase class name."""
        if not issubclass(klass, KVStoreBase):
            raise MXNetError(f"{klass!r} must subclass KVStoreBase")
        name = klass.__name__.lower()
        KVStoreBase.kv_registry[name] = klass
        return klass

    @staticmethod
    def register_alias(name, klass):
        KVStoreBase.kv_registry[name.lower()] = klass

    # ------------------------------------------------------- v1.7+ surface
    def broadcast(self, key, value, out, priority=0):
        """Initialize ``key`` with ``value`` and broadcast into ``out``."""
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        """Aggregate ``value`` across devices/workers; write into ``out``."""
        raise NotImplementedError

    @classmethod
    def is_capable(cls, capability):
        return capability in getattr(cls, "CAPABILITIES", ())

    # ------------------------------------------------------------- identity
    @property
    def type(self):
        return type(self).__name__.lower()

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1
