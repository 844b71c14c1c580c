"""Decode serving of the PyTorch port (docs/serving.md §6, §8, §9)."""
from .config import ServingConfig
from .decode import DecodeEngine, GenerateRequest, PagedLMAdapter, \
    as_decode_model
from .kv_cache import DeviceKVPool, PageAllocator, PageGeometry, PrefixCache
from .resilience import Deadline, DeadlineExceededError, \
    ServerOverloadedError

__all__ = ["ServingConfig", "DecodeEngine", "GenerateRequest",
           "PagedLMAdapter", "as_decode_model", "DeviceKVPool",
           "PageAllocator", "PageGeometry", "PrefixCache", "Deadline",
           "DeadlineExceededError", "ServerOverloadedError"]
