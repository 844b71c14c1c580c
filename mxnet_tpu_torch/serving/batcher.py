"""Power-of-two shape buckets (docs/serving.md §3).

The port's copy of the bucket policy of ``mxnet_tpu.serving.batcher``:
the decode engine pads prompt lengths and verify windows to these
buckets, so any traffic mix reaches the model as at most
``len(bucket_set(max_context))`` distinct shapes per program family.
(``DynamicBatcher`` belongs to the predict path and is not ported.)
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["next_bucket", "bucket_set"]


def next_bucket(rows, max_batch):
    """Smallest power of two >= rows, capped at max_batch (the cap
    itself is the last bucket even when it is not a power of two), so
    the bucket set is {1, 2, 4, ..., max_batch}."""
    if rows < 1:
        raise MXNetError(f"next_bucket: rows must be >= 1, got {rows}")
    if rows >= max_batch:
        return max_batch
    b = 1
    while b < rows:
        b <<= 1
    return min(b, max_batch)


def bucket_set(max_batch):
    """Every bucket :func:`next_bucket` can produce for ``max_batch``,
    ascending — the ONE definition of the bucket policy (the decode
    engine's program bound counts it)."""
    buckets, b = [], 1
    while b < max_batch:
        buckets.append(b)
        b <<= 1
    buckets.append(max_batch)       # the cap is always the last bucket
    return buckets
