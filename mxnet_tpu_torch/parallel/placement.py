"""Replica placement over the visible devices.

The PyTorch port of ``mxnet_tpu.parallel.placement``.  The serving
replica layer (``mxnet_tpu_torch.serving.replica``) maps one model
version to N replicas, each owning a **disjoint device group** — a
replica is the unit of both throughput (replicas serve concurrently)
and availability (a dead replica's group takes nothing else down with
it).  A replica's group may itself hold several devices (``tp`` > 1)
when the model is tensor-sharded *within* the replica; running such a
group waits for the port's multi-GPU item (ROADMAP.md Queue A, item 5).

These helpers are plain list/shape math over the visible CUDA devices
(or any explicit device list — tests pass plain objects), so placement
policy is decided and testable without touching a device:

- :func:`replica_groups` — split a device list into N disjoint,
  contiguous groups of ``tp`` devices each.  With fewer devices than
  replicas ask for, ``oversubscribe=True`` shares devices round-robin;
  by default a pool of ONE device is shared (one H100 holding every
  replica: each keeps its own graphs, streams and pools, not its own
  card).
- :func:`replica_mesh` — a (dp=1, tp) :class:`ReplicaMesh` descriptor
  over one group.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError

__all__ = ["replica_groups", "replica_mesh", "ReplicaMesh"]


def _visible_devices():
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise MXNetError(
            "replica_groups: no CUDA device is visible — pass devices= "
            "to place replicas on an explicit device list (the port "
            "places replicas on the card; nothing falls back to the CPU)")
    return [torch.device("cuda", i) for i in range(n)]


def replica_groups(n_replicas, devices=None, tp=1, oversubscribe=None):
    """Split ``devices`` into ``n_replicas`` disjoint groups of ``tp``.

    Returns a list of ``n_replicas`` tuples of devices.  ``devices``
    defaults to the visible CUDA devices (``cuda:0`` .. ``cuda:n-1``);
    with none visible it raises :class:`MXNetError` unless the caller
    passes ``devices=``.  Groups are contiguous slices of the device
    order and strictly disjoint when the device count covers
    ``n_replicas * tp``.

    ``oversubscribe`` controls the under-provisioned case (fewer than
    ``n_replicas * tp`` devices): ``True`` assigns groups round-robin
    so several replicas share physical devices; ``False`` raises;
    ``None`` (default) oversubscribes only when the whole pool is a
    single device and raises otherwise, so a multi-device pool never
    silently loses replica fault isolation.
    """
    n_replicas = int(n_replicas)
    tp = int(tp)
    if n_replicas < 1:
        raise MXNetError(
            f"replica_groups: n_replicas must be >= 1, got {n_replicas}")
    if tp < 1:
        raise MXNetError(f"replica_groups: tp must be >= 1, got {tp}")
    devices = _visible_devices() if devices is None else list(devices)
    need = n_replicas * tp
    if len(devices) < need:
        if oversubscribe is None:
            oversubscribe = len(devices) == 1
        if not oversubscribe:
            raise MXNetError(
                f"replica_groups: {n_replicas} replica(s) x tp={tp} "
                f"need {need} devices, only {len(devices)} available — "
                f"shrink the replica count, or pass oversubscribe=True "
                f"to share devices (logical replicas lose physical "
                f"fault isolation)")
        return [tuple(devices[(r * tp + i) % len(devices)]
                      for i in range(tp))
                for r in range(n_replicas)]
    return [tuple(devices[r * tp:(r + 1) * tp])
            for r in range(n_replicas)]


class ReplicaMesh:
    """The device layout of ONE replica: ``axis_names`` ``("dp",
    axis_name)``, ``devices`` a (1, n) object array of the group in
    order, and ``shape`` ``{"dp": 1, axis_name: n}`` — the port's
    counterpart of the reference's per-replica ``jax.sharding.Mesh``.
    A descriptor only: executing a group of n > 1 devices inside a
    replica waits for the multi-GPU item (ROADMAP.md Queue A, item 5)."""

    def __init__(self, group, axis_name="tp"):
        group = tuple(group)
        if not group:
            raise MXNetError("replica_mesh: empty device group")
        self.axis_names = ("dp", axis_name)
        self.devices = np.empty((1, len(group)), dtype=object)
        for i, d in enumerate(group):
            self.devices[0, i] = d
        self.shape = {"dp": 1, axis_name: len(group)}

    def __repr__(self):
        return (f"ReplicaMesh(axis_names={self.axis_names}, "
                f"shape={self.shape})")


def replica_mesh(group, axis_name="tp"):
    """A (1, tp) :class:`ReplicaMesh` over ONE replica's device group,
    axes ``("dp", axis_name)``.  Raises :class:`MXNetError` for an empty
    group."""
    return ReplicaMesh(group, axis_name)
