"""The device mesh of the port's trainer: one card.

The counterpart of ``mxnet_tpu.parallel.make_mesh`` for the dp = tp =
sp = 1 slice.  A mesh with any axis above 1 is refused with an error
that names the roadmap's multi-GPU item (ROADMAP.md Queue A, item 3):
nothing runs silently on one device in its place.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["Mesh", "make_mesh"]


class Mesh:
    """A one-device mesh: ``device`` (a ``torch.device``), ``shape``
    ``{"dp": 1, "tp": 1, "sp": 1}`` and ``axis_names``."""

    axis_names = ("dp", "tp", "sp")

    def __init__(self, device):
        self.device = torch.device(device)
        self.shape = {a: 1 for a in self.axis_names}

    def __repr__(self):
        return f"Mesh(device={self.device}, shape={self.shape})"


def make_mesh(dp=1, tp=1, sp=1, devices=None, device="cuda"):
    """A :class:`Mesh` over one device: ``devices[0]`` when ``devices``
    is given, else ``device`` (default ``"cuda"``, which must exist —
    the CPU is used only when asked for).  Raises :class:`MXNetError`
    for any axis above 1."""
    axes = {"dp": dp, "tp": tp, "sp": sp}
    big = {a: n for a, n in axes.items() if int(n) != 1}
    if big:
        raise MXNetError(
            f"make_mesh: axes {big} need more than one device; the port "
            f"trains on one card (dp=tp=sp=1) until the multi-GPU item "
            f"of ROADMAP.md (Queue A: torch.distributed / NCCL) lands")
    if devices is not None:
        if len(devices) != 1:
            raise MXNetError(f"make_mesh: a one-device mesh takes one "
                             f"device, got {len(devices)}")
        device = devices[0]
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError("make_mesh: no CUDA device; pass device='cpu' "
                         "to train on the CPU")
    return Mesh(device)
