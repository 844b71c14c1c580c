"""The device mesh of the port's trainer: axes dp / tp / sp / ep over the
ranks of a ``torch.distributed`` process group.

The counterpart of ``mxnet_tpu.parallel.make_mesh``.  Over an
initialized group (:func:`.dist.initialize`) the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dim names
``("dp", "tp", "sp", "ep")``, one rank per device; :class:`Mesh` keeps
its per-axis process groups and this rank's coordinates.  Without a
group a mesh is one device, as in the one-card slices; a mesh above one
device then raises and says to initialize the group first.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

from ..base import MXNetError

__all__ = ["Mesh", "make_mesh", "mesh_axis_size"]

AXES = ("dp", "tp", "sp", "ep")


class Mesh:
    """A device mesh seen from one rank.

    ``shape`` (``{axis: size}``), ``axis_names``, ``device`` (this
    rank's device), ``groups`` (``{axis: ProcessGroup}``, None without a
    process group), ``coords`` (``{axis: this rank's index}``),
    ``device_mesh`` (the ``DeviceMesh``, or None) and ``backend``."""

    def __init__(self, device, shape=None, axis_names=AXES,
                 device_mesh=None):
        self.device = torch.device(device)
        self.axis_names = tuple(axis_names)
        self.shape = dict(shape) if shape is not None \
            else {a: 1 for a in self.axis_names}
        self.device_mesh = device_mesh
        if device_mesh is None:
            self.groups = None
            self.coords = {a: 0 for a in self.axis_names}
            self.backend = None
        else:
            self.groups = {a: device_mesh.get_group(a)
                           for a in self.axis_names}
            coord = device_mesh.get_coordinate()
            self.coords = dict(zip(self.axis_names, coord))
            self.backend = tdist.get_backend()

    @property
    def size(self):
        n = 1
        for v in self.shape.values():
            n *= int(v)
        return n

    def group(self, axis):
        """The process group of ``axis`` (None on a one-device mesh)."""
        return None if self.groups is None else self.groups[axis]

    def __repr__(self):
        return (f"Mesh(device={self.device}, shape={self.shape}, "
                f"coords={self.coords}, backend={self.backend})")


def _check_device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError("no CUDA device; pass device='cpu' to train on "
                         "the CPU")
    return device


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def make_mesh(dp=None, tp=1, sp=1, ep=1, devices=None, device="cuda"):
    """Build a :class:`Mesh` with axes (dp, tp, sp, ep).

    ``dp=None`` absorbs what the other axes leave of the world size.
    Over an initialized process group the mesh spans every rank (a mesh
    that asks for more devices than ranks raises as the JAX package's
    does; one that leaves ranks out raises too), and this rank's device
    is the one :func:`.dist.initialize` chose, else ``device``.  Without
    a group the mesh is one device: ``devices[0]`` when ``devices`` is
    given, else ``device`` (default ``"cuda"``, which must exist — the
    CPU is used only when asked for); an axis above 1 then raises
    :class:`MXNetError` saying to initialize a process group."""
    from . import dist as _dist
    tp, sp, ep = int(tp), int(sp), int(ep)
    grouped = tdist.is_initialized()
    if not grouped:
        want = (1 if dp is None else int(dp)) * tp * sp * ep
        if want > 1 or (devices is not None and len(devices) > 1):
            raise MXNetError(
                f"make_mesh: mesh {dp or 1}x{tp}x{sp}x{ep} needs "
                f"{max(want, len(devices or ()))} devices, but no process "
                f"group is initialized: call parallel.dist.initialize "
                f"first (initialize a process group, one rank per device, "
                f"e.g. with python3 -m mxnet_tpu_torch.tools.launch -n "
                f"<ranks> ...)")
        return Mesh(_check_device(devices[0] if devices is not None
                                  else device))
    n = len(devices) if devices is not None else tdist.get_world_size()
    if dp is None:
        if n % (tp * sp * ep):
            raise MXNetError(f"{n} devices not divisible by tp*sp*ep="
                             f"{tp * sp * ep}")
        dp = n // (tp * sp * ep)
    dp = int(dp)
    want = dp * tp * sp * ep
    if want > n:
        raise MXNetError(f"mesh {dp}x{tp}x{sp}x{ep} needs {want} devices, "
                         f"only {n} available")
    if want != tdist.get_world_size():
        raise MXNetError(
            f"make_mesh: mesh {dp}x{tp}x{sp}x{ep} covers {want} of the "
            f"group's {tdist.get_world_size()} ranks; a mesh spans every "
            f"rank of the process group")
    device = _dist.device() or _check_device(device)
    from torch.distributed.device_mesh import init_device_mesh
    # the DeviceMesh only names and groups the ranks (the port keeps no
    # DTensor): a gloo group is labelled "cpu" even when its ranks hold
    # CUDA tensors, so nothing in DeviceMesh binds ranks to cards
    mesh_type = "cuda" if tdist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(mesh_type, (dp, tp, sp, ep), mesh_dim_names=AXES)
    return Mesh(device, {"dp": dp, "tp": tp, "sp": sp, "ep": ep},
                device_mesh=dm)
