"""Device meshes for the distributed solves, on ``torch.distributed``.

PyTorch counterpart of ``hybrid_fem_lssvr_tpu/parallel/mesh.py``.  A JAX
``Mesh`` of devices becomes a ``torch.distributed.device_mesh.DeviceMesh``
of ranks, one process per rank, with the JAX axis names as the mesh's
dimension names:

* ``element_mesh``  — one dimension ``"elements"``: contiguous element
  ranges (1D) or y-slabs / z-slabs (2D / 3D);
* ``grid_mesh``     — ``("ely", "elx")``: 2D blocks of element rows and
  columns;
* ``grid_mesh_3d``  — ``("elz", "ely")``: 3D blocks of layers and rows,
  x local.

The caller starts the process group (``torch.distributed.
init_process_group`` with its address, world size and rank) before it
builds a mesh; nothing here keeps module-level state.  ``device_type`` is
``"cuda"`` unless the caller asks for ``"cpu"``; on CUDA each rank takes
card ``local_rank % torch.cuda.device_count()`` (``LOCAL_RANK`` from the
environment, else the global rank), so several ranks may share one card.

JAX's ``element_spec`` / ``replicated_spec`` (``PartitionSpec`` helpers)
have no counterpart: a rank holds its own shard as a plain tensor, and a
replicated value is the same tensor on every rank.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..utils.device import resolve as resolve_device

ELEMENT_AXIS = "elements"
GRID_AXES = ("ely", "elx")
GRID_AXES_3D = ("elz", "ely")


def _build(shape, names, device_type: Optional[str]) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(
            "start the process group first (torch.distributed."
            "init_process_group with its address, world size and rank)")
    world = dist.get_world_size()
    size = 1
    for s in shape:
        size *= s
    if size != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {size} ranks; the "
                         f"process group has {world}")
    device_type = device_type or "cuda"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_type='cuda' and torch.cuda.is_available() is False; "
                "pass device_type='cpu' to build a CPU mesh")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def element_mesh(n_devices: Optional[int] = None,
                 device_type: Optional[str] = None) -> DeviceMesh:
    """1-D mesh ``("elements",)`` over ``n_devices`` ranks (default: the
    whole process group, which must have exactly that many ranks)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return _build((n,), (ELEMENT_AXIS,), device_type)


def grid_mesh(n_dy: int, n_dx: int,
              device_type: Optional[str] = None) -> DeviceMesh:
    """2-axis mesh ``("ely", "elx")`` of element-row by element-column
    blocks: the 2D analog of ``element_mesh``."""
    return _build((n_dy, n_dx), GRID_AXES, device_type)


def grid_mesh_3d(n_dz: int, n_dy: int,
                 device_type: Optional[str] = None) -> DeviceMesh:
    """2-axis mesh ``("elz", "ely")`` of element-layer by element-row blocks
    of a 3D hex grid (x stays local)."""
    return _build((n_dz, n_dy), GRID_AXES_3D, device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis`` (JAX ``mesh.shape[axis]``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def mesh_device(device=None) -> torch.device:
    """The device this rank computes on: ``device`` when given, else the
    card the mesh assigned to this rank (None with no card raises, as
    ``utils.device.resolve`` does; the CPU runs only when asked for)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
